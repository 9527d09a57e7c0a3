"""The serving engine on the CPU: ``tmr_tpu_torch.serve.ServeEngine`` against
``tmr_tpu.serve.ServeEngine`` on the TINY pair of ``tests/test_torch_predictor.py`` (the
JAX ``Predictor`` and the port's, loaded through ``params_from_jax``), and against the
port's own programs.

- Against the JAX engine: the same seeded requests (single, multi at k = 3, mixed
  buckets, ragged tails of 1-5) give the same detections at ``test_torch_predictor``'s
  tolerance (boxes, scores and refs within 1e-5, ``valid`` equal), and the counters and
  the ``stats()`` shape are the JAX engine's.
- Against itself: a served request equals the same program run on the engine's padded
  stack bit for bit. Against a sequential B = 1 call it holds the same 1e-5, because on
  the CPU the decoder's 3x3 convolutions (``F.conv2d``) take other algorithms at other
  batch sizes: :func:`test_batch_variance_on_the_cpu_is_the_decoder_convolution` names
  that layer.
- The caches, coalescing, promotion to the heads path, isolation, fallback, close and
  the refusals of what is not ported.

Every future is awaited with a timeout and every engine closed with a bounded drain.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_predictor import SIZE, TINY, _make_pair  # noqa: E402
from tmr_tpu.serve import ServeEngine as JServeEngine  # noqa: E402
from tmr_tpu.serve.batcher import MicroBatcher as JMicroBatcher  # noqa: E402
from tmr_tpu.serve.batcher import Request as JRequest  # noqa: E402
from tmr_tpu.serve.caches import LRUCache as JLRUCache  # noqa: E402
from tmr_tpu.serve.caches import array_digest as j_array_digest  # noqa: E402
from tmr_tpu.serve.staging import _pad_to as j_pad_to  # noqa: E402
from tmr_tpu_torch.serve import LRUCache, MicroBatcher, Request, ServeEngine  # noqa: E402
from tmr_tpu_torch.serve.caches import array_digest  # noqa: E402
from tmr_tpu_torch.serve.staging import _PAD_BOX, _pad_to  # noqa: E402

FIELDS = ("boxes", "scores", "refs", "valid")
TOL = 1e-5  # tests/test_torch_predictor.py's, on boxes, scores and refs
WAIT_S = 60  # every future's timeout
#: a latency bound long enough that requests submitted together ride one batch
LONG_WAIT_MS = 1000

EX_A = np.array([[0.2, 0.2, 0.4, 0.5]], np.float32)  # bucket 9
EX_B = np.array([[0.5, 0.55, 0.7, 0.6]], np.float32)
EX_C = np.array([[0.1, 0.6, 0.15, 0.7]], np.float32)
#: two exemplar rows: a bucket of its own, ("single", 32, 9, 2) (the TINY 8 x 8 map
#: puts every box in template bucket 9)
EX_TWO = np.concatenate([EX_A, EX_B])
MULTI = np.array([[0.2, 0.2, 0.4, 0.5], [0.5, 0.55, 0.7, 0.6], [0.1, 0.6, 0.15, 0.7]],
                 np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def pair():
    return _make_pair(TINY)


@pytest.fixture
def engines():
    """A factory of engines (either package's); each is closed with a bounded drain."""
    made = []

    def make(cls, pred, **kw):
        made.append(cls(pred, **kw))
        return made[-1]

    yield make
    for eng in made:
        eng.close(timeout=30)


def _images(n, seed=2):
    return np.random.default_rng(seed).standard_normal((n, SIZE, SIZE, 3)).astype(
        np.float32)


def _results(futures):
    return [f.result(timeout=WAIT_S) for f in futures]


def _assert_close(got, want, ctx=""):
    np.testing.assert_array_equal(got["valid"], np.asarray(want["valid"]), err_msg=ctx)
    for k in ("boxes", "scores", "refs"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=TOL, atol=TOL,
                                   err_msg=f"{ctx} {k}")


def _assert_bitwise(got, want, ctx=""):
    for k in FIELDS:
        assert np.array_equal(got[k], np.asarray(want[k])), f"{ctx}: {k} not bit for bit"


def _serve_both(pair, engines, requests, **kw):
    """The same requests (image, exemplars, submit kwargs) through a JAX engine and a
    port engine; returns both result lists and both engines."""
    jpred, pred, _ = pair
    out = []
    for cls, p in ((JServeEngine, jpred), (ServeEngine, pred)):
        eng = engines(cls, p, **kw)
        futs = [eng.submit(img, ex, **skw) for img, ex, skw in requests]
        out.append((_results(futs), eng))
    return out


# ------------------------------------------------------- pure logic vs JAX
def test_lru_cache_matches_jax_on_a_scripted_sequence():
    ours, theirs = LRUCache(3, max_bytes=64), JLRUCache(3, max_bytes=64)
    rng = np.random.default_rng(0)
    for step in range(200):
        key = int(rng.integers(0, 6))
        if rng.random() < 0.5:
            val = np.zeros(int(rng.integers(1, 24)), np.float32)
            ours.put(key, val)
            theirs.put(key, val)
        else:
            assert (ours.get(key) is None) == (theirs.get(key) is None), step
        assert ours.stats() == theirs.stats(), step
        assert (key in ours) == (key in theirs)
    off = LRUCache(0)
    off.put("x", 1)
    assert off.get("x") is None and len(off) == 0


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "uint8"])
def test_array_digest_hex_matches_jax(dtype):
    a = (np.random.default_rng(1).standard_normal((3, 5, 2)) * 50).astype(dtype)
    b = np.arange(4, dtype=np.float32)
    assert array_digest(a) == j_array_digest(a)
    assert array_digest(a, b) == j_array_digest(a, b)
    assert array_digest(torch.from_numpy(a)) == j_array_digest(a)  # host bytes


def test_array_digest_of_bf16_tensors_matches_jax_bfloat16():
    import jax.numpy as jnp

    x = np.random.default_rng(3).standard_normal((4, 6)).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    assert array_digest(t) == j_array_digest(np.asarray(jnp.asarray(x, jnp.bfloat16)))
    assert array_digest(np.zeros(4, np.float32)) != array_digest(np.zeros((2, 2),
                                                                          np.float32))


def test_pad_to_matches_jax():
    for bound in range(1, 17):
        for n in range(1, 20):
            assert _pad_to(n, bound) == j_pad_to(n, bound), (n, bound)


def _release_order(batcher_cls, request_cls, script, t0, bound=3):
    """Release order of a scripted sequence: full buckets first, then the drain after
    close (submit stamps from ``t0``, far enough ahead that no latency bound expires)."""
    b = batcher_cls(max_wait_ms=60_000, bound_for=lambda bucket: bound)
    for i, (bucket, prio) in enumerate(script):
        r = request_cls(image=None, exemplars=None, bucket=bucket, priority=prio,
                        t_submit=t0 + i)
        r.trace_id = str(i)
        b.put(r)
    b.close()
    order = []
    while (nb := b.next_batch()) is not None:
        order.append((nb[0], [r.trace_id for r in nb[1]]))
    return order, b.occupancy_snapshot()


def test_micro_batcher_release_order_matches_jax():
    import time

    from tmr_tpu.serve.admission import class_weight_fn as j_weights
    from tmr_tpu_torch.serve.admission import class_weight_fn

    rng = np.random.default_rng(4)
    script = [(("single", 32, int(rng.choice([9, 17])), 1), int(rng.integers(0, 3)))
              for _ in range(23)]
    t0 = time.perf_counter() + 1e4
    plain = _release_order(MicroBatcher, Request, script, t0)
    assert plain == _release_order(JMicroBatcher, JRequest, script, t0)
    assert sum(len(ids) for _, ids in plain[0]) == len(script)

    def weighted(cls, weights):
        return lambda **kw: cls(class_weight=weights(), **kw)

    got = _release_order(weighted(MicroBatcher, class_weight_fn), Request, script, t0)
    assert got == _release_order(weighted(JMicroBatcher, j_weights), JRequest, script, t0)


def test_micro_batcher_flushes_at_max_wait_and_full_bucket_at_once():
    import time

    b = MicroBatcher(max_wait_ms=150, bound_for=lambda bucket: 2)
    b.put(Request(image=None, exemplars=None, bucket=("x",)))
    t0 = time.perf_counter()
    assert len(b.next_batch()[1]) == 1
    assert 0.05 <= time.perf_counter() - t0 < 5.0
    b.put(Request(image=None, exemplars=None, bucket=("x",)))
    b.put(Request(image=None, exemplars=None, bucket=("x",)))
    t0 = time.perf_counter()
    assert len(b.next_batch()[1]) == 2 and time.perf_counter() - t0 < 1.0
    b.close()
    assert b.next_batch() is None


# -------------------------------------------------- engine vs the JAX engine
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_ragged_tail_matches_jax_engine(pair, engines, n):
    """n requests on one bucket at bound 4: a full batch and a ragged tail (n = 5), or
    one ragged batch; the same detections, counters and stats shape as the JAX engine."""
    images = _images(n)
    reqs = [(images[i], EX_A, {}) for i in range(n)]
    (want, jeng), (got, eng) = _serve_both(pair, engines, reqs, batch=4,
                                           max_wait_ms=LONG_WAIT_MS, feature_cache=0)
    for i in range(n):
        _assert_close(got[i], want[i], f"request {i}")
    assert eng.counters == jeng.counters
    assert eng.stats()["batch_occupancy"] == jeng.stats()["batch_occupancy"]
    assert set(eng.stats()) == set(jeng.stats())


def test_multi_exemplar_requests_match_jax_engine(pair, engines):
    images = _images(3, seed=5)
    reqs = [(images[0], MULTI, dict(multi=True)),
            (images[1], MULTI, dict(multi=True, k_real=2)),
            (images[2], MULTI[:1], dict(multi=True))]
    (want, jeng), (got, eng) = _serve_both(pair, engines, reqs, batch=4,
                                           max_wait_ms=LONG_WAIT_MS)
    for i in range(len(reqs)):
        _assert_close(got[i], want[i], f"multi request {i}")
        assert got[i]["boxes"].shape == np.asarray(want[i]["boxes"]).shape
    assert eng.counters == jeng.counters


def test_mixed_buckets_caches_and_promotion_match_jax_engine(pair, engines):
    """Three buckets (one exemplar row, two rows, multi at k = 3), a repeat (result
    cache), a second sighting with a new exemplar (promotion: the heads path with a
    fill) and a third (a feature-cache hit)."""
    images = _images(4, seed=6)
    first = [(images[0], EX_A, {}), (images[1], EX_TWO, {}), (images[2], EX_A, {}),
             (images[3], MULTI, dict(multi=True))]
    jpred, pred, _ = pair
    results = []
    for cls, p in ((JServeEngine, jpred), (ServeEngine, pred)):
        eng = engines(cls, p, batch=4, max_wait_ms=30, feature_cache=4)
        got = _results([eng.submit(img, ex, **kw) for img, ex, kw in first])
        got += _results([eng.submit(images[0], EX_A)])  # result-cache hit
        got += _results([eng.submit(images[2], EX_B)])  # second sighting: fill
        got += _results([eng.submit(images[2], EX_C)])  # feature-cache hit
        results.append((got, eng))
    (want, jeng), (got, eng) = results
    for i in range(len(want)):
        _assert_close(got[i], want[i], f"request {i}")
    assert got[4] is got[0]
    assert eng.counters == jeng.counters
    assert eng.counters["heads_batches"] == 2 and eng.counters["feature_fills"] == 1
    for which in ("result_cache", "feature_cache"):
        assert eng.stats()[which] == jeng.stats()[which]


def test_reports_pass_the_jax_validators(pair, engines):
    from tmr_tpu.diagnostics import validate_health_report as j_health
    from tmr_tpu.diagnostics import validate_metrics_report as j_metrics
    from tmr_tpu_torch.diagnostics import validate_health_report, validate_metrics_report

    _, pred, _ = pair
    eng = engines(ServeEngine, pred, batch=2, max_wait_ms=10)
    _results([eng.submit(img, EX_A) for img in _images(3)])
    snap, health = eng.metrics_snapshot(), eng.health()
    assert j_metrics(snap) == [] and validate_metrics_report(snap) == []
    assert j_health(health) == [] and validate_health_report(health) == []
    assert snap["histograms"]["serve.request_latency_s"]["count"] == 3
    assert {"serve.submitted", "serve.cache.result.hits"} <= set(snap["counters"])


# ------------------------------------------------------ engine vs itself
def _padded_stack(images, ex, n_pad):
    """The engine's padded stack of n requests: their rows, then zero images with the
    dummy exemplar."""
    n = len(images)
    imgs = np.zeros((n_pad, SIZE, SIZE, 3), np.float32)
    imgs[:n] = images
    exs = np.tile(np.asarray(_PAD_BOX, np.float32), (n_pad, 1, 1))
    exs[:n] = ex
    return imgs, exs


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_served_equals_the_program_on_the_padded_stack(pair, engines, n):
    """One batch of n requests at bound 8 (padded to 1, 2, 4, 4, 8) equals
    ``_get_fn(cap)`` on the same padded stack bit for bit, and a sequential B = 1 call
    within the stated tolerance."""
    _, pred, _ = pair
    images = _images(n, seed=7)
    eng = engines(ServeEngine, pred, batch=8, max_wait_ms=LONG_WAIT_MS, feature_cache=0)
    got = _results([eng.submit(img, EX_A) for img in images])
    assert eng.stats()["batch_occupancy"] == {str(n): 1}
    cap = pred.pick_capacity(EX_A, SIZE)
    want = pred._get_fn(cap)(*_padded_stack(images, EX_A, _pad_to(n, 8)))
    for i in range(n):
        _assert_bitwise(got[i], {k: want[k][i:i + 1].numpy() for k in FIELDS}, f"row {i}")
        one = pred(images[i:i + 1], EX_A[None])
        _assert_close(got[i], {k: one[k].numpy() for k in FIELDS}, f"row {i} vs B = 1")
    assert eng.stats()["padded_slots"] == _pad_to(n, 8) - n


def _first_variant_module(model, run_batch, run_one):
    """The first module, in execution order, whose output for row 0 differs between a
    batched forward and the same row alone; None when none does."""
    records = {}

    def hook(name):
        def fn(_mod, _inp, out):
            out = out[0] if isinstance(out, (tuple, list)) else out
            if torch.is_tensor(out):
                records.setdefault(name, []).append(out[:1].clone())
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in model.named_modules() if n]
    order = []
    try:
        with torch.inference_mode():
            run_batch()
            order = list(records)
            run_one()
    finally:
        for h in handles:
            h.remove()
    for name in order:
        a, b = records[name][0], records[name][-1]
        if a.shape == b.shape and not torch.equal(a, b):
            return name
    return None


def test_batch_variance_on_the_cpu_is_the_decoder_convolution(pair):
    """The layer that breaks B = 4 against B = 1 on the CPU: the decoder's 3x3
    convolution (``F.conv2d`` picks its algorithm by batch size); every layer before it
    gives row 0 the same bits at both sizes."""
    _, pred, _ = pair
    images, exs = _padded_stack(_images(3, seed=8), EX_A, 4)
    cap = pred.pick_capacity(EX_A, SIZE)
    m = pred.model
    first = _first_variant_module(
        m, lambda: m(torch.as_tensor(images), torch.as_tensor(exs), cap),
        lambda: m(torch.as_tensor(images[:1]), torch.as_tensor(exs[:1]), cap))
    assert first is not None and first.startswith(("decoder_b_0.conv", "decoder_o_0.conv")
                                                  ), first


def test_result_cache_hit_returns_the_identical_result(pair, engines):
    _, pred, _ = pair
    eng = engines(ServeEngine, pred, batch=2, max_wait_ms=10, feature_cache=0)
    img = _images(1, seed=9)[0]
    a = eng.predict(img, EX_A)
    b = eng.submit(img, EX_A).result(timeout=WAIT_S)
    assert b is a
    s = eng.stats()
    assert s["result_cache"]["hits"] == 1 and s["batches"] == 1
    assert s["submitted"] == s["completed"] == 2


def test_inflight_duplicates_coalesce(pair, engines):
    _, pred, _ = pair
    eng = engines(ServeEngine, pred, batch=4, max_wait_ms=LONG_WAIT_MS, feature_cache=0)
    img = _images(1, seed=10)[0]
    got = _results([eng.submit(img, EX_A) for _ in range(3)])
    assert got[0] is got[1] is got[2]
    c = eng.counters
    assert (c["submitted"], c["completed"], c["coalesced"], c["batches"]) == (3, 3, 2, 1)


def test_second_sighting_promotes_and_heads_path_equals_fused(pair, engines):
    """The second sighting runs the heads path with a fill, the third a feature-cache
    hit; each equals the fused program on a stack of the same batch size bit for bit
    (the encoder is batch-invariant here, and the tail runs at the same size)."""
    _, pred, _ = pair
    eng = engines(ServeEngine, pred, batch=1, max_wait_ms=5, feature_cache=4)
    img = _images(1, seed=11)[0]
    fused = eng.predict(img, EX_A)
    fill = eng.predict(img, EX_B)
    hit = eng.predict(img, EX_C)
    c = eng.counters
    assert (c["heads_batches"], c["feature_fills"], c["batches"]) == (2, 1, 3)
    assert eng.stats()["feature_cache"]["hits"] == 1
    for got, ex in ((fused, EX_A), (fill, EX_B), (hit, EX_C)):
        want = pred._get_fn(pred.pick_capacity(ex, SIZE))(np.stack([img]), np.stack([ex]))
        _assert_bitwise(got, {k: want[k].numpy() for k in FIELDS})
    stamp = pred.feature_stamp()
    assert list(eng.feature_cache._data)[0][2:] == stamp
    assert len(stamp[0]) == 40 and stamp[1] == pred.cfg.backbone


def test_malformed_request_fails_alone(pair, engines):
    _, pred, _ = pair
    eng = engines(ServeEngine, pred, batch=4, max_wait_ms=20, feature_cache=0)
    good = eng.submit(_images(1, seed=12)[0], EX_A)
    bad = eng.submit(np.zeros((SIZE, SIZE + 1, 3), np.float32), EX_A)
    with pytest.raises(ValueError, match="square"):
        bad.result(timeout=WAIT_S)
    assert good.result(timeout=WAIT_S)["boxes"].shape[0] == 1
    assert eng.counters["rejected"] == 1 and eng.counters["completed"] == 1


def test_batch_failure_falls_back_to_per_request_execution(pair, engines, monkeypatch):
    _, pred, _ = pair
    eng = engines(ServeEngine, pred, batch=4, max_wait_ms=LONG_WAIT_MS, feature_cache=0)

    def boom(staged):
        raise RuntimeError("injected batch failure")

    monkeypatch.setattr(eng, "_run_batch", boom)
    images = _images(3, seed=13)
    got = _results([eng.submit(img, EX_A) for img in images])
    c = eng.counters
    assert (c["batch_fallbacks"], c["completed"], c["errors"]) == (1, 3, 0)
    for i in range(3):
        one = pred(images[i:i + 1], EX_A[None])
        _assert_bitwise(got[i], {k: one[k].numpy() for k in FIELDS})


def test_submit_after_close_raises(pair):
    _, pred, _ = pair
    eng = ServeEngine(pred, batch=2, max_wait_ms=5)
    eng.close(timeout=30)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(_images(1)[0], EX_A).result(timeout=WAIT_S)
    assert not any(t.is_alive() for t in eng._threads)


@pytest.mark.parametrize("kw, item", [
    (dict(mesh="dp=2"), "A7"),
    (dict(devices=["cpu", "cpu"]), "A7"),
    (dict(feature_client=object()), "A7"),
])
def test_unported_options_are_refused_by_name(pair, engines, kw, item):
    """Mesh serving and several devices stay refused (ROADMAP A7). ``feature_client=`` is
    ported (``serve/feature_tier.py``; ``tests/test_torch_feature_tier.py``), so its case
    holds what the JAX engine does with the argument: both engines take the object, and a
    single-exemplar request asks it ``holds(size)``, so an object without that method
    fails that request alone, with the same error in both packages."""
    jpred, pred, _ = pair
    if "feature_client" not in kw:
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            ServeEngine(pred, **kw)
        return
    outs = []
    for cls, p in ((JServeEngine, jpred), (ServeEngine, pred)):
        eng = engines(cls, p, batch=1, max_wait_ms=5, **kw)
        assert eng._feature_client is kw["feature_client"]
        fut = eng.submit(_images(1)[0], EX_A)
        with pytest.raises(AttributeError, match="holds") as err:
            fut.result(timeout=WAIT_S)
        outs.append((type(err.value), eng.counters["rejected"], eng.counters["submitted"]))
    assert outs[0] == outs[1] == (AttributeError, 1, 0)


def test_unported_methods_and_knobs_are_refused(pair, engines, monkeypatch):
    """The live tuner (A8) and ``TMR_SERVE_MESH`` (A7) stay refused. The gallery is
    ported (``tests/test_torch_gallery.py``): ``search_gallery`` before
    ``attach_gallery`` raises, after it searches the attached backend, counted."""
    _, pred, _ = pair
    eng = engines(ServeEngine, pred, batch=1)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        eng.attach_live_tuner(object())
    with pytest.raises(RuntimeError, match="no gallery attached"):
        eng.search_gallery(_images(1)[0])
    seen = []
    eng.attach_gallery(type("Backend", (), {
        "search": lambda self, image, **kw: seen.append((image.shape, kw)) or {}})())
    assert eng.search_gallery(_images(1)[0], prefilter_topk=2) == {}
    assert seen == [((SIZE, SIZE, 3), {"prefilter_topk": 2})]
    assert eng.metrics.counter("serve.gallery.searches").value == 1
    with pytest.raises(ValueError, match="donation"):
        ServeEngine(pred, donate=True)
    monkeypatch.setenv("TMR_SERVE_MESH", "dp=2")
    with pytest.raises(NotImplementedError, match="TMR_SERVE_MESH.*ROADMAP A7"):
        ServeEngine(pred)
    monkeypatch.setenv("TMR_SERVE_MESH", "off")
    engines(ServeEngine, pred, batch=1)


def test_engine_refuses_a_predictor_without_weights(pair):
    from tmr_tpu_torch.inference import Predictor

    _, pred, _ = pair
    bare = Predictor(pred.cfg, device="cpu", model=pred.model)
    with pytest.raises(RuntimeError, match="no weights set"):
        ServeEngine(bare)


def test_warmup_runs_each_padded_shape_once(pair, engines):
    _, pred, _ = pair
    bucket = pred.bucket_key(SIZE, EX_A)
    eng = engines(ServeEngine, pred, batch=4, warmup_buckets=[bucket])
    assert eng.stats()["warmup"]["programs"] == 3  # shapes 1, 2 and 4
    assert eng.counters["batches"] == 0
    got = eng.predict(_images(1, seed=14)[0], EX_A)
    assert got["valid"].shape[0] == 1
