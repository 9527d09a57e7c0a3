"""Stream sessions of the port (``tmr_tpu_torch/serve/streams.py``) and the engine's
``submit(features=)`` hook, case by case as ``tests/test_streams.py`` holds the JAX
package's, on the port's ``StubFeaturePredictor`` (its features carry each image's mean
signature end to end, so a wrong anchor, a crossed stream or a stale cache row shows as
a score mismatch), then against the JAX package:

- the same seeded frame sequence through the JAX ``StreamRouter`` over the JAX engine
  and through the port's, each on its own stub: the same route per frame (first,
  changed, reused), the same counters, the same ``block_signature`` values (atol 1e-6)
  and the same stub scores;
- ``submit(features=)`` on the TINY pair of ``tests/test_torch_predictor.py``: the JAX
  engine's detections within ``test_torch_serve.py``'s 1e-5 (``valid`` equal).

Every future is awaited with a timeout and every engine closed with a bounded drain.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tmr_tpu.serve import ServeEngine as JServeEngine  # noqa: E402
from tmr_tpu.serve import StreamRouter as JStreamRouter  # noqa: E402
from tmr_tpu.serve import block_signature as j_block_signature  # noqa: E402
from tmr_tpu.serve.feature_tier import StubFeaturePredictor as JStub  # noqa: E402
from tmr_tpu_torch.serve import ServeEngine, StreamRouter, block_signature  # noqa: E402
from tmr_tpu_torch.serve.feature_tier import StubFeaturePredictor  # noqa: E402

SIZE = 32
BOX = np.asarray([[0.2, 0.2, 0.4, 0.4]], np.float32)
FIELDS = ("boxes", "scores", "refs", "valid")
WAIT_S = 60
TOL = 1e-5  # tests/test_torch_serve.py's, on boxes, scores and refs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _img(seed):
    return np.random.default_rng(seed).standard_normal((SIZE, SIZE, 3)).astype(np.float32)


def _stub_engine(cls=ServeEngine, pred=None, **kw):
    kw = dict(dict(batch=2, max_wait_ms=5.0, feature_cache=0, exemplar_cache=0), **kw)
    return cls(StubFeaturePredictor() if pred is None else pred, **kw)


@pytest.fixture()
def engine():
    eng = _stub_engine()
    yield eng
    eng.close(timeout=30)


def _same(a, b):
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in FIELDS)


def _get(fut):
    return fut.result(timeout=WAIT_S)


# ------------------------------------------------------------ off by default
def test_reuse_off_by_default_is_pure_passthrough(engine, monkeypatch):
    """No env, no constructor flag: ``submit_stream`` is ``engine.submit`` with a frame
    counter: no sessions, no labels, no feature work."""
    monkeypatch.delenv("TMR_STREAM_REUSE", raising=False)
    r = StreamRouter(engine)
    assert r.reuse is False
    frame = _img(0)
    out = _get(r.submit_stream("a", frame, BOX))
    again = _get(r.submit_stream("a", frame, BOX))
    assert "degrade_steps" not in out and "degrade_steps" not in again
    assert _same(out, _get(engine.submit(frame, BOX)))
    assert r.sessions() == {} and r.counters() == {"frames": 2}
    monkeypatch.setenv("TMR_STREAM_REUSE", "0")
    assert StreamRouter(engine).reuse is False
    monkeypatch.setenv("TMR_STREAM_REUSE", "1")
    assert StreamRouter(engine).reuse is True


# --------------------------------------------------------- delta boundaries
def test_delta_boundaries_exact_equal_at_threshold_and_above(engine):
    """The election rule at its edges in exact float32 arithmetic (zeros, powers of two,
    4x4 signature blocks): delta 0.0 reuses even at threshold 0.0; a one-pixel change
    landing on the threshold still reuses; strictly above goes the full path and
    re-anchors."""
    r = StreamRouter(engine, reuse=True, delta=0.0625)
    base = np.zeros((SIZE, SIZE, 3), np.float32)
    first = _get(r.submit_stream("s", base, BOX))
    assert "degrade_steps" not in first
    exact = _get(r.submit_stream("s", base.copy(), BOX))
    assert exact.get("degrade_steps") == ["temporal_reuse"]
    at = base.copy()
    at[0, 0, 0] = 1.0  # delta == threshold (1/16): still reuses
    assert _get(r.submit_stream("s", at, BOX)).get("degrade_steps") == ["temporal_reuse"]
    above = base.copy()
    above[0, 0, 0] = 2.0  # delta 0.125 > 0.0625: full path, new anchor
    out_above = _get(r.submit_stream("s", above, BOX))
    assert "degrade_steps" not in out_above
    assert _same(out_above, _get(engine.submit(above, BOX)))
    c = r.counters()
    assert (c["first_frames"], c["reused_frames"], c["changed_frames"]) == (1, 2, 1)
    rep = _get(r.submit_stream("s", above.copy(), BOX))  # the changed frame re-anchored
    assert rep.get("degrade_steps") == ["temporal_reuse"]
    assert np.array_equal(rep["scores"], out_above["scores"])
    r0 = StreamRouter(engine, reuse=True, delta=0.0)
    _get(r0.submit_stream("z", base, BOX))
    assert _get(r0.submit_stream("z", base.copy(), BOX)).get("degrade_steps") == [
        "temporal_reuse"]


@pytest.mark.parametrize("shape", [(SIZE, SIZE, 3), (3, 3, 3), (37, 53, 3)])
def test_block_signature_is_deterministic_and_matches_jax(shape):
    """Deterministic, float32, the grid clamped to the frame, and the JAX function's
    values (atol 1e-6; the same numpy reductions, so in fact equal)."""
    frame = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    a, b = block_signature(frame), block_signature(frame.copy())
    assert np.array_equal(a, b) and a.dtype == np.float32
    g = min(8, shape[0], shape[1])
    assert a.shape == (g * g, 3)
    np.testing.assert_allclose(a, j_block_signature(frame), rtol=0, atol=1e-6)


# ------------------------------------------------------ reuse data contracts
def test_reused_frames_ride_anchor_features_per_stream(engine):
    """Reused results derive from the session's own anchor features (the stub's
    signature rides through), and two streams with different content never share."""
    r = StreamRouter(engine, reuse=True)
    a_frame, b_frame = _img(1), _img(2)
    a0 = _get(r.submit_stream("a", a_frame, BOX))
    b0 = _get(r.submit_stream("b", b_frame, BOX))
    a1 = _get(r.submit_stream("a", a_frame.copy(), BOX))
    b1 = _get(r.submit_stream("b", b_frame.copy(), BOX))
    assert np.array_equal(a1["scores"], a0["scores"])
    assert np.array_equal(b1["scores"], b0["scores"])
    assert not np.array_equal(a1["scores"], b1["scores"])
    c = r.counters()
    assert c["reused_frames"] == 2 and c["local_fills"] == 2
    assert set(r.sessions()) == {"a", "b"}


def test_reused_result_cache_namespace_never_leaks():
    """A reused answer is never served to a frame-independent query: the
    ``temporal_reuse`` step is part of the result-cache key."""
    eng = _stub_engine(exemplar_cache=16)
    try:
        r = StreamRouter(eng, reuse=True)
        frame = _img(3)
        _get(r.submit_stream("a", frame, BOX))
        reused = _get(r.submit_stream("a", frame.copy(), BOX))
        assert reused.get("degrade_steps") == ["temporal_reuse"]
        plain = _get(eng.submit(frame, BOX))
        assert "degrade_steps" not in plain
    finally:
        eng.close(timeout=30)


def test_features_with_multi_exemplar_is_rejected(engine):
    """Reuse rides the heads-only program, which has no multi-exemplar formulation: the
    combination fails that request alone, at submit."""
    multi_ex = np.asarray([[0.2, 0.2, 0.4, 0.4], [0.5, 0.5, 0.7, 0.7]], np.float32)
    fut = engine.submit(_img(4), multi_ex, multi=True, k_real=2,
                        features=np.zeros((1, 2, 2, 4), np.float32))
    with pytest.raises(ValueError, match="single-exemplar"):
        _get(fut)
    assert engine.counters["rejected"] == 1


def test_router_prefers_feature_tier_for_anchor_fills(engine):
    """With the engine's feature client armed and holding, the anchor fill goes remote
    (counted ``remote_fills``); a client that fails drops to the counted local fill."""
    calls = []

    class FakeClient:
        def __init__(self, alive=True):
            self.alive = alive

        def holds(self, size):
            return self.alive

        def fetch(self, image, digest, size):
            calls.append(digest)
            if not self.alive:
                return None
            sig = np.asarray(image, np.float32).reshape(1, -1).mean(axis=1)
            return np.tile(sig.reshape(1, 1, 1, 1), (1, 2, 2, 4)).astype(np.float32)

    engine._feature_client = FakeClient(alive=True)
    r = StreamRouter(engine, reuse=True)
    frame = _img(5)
    first = _get(r.submit_stream("a", frame, BOX))
    reused = _get(r.submit_stream("a", frame.copy(), BOX))
    assert np.array_equal(reused["scores"], first["scores"])
    assert calls and r.counters()["remote_fills"] == 1
    engine._feature_client.alive = False  # the worker dies mid-stream
    frame2 = _img(6)
    _get(r.submit_stream("b", frame2, BOX))
    fb = _get(r.submit_stream("b", frame2.copy(), BOX))
    assert fb.get("degrade_steps") == ["temporal_reuse"]
    c = r.counters()
    assert c["local_fills"] == 1 and c["remote_fills"] == 1


# ----------------------------------------------------------------- lifecycle
def test_idle_sessions_evict_lazily(engine, monkeypatch):
    monkeypatch.setenv("TMR_STREAM_IDLE_S", "0.05")
    r = StreamRouter(engine, reuse=True)
    assert r.idle_s == 0.05
    frame = _img(8)
    _get(r.submit_stream("a", frame, BOX))
    time.sleep(0.12)
    _get(r.submit_stream("b", _img(9), BOX))  # sweeps "a" out
    assert set(r.sessions()) == {"b"}
    assert r.counters()["evicted_sessions"] == 1
    out = _get(r.submit_stream("a", frame.copy(), BOX))  # "a" starts over
    assert "degrade_steps" not in out
    assert r.counters()["first_frames"] == 3


def test_explicit_evict_drops_session_and_features(engine):
    r = StreamRouter(engine, reuse=True)
    frame = _img(10)
    _get(r.submit_stream("a", frame, BOX))
    _get(r.submit_stream("a", frame.copy(), BOX))
    assert r.stats()["feature_cache"]["size"] == 1
    assert r.evict("a") is True and r.evict("a") is False
    assert r.sessions() == {} and r.stats()["feature_cache"]["size"] == 0


def test_stream_knob_defaults_and_stats(engine, monkeypatch):
    for knob in ("TMR_STREAM_REUSE", "TMR_STREAM_DELTA", "TMR_STREAM_IDLE_S",
                 "TMR_STREAM_CACHE_MB"):
        monkeypatch.delenv(knob, raising=False)
    r = StreamRouter(engine)
    assert (r.reuse, r.delta, r.idle_s) == (False, 0.02, 300.0)
    assert r._features.max_bytes == 64 << 20
    monkeypatch.setenv("TMR_STREAM_DELTA", "0.5")
    monkeypatch.setenv("TMR_STREAM_CACHE_MB", "1")
    r2 = StreamRouter(engine, reuse=True)
    assert r2.delta == 0.5 and r2._features.max_bytes == 1 << 20
    s = r2.stats()
    assert s["reuse"] is True and s["sessions"] == 0


def test_router_counters_hold_under_concurrent_streams(engine):
    """16 client threads, a stream each (first, two repeats, a cut, a repeat, a cut back),
    with the interpreter switching threads every microsecond: no update of the router's
    sessions or counters is lost, and every result carries its own frame's signature (a
    reused frame is an exact repeat of its anchor)."""
    import sys
    import threading

    from tmr_tpu_torch.serve.fleet import stub_signature

    r = StreamRouter(engine, reuse=True)
    results = {}

    def client(s):
        a, b = _img(100 + s), _img(200 + s)
        results[s] = [(f, r.submit_stream(f"s{s}", f, BOX)) for f in (a, a, a, b, b, a)]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(s,)) for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    for s, frames in results.items():
        for f, fut in frames:
            assert _get(fut)["scores"][0, 0] == stub_signature(f), s
    assert r.counters() == {"frames": 96, "first_frames": 16, "reused_frames": 48,
                            "changed_frames": 32, "local_fills": 32}
    # each stream's last frame re-anchored, which drops the old anchor's features
    assert len(r.sessions()) == 16 and r.stats()["feature_cache"]["size"] == 0


# ------------------------------------------------------- stamped feature keys
def test_feature_cache_keys_carry_params_and_backbone_stamp():
    """Feature keys carry (weights digest, backbone formulation), so two engines over
    other weights sharing one cache never serve each other's features; a predictor
    without a stamp keys on the image alone, as in the JAX engine."""
    from tmr_tpu_torch.serve.fleet import StubFleetPredictor

    class OtherCheckpoint(StubFeaturePredictor):
        def feature_stamp(self):
            return ("other-params", "stub-backbone")

    a = _stub_engine(batch=1, feature_cache=4)
    b = _stub_engine(pred=OtherCheckpoint(), batch=1, feature_cache=4)
    c = _stub_engine(pred=StubFleetPredictor(), batch=1, feature_cache=4)
    try:
        ka, kb = a._feature_key("digest", SIZE), b._feature_key("digest", SIZE)
        assert ka != kb
        assert ka == ("digest", SIZE, "stub-params", "stub-backbone")
        assert kb[2:] == ("other-params", "stub-backbone")
        assert c._feature_key("digest", SIZE) == ("digest", SIZE)
    finally:
        for eng in (a, b, c):
            eng.close(timeout=30)


def test_gallery_bank_feature_keys_carry_stamp_too():
    from tmr_tpu_torch.serve import GalleryBank

    class OtherCheckpoint(StubFeaturePredictor):
        def feature_stamp(self):
            return ("other-params", "stub-backbone")

    bank_a = GalleryBank.__new__(GalleryBank)
    bank_b = GalleryBank.__new__(GalleryBank)
    for bank, pred in ((bank_a, StubFeaturePredictor()), (bank_b, OtherCheckpoint())):
        bank._feat_stamp = tuple(pred.feature_stamp())
    assert bank_a._feature_key("d", SIZE) != bank_b._feature_key("d", SIZE)


def test_predictor_feature_stamp_tracks_the_weights_content():
    """The port's stamp is a content digest of the weights: other weights move it, the
    same weights in another ``Predictor`` (another process's worker) give the same one,
    and the backbone's name rides beside it."""
    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.inference import Predictor
    from tmr_tpu_torch.models import build_model
    from tmr_tpu_torch.models.vit import SamViT

    cfg = preset("TMR_FSCD147", backbone="sam_vit_b", emb_dim=16,
                 compute_dtype="float32", image_size=SIZE)

    def make(seed):
        model = build_model(cfg, device="cpu", backbone=SamViT(
            pretrain_img_size=SIZE, embed_dim=32, depth=2, num_heads=2,
            global_attn_indexes=(1,), patch_size=8, window_size=3, out_chans=16))
        pred = Predictor(cfg, device="cpu", model=model)
        pred.init_params(seed)
        return pred

    a, a2, b = make(0), make(0), make(1)
    assert a.feature_stamp()[1] == "sam_vit_b"
    assert a.feature_stamp() == a2.feature_stamp() != b.feature_stamp()


# --------------------------------------------------------- against the JAX package
def _frame_sequence():
    """3 streams x 6 frames, interleaved and seeded: exact repeats, noise well under the
    0.02 delta, cuts to new content, and an eviction of stream 1 before its frame 4."""
    rng = np.random.default_rng(11)
    scenes = {s: [rng.standard_normal((SIZE, SIZE, 3)).astype(np.float32)
                  for _ in range(2)] for s in range(3)}
    plan = {0: [(0, 0.0), (0, 0.0), (0, 1e-3), (1, 0.0), (1, 1e-3), (0, 0.0)],
            1: [(0, 0.0), (0, 2e-3), (0, 2e-3), (0, 0.5), (0, 0.0), (1, 0.0)],
            2: [(0, 0.0), (1, 0.0), (1, 1e-3), (1, 0.0), (0, 1e-3), (0, 0.0)]}
    seq = []
    for t in range(6):
        for s in range(3):
            scene, noise = plan[s][t]
            frame = scenes[s][scene] + noise * rng.standard_normal(
                (SIZE, SIZE, 3)).astype(np.float32)
            seq.append((f"cam{s}", t, frame.astype(np.float32)))
    return seq


def _drive(router_cls, engine, seq):
    """Each frame through the router in order; returns (route per frame, results,
    counters). The route is read off the counters the frame moved."""
    r = router_cls(engine, reuse=True)
    routes, results = [], []
    for sid, t, frame in seq:
        if sid == "cam1" and t == 4:
            assert r.evict(sid) is True
        before = r.counters()
        results.append(_get(r.submit_stream(sid, frame, BOX)))
        after = r.counters()
        moved = [k for k in ("first_frames", "changed_frames", "reused_frames")
                 if after.get(k, 0) != before.get(k, 0)]
        assert len(moved) == 1, moved
        routes.append(moved[0].split("_")[0])
    return routes, results, r.counters()


def test_router_matches_jax_on_a_seeded_frame_sequence():
    """The same seeded sequence through the JAX router over the JAX engine and through
    the port's, each on its own stub: the same route per frame, the same counters and
    the same stub scores (the signatures the features carried)."""
    seq = _frame_sequence()
    jeng = JServeEngine(JStub(), batch=2, max_wait_ms=5.0, feature_cache=0,
                        exemplar_cache=0)
    eng = _stub_engine()
    try:
        j_routes, j_results, j_counters = _drive(JStreamRouter, jeng, seq)
        routes, results, counters = _drive(StreamRouter, eng, seq)
    finally:
        jeng.close()
        eng.close(timeout=30)
    assert routes == j_routes
    assert set(routes) == {"first", "changed", "reused"}
    assert counters == j_counters
    for (sid, t, frame), got, want in zip(seq, results, j_results):
        assert got.get("degrade_steps") == want.get("degrade_steps"), (sid, t)
        assert np.array_equal(got["scores"], want["scores"]), (sid, t)
        np.testing.assert_allclose(block_signature(frame), j_block_signature(frame),
                                   rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def pair():
    from tests.test_torch_predictor import TINY, _make_pair

    return _make_pair(TINY)


def test_submit_features_matches_the_jax_engine_on_the_tiny_pair(pair):
    """``submit(features=)`` on each package's TINY predictor, the features from its own
    encoder on the same image: the JAX engine's detections within 1e-5, ``valid`` equal,
    both labelled ``temporal_reuse``; the port's result equals its heads program on the
    same features bit for bit."""
    from tests.test_torch_predictor import SIZE as PSIZE

    jpred, pred, _ = pair
    rng = np.random.default_rng(21)
    jeng = JServeEngine(jpred, batch=1, max_wait_ms=5.0, feature_cache=0, exemplar_cache=0)
    eng = ServeEngine(pred, batch=1, max_wait_ms=5.0, feature_cache=0, exemplar_cache=0)
    try:
        for ex in (np.array([[0.2, 0.2, 0.4, 0.5]], np.float32),
                   np.array([[0.5, 0.55, 0.7, 0.6]], np.float32)):
            img = rng.standard_normal((PSIZE, PSIZE, 3)).astype(np.float32)
            jfeats = np.asarray(jpred._get_backbone_fn()(jpred.params, np.stack([img])))
            feats = pred._get_backbone_fn()(np.stack([img]))
            want = _get(jeng.submit(img, ex, features=jfeats))
            got = _get(eng.submit(img, ex, features=feats))
            assert got["degrade_steps"] == want["degrade_steps"] == ["temporal_reuse"]
            np.testing.assert_array_equal(got["valid"], want["valid"])
            for k in ("boxes", "scores", "refs"):
                np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)
            heads = pred._get_heads_fn(pred.pick_capacity(ex, PSIZE), PSIZE)(
                feats, np.stack([ex]))
            for k in FIELDS:
                assert np.array_equal(got[k], heads[k].numpy()), k
    finally:
        jeng.close()
        eng.close(timeout=30)
