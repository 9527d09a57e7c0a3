"""The port's disaggregated feature tier (``tmr_tpu_torch/serve/feature_tier.py``), the
engine's ``feature_client=``, the feature sink's ``on_request`` hook and the pieces of
``serve/fleet.py`` the tier imports, case by case as ``tests/test_feature_tier.py``
holds the JAX package's, on the port's ``StubFeaturePredictor`` over loopback, then
against the JAX package:

- the wire helpers: a bf16 tensor travels as its 16-bit words under ``"bfloat16"`` and
  comes back bit for bit, and a document the JAX ``pack_array`` wrote for a bf16 array
  unpacks to the same values; detections, the fleet policy and the stub signature are
  the JAX ones;
- a JAX ``FeatureWorker`` answers a port ``FeatureTierClient`` (and serves a port engine),
  and a port ``FeatureWorker`` answers a JAX client: the wire is the JAX protocol;
- on the TINY pair of ``tests/test_torch_predictor.py``, a feature-tier round trip in
  each package gives the JAX engine's detections within 1e-5 (``valid`` equal).

The lease tests use TTLs of seconds, and every wait is bounded. Workers are threads,
as in the JAX tests.
"""

import socket
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tmr_tpu.parallel.leases import recv_line, send_line  # noqa: E402
from tmr_tpu.serve import feature_tier as j_tier  # noqa: E402
from tmr_tpu.serve import fleet as j_fleet  # noqa: E402
from tmr_tpu_torch.parallel.leases import LeasePolicy  # noqa: E402
from tmr_tpu_torch.serve import ServeEngine  # noqa: E402
from tmr_tpu_torch.serve.feature_tier import (  # noqa: E402
    FeatureTier,
    FeatureWorker,
    StubFeaturePredictor,
    _ExtractLink,
)
from tmr_tpu_torch.serve.fleet import (  # noqa: E402
    StubFleetPredictor,
    fleet_policy,
    pack_array,
    pack_detections,
    stub_signature,
    unpack_array,
    unpack_detections,
)
from tmr_tpu_torch.serve.gallery import FeatureSinkServer  # noqa: E402

SIZE = 32
BOX = np.asarray([[0.2, 0.2, 0.4, 0.4]], np.float32)
FIELDS = ("boxes", "scores", "refs", "valid")
WAIT_S = 30
TOL = 1e-5  # tests/test_torch_serve.py's, on boxes, scores and refs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _img(seed):
    return np.random.default_rng(seed).standard_normal((SIZE, SIZE, 3)).astype(np.float32)


def _wait(cond, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _worker(address, wid, pred=None):
    return FeatureWorker(address, wid, StubFeaturePredictor() if pred is None else pred,
                         device="cpu", data_host="127.0.0.1", data_port=0).start()


@pytest.fixture()
def tier_worker():
    """One coordinator and one holding worker on loopback: (tier, worker, predictor)."""
    pred = StubFeaturePredictor()
    tier = FeatureTier([SIZE], host="127.0.0.1", port=0)
    tier.start()
    worker = _worker(tier.address, "w0")
    try:
        _wait(lambda: worker.held, msg="worker to acquire a partition")
        yield tier, worker, pred
    finally:
        worker.stop()
        tier.close()


def _engine(pred, client, **kw):
    return ServeEngine(pred, **dict(dict(batch=2, max_wait_ms=5.0, feature_cache=4,
                                         exemplar_cache=0, feature_client=client), **kw))


# ------------------------------------------------------------- wire helpers
def test_bf16_travels_as_its_words_and_jax_documents_unpack():
    """A bf16 tensor is packed as its 16-bit words under ``"bfloat16"`` (half the bytes
    of an f32 upcast) and comes back bit for bit; a document the JAX ``pack_array`` wrote
    for a bf16 array unpacks to the same values; the JAX side reads the port's
    document back to the same values."""
    import jax.numpy as jnp

    vals = np.random.default_rng(3).standard_normal((2, 5, 7)).astype(np.float32)
    t = torch.from_numpy(vals).to(torch.bfloat16)
    doc = pack_array(t)
    assert doc["dtype"] == "bfloat16" and doc["shape"] == [2, 5, 7]
    assert len(doc["b64"]) == len(pack_array(vals.astype(np.float16))["b64"])
    back = unpack_array(doc)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))
    jdoc = j_fleet.pack_array(np.asarray(jnp.asarray(vals, jnp.bfloat16)))
    assert jdoc["dtype"] == "bfloat16"
    assert jdoc == doc
    np.testing.assert_array_equal(unpack_array(jdoc).float().numpy(),
                                  np.asarray(j_fleet.unpack_array(jdoc), np.float32))
    np.testing.assert_array_equal(np.asarray(j_fleet.unpack_array(doc), np.float32),
                                  t.float().numpy())


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.bool_, np.uint8])
def test_numpy_arrays_and_tensors_pack_as_jax_does(dtype):
    a = (np.random.default_rng(4).standard_normal((3, 4)) * 5).astype(dtype)
    assert pack_array(a) == j_fleet.pack_array(a)
    assert pack_array(torch.from_numpy(a)) == j_fleet.pack_array(a)
    back = unpack_array(j_fleet.pack_array(a))
    assert back.dtype == a.dtype and np.array_equal(back, a) and back.flags.writeable


def test_detections_policy_and_stub_match_jax():
    stub = StubFleetPredictor()
    dets = stub._dets(np.stack([_img(1), _img(2)]))
    jdets = j_fleet.StubFleetPredictor()._dets(np.stack([_img(1), _img(2)]))
    for k in FIELDS:
        assert np.array_equal(dets[k].numpy(), jdets[k]), k
    doc = pack_detections(dict(dets, count=torch.tensor([1, 1], dtype=torch.int32)))
    assert doc == j_fleet.pack_detections({**jdets, "count": np.array([1, 1], np.int32)})
    back = unpack_detections(doc)
    assert set(back) == set(FIELDS) | {"count"}
    assert stub_signature(_img(5)) == j_fleet.stub_signature(_img(5))
    assert fleet_policy() == LeasePolicy(**vars(j_fleet.fleet_policy()))
    custom = LeasePolicy.from_env(lease_ttl_s=3.0)
    assert fleet_policy(custom) is custom


# ------------------------------------------------------- sink window reset
def test_sink_window_resets_on_any_successful_roundtrip():
    """An error followed by a successful non-sync round trip (here: evict) must not
    poison the next sync."""
    sink = FeatureSinkServer(max_entries=8)
    host, port = sink.start()
    try:
        with socket.create_connection((host, port), timeout=5) as s:
            f = s.makefile("rb")
            send_line(s, {"op": "hello", "worker": "t"})
            assert recv_line(f)["ok"]
            send_line(s, {"op": "feature", "shard": "x", "name": "bad",
                          "array": {"b64": "!!!", "dtype": "float32", "shape": [1]}})
            send_line(s, {"op": "evict", "shard": "y"})
            assert recv_line(f)["ok"] is True
            send_line(s, {"op": "feature", "shard": "x", "name": "good",
                          "array": pack_array(np.ones((2,), np.float32))})
            send_line(s, {"op": "sync", "shard": "x"})
            reply = recv_line(f)
            assert reply["ok"] is True, reply
            assert reply["errors"] == 0 and reply["features"] == 1
            send_line(s, {"op": "bye"})
    finally:
        sink.close()
    assert sink.counters()["errors"] == 1


def test_sink_on_request_hook_acks_errors_and_unknown_ops():
    """``on_request`` replies close the window like any ack, its exceptions become
    counted error replies, and ops nobody owns still get the unknown-op error."""

    def hook(doc, state):
        if doc.get("op") == "ping":
            return {"op": "ping", "ok": True}
        if doc.get("op") == "boom":
            raise ValueError("kapow")
        return None

    sink = FeatureSinkServer(max_entries=8, on_request=hook)
    host, port = sink.start()
    try:
        with socket.create_connection((host, port), timeout=5) as s:
            f = s.makefile("rb")
            send_line(s, {"op": "feature", "shard": "x", "name": "bad",
                          "array": {"b64": "!!!", "dtype": "float32", "shape": [1]}})
            send_line(s, {"op": "ping"})
            assert recv_line(f)["ok"] is True
            send_line(s, {"op": "sync", "shard": "x"})
            assert recv_line(f)["ok"] is True  # the ping reset the window
            send_line(s, {"op": "boom"})
            reply = recv_line(f)
            assert reply["ok"] is False and "kapow" in reply["error"]
            send_line(s, {"op": "nonsense"})
            reply = recv_line(f)
            assert reply["ok"] is False and "unknown op" in reply["error"]
    finally:
        sink.close()
    assert sink.counters()["errors"] == 2


# --------------------------------------------------- disaggregated serving
def test_remote_features_match_local_execution(tier_worker):
    """An engine armed with a feature client routes its first sighting down the
    heads-only path on remote features, and the result carries the image's signature,
    equal to a direct local call."""
    tier, worker, pred = tier_worker
    client = tier.client(predictor=pred)
    eng = _engine(pred, client)
    try:
        img = _img(1)
        out = eng.submit(img, BOX).result(timeout=WAIT_S)
        local = pred(img[None], BOX[None])
        for k in FIELDS:
            assert np.array_equal(out[k], local[k].numpy()), k
        oc = eng.overload_counters()
        assert oc.get("feature_tier.remote_frames", 0) == 1, oc
        assert worker.counters()["extracted"] == 1
        assert client.counters()["fetched"] == 1
        assert eng.feature_cache.stats()["inserts"] == 1
        assert eng.counters["feature_fills"] == 0  # no local encoder
    finally:
        eng.close(timeout=30)
        client.close()


def test_dead_worker_degrades_to_counted_local_fallback(tier_worker):
    """Kill the only feature worker mid-stream: later frames resolve through local
    execution (cold or fallback counted, never silent) with no dropped future."""
    tier, worker, pred = tier_worker
    client = tier.client(predictor=pred)
    eng = _engine(pred, client)
    try:
        assert eng.submit(_img(2), BOX).result(timeout=WAIT_S)["valid"].any()
        worker.stop()
        _wait(lambda: tier.holder_for(SIZE) is None, msg="holder to clear")
        futs = [eng.submit(_img(10 + i), BOX) for i in range(3)]
        for i, fut in enumerate(futs):
            got = fut.result(timeout=WAIT_S)
            local = pred(_img(10 + i)[None], BOX[None])
            assert np.array_equal(got["scores"], local["scores"].numpy())
        oc = eng.overload_counters()
        counted = (oc.get("feature_tier.cold_frames", 0)
                   + oc.get("feature_tier.fallback_frames", 0))
        assert counted >= 3, oc
    finally:
        eng.close(timeout=30)
        client.close()


def test_failed_fetch_runs_the_row_locally_counted():
    """A client that holds the size but whose fetch fails (the worker died mid-flight):
    the row drops to the local encoder inside its heads batch, counted
    ``feature_tier.fallback_frames``, and equals the local call."""

    class Failing:
        calls = 0

        def holds(self, size):
            return True

        def fetch(self, image, digest, size):
            Failing.calls += 1
            raise ConnectionError("worker gone")

    pred = StubFeaturePredictor()
    eng = _engine(pred, Failing(), batch=1)
    try:
        imgs = [_img(30), _img(31)]
        outs = [eng.submit(img, BOX).result(timeout=WAIT_S) for img in imgs]
        for img, out in zip(imgs, outs):
            local = pred(img[None], BOX[None])
            assert np.array_equal(out["scores"], local["scores"].numpy())
        oc = eng.overload_counters()
        assert oc.get("feature_tier.fallback_frames") == 2 and Failing.calls == 2
        assert "feature_tier.remote_frames" not in oc
        assert eng.counters["feature_fills"] == 2 and eng.counters["heads_batches"] == 2
    finally:
        eng.close(timeout=30)


def test_fenced_extract_never_serves_stale_features(tier_worker):
    """An extract carrying a revoked or unknown (partition, epoch) answers ``fenced``."""
    tier, worker, pred = tier_worker
    wid, epoch, index, addr = tier.holder_for(SIZE)
    link = _ExtractLink(addr, timeout_s=5.0)
    try:
        stale = link.call({"op": "extract", "partition": index, "epoch": epoch + 7,
                           "digest": "d", "image": pack_array(_img(3))})
        assert stale["ok"] is False and stale["status"] == "fenced"
        assert worker.counters()["fenced"] == 1
        live = link.call({"op": "extract", "partition": index, "epoch": epoch,
                          "digest": "d", "image": pack_array(_img(3))})
        assert live["ok"] is True
        assert tuple(live["stamp"]) == pred.feature_stamp()
        assert np.array_equal(unpack_array(live["features"]),
                              pred._get_backbone_fn()(_img(3)[None]).numpy())
    finally:
        link.close()


def test_client_refuses_stamp_mismatch(tier_worker):
    tier, worker, pred = tier_worker

    class OtherCheckpoint(StubFeaturePredictor):
        def feature_stamp(self):
            return ("other-params", "stub-backbone")

    client = tier.client(predictor=OtherCheckpoint())
    try:
        assert client.fetch(_img(4), "d", SIZE) is None
        assert client.counters()["stamp_mismatches"] == 1
    finally:
        client.close()


def test_client_window_saturation_fails_fast(tier_worker):
    tier, worker, pred = tier_worker
    client = tier.client(predictor=pred, window=1)
    try:
        assert client._window.acquire(blocking=False)  # saturate it
        t0 = time.monotonic()
        assert client.fetch(_img(5), "d", SIZE) is None
        assert time.monotonic() - t0 < 1.0  # fast, not a queue wait
        assert client.counters()["window_rejections"] == 1
        client._window.release()
        assert client.fetch(_img(5), "d", SIZE) is not None
    finally:
        client.close()


def test_client_counts_no_holder_when_tier_is_cold():
    tier = FeatureTier([SIZE], host="127.0.0.1", port=0)
    tier.start()
    client = tier.client(predictor=StubFeaturePredictor())
    try:
        assert client.holds(SIZE) is False
        assert client.fetch(_img(6), "d", SIZE) is None
        assert client.counters()["no_holder"] == 1
    finally:
        client.close()
        tier.close()


def test_worker_rebalance_after_kill_minus_nine():
    """A worker that vanishes without ``bye`` (beats frozen, control socket torn down)
    loses its partition, and a second worker inherits it at a higher epoch: the fence the
    extract path checks. TTL 2 s."""
    policy = fleet_policy(LeasePolicy.from_env(lease_ttl_s=2.0, hb_interval_s=0.5,
                                               check_interval_s=0.1))
    tier = FeatureTier([SIZE], host="127.0.0.1", port=0, policy=policy,
                       check_interval_s=0.1)
    tier.start()
    w1 = _worker(tier.address, "w1")
    try:
        _wait(lambda: w1.held, msg="w1 to hold")
        epoch1 = next(iter(w1.held.values()))
        w1._stop_event.set()  # kill -9: freeze the beats and sever the control socket
        w1._sock.close()
        w2 = _worker(tier.address, "w2")
        try:
            _wait(lambda: w2.held, timeout=20.0, msg="w2 to inherit the partition")
            resolved = tier.holder_for(SIZE)
            assert resolved is not None and resolved[0] == "w2"
            assert resolved[1] > epoch1
        finally:
            w2.stop()
    finally:
        w1._sink.close()
        tier.close()


def test_tier_state_and_unknown_ops(tier_worker):
    tier, worker, pred = tier_worker
    state = tier.state()
    assert state["ok"] and state["partitions"][f"feat{SIZE}"]["holder"][0] == "w0"
    assert tier.dispatch({"op": "nonsense"})["ok"] is False
    with pytest.raises(ValueError, match="at least one size"):
        FeatureTier([])


def test_worker_refuses_the_cpu_unless_asked(tier_worker, monkeypatch):
    """Built for a real ``Predictor``, the worker runs on the card: without ``device``
    on a machine with no GPU it raises before it dials; a predictor on another device
    than the worker's is refused."""
    tier, _, _ = tier_worker
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FeatureWorker(tier.address, "wx", StubFeaturePredictor())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="runs on cuda"):
        FeatureWorker(tier.address, "wy", StubFeaturePredictor(), device="cuda")


def test_fleet_obs_is_refused_by_name(tier_worker, monkeypatch):
    """``TMR_FLEET_OBS`` asks for the fleet observability spans, which come with the
    fleet: the worker and the client refuse by name; off, both run."""
    tier, _, pred = tier_worker
    monkeypatch.setenv("TMR_FLEET_OBS", "1")
    with pytest.raises(NotImplementedError, match="TMR_FLEET_OBS.*ROADMAP A7.4"):
        FeatureWorker(tier.address, "wz", StubFeaturePredictor(), device="cpu")
    with pytest.raises(NotImplementedError, match="TMR_FLEET_OBS.*ROADMAP A7.4"):
        tier.client(predictor=pred)
    monkeypatch.setenv("TMR_FLEET_OBS", "0")
    tier.client(predictor=pred).close()


# ------------------------------------------------------ across the packages
def test_jax_worker_answers_a_port_client_and_engine():
    """A JAX ``FeatureWorker`` joins a port ``FeatureTier`` and answers the port's client:
    the features are the port stub's encoder on the same image, and a port engine serves
    a remote frame from them with the image's signature."""
    tier = FeatureTier([SIZE], host="127.0.0.1", port=0)
    tier.start()
    jw = j_tier.FeatureWorker(tier.address, "jw", j_tier.StubFeaturePredictor(),
                              data_host="127.0.0.1", data_port=0).start()
    pred = StubFeaturePredictor()
    client = tier.client(predictor=pred)
    eng = _engine(pred, client)
    try:
        _wait(lambda: jw.held, msg="the JAX worker to hold")
        feats = client.fetch(_img(7), "d", SIZE)
        assert np.array_equal(feats, pred._get_backbone_fn()(_img(7)[None]).numpy())
        out = eng.submit(_img(8), BOX).result(timeout=WAIT_S)
        assert out["scores"][0, 0] == stub_signature(_img(8))
        assert eng.overload_counters().get("feature_tier.remote_frames") == 1
        assert jw.counters()["extracted"] == 2
        assert client.counters()["stamp_mismatches"] == 0
    finally:
        eng.close(timeout=30)
        client.close()
        jw.stop()
        tier.close()


def test_port_worker_answers_a_jax_client():
    """A port ``FeatureWorker`` joins a JAX ``FeatureTier`` and answers the JAX client:
    the stamp matches, and the features are the JAX stub's encoder on the same image."""
    jtier = j_tier.FeatureTier([SIZE], host="127.0.0.1", port=0)
    jtier.start()
    worker = _worker(jtier.address, "pw")
    jpred = j_tier.StubFeaturePredictor()
    jclient = jtier.client(predictor=jpred)
    try:
        _wait(lambda: worker.held, msg="the port worker to hold")
        feats = jclient.fetch(_img(9), "d", SIZE)
        assert feats is not None, jclient.counters()
        assert np.array_equal(feats, jpred._get_backbone_fn()(None, _img(9)[None]))
        assert worker.counters()["extracted"] == 1
        assert jclient.counters()["stamp_mismatches"] == 0
    finally:
        jclient.close()
        worker.stop()
        jtier.close()


def test_feature_tier_round_trip_matches_the_jax_engine_on_the_tiny_pair():
    """The TINY pair: each package's engine with its own tier and worker (on its own
    predictor), the same requests, served from remote features: the JAX engine's
    detections within 1e-5, ``valid`` equal; the port's remote frames launch no local
    encoder."""
    from tests.test_torch_predictor import SIZE as PSIZE
    from tests.test_torch_predictor import TINY, _make_pair
    from tmr_tpu.serve import ServeEngine as JServeEngine

    jpred, pred, _ = _make_pair(TINY)
    rng = np.random.default_rng(23)
    reqs = [(rng.standard_normal((PSIZE, PSIZE, 3)).astype(np.float32), ex)
            for ex in (np.array([[0.2, 0.2, 0.4, 0.5]], np.float32),
                       np.array([[0.5, 0.55, 0.7, 0.6]], np.float32))]
    results = {}
    for name, pkg_tier, engine_cls, p, kw in (
            ("jax", j_tier, JServeEngine, jpred, {}),
            ("port", None, ServeEngine, pred, {"device": "cpu"})):
        tier_cls = j_tier.FeatureTier if pkg_tier else FeatureTier
        worker_cls = j_tier.FeatureWorker if pkg_tier else FeatureWorker
        tier = tier_cls([PSIZE], host="127.0.0.1", port=0)
        tier.start()
        worker = worker_cls(tier.address, f"{name}-w", p, data_host="127.0.0.1",
                            data_port=0, **kw).start()
        client = tier.client(predictor=p)
        eng = engine_cls(p, batch=1, max_wait_ms=5.0, feature_cache=4, exemplar_cache=0,
                         feature_client=client)
        try:
            _wait(lambda: worker.held, msg=f"the {name} worker to hold")
            results[name] = [eng.submit(img, ex).result(timeout=WAIT_S)
                             for img, ex in reqs]
            oc = eng.overload_counters()
            assert oc.get("feature_tier.remote_frames") == len(reqs), (name, oc)
            if name == "port":
                assert eng.counters["feature_fills"] == 0
                assert client.counters()["stamp_mismatches"] == 0
        finally:
            eng.close()
            client.close()
            worker.stop()
            tier.close()
    for got, want in zip(results["port"], results["jax"]):
        np.testing.assert_array_equal(got["valid"], np.asarray(want["valid"]))
        for k in ("boxes", "scores", "refs"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=TOL, atol=TOL,
                                       err_msg=k)
