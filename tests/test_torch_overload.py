"""Overload control of the port's serving layer: ``serve/admission.py`` and
``serve/degrade.py`` against the JAX modules on the same scripted sequences
(``RejectedError`` fields, admission decisions, class weights, the degrade ladder,
``downscale_image``), then the engine's wiring on a stub predictor (instant CPU
"programs", so the tests exercise queues, locks and accounting): exact rejection
accounting under a burst of 5x the admission bound, deadline shedding before any
program runs, coalesced deadlines, the degrade exactness contract, and the bounded
``close()`` drain."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tmr_tpu.serve import admission as j_admission  # noqa: E402
from tmr_tpu.serve import degrade as j_degrade  # noqa: E402
from tmr_tpu_torch.diagnostics import validate_health_report  # noqa: E402
from tmr_tpu_torch.serve import (  # noqa: E402
    AdmissionController,
    DegradeController,
    RejectedError,
    ServeEngine,
)
from tmr_tpu_torch.serve import admission, degrade  # noqa: E402

SIZE = 32
WAIT_S = 60
EX = np.asarray([[0.45, 0.45, 0.53, 0.55]], np.float32)
MULTI = np.asarray([[0.45, 0.45, 0.53, 0.55], [0.2, 0.2, 0.28, 0.3],
                    [0.6, 0.55, 0.68, 0.66]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _img(seed, size=SIZE):
    return np.random.default_rng(seed).standard_normal((size, size, 3)).astype(np.float32)


class _Stub:
    """Predictor stand-in on the CPU: host bucket keys and instant programs that return
    zero detections. ``gate`` (a threading.Event) stalls every program until set: a
    wedged device."""

    weights_set = True
    device = torch.device("cpu")

    def __init__(self, gate=None):
        self.gate = gate
        self.calls = 0

    def feature_stamp(self):
        return ("stub", "stub")

    def bucket_key(self, size, ex, multi=False, k_real=None):
        ex = np.asarray(ex, np.float32).reshape(-1, 4)
        k = int(k_real) if k_real is not None else len(ex)
        return ("multi", int(size), 9, k) if multi else ("single", int(size), 9, len(ex))

    def _run(self, b):
        if self.gate is not None:
            self.gate.wait()
        self.calls += 1
        return {"boxes": torch.zeros(b, 8, 4), "scores": torch.zeros(b, 8),
                "refs": torch.zeros(b, 8, 2), "valid": torch.zeros(b, 8, dtype=torch.bool)}

    def _get_fn(self, capacity):
        return lambda image, ex: self._run(image.shape[0])

    def _get_multi_batched_fn(self, capacity, k):
        return lambda image, ex, k_real: self._run(image.shape[0])

    def _get_backbone_fn(self):
        return lambda image: torch.zeros(image.shape[0], 2, 2, 4)

    def _get_heads_fn(self, capacity, size):
        return lambda feats, ex: self._run(feats.shape[0])

    def __call__(self, image, exemplars):
        return self._run(1)

    def predict_multi_exemplar(self, image, exemplars, k_real=None):
        return self._run(1)


@pytest.fixture
def engine():
    """``engine(pred=None, **kw)`` builds an engine on a stub (bound 1, 5 ms, no
    feature cache by default); each is closed with a bounded drain."""
    made = []

    def make(pred=None, **kw):
        kw.setdefault("batch", 1)
        kw.setdefault("max_wait_ms", 5)
        kw.setdefault("feature_cache", 0)
        made.append(ServeEngine(pred or _Stub(), **kw))
        return made[-1]

    yield make
    for eng in made:
        eng.close(timeout=10)


# ------------------------------------------------------ pure logic vs JAX
def test_rejected_error_fields_and_record_match_jax():
    for cause in admission.REJECTION_CAUSES:
        ours = RejectedError(cause, "m", priority=2, retry_after_s=0.12345)
        theirs = j_admission.RejectedError(cause, "m", priority=2, retry_after_s=0.12345)
        assert ours.record() == theirs.record()
        assert (ours.cause, ours.priority, ours.retry_after_s) == (cause, 2, 0.123)
    assert admission.REJECTION_CAUSES == j_admission.REJECTION_CAUSES
    with pytest.raises(AssertionError):
        RejectedError("nope", "m")


def _admission_script(mod, kw, script):
    ctl = mod.AdmissionController(enabled=True, **kw)
    out = []
    for op, prio in script:
        if op == "admit":
            rej = ctl.try_admit(prio)
            out.append(None if rej is None else (rej.cause, rej.priority))
        else:
            ctl.release_class(prio)
            out.append("released")
    stats = ctl.stats()
    stats.pop("drain_per_sec")
    return out, stats


@pytest.mark.parametrize("kw", [dict(max_pending=3),
                                dict(max_pending=10, class_pending=[2, 1, 4]),
                                dict(max_pending=10, rate=1e-3, burst=3)])
def test_admission_decisions_match_jax(kw):
    rng = np.random.default_rng(0)
    script = [("admit" if rng.random() < 0.65 else "release", int(rng.integers(0, 3)))
              for _ in range(60)]
    ours = _admission_script(admission, kw, script)
    assert ours == _admission_script(j_admission, kw, script)
    assert any(d not in (None, "released") for d in ours[0])  # something bounced


def test_disabled_admission_is_inert_and_release_is_idempotent():
    ctl = AdmissionController(enabled=False, max_pending=0)
    assert ctl.try_admit(0) is None
    on = AdmissionController(enabled=True, max_pending=1)
    assert on.try_admit(0) is None

    class _R:
        admitted, priority = True, 0

    r = _R()
    on.release(r)
    on.release(r)
    assert on.stats()["in_system"] == 0 and r.admitted is False


@pytest.mark.parametrize("spec", ["", "1,3,9", "2", "bad,1", "1,-1", " 0.5 , 0.25 "])
def test_class_weights_match_jax(spec):
    assert admission.parse_class_weights(spec) == j_admission.parse_class_weights(spec)
    ours, theirs = admission.class_weight_fn(spec), j_admission.class_weight_fn(spec)
    assert [ours(p) for p in range(-1, 7)] == [theirs(p) for p in range(-1, 7)]


@pytest.mark.parametrize("mode", ["off", "auto", "2", "9", "0"])
def test_degrade_ladder_matches_jax(mode):
    over = [{"anomaly": "queue_saturation"}]
    storm = [{"anomaly": "recompile_storm"}]
    passes = [over, over, [], storm, [], over, over, over, over, [], [], [], [], []]
    runs = []
    for mod in (degrade, j_degrade):
        ctl = mod.DegradeController(mode=mode, max_level=3, cooldown=2, min_size=16)
        runs.append([(ctl.observe(a), tuple(ctl.active_steps())) for a in passes]
                    + [ctl.stats()])
    assert runs[0] == runs[1]
    with pytest.raises(ValueError, match="TMR_DEGRADE"):
        DegradeController(mode="fast")
    assert degrade.DEGRADE_STEPS == j_degrade.DEGRADE_STEPS


def test_downscale_image_matches_jax():
    img = _img(1, 64)
    for factor in (2, 4):
        got = degrade.downscale_image(img, factor)
        assert np.array_equal(got, j_degrade.downscale_image(img, factor))
        assert got.shape == (64 // factor, 64 // factor, 3) and got.flags.c_contiguous


# -------------------------------------------------------- engine wiring
def test_default_knobs_keep_the_jax_shapes(engine):
    eng = engine()
    r = eng.submit(_img(1), EX).result(timeout=WAIT_S)
    assert "degrade_steps" not in r
    assert "overload" not in eng.stats()
    health = eng.health()
    assert "admission" not in health and "degrade" not in health
    assert validate_health_report(health) == []


def test_burst_of_five_times_the_bound_is_accounted_exactly(engine):
    """An in-flight bound of 4 and a burst of 20 on a stalled device: 16 bounce at once
    with a structured cause, the 4 admitted complete once the device moves, and
    submitted + rejected reconcile with the burst exactly."""
    gate = threading.Event()
    eng = engine(_Stub(gate), admission=AdmissionController(enabled=True, max_pending=4))
    futs = [eng.submit(_img(10 + i), EX) for i in range(20)]
    bounced = [f for f in futs if f.done() and f.exception() is not None]
    assert len(bounced) == 16
    for f in bounced:
        e = f.exception()
        assert isinstance(e, RejectedError) and e.cause == "queue_full"
        assert e.retry_after_s is not None and e.retry_after_s > 0
    gate.set()
    done = [f.result(timeout=WAIT_S) for f in futs if f not in bounced]
    assert len(done) == 4
    c, ov = eng.counters, eng.overload_counters()
    assert (c["submitted"], c["completed"], c["errors"], ov["admit_rejected"]) == \
        (4, 4, 0, 16)
    assert ov["admit_rejected.queue_full"] == 16
    assert c["submitted"] + ov["admit_rejected"] == len(futs)
    health = eng.health()
    assert health["admission"]["in_system"] == 0 and validate_health_report(health) == []
    assert eng.stats()["overload"]["admission"]["rejected"] == {"queue_full": 16}


def test_expired_requests_shed_before_any_program_runs(engine):
    pred = _Stub()
    eng = engine(pred, batch=4, max_wait_ms=60)
    futs = [eng.submit(_img(20 + i), EX, deadline_ms=1.0) for i in range(2)]
    for f in futs:
        with pytest.raises(RejectedError) as ei:
            f.result(timeout=WAIT_S)
        assert ei.value.cause == "deadline"
    assert pred.calls == 0
    stats = eng.stats()
    assert stats["batches"] == 0
    assert stats["overload"]["counters"]["shed"] == 2
    assert stats["overload"]["counters"]["shed.stage"] == 2


def test_coalesced_duplicates_inherit_the_earliest_deadline(engine):
    gate = threading.Event()
    eng = engine(_Stub(gate), batch=4, max_wait_ms=60)
    img = _img(30)
    first = eng.submit(img, EX)  # no deadline
    second = eng.submit(img, EX, deadline_ms=1.0, priority=2)
    assert eng.counters["coalesced"] == 1
    time.sleep(0.1)
    gate.set()
    for f in (first, second):
        with pytest.raises(RejectedError, match="deadline"):
            f.result(timeout=WAIT_S)
    assert eng.overload_counters()["shed"] == 2


def test_forced_degrade_labels_results_and_their_cache_entries(engine):
    eng = engine(degrade=DegradeController(mode="1"), exemplar_cache=8)
    img = _img(40)
    r = eng.submit(img, MULTI, multi=True).result(timeout=WAIT_S)
    assert r["degrade_steps"] == ["truncate_k"]
    again = eng.submit(img, MULTI, multi=True).result(timeout=WAIT_S)
    assert again is r and eng.stats()["result_cache"]["hits"] == 1
    ov = eng.overload_counters()
    assert ov["degraded"] == 2 and ov["degrade.truncate_k"] == 2
    single = eng.submit(img, EX).result(timeout=WAIT_S)
    assert "degrade_steps" not in single  # a single request has nothing to truncate


def test_forced_downscale_routes_to_the_half_resolution_bucket(engine):
    eng = engine(degrade=DegradeController(mode="3", min_size=16))
    r = eng.submit(_img(41, 64), EX).result(timeout=WAIT_S)
    assert r["degrade_steps"] == ["downscale"]
    assert eng.stats()["batch_bounds"] == {"32": 1}


def test_close_bounds_the_drain_on_a_stalled_device(engine):
    gate = threading.Event()  # never set before close: a wedged device
    eng = engine(_Stub(gate), batch=1, max_wait_ms=5)
    futs = [eng.submit(_img(60 + i), EX) for i in range(3)]
    t0 = time.perf_counter()
    eng.close(timeout=0.5)
    assert time.perf_counter() - t0 < 5.0
    for f in futs:
        assert f.done()
        exc = f.exception()
        assert isinstance(exc, RejectedError) and exc.cause == "shutdown"
    stats = eng.stats()
    assert stats["overload"]["drain_timed_out"] is True
    assert stats["overload"]["counters"]["shed.shutdown"] == 3
    gate.set()  # let the daemon threads finish


def test_close_drains_cleanly_when_the_device_moves(engine):
    eng = engine()
    f = eng.submit(_img(70), EX)
    eng.close(timeout=30)
    assert f.result(timeout=WAIT_S)["boxes"].shape == (1, 8, 4)
    assert "overload" not in eng.stats()
    assert not any(t.is_alive() for t in eng._threads)


def test_many_clients_keep_the_counters_exact(engine):
    """More client threads than cores, a short switch interval, duplicates among the
    requests and an admission bound: every future resolves, and submitted, completed,
    coalesced, result-cache hits and rejections reconcile exactly (a lost update in any
    of them breaks an equation)."""
    import os
    import sys

    clients = max(8, 2 * (os.cpu_count() or 4))
    per_client = 12
    images = [_img(100 + i) for i in range(10)]
    eng = engine(batch=4, max_wait_ms=2, exemplar_cache=64,
                 admission=AdmissionController(enabled=True, max_pending=6))
    futs = [[] for _ in range(clients)]

    def client(c):
        for j in range(per_client):
            futs[c].append(eng.submit(images[(c + j) % len(images)], EX))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    flat = [f for fs in futs for f in fs]
    assert len(flat) == clients * per_client
    rejected = 0
    for f in flat:
        exc = f.exception(timeout=WAIT_S)
        if exc is not None:
            assert isinstance(exc, RejectedError), exc
            rejected += 1
    c, ov, stats = eng.counters, eng.overload_counters(), eng.stats()
    assert c["errors"] == 0 and c["rejected"] == 0
    assert c["submitted"] == c["completed"] == len(flat) - rejected
    assert ov["admit_rejected"] == rejected
    riders = c["submitted"] - stats["result_cache"]["hits"]
    assert riders - c["coalesced"] == sum(int(k) * v for k, v in
                                          stats["batch_occupancy"].items())
    assert eng.health()["admission"]["in_system"] == 0
