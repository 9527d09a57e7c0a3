"""The port's telemetry (``tmr_tpu_torch/obs`` and the metrics and health validators of
``tmr_tpu_torch/diagnostics.py``) against ``tmr_tpu/obs`` on the same scripted
sequences: histogram quantiles and registry snapshots, the compile-event causes, the
HealthWatch's anomalies; span tracing (no-op when off, nesting, the Chrome trace, the
ring bound, ``torch.profiler.record_function`` regions); the flight ring and the
heartbeat; and the ``nvcc`` builds of ``ops/_build.py`` as compile events (a stand-in
compiler writes the library here, where there is no ``nvcc``)."""

import json
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tmr_tpu.obs import flight as j_flight  # noqa: E402
from tmr_tpu.obs import metrics as j_metrics  # noqa: E402
from tmr_tpu_torch import obs  # noqa: E402
from tmr_tpu_torch.diagnostics import (  # noqa: E402
    ANOMALY_KINDS,
    validate_anomaly,
    validate_health_report,
    validate_metrics_report,
)
from tmr_tpu_torch.obs import compile as compile_mod  # noqa: E402
from tmr_tpu_torch.obs import flight, tracing  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _obs_off_after():
    """Each test leaves tracing and the flight recorder off and their rings empty."""
    yield
    tracing.configure(enabled=False)
    tracing.clear()
    flight.configure(enabled=False)
    flight.get_recorder().clear()


# ----------------------------------------------------------------- metrics
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_quantiles_match_jax(seed):
    rng = np.random.default_rng(seed)
    vals = np.exp(rng.normal(-4.0, 2.0, 500))
    ours, theirs = obs.Histogram(), j_metrics.Histogram()
    for v in vals:
        ours.observe(v)
        theirs.observe(v)
    for q in (0.0, 0.1, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ours.quantile(q) == theirs.quantile(q), q
    assert ours.snapshot() == theirs.snapshot()
    assert obs.Histogram().quantile(0.5) == 0.0
    with pytest.raises(ValueError, match="ascending"):
        obs.Histogram([2.0, 1.0])


def test_registry_snapshot_matches_jax_and_passes_both_validators():
    from tmr_tpu.diagnostics import validate_metrics_report as j_validate

    ours, theirs = obs.MetricsRegistry(), j_metrics.MetricsRegistry()
    for reg in (ours, theirs):
        reg.counter("serve.submitted").inc(3)
        reg.counter("serve.cache.result.hits").inc()
        reg.gauge("serve.depth").set(7)
        h = reg.histogram("serve.request_latency_s")
        for v in (0.001, 0.02, 0.3):
            h.observe(v)
    snap = ours.snapshot()
    assert snap == theirs.snapshot()
    assert validate_metrics_report(snap) == [] and j_validate(snap) == []
    with pytest.raises(TypeError):
        ours.gauge("serve.submitted")
    broken = dict(snap, counters={"x": "1"}, histograms={"h": {"counts": [1]}})
    assert len(validate_metrics_report(broken)) >= 2
    assert validate_metrics_report([]) == ["not a dict: list"]


# ----------------------------------------------------------------- tracing
def test_disabled_span_is_a_shared_noop():
    tracing.configure(enabled=False)
    assert tracing.span("a") is tracing.span("b", x=1)
    with tracing.span("a"):
        pass
    tracing.add_span("b", 0.0, 1.0)
    assert tracing.spans() == []


def test_spans_nest_within_and_across_threads_and_export_chrome_json():
    tracing.configure(enabled=True)
    tid = tracing.new_trace_id()
    with tracing.span("outer", trace_id=tid):
        with tracing.span("inner", k=1):
            pass
    seen = {}

    def worker():
        with tracing.span("other"):
            seen["trace"] = tracing.spans()

    t = threading.Thread(target=worker, name="span-worker")
    t.start()
    t.join()
    recs = {r["name"]: r for r in tracing.spans()}
    assert recs["inner"]["trace"] == tid == recs["outer"]["trace"]
    assert recs["inner"]["parent"] == recs["outer"]["span"]
    assert recs["other"]["trace"] != tid and recs["other"]["parent"] == 0
    doc = json.loads(json.dumps(tracing.chrome_trace()))
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"outer", "inner", "other"} <= names
    meta = [e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"]
    assert "span-worker" in meta


def test_ring_buffer_bounds_memory():
    tracing.configure(enabled=True, ring=16)
    out = {}

    def worker():
        for i in range(40):
            tracing.add_span("s", float(i), float(i) + 1)
        out["n"] = len([r for r in tracing.spans() if r["name"] == "s"])

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert out["n"] == 16 and tracing.dropped_spans() >= 24
    tracing.configure(ring=8192)


def test_spans_enter_torch_profiler_regions():
    """The JAX spans' TraceAnnotation is torch.profiler.record_function here: a span's
    name shows in a profiler trace of the work inside it."""
    from torch.profiler import ProfilerActivity, profile

    tracing.configure(enabled=True, annotate=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("serve.execute"):
            torch.ones(8).sum()
    assert "serve.execute" in {e.name for e in prof.events()}


# ----------------------------------------------------------------- compile
def test_compile_event_causes_match_jax():
    """cold for a kind's first key (a repeat of a seen key too), key-change for a new
    key of a known kind; the same sequence through both modules."""
    from tmr_tpu.obs import compile as j_compile

    stamp = f"t{time.perf_counter_ns()}"
    seq = [("a", 1), ("a", 1), ("a", 2), ("b", 1), ("b", 3), ("a", 2)]
    ours = [compile_mod.record_compile_event(f"{stamp}{k}", key, 0.0, 0.5)["cause"]
            for k, key in seq]
    theirs = [j_compile.record_compile_event(f"{stamp}{k}", key, 0.0, 0.5)["cause"]
              for k, key in seq]
    assert ours == theirs == ["cold", "cold", "key-change", "cold", "key-change", "cold"]
    cursor = compile_mod.compile_event_seq()
    compile_mod.record_compile_event(f"{stamp}c", 0, 0.0, 1.0)
    new, cursor2 = compile_mod.compile_events_since(cursor)
    assert [e["kind"] for e in new] == [f"{stamp}c"] and cursor2 == cursor + 1
    assert compile_mod.compile_events_since(cursor2) == ([], cursor2)


def test_nvcc_builds_are_recorded_as_compile_events(tmp_path, monkeypatch):
    """``_build.build`` records each library it compiles (kind ``nvcc <name>.cu``, key
    the library file) and nothing for one already built; a stand-in compiler writes the
    ``-o`` file, as ``nvcc`` would on the card."""
    from tmr_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'wb').close()\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    reg = obs.get_registry()
    total0 = reg.counter("compile.total").value
    cursor = obs.compile_event_seq()
    _build.build(("probe", "nms"))
    events, _ = obs.compile_events_since(cursor)
    assert sorted(e["kind"] for e in events) == ["nvcc nms.cu", "nvcc probe.cu"]
    for e in events:
        assert e["key"] == repr(_build._lib_path(e["kind"][5:-3]).name)
        assert e["wall_s"] >= 0 and e["cause"] == "cold"
    assert reg.counter("compile.total").value == total0 + 2
    _build.build(("probe",))  # built already: no event
    assert obs.compile_events_since(cursor)[0] == events


# ------------------------------------------------------------------ flight
def _observe_both(calls, **kw):
    """The same observe() calls through both HealthWatches; the anomaly kinds and
    evidence fired per pass."""
    out = []
    for mod in (flight, j_flight):
        watch = mod.HealthWatch(**kw)
        out.append([[(a["anomaly"], a["evidence"]) for a in watch.observe(snap, **ckw)]
                    for snap, ckw in calls])
    return out


def _latency_snapshots():
    reg = obs.MetricsRegistry()
    hist = reg.histogram("serve.request_latency_s")
    snaps = []
    for v in (0.010, 0.010, 0.500, 0.500, 0.012):
        for _ in range(30):
            hist.observe(v)
        snaps.append((reg.snapshot(), {}))
    return snaps


@pytest.mark.parametrize("name", ["storm", "queue", "latency", "cache"])
def test_health_watch_anomalies_match_jax(name):
    key_change = {"cause": "key-change", "kind": "nvcc attn.cu", "wall_s": 1.0}
    cold = dict(key_change, cause="cold")
    cases = {
        "storm": ([({}, dict(compile_events=[key_change] * 2)),
                   ({}, dict(compile_events=[key_change] * 3)),
                   ({}, dict(compile_events=[cold] * 10))],
                  dict(recompile_storm_threshold=3)),
        "queue": ([({}, dict(pending=7)), ({}, dict(pending=8)), ({}, dict(pending=0))],
                  dict(queue_depth_threshold=8)),
        "latency": (_latency_snapshots(), dict(p99_factor=3.0, min_window_requests=20)),
        "cache": ([({"counters": {"serve.cache.result.hits": 90,
                                  "serve.cache.result.misses": 10}}, {}),
                   ({"counters": {"serve.cache.result.hits": 95,
                                  "serve.cache.result.misses": 105}}, {})],
                  dict(hit_rate_drop=0.5, min_window_lookups=20)),
    }
    calls, kw = cases[name]
    ours, theirs = _observe_both(calls, **kw)
    assert ours == theirs
    assert any(ours), "the sequence fires its anomaly"


def test_anomaly_records_validate_and_reach_the_flight_ring():
    flight.configure(enabled=True)
    watch = obs.HealthWatch(queue_depth_threshold=1)
    rec = watch.observe({}, pending=5)[0]
    assert rec["anomaly"] in ANOMALY_KINDS and validate_anomaly(rec) == []
    assert watch.recent()[-1]["anomaly"] == "queue_saturation"
    assert [r["kind"] for r in flight.get_recorder().snapshot()] == ["anomaly"]
    assert validate_anomaly({"anomaly": "nope", "message": "", "evidence": 1}) != []


def test_flight_ring_bounds_and_disabled_record_is_a_noop():
    flight.configure(enabled=False)
    assert flight.record("x") is None
    ring = obs.FlightRecorder(16)
    for i in range(40):
        ring.record("r", i=i)
    assert len(ring.snapshot()) == 16 and ring.dropped() == 24
    assert ring.snapshot()[0]["i"] == 24


def test_heartbeat_writes_jsonl_and_a_final_beat(tmp_path):
    path = tmp_path / "health.jsonl"
    n = {"beats": 0}

    def emit():
        n["beats"] += 1
        return {"beat": n["beats"]}

    hb = obs.Heartbeat(emit, str(path), interval_s=0.05)
    time.sleep(0.3)
    hb.stop()
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) >= 3 and lines[-1]["beat"] == len(lines) == hb.beats
    bad = obs.Heartbeat(lambda: {"x": object()}, str(path), interval_s=10)
    bad.stop()
    assert bad.errors == 2 and bad.beats == 0


def test_health_validator_rejects_broken_documents():
    assert validate_health_report([]) == ["not a dict: list"]
    problems = validate_health_report({"schema": "health_report/v1", "mesh": {},
                                       "quant": {"mode": "int8", "storage": "int8"}})
    text = " ".join(problems)
    for fragment in ("ROADMAP A7", "quant.digest", "queues", "compile", "anomalies"):
        assert fragment in text
