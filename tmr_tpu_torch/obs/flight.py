"""Flight recorder, health watch and heartbeat (counterpart of ``tmr_tpu/obs/flight.py``).

- :func:`flight_enabled` / :func:`configure`: the ``TMR_FLIGHT`` master switch (default
  off); disabled, every instrumented site pays one module-global bool check.
- :class:`FlightRecorder`: a bounded ring (``TMR_FLIGHT_RING`` records, the oldest roll
  off) of per-request summaries and every anomaly fired.
- :class:`HealthWatch`: a detector pass over successive metrics-registry snapshots that
  emits anomaly records (``diagnostics.ANOMALY_KINDS``: recompile storm, p99 latency
  regression against a rolling baseline, queue saturation, cache-hit collapse) with a
  closed-vocabulary kind, a message and numeric evidence. The JAX watch's MFU-drop check
  reads device time per program (``tmr_tpu/obs/devtime.py``), which the port does not
  measure until ROADMAP A8: it has no input here and stays silent.
- :class:`Heartbeat`: a daemon thread appending a caller-supplied document
  (``ServeEngine.health()`` in practice) to a JSONL file every ``TMR_HEALTH_INTERVAL_S``
  seconds.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from tmr_tpu_torch.diagnostics import ANOMALY_KINDS
from tmr_tpu_torch.obs.tracing import _env_flag, _env_int

#: anomaly-record schema tag (the closed kind vocabulary is
#: diagnostics.ANOMALY_KINDS)
ANOMALY_SCHEMA = "anomaly/v1"

_LOCK = threading.Lock()

#: module-global fast path: the ONLY thing a disabled flight site
#: touches. None = not yet resolved: the TMR_FLIGHT* knobs are read
#: lazily on first use, as in tracing.py.
_ENABLED: Optional[bool] = None
_RING: Optional[int] = None

_RECORDER: Optional["FlightRecorder"] = None


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _resolve_env_unlocked() -> None:
    """Fill any still-unset knob from the environment. Caller MUST hold
    ``_LOCK`` (a first-use resolve racing configure() could overwrite
    the explicit setting with the env default)."""
    global _ENABLED, _RING
    if _ENABLED is None:
        _ENABLED = _env_flag("TMR_FLIGHT")
    if _RING is None:
        _RING = max(_env_int("TMR_FLIGHT_RING", 2048), 16)


def flight_enabled() -> bool:
    """One bool check after first resolution: the whole disabled-mode
    cost of the flight layer at every instrumented site."""
    if _ENABLED is None:
        with _LOCK:
            _resolve_env_unlocked()
    return _ENABLED


def configure(enabled: Optional[bool] = None,
              ring: Optional[int] = None) -> None:
    """Programmatic override of TMR_FLIGHT / TMR_FLIGHT_RING (probes and
    tests flip the recorder without re-execing). ``ring`` applies to
    recorders created after the call."""
    global _ENABLED, _RING
    with _LOCK:
        if enabled is not None:
            _ENABLED = bool(enabled)
        if ring is not None:
            _RING = max(int(ring), 16)
        _resolve_env_unlocked()


class FlightRecorder:
    """Bounded ring of flight records. Thread-safe; the ring is a
    ``deque(maxlen=...)``, so a long-lived server never grows: the
    oldest summaries roll off and ``dropped`` counts them."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        if capacity is None:
            if _RING is None:
                with _LOCK:
                    _resolve_env_unlocked()
            capacity = _RING
        self.capacity = max(int(capacity), 16)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=self.capacity)
        self._written = 0

    def record(self, kind: str, **fields) -> dict:
        rec = {"kind": kind, "t": time.time(), **fields}
        with self._lock:
            self._ring.append(rec)
            self._written += 1
        return rec

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._ring]

    def dropped(self) -> int:
        with self._lock:
            return max(0, self._written - len(self._ring))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._written = 0


def get_recorder() -> FlightRecorder:
    """The process-wide flight ring (created lazily at the resolved
    ``TMR_FLIGHT_RING`` capacity)."""
    global _RECORDER
    with _LOCK:
        if _RECORDER is None:
            _resolve_env_unlocked()
            _RECORDER = FlightRecorder(_RING)
        return _RECORDER


def record(kind: str, **fields) -> Optional[dict]:
    """Convenience: record into the process-wide ring when the flight
    recorder is enabled; no-op (one bool check) otherwise."""
    if not flight_enabled():
        return None
    return get_recorder().record(kind, **fields)


def _anomaly(kind: str, message: str, **evidence) -> dict:
    """One structured anomaly record: closed-vocabulary kind, a human
    message, and the numeric evidence the verdict keys on."""
    assert kind in ANOMALY_KINDS, kind
    return {
        "schema": ANOMALY_SCHEMA,
        "anomaly": kind,
        "message": message,
        "evidence": dict(evidence),
        "ts": time.time(),
    }


def _delta_hist_quantile(prev: Optional[dict], cur: dict, q: float):
    """Approximate q-quantile of the observations a histogram snapshot
    gained since ``prev`` (bucket-delta linear interpolation, the
    metrics.Histogram scheme applied to a window). Returns (quantile,
    window_count); (None, 0) when the window is empty."""
    bounds = cur.get("buckets_le") or []
    cur_counts = cur.get("counts") or []
    prev_counts = (prev or {}).get("counts") or [0] * len(cur_counts)
    if len(prev_counts) != len(cur_counts):
        prev_counts = [0] * len(cur_counts)
    counts = [c - p for c, p in zip(cur_counts, prev_counts)]
    total = sum(counts)
    if total <= 0:
        return None, 0
    target = q * total
    seen = 0
    for i, c in enumerate(counts):
        if c <= 0:
            continue
        if seen + c >= target:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else (
                bounds[-1] * 2 if bounds else lo
            )
            frac = (target - seen) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0), total
        seen += c
    return None, total


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


class HealthWatch:
    """Anomaly detector over successive registry snapshots.

    ``observe(snapshot, ...)`` compares the new ``metrics_report/v1``
    snapshot against the previous one (windows, not lifetimes: every
    rate/quantile is computed on the delta since the last observe) and
    against small rolling baselines, and returns the anomaly records
    that fired this pass, at most one per kind per pass (the JAX watch's
    per-replica-group queue checks come with mesh serving, ROADMAP A7).
    Thresholds are constructor parameters so tests can inject
    deterministically; the defaults are sized for the serve engine's
    production shape. ``mfu_drop`` never fires: its input, device time
    per program, is ROADMAP A8's.
    """

    def __init__(self, *,
                 recompile_storm_threshold: int = 3,
                 queue_depth_threshold: int = 64,
                 p99_factor: float = 3.0,
                 min_window_requests: int = 20,
                 hit_rate_drop: float = 0.5,
                 min_window_lookups: int = 20,
                 history: int = 8,
                 latency_histogram: str = "serve.request_latency_s",
                 result_cache: str = "serve.cache.result"):
        self.recompile_storm_threshold = int(recompile_storm_threshold)
        self.queue_depth_threshold = int(queue_depth_threshold)
        self.p99_factor = float(p99_factor)
        self.min_window_requests = int(min_window_requests)
        self.hit_rate_drop = float(hit_rate_drop)
        self.min_window_lookups = int(min_window_lookups)
        self.latency_histogram = latency_histogram
        self.result_cache = result_cache
        self._lock = threading.Lock()
        self._prev: Optional[dict] = None
        self._p99_hist: deque = deque(maxlen=history)
        self._hit_hist: deque = deque(maxlen=history)
        self._recent: deque = deque(maxlen=64)

    def observe(self, snapshot: dict, *,
                compile_events: Any = (),
                pending: int = 0) -> List[dict]:
        """One detector pass. ``snapshot`` is a metrics_report/v1 dict;
        ``compile_events`` the compile-event records new since the last
        pass; ``pending`` the batcher queue depth right now. Returns the
        anomalies fired this pass (also kept in :meth:`recent` and
        recorded into the process flight ring)."""
        fired: List[dict] = []
        with self._lock:
            # recompile storm: key-change events (the storm signature —
            # a known program kind compiling under keys it never saw)
            storms = [e for e in compile_events
                      if e.get("cause") == "key-change"]
            if len(storms) >= self.recompile_storm_threshold:
                kinds: Dict[str, int] = {}
                for e in storms:
                    kinds[e.get("kind", "?")] = kinds.get(
                        e.get("kind", "?"), 0) + 1
                fired.append(_anomaly(
                    "recompile_storm",
                    f"{len(storms)} key-change compile events in one "
                    f"window (threshold "
                    f"{self.recompile_storm_threshold}) — a bucket/key "
                    "that should be a cache hit is recompiling",
                    key_change_events=len(storms),
                    threshold=self.recompile_storm_threshold,
                    kinds=kinds,
                    wall_s=round(sum(
                        float(e.get("wall_s", 0.0)) for e in storms
                    ), 3),
                ))

            # queue saturation: the batcher is holding more requests
            # than the engine can drain under its latency bound
            if pending >= self.queue_depth_threshold:
                fired.append(_anomaly(
                    "queue_saturation",
                    f"{pending} requests pending in the batcher "
                    f"(threshold {self.queue_depth_threshold}) — "
                    "arrival rate exceeds drain rate",
                    pending=int(pending),
                    threshold=self.queue_depth_threshold,
                ))

            hists = (snapshot or {}).get("histograms") or {}
            prev_hists = (self._prev or {}).get("histograms") or {}
            lat = hists.get(self.latency_histogram)
            if lat is not None:
                p99, n = _delta_hist_quantile(
                    prev_hists.get(self.latency_histogram), lat, 0.99
                )
                if p99 is not None and n >= self.min_window_requests:
                    regressed = False
                    if self._p99_hist:
                        base = _median(list(self._p99_hist))
                        if base > 0 and p99 > self.p99_factor * base:
                            regressed = True
                            fired.append(_anomaly(
                                "latency_regression",
                                f"window p99 {p99 * 1000:.1f} ms vs "
                                f"rolling baseline {base * 1000:.1f} ms "
                                f"(factor {self.p99_factor}) over "
                                f"{n} requests",
                                p99_s=p99, baseline_s=base,
                                factor=self.p99_factor, requests=n,
                            ))
                    if not regressed:
                        # a regressed window must NOT enter its own
                        # baseline: a sustained incident would walk
                        # the median up and silence the detector while
                        # the regression persists
                        self._p99_hist.append(p99)

            counters = (snapshot or {}).get("counters") or {}
            prev_counters = (self._prev or {}).get("counters") or {}

            def _delta(name: str) -> float:
                return float(counters.get(name, 0)) - float(
                    prev_counters.get(name, 0))

            hits = _delta(f"{self.result_cache}.hits")
            misses = _delta(f"{self.result_cache}.misses")
            lookups = hits + misses
            if lookups >= self.min_window_lookups:
                rate = hits / lookups
                collapsed = False
                if self._hit_hist:
                    base = _median(list(self._hit_hist))
                    if base > 0 and rate < self.hit_rate_drop * base:
                        collapsed = True
                        fired.append(_anomaly(
                            "cache_hit_collapse",
                            f"window hit rate {rate:.2f} vs rolling "
                            f"baseline {base:.2f} (drop factor "
                            f"{self.hit_rate_drop}) over "
                            f"{int(lookups)} lookups",
                            hit_rate=rate, baseline=base,
                            drop_factor=self.hit_rate_drop,
                            lookups=int(lookups),
                        ))
                if not collapsed:  # same no-self-poisoning rule as p99
                    self._hit_hist.append(rate)

            self._prev = snapshot
            self._recent.extend(fired)
        for rec in fired:
            record("anomaly", **{k: v for k, v in rec.items()
                                 if k != "schema"})
        return fired

    def recent(self) -> List[dict]:
        """The last anomalies fired across passes (bounded)."""
        with self._lock:
            return [dict(r) for r in self._recent]


class Heartbeat:
    """Append a document to a JSONL file on an interval.

    ``emit`` is a zero-arg callable returning a JSON-serializable dict
    (``ServeEngine.health`` in practice). One line is written
    synchronously at construction (a started heartbeat always has a
    first beat on disk), then a daemon thread appends every
    ``interval_s`` seconds (default ``TMR_HEALTH_INTERVAL_S``, 10 s),
    and :meth:`stop` writes one final beat. Write failures never
    propagate: they count in ``errors`` (telemetry must not kill the
    process it watches)."""

    def __init__(self, emit, path: str,
                 interval_s: Optional[float] = None) -> None:
        self._emit = emit
        self.path = str(path)
        self.interval_s = (
            max(_env_float("TMR_HEALTH_INTERVAL_S", 10.0), 0.05)
            if interval_s is None else max(float(interval_s), 0.05)
        )
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._beats = 0
        self._errors = 0
        self._write()
        self._thread = threading.Thread(
            target=self._loop, name="flight-heartbeat", daemon=True
        )
        self._thread.start()

    def _write(self) -> None:
        try:
            line = json.dumps(self._emit())
            with open(self.path, "a") as f:
                f.write(line + "\n")
            with self._lock:
                self._beats += 1
        except Exception:
            with self._lock:
                self._errors += 1

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._write()

    @property
    def beats(self) -> int:
        with self._lock:
            return self._beats

    @property
    def errors(self) -> int:
        with self._lock:
            return self._errors

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the writer thread and append one final beat."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join(timeout=timeout)
        self._write()
