"""Compile-event accounting (counterpart of ``tmr_tpu/obs/compile.py``).

The port has no jit: its only compilations are the ``nvcc`` builds of
``tmr_tpu_torch/csrc`` at first use (``ops/_build.build``), one per source whose library
is not built yet. Each is an event here: the kind (``nvcc <source>.cu``), the key (the
library, named by the digest of its source and flags), its wall seconds and a cause:

- ``cold``: this kind never built in this process (the expected first build);
- ``key-change``: this kind built before under another key: an edited source or other
  flags rebuilt in a running process, the signature of a storm.

Events land in three places at once: a bounded in-process log (:func:`compile_events`,
:func:`compile_events_since`), the process-wide metrics
registry (``compile.total``, ``compile.cold``, ``compile.key_change`` counters and the
``compile.wall_s`` histogram), and, when tracing is on, a ``compile`` span on the thread
that paid the wall time. A library found already built records nothing. The serving
engine's ``health()`` reads them into its ``compile`` section and its HealthWatch's
storm check.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional

from tmr_tpu_torch.obs import metrics as _metrics
from tmr_tpu_torch.obs import tracing as _tracing

#: a long-lived server that never drains must not grow without bound
_MAX_EVENTS = 512

_LOCK = threading.Lock()
_EVENTS: List[dict] = []
#: monotonic event sequence (never trimmed, never drained): consumers
#: that window the log (ServeEngine.health's recompile-storm detector)
#: key on it instead of list offsets, which go blind the moment the
#: bounded log trims or another harness drains it
_SEQ = 0
#: kind -> set of key reprs ever compiled: the cause is decided per
#: (kind, key); only a new key of a known kind is "key-change"
_SEEN_KEYS: dict = {}


def record_compile_event(kind: str, key: Any, t0: float, t1: float,
                         bucket: Optional[dict] = None) -> dict:
    """Record one trace/compile occurrence; returns the event record."""
    global _SEQ
    key_repr = repr(key)
    with _LOCK:
        seen = _SEEN_KEYS.setdefault(kind, set())
        cause = "key-change" if (seen and key_repr not in seen) else "cold"
        seen.add(key_repr)
        _SEQ += 1
        rec = {
            "kind": kind,
            "key": key_repr,
            "bucket": dict(bucket or {}),
            "wall_s": t1 - t0,
            "cause": cause,
            "seq": _SEQ,
        }
        _EVENTS.append(rec)
        if len(_EVENTS) > _MAX_EVENTS:
            del _EVENTS[:-_MAX_EVENTS]
    reg = _metrics.get_registry()
    reg.counter("compile.total").inc()
    reg.counter("compile.cold" if cause == "cold"
                else "compile.key_change").inc()
    reg.histogram("compile.wall_s").observe(rec["wall_s"])
    _tracing.add_span("compile", t0, t1, kind=kind, key=rec["key"],
                      cause=cause)
    return rec


def compile_events() -> List[dict]:
    """Snapshot of recorded events (oldest first), not cleared."""
    with _LOCK:
        return [dict(e) for e in _EVENTS]


def compile_event_seq() -> int:
    """The latest event's monotonic sequence number (0 = none ever):
    the cursor a windowing consumer snapshots at construction."""
    with _LOCK:
        return _SEQ


def compile_events_since(seq: int):
    """``(events with .seq > seq, latest seq)``: the cursor-based
    window read. Unlike slicing :func:`compile_events` by offset, this
    keeps working after the bounded log trims its head or a harness
    drains it (events that rolled off before being read are simply
    missed; the returned cursor still advances past them)."""
    with _LOCK:
        return [dict(e) for e in _EVENTS if e["seq"] > seq], _SEQ

