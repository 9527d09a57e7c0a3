"""Request-scoped host-side span tracing (counterpart of ``tmr_tpu/obs/tracing.py``).

``span("stage", **attrs)`` is a context manager that records one complete event (name,
start, duration, thread, trace/span/parent IDs, attributes) into a per-thread ring
buffer; ``add_span`` records an event with explicit timestamps for stages whose
boundaries were stamped elsewhere (the batcher's queue-wait window, a batch-level stage
attributed to each request in it). Exports:

- :func:`chrome_trace`: Chrome trace-event JSON (open in Perfetto or
  ``chrome://tracing``), one ``ph: "X"`` event per span plus thread names, the IDs under
  ``args``;
- every entered span also enters ``torch.profiler.record_function`` (the JAX package's
  ``jax.profiler.TraceAnnotation``), so the same host spans appear in a
  ``torch.profiler`` trace beside the kernels they launched.

Cost model:

- ``TMR_TRACE=0`` (the default): ``span()`` is one module-global bool check returning a
  shared no-op context manager; nothing is allocated or locked. Hot paths that would pay
  even for building kwargs guard on :func:`tracing_enabled` first.
- ``TMR_TRACE=1``: each thread appends to its own ring (the global lock is taken once
  per thread, at registration), which overwrites its oldest events: a long-lived traced
  server keeps at most ``TMR_TRACE_RING`` events per thread.

A request's trace id is minted at submit (:func:`new_trace_id`), travels with the
request object through queueing, coalescing, staging, execution and resolution, and
every stage span carries it. Spans opened without an explicit trace id inherit the
enclosing span's (per-thread stack).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional


def _env_flag(name: str, default: bool = False) -> bool:
    raw = os.environ.get(name, "").strip().lower()
    if not raw:
        return default
    return raw not in ("0", "off", "false", "no")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


#: module-global fast path: the ONLY thing a disabled span() touches.
#: None = not yet resolved: the TMR_TRACE* knobs are read lazily on first
#: use (an import-time read would freeze them before a consumer process
#: could set them); after that the disabled path stays one bool check.
_ENABLED: Optional[bool] = None
_ANNOTATE_WANTED: Optional[bool] = None
_RING: Optional[int] = None


def _resolve_env_unlocked() -> None:
    """Fill any still-unset knob from the environment. Caller MUST hold
    ``_REG_LOCK``: an unsynchronized first-span resolve racing a
    ``configure(enabled=True)`` could re-check ``is None`` stale and
    overwrite the explicit setting with the env default."""
    global _ENABLED, _ANNOTATE_WANTED, _RING
    if _ENABLED is None:
        _ENABLED = _env_flag("TMR_TRACE")
    if _ANNOTATE_WANTED is None:
        _ANNOTATE_WANTED = _env_flag("TMR_TRACE_ANNOTATE", True)
    if _RING is None:
        _RING = max(_env_int("TMR_TRACE_RING", 8192), 16)


def _resolve_env() -> None:
    """Lazy first-use resolution (an explicit :func:`configure` value is
    never overwritten). Cost: taken only while ``_ENABLED is None`` —
    after the first resolution the disabled span path is back to one
    global bool check."""
    with _REG_LOCK:
        _resolve_env_unlocked()

_REG_LOCK = threading.Lock()
_ALL_BUFS: List["_Buf"] = []
_SPAN_IDS = itertools.count(1)  # .__next__ is atomic under the GIL

#: resolved ``torch.profiler.record_function`` class, None = not yet resolved,
#: False = unavailable/disabled (``TMR_TRACE_ANNOTATE=0``)
_ANN_CLS: Any = None


def _annotation_cls():
    global _ANN_CLS
    if _ANN_CLS is None:
        if not _ANNOTATE_WANTED:
            _ANN_CLS = False
        else:
            try:
                from torch.profiler import record_function

                _ANN_CLS = record_function
            except Exception:
                _ANN_CLS = False
    return _ANN_CLS


class _Buf:
    """One thread's span ring. Only its owner thread writes; readers
    snapshot under the registry lock at export time (a torn read of the
    newest slot is possible and acceptable — exports are diagnostics,
    the write path must never wait)."""

    __slots__ = ("tid", "thread_name", "cap", "events", "write", "stack")

    def __init__(self, cap: int) -> None:
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.thread_name = t.name
        self.cap = cap
        self.events: List[dict] = []
        self.write = 0
        self.stack: List[tuple] = []  # (span_id, trace_id) of open spans

    def record(self, rec: dict) -> None:
        # one local reference for the whole operation: clear() (any
        # thread) swaps self.events for a fresh list, and a check-then-
        # index against the attribute could len() the old list and index
        # the new empty one (IndexError on a pipeline thread that must
        # never die); a racing record lands in the old list and is
        # dropped with it
        events = self.events
        if len(events) < self.cap:
            events.append(rec)
        else:
            events[self.write % self.cap] = rec
        self.write += 1

    def snapshot(self) -> List[dict]:
        n = len(self.events)
        if n < self.cap or self.write <= n:
            return list(self.events)
        i = self.write % self.cap
        return self.events[i:] + self.events[:i]

    def dropped(self) -> int:
        return max(0, self.write - self.cap)


class _Local(threading.local):
    buf: Optional[_Buf] = None


_TLS = _Local()


def _buf() -> _Buf:
    b = _TLS.buf
    if b is None:
        b = _Buf(_RING)
        _TLS.buf = b
        with _REG_LOCK:
            _ALL_BUFS.append(b)
    return b


def tracing_enabled() -> bool:
    if _ENABLED is None:
        _resolve_env()
    return _ENABLED


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def configure(enabled: Optional[bool] = None,
              annotate: Optional[bool] = None,
              ring: Optional[int] = None) -> None:
    """Programmatic override of the TMR_TRACE / TMR_TRACE_ANNOTATE /
    TMR_TRACE_RING env knobs (probes and tests flip tracing without
    re-execing). ``ring`` applies to rings created after the call."""
    global _ENABLED, _ANNOTATE_WANTED, _ANN_CLS, _RING
    with _REG_LOCK:  # explicit settings and lazy env resolution must
        if enabled is not None:  # never interleave (first-span race)
            _ENABLED = bool(enabled)
        if annotate is not None:
            _ANNOTATE_WANTED = bool(annotate)
            _ANN_CLS = None  # re-resolve lazily
        if ring is not None:
            _RING = max(int(ring), 16)
        _resolve_env_unlocked()  # anything not explicitly set -> env


class _NoopSpan:
    """The shared disabled-mode span: enter/exit do nothing, one instance
    serves every call site — zero allocation on the disabled path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "attrs", "trace_id", "span_id", "parent_id",
                 "t0", "_ann", "_b")

    def __init__(self, name: str, trace_id: Optional[str],
                 attrs: Dict[str, Any]) -> None:
        self.name = name
        self.trace_id = trace_id
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        b = _buf()
        self._b = b
        parent = b.stack[-1] if b.stack else None
        if self.trace_id is None:
            self.trace_id = parent[1] if parent else new_trace_id()
        self.span_id = next(_SPAN_IDS)
        self.parent_id = parent[0] if parent else 0
        b.stack.append((self.span_id, self.trace_id))
        ann_cls = _annotation_cls()
        self._ann = ann_cls(self.name) if ann_cls else None
        if self._ann is not None:
            self._ann.__enter__()
        self.t0 = time.perf_counter()
        return self

    def set_attr(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __exit__(self, exc_type=None, exc=None, tb=None) -> bool:
        t1 = time.perf_counter()
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
        b = self._b
        if b.stack and b.stack[-1][0] == self.span_id:
            b.stack.pop()
        b.record({
            "name": self.name,
            "ts": self.t0,
            "dur": t1 - self.t0,
            "tid": b.tid,
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "attrs": self.attrs,
        })
        return False


def span(name: str, trace_id: Optional[str] = None, **attrs):
    """Context manager timing one named stage. No-op (shared singleton)
    when tracing is disabled; otherwise records a complete event on exit
    and mirrors the region into ``torch.profiler.record_function``."""
    if _ENABLED is None:
        _resolve_env()
    if not _ENABLED:
        return _NOOP
    return _Span(name, trace_id, attrs)


def add_span(name: str, t0: float, t1: float,
             trace_id: Optional[str] = None, **attrs) -> None:
    """Record a complete event whose boundaries were stamped elsewhere
    (``time.perf_counter`` values): queue-wait windows, batch-level
    stages attributed per request. Does not touch the nesting stack."""
    if _ENABLED is None:
        _resolve_env()
    if not _ENABLED:
        return
    b = _buf()
    b.record({
        "name": name,
        "ts": t0,
        "dur": max(t1 - t0, 0.0),
        "tid": b.tid,
        "trace": trace_id or "",
        "span": next(_SPAN_IDS),
        "parent": 0,
        "attrs": attrs,
    })


def spans() -> List[dict]:
    """Every recorded span (all threads), oldest first."""
    with _REG_LOCK:
        bufs = list(_ALL_BUFS)
    out: List[dict] = []
    for b in bufs:
        out.extend(b.snapshot())
    out.sort(key=lambda r: r["ts"])
    return out


def dropped_spans() -> int:
    with _REG_LOCK:
        return sum(b.dropped() for b in _ALL_BUFS)


def clear() -> None:
    """Discard recorded spans (rings stay registered; open spans keep
    nesting state): the drain-before-measure protocol."""
    with _REG_LOCK:
        for b in _ALL_BUFS:
            b.events = []
            b.write = 0


def chrome_trace() -> dict:
    """Chrome trace-event JSON (the ``traceEvents`` array format) —
    ``json.dump`` the result and load it in Perfetto. Timestamps are
    perf_counter microseconds (a shared monotonic base; only relative
    placement is meaningful)."""
    pid = os.getpid()
    events: List[dict] = []
    with _REG_LOCK:
        bufs = list(_ALL_BUFS)
    for b in bufs:
        events.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": b.tid,
            "args": {"name": b.thread_name},
        })
    for rec in spans():
        args = {"trace": rec["trace"], "span": rec["span"],
                "parent": rec["parent"]}
        args.update(rec["attrs"])
        events.append({
            "ph": "X",
            "name": rec["name"],
            "pid": pid,
            "tid": rec["tid"],
            "ts": rec["ts"] * 1e6,
            "dur": rec["dur"] * 1e6,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}

