"""Dynamic micro-batching (counterpart of ``tmr_tpu/serve/batcher.py``): coalesce
single-image requests into bucket programs under a latency bound.

Requests accumulate per bucket key (``Predictor.bucket_key``: one program shape per
key) and a batch is released when EITHER

- a bucket reaches its size bound (``bound_for(bucket)``, the engine's batch bound), or
- the OLDEST request in a bucket has waited ``max_wait_ms`` (the latency bound: a lone
  request is never held hostage to batch-filling).

Ragged releases (timeout flushes, close-time drains) are padded by the staging layer
to power-of-two sub-buckets (``staging._pad_to``). The JAX batcher's per-replica-group
queues come with mesh serving (ROADMAP A7).
"""

from __future__ import annotations

import threading
import time
from collections import Counter, OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from tmr_tpu_torch import obs


@dataclass
class Request:
    """One in-flight inference request riding the batching pipeline."""

    image: Any  # host (S, S, 3) float32
    exemplars: Any  # host (K, 4) float32 (multi: padded to k_bucket)
    bucket: tuple  # Predictor.bucket_key(...)
    futures: List[Any] = field(default_factory=list)  # resolved together
    t_submit: float = field(default_factory=time.perf_counter)
    k_real: int = 1  # multi path: real exemplar rows
    image_digest: str = ""
    result_key: Optional[tuple] = None  # result-cache key
    features: Any = None  # cached device features (heads path, hit)
    needs_features: bool = False  # heads path, promotion fill
    trace_id: str = ""  # per-request span correlation (obs.tracing)
    priority: int = 0  # class-weighted scheduling (higher = sooner)
    deadline: Optional[float] = None  # absolute perf_counter seconds;
    # coalesced duplicates inherit the EARLIEST deadline of the group
    admitted: bool = False  # holds one admission slot until terminal
    degrade_steps: tuple = ()  # ladder steps applied to THIS request

    def expired(self, now: Optional[float] = None) -> bool:
        """Past its deadline? Expired requests are shed by the next
        pipeline stage instead of burning device time."""
        if self.deadline is None:
            return False
        return (time.perf_counter() if now is None else now) > self.deadline

    def resolve(self, value) -> None:
        for f in self.futures:
            if not f.done():
                f.set_result(value)

    def fail(self, exc: BaseException) -> None:
        for f in self.futures:
            if not f.done():
                f.set_exception(exc)


class MicroBatcher:
    """Per-bucket request queue with size- and latency-bounded release.

    ``next_batch()`` blocks until a batch is due and returns
    ``(bucket, [Request, ...])``, or None once the batcher is closed AND
    drained (the consumer thread's shutdown signal). Thread-safe: any
    number of producers (``put``), one consumer.
    """

    def __init__(self, max_wait_ms: float,
                 bound_for: Callable[[tuple], int],
                 class_weight: Optional[Callable[[int], float]] = None):
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.bound_for = bound_for
        #: priority-class weight for pop ordering (serve/admission.py's
        #: class_weight_fn in the engine); None -> all classes equal
        self.class_weight = class_weight
        # ordered so the flush scan visits buckets in first-use order:
        # no bucket can be starved behind a constantly-full sibling
        self._pending: "OrderedDict[tuple, deque]" = OrderedDict()
        #: highest priority currently waiting per bucket (entries only
        #: for nonzero priorities): the weighted full-bucket election and
        #: the priority-pop guard read this in O(1) instead of scanning
        #: the backlog
        self._maxp: Dict[tuple, int] = {}
        self._cond = threading.Condition()
        self._closed = False
        #: released-batch size histogram {occupied_slots: count}
        self.occupancy: Counter = Counter()

    def put(self, req: Request) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            key = req.bucket
            self._pending.setdefault(key, deque()).append(req)
            if req.priority > self._maxp.get(key, 0):
                self._maxp[key] = req.priority
            self._cond.notify()

    def close(self) -> None:
        """Stop accepting; pending requests still drain via next_batch."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def _bound(self, key: tuple) -> int:
        return max(1, int(self.bound_for(key)))

    def _pop(self, key: tuple, n: int) -> Tuple[tuple, List[Request]]:
        dq = self._pending[key]
        n = min(n, len(dq))
        if self._maxp.get(key, 0):
            # class-weighted pop: release the n highest-priority
            # requests (FIFO within a class). The queue stays arrival-
            # ordered, so priority is a pop-side selection; the OLDEST
            # request (dq[0]) always rides: the max_wait flush fires on
            # its age, and leaving it behind for heavier classes would
            # starve low classes indefinitely
            picked = sorted(
                range(1, len(dq)),
                key=lambda i: (-dq[i].priority, dq[i].t_submit),
            )[:n - 1]
            picked_set = {0, *picked}
            out = [dq[i] for i in sorted(picked_set)]
            rest = [r for i, r in enumerate(dq) if i not in picked_set]
            dq.clear()
            dq.extend(rest)
        else:
            out = [dq.popleft() for _ in range(n)]
        if not dq:
            del self._pending[key]
            self._maxp.pop(key, None)
        else:
            if self._maxp.get(key, 0):
                mp = max(r.priority for r in dq)
                if mp > 0:
                    self._maxp[key] = mp
                else:
                    self._maxp.pop(key, None)
            # a bucket that released but still holds requests goes to the
            # back of the scan order: a sustained-load bucket must not
            # monopolize the full-bucket scan while siblings queue
            self._pending.move_to_end(key)
        self.occupancy[len(out)] += 1
        if obs.tracing_enabled():
            # queue wait = submit -> release, per request, recorded here
            # from the submit stamp; guarded: this runs on the consumer
            # thread outside the engine's isolation try blocks
            try:
                now = time.perf_counter()
                for r in out:
                    obs.add_span("serve.queue_wait", r.t_submit, now,
                                 trace_id=r.trace_id or None,
                                 bucket=str(key))
            except Exception:
                pass
        return key, out

    def next_batch(self) -> Optional[Tuple[tuple, List[Request]]]:
        """Block until a batch is due and return ``(bucket, requests)``."""
        with self._cond:
            while True:
                # 1. an EXPIRED latency deadline releases first: the
                # max_wait_ms bound holds even while a sibling bucket is
                # kept full by sustained load
                now = time.perf_counter()
                deadline = None
                due = None
                for key, dq in self._pending.items():
                    t = dq[0].t_submit + self.max_wait_s
                    if deadline is None or t < deadline:
                        deadline, due = t, key
                if deadline is not None and now >= deadline:
                    return self._pop(due, self._bound(due))
                # 2. any full bucket releases immediately; with a class
                # weighting, the full bucket holding the heaviest-class
                # request wins (ties keep first-use order, rotated by
                # _pop); rule 1 still bounds every class's wait
                best = None
                best_bound = 0
                best_w = 0.0
                for key, dq in self._pending.items():
                    bound = self._bound(key)
                    if len(dq) < bound:
                        continue
                    if self.class_weight is None:
                        return self._pop(key, bound)
                    w = self.class_weight(self._maxp.get(key, 0))
                    if best is None or w > best_w:
                        best, best_bound, best_w = key, bound, w
                if best is not None:
                    return self._pop(best, best_bound)
                if self._closed:
                    # drain: flush partial buckets oldest-first
                    for key in self._pending:
                        return self._pop(key, self._bound(key))
                    return None
                # 3. else sleep until the earliest deadline (or new work)
                self._cond.wait(
                    timeout=None if deadline is None else deadline - now
                )

    def pending(self) -> int:
        with self._cond:
            return sum(len(d) for d in self._pending.values())

    def depth_snapshot(self) -> Dict[tuple, int]:
        """Per-bucket queue depths right now (``ServeEngine.health()``)."""
        with self._cond:
            return {key: len(dq) for key, dq in self._pending.items()}

    def occupancy_snapshot(self) -> Dict[int, int]:
        with self._cond:
            return dict(self.occupancy)
