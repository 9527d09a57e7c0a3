"""SLO-aware admission control for the serving engine (counterpart of
``tmr_tpu/serve/admission.py``).

- :class:`RejectedError`: the structured early rejection a rejected request's future
  carries: a closed-vocabulary ``cause`` (:data:`REJECTION_CAUSES`), the request's
  ``priority`` class and a ``retry_after_s`` hint from the measured drain rate.
- :class:`AdmissionController`: the bounded front door the engine consults in
  ``submit`` before any work is done for a request: a total in-system bound
  (``TMR_ADMIT_MAX_PENDING``), per-priority-class bounds (``TMR_ADMIT_CLASS_PENDING``)
  and an optional token-bucket arrival-rate limit (``TMR_ADMIT_RATE`` /
  ``TMR_ADMIT_BURST``). Disabled (``TMR_ADMIT=0``, the default) the controller is one
  bool check: unbounded queues, no rejection.

Accounting contract: every admitted request holds exactly one admission slot from
``try_admit`` until its ONE terminal event (resolve, fail, shed, or shutdown rejection);
``release`` is idempotent per request, so the reject, shed, complete and error tallies
reconcile exactly with submissions.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

#: closed rejection-cause vocabulary carried by RejectedError (and the
#: overload probe's per-cause tallies): "queue_full" = the total
#: in-system bound tripped, "class_limit" = this priority class's bound
#: tripped, "rate_limited" = the token bucket ran dry, "deadline" = the
#: request's deadline expired before a pipeline stage would have spent
#: device time on it (shed), "shutdown" = the engine closed before the
#: request could be served (bounded-drain rejection), "worker_lost" =
#: the fleet front door (the JAX ``serve/fleet.py``; ROADMAP A7)
#: exhausted its resubmission bound after the request's serve worker
#: died: terminal, never silently retried past the bound.
REJECTION_CAUSES = (
    "queue_full",
    "class_limit",
    "rate_limited",
    "deadline",
    "shutdown",
    "worker_lost",
)


class RejectedError(RuntimeError):
    """A request the engine declined to serve, with machine-readable why.

    ``cause`` is one of :data:`REJECTION_CAUSES`; ``priority`` the
    request's class; ``retry_after_s`` a positive backoff hint when the
    condition is transient (queue/rate pressure), None when retrying is
    pointless (shutdown).
    """

    def __init__(self, cause: str, message: str, *, priority: int = 0,
                 retry_after_s: Optional[float] = None):
        assert cause in REJECTION_CAUSES, cause
        super().__init__(message)
        self.cause = cause
        self.priority = int(priority)
        self.retry_after_s = (
            None if retry_after_s is None else round(float(retry_after_s), 3)
        )

    def record(self) -> dict:
        """The cause record (one dict, no message parsing needed
        downstream)."""
        return {
            "cause": self.cause,
            "priority": self.priority,
            "retry_after_s": self.retry_after_s,
            "message": str(self),
        }


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0", "false", "off")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int_list(name: str) -> List[int]:
    out: List[int] = []
    for part in os.environ.get(name, "").split(","):
        part = part.strip()
        if not part:
            continue
        try:
            out.append(int(part))
        except ValueError:
            return []
    return out


def parse_class_weights(spec: str = "") -> Sequence[float]:
    """``TMR_ADMIT_CLASS_WEIGHTS`` parser: comma-separated positive
    floats indexed by priority class; class beyond the list reuses the
    last entry. Empty/invalid -> the default doubling ladder (class 0
    weight 1, each higher class twice the previous)."""
    spec = spec or os.environ.get("TMR_ADMIT_CLASS_WEIGHTS", "")
    weights: List[float] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            w = float(part)
        except ValueError:
            weights = []
            break
        if w <= 0:
            weights = []
            break
        weights.append(w)
    return tuple(weights) or (1.0, 2.0, 4.0, 8.0)


def class_weight_fn(spec: str = ""):
    """A ``priority -> weight`` callable over :func:`parse_class_weights`
    (the MicroBatcher's pop-ordering input)."""
    weights = parse_class_weights(spec)

    def weight(priority: int) -> float:
        p = max(int(priority), 0)
        return weights[min(p, len(weights) - 1)]

    return weight


class AdmissionController:
    """Bounded admission with per-class depth limits and a token bucket.

    All state lives under one lock: the submit path (any caller thread)
    admits, and every pipeline thread releases at a request's terminal
    event. Releases also feed a small timestamp window that estimates
    the engine's drain rate: the ``retry_after_s`` hint on a rejection
    is ``excess / drain_rate``, "by when will a slot plausibly be free",
    not a magic constant.
    """

    def __init__(self, *, enabled: Optional[bool] = None,
                 max_pending: Optional[int] = None,
                 class_pending: Optional[Sequence[int]] = None,
                 rate: Optional[float] = None,
                 burst: Optional[int] = None):
        self.enabled = _env_flag("TMR_ADMIT") if enabled is None \
            else bool(enabled)
        self.max_pending = (
            _env_int("TMR_ADMIT_MAX_PENDING", 256)
            if max_pending is None else int(max_pending)
        )
        cp = (_env_int_list("TMR_ADMIT_CLASS_PENDING")
              if class_pending is None else list(class_pending))
        self.class_pending = tuple(int(x) for x in cp)
        self.rate = _env_float("TMR_ADMIT_RATE", 0.0) if rate is None \
            else float(rate)
        self.burst = (
            max(_env_int("TMR_ADMIT_BURST", 16), 1)
            if burst is None else max(int(burst), 1)
        )
        self._lock = threading.Lock()
        self._counts: Dict[int, int] = {}
        self._total = 0
        self._tokens = float(self.burst)
        self._t_tokens = time.monotonic()
        self._releases: deque = deque(maxlen=64)
        self._rejected: Dict[str, int] = {}

    # ----------------------------------------------------------- helpers
    def _class_bound(self, priority: int) -> int:
        """Per-class in-system bound: the ``TMR_ADMIT_CLASS_PENDING``
        entry for this class (classes beyond the list reuse the last
        entry); no list -> the total bound applies per class too."""
        if not self.class_pending:
            return self.max_pending
        p = max(int(priority), 0)
        return self.class_pending[min(p, len(self.class_pending) - 1)]

    def _drain_rate_unlocked(self) -> float:
        """Measured drain rate: releases per second over the recent
        release window (0.0 when fewer than two releases have been
        observed). The JAX controller's attached per-replica-group
        source comes with mesh serving (ROADMAP A7)."""
        if len(self._releases) < 2:
            return 0.0
        span = self._releases[-1] - self._releases[0]
        if span <= 0:
            return 0.0
        return (len(self._releases) - 1) / span

    def _retry_after_unlocked(self, excess: int) -> Optional[float]:
        rate = self._drain_rate_unlocked()
        if rate <= 0:
            return 1.0  # no drain evidence yet: a modest fixed backoff
        return min(max(excess / rate, 0.05), 60.0)

    # ------------------------------------------------------------ admit
    def try_admit(self, priority: int = 0) -> Optional[RejectedError]:
        """One admission decision. None = admitted (a slot is now held
        and MUST be released exactly once via :meth:`release` /
        :meth:`release_class`); a :class:`RejectedError` = rejected, no
        slot held."""
        if not self.enabled:
            return None
        priority = max(int(priority), 0)
        with self._lock:
            if self.rate > 0:
                now = time.monotonic()
                self._tokens = min(
                    float(self.burst),
                    self._tokens + (now - self._t_tokens) * self.rate,
                )
                self._t_tokens = now
                if self._tokens < 1.0:
                    self._rejected["rate_limited"] = (
                        self._rejected.get("rate_limited", 0) + 1
                    )
                    return RejectedError(
                        "rate_limited",
                        f"arrival rate over TMR_ADMIT_RATE={self.rate}",
                        priority=priority,
                        retry_after_s=(1.0 - self._tokens) / self.rate,
                    )
            if self._total >= self.max_pending:
                self._rejected["queue_full"] = (
                    self._rejected.get("queue_full", 0) + 1
                )
                return RejectedError(
                    "queue_full",
                    f"{self._total} requests in system (bound "
                    f"{self.max_pending})",
                    priority=priority,
                    retry_after_s=self._retry_after_unlocked(
                        self._total - self.max_pending + 1
                    ),
                )
            bound = self._class_bound(priority)
            held = self._counts.get(priority, 0)
            if held >= bound:
                self._rejected["class_limit"] = (
                    self._rejected.get("class_limit", 0) + 1
                )
                return RejectedError(
                    "class_limit",
                    f"priority class {priority} holds {held} slots "
                    f"(bound {bound})",
                    priority=priority,
                    retry_after_s=self._retry_after_unlocked(
                        held - bound + 1
                    ),
                )
            if self.rate > 0:
                self._tokens -= 1.0
            self._counts[priority] = held + 1
            self._total += 1
        return None

    def release_class(self, priority: int) -> None:
        """Give back one slot for ``priority`` (the pre-Request paths:
        cache hit, coalesce, malformed; the request object never
        carried the slot)."""
        if not self.enabled:
            return
        priority = max(int(priority), 0)
        with self._lock:
            held = self._counts.get(priority, 0)
            if held > 0:
                self._counts[priority] = held - 1
                self._total -= 1
                self._releases.append(time.monotonic())

    def release(self, req) -> None:
        """Terminal-event release for an enqueued Request, idempotent:
        the ``admitted`` flag flips under this controller's lock, so
        whichever pipeline stage reaches the request's terminal event
        first releases, and every later caller no-ops."""
        if not self.enabled:
            return
        with self._lock:
            if not getattr(req, "admitted", False):
                return
            req.admitted = False
            priority = max(int(req.priority), 0)
            held = self._counts.get(priority, 0)
            if held > 0:
                self._counts[priority] = held - 1
                self._total -= 1
                self._releases.append(time.monotonic())

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "max_pending": self.max_pending,
                "class_pending": list(self.class_pending),
                "rate": self.rate,
                "burst": self.burst,
                "in_system": self._total,
                "per_class": dict(self._counts),
                "drain_per_sec": round(self._drain_rate_unlocked(), 3),
                "rejected": dict(self._rejected),
            }
