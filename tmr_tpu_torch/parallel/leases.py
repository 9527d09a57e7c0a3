"""Generic lease service (counterpart of ``tmr_tpu/parallel/leases.py``, the same state
machine, names and records): typed resources, epoch-fenced grants, heartbeat liveness,
and cause-tagged reassignment.

A monotone per-resource epoch fences every commit, a stale heartbeat revokes, a dead
worker's holdings reassign under epoch + 1, and a worker failing too many distinct
resources is drained. The elastic map coordinator (``parallel/elastic.py``) is its
client for map shards; the JAX package's serving fleet, its second client, is not
ported (ROADMAP A7). Both packages speak the same JSON-lines protocol, so a port worker
runs against a JAX coordinator and the other way round.

Design notes:

- **one RLock** guards all mutable run state. Re-entrant on purpose:
  clients compose multi-step transitions (fence-check + client-specific
  bookkeeping + commit) under ``with service.lock:`` while every public
  method still takes the lock itself, so no caller can touch state
  unlocked by accident.
- **two-phase grants**: ``select()`` reserves (resource, epoch) under
  the lock; the client fires its fault point / does I/O OUTSIDE the
  lock; ``install()`` or ``requeue()`` completes or aborts the grant.
  Same for straggler election (``elect_straggler`` →
  ``confirm_steal``/``veto_steal``). Latency injected at those points
  must never stall every other worker's heartbeat.
- **transition hook**: ``on_transition(resource, lease, state)`` fires
  under the lock at held/revoked/committed/failed — the map client
  writes its durable ``_leases/*.json`` record there.
- **metric names** are client-shaped (``metrics_prefix``/``noun``): the
  map client counts under ``elastic.shards_committed``, ... in the port's
  ``obs`` registry, the JAX package's names.

Resources need not ever settle: a resource leased for the lifetime of its holder simply
re-enters the pending queue on revocation; ``wait()``/``done`` only matter to clients
whose resources commit (map shards).

Nothing here imports torch: a coordinator runs on a host with no CUDA stack.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from tmr_tpu_torch import obs

#: closed reassignment-cause vocabulary (mirrored by
#: diagnostics.ELASTIC_REASSIGN_CAUSES, which validators consume):
#: stale_heartbeat | worker_exit | straggler | poison_worker | scale_out
REASSIGN_CAUSES = (
    "stale_heartbeat", "worker_exit", "straggler", "poison_worker",
    "scale_out",
)


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


@dataclasses.dataclass(frozen=True)
class LeasePolicy:
    """Liveness / straggler / poison knobs for one lease service.

    ``lease_ttl_s`` is the heartbeat budget: a lease not heartbeated for
    this long is revoked and its resource reassigned. ``hb_interval_s``
    is the worker's beat cadence (default TTL/4 so one dropped beat
    never revokes). ``straggler_factor`` scales the rolling median of
    committed resource wall times into the speculative-re-execution
    bound (0 disables); ``straggler_min_done`` committed resources are
    required before the median means anything. ``max_reassigns`` bounds
    how many times one resource may bounce before it is quarantined
    outright; ``poison_failures`` distinct failed resources drain a
    worker; ``resource_fail_workers`` distinct workers failing one
    resource quarantine the resource."""

    lease_ttl_s: float = 10.0
    hb_interval_s: float = 2.5
    check_interval_s: float = 1.0
    straggler_factor: float = 3.0
    straggler_min_s: float = 5.0
    straggler_min_done: int = 3
    max_reassigns: int = 4
    poison_failures: int = 3
    resource_fail_workers: int = 2

    @classmethod
    def from_env(cls, **overrides) -> "LeasePolicy":
        """Resolve defaults from the TMR_ELASTIC_* env knobs (read
        lazily, at call time — the one lease-liveness knob family both
        clients share), then apply explicit overrides."""
        ttl = _env_float("TMR_ELASTIC_TTL_S", 10.0)
        base = dict(
            lease_ttl_s=ttl,
            hb_interval_s=_env_float("TMR_ELASTIC_HB_S", ttl / 4.0),
            check_interval_s=_env_float("TMR_ELASTIC_CHECK_S", ttl / 10.0),
            straggler_factor=_env_float("TMR_ELASTIC_STRAGGLER_FACTOR",
                                        3.0),
            straggler_min_s=_env_float("TMR_ELASTIC_STRAGGLER_MIN_S", 5.0),
            max_reassigns=_env_int("TMR_ELASTIC_MAX_REASSIGNS", 4),
            poison_failures=_env_int("TMR_ELASTIC_POISON_FAILURES", 3),
        )
        base.update(overrides)
        return cls(**base)


class Lease:
    __slots__ = ("worker", "epoch", "granted_at", "expires_at", "hb")

    def __init__(self, worker: str, epoch: int, granted_at: float,
                 ttl_s: float):
        self.worker = worker
        self.epoch = epoch
        self.granted_at = granted_at
        self.expires_at = granted_at + ttl_s
        self.hb = 0


class Resource:
    """One leasable resource. ``key`` is the durable identity carried in
    reassignment/fence records (a shard basename); clients subclass to
    attach their own payload fields (the map shard adds path, category
    and the committed journal entry)."""

    __slots__ = (
        "index", "key", "status", "next_epoch", "leases", "assignments",
        "reassigns", "failures", "failed_workers", "worker", "epoch",
        "straggled", "first_granted_at", "wall_s", "cleaned",
    )

    def __init__(self, index: int, key: str):
        self.index = index
        self.key = key
        self.status = "pending"  # pending|leased|committed|resumed|quarantined
        self.next_epoch = 1
        self.leases: Dict[int, Lease] = {}
        self.assignments = 0
        #: reassignment records for THIS resource (stragglers included)
        #: — the O(1) bound counter; the service-level list is the
        #: report's content, never rescanned per event
        self.reassigns = 0
        self.failures: List[dict] = []
        self.failed_workers: set = set()
        self.worker: Optional[str] = None
        self.epoch: Optional[int] = None
        self.straggled = False
        self.first_granted_at: Optional[float] = None
        self.wall_s = 0.0
        self.cleaned = False

    @property
    def settled(self) -> bool:
        return self.status in ("committed", "resumed", "quarantined")


class WorkerRecord:
    __slots__ = ("wid", "committed", "failed", "drained", "dead", "bye")

    def __init__(self, wid: str):
        self.wid = wid
        self.committed = 0
        self.failed: set = set()
        self.drained = False
        self.dead = False
        self.bye = False


class LeaseService:
    """The epoch-fenced lease state machine over a fixed resource list.

    All mutable state lives behind ``self.lock`` (an RLock — see the
    module docstring for the composition contract). Clients provide the
    wire protocol, durable records, and reports; this class provides the
    one correct grant/heartbeat/fence/reassign/drain discipline."""

    def __init__(self, resources: Sequence[Resource],
                 policy: Optional[LeasePolicy] = None, *,
                 metrics_prefix: str = "lease", noun: str = "resource",
                 key_field: str = "resource",
                 on_transition: Optional[Callable] = None,
                 history_bound: Optional[int] = None):
        self.policy = policy or LeasePolicy()
        self.lock = threading.RLock()
        self.resources: List[Resource] = list(resources)
        keys = [r.key for r in self.resources]
        if len(set(keys)) != len(keys):
            raise ValueError(
                f"duplicate {noun} keys cannot be leased unambiguously"
            )
        #: record-key name in reassignment/fence dicts ("shard" for the
        #: map client)
        self.key_field = key_field
        self._prefix = metrics_prefix
        self._noun = noun
        #: fires under the lock at every lease state change
        #: (resource, lease, "held"|"revoked"|"committed"|"failed")
        self.on_transition = on_transition
        self._pending: deque = deque(
            r.index for r in self.resources if not r.settled
        )
        self.workers: Dict[str, WorkerRecord] = {}
        #: oldest records roll off past ``history_bound`` (None =
        #: unbounded — the map client's report validator reconciles
        #: totals against list LENGTHS, and a map run is bounded by its
        #: shard count anyway; a client that leases indefinitely passes
        #: a bound so a flapping worker cannot grow these forever)
        self.history_bound = history_bound
        self.reassignments: List[dict] = []
        self.fenced: List[dict] = []
        self._settled = sum(1 for r in self.resources if r.settled)
        self.done_event = threading.Event()
        self._t0 = time.monotonic()
        self.wall_s = 0.0
        if self._settled == len(self.resources):
            self.done_event.set()

    # ------------------------------------------------------------- counters
    def _count(self, name: str) -> None:
        obs.get_registry().counter(f"{self._prefix}.{name}").inc()

    def _trim_locked(self, records: List[dict]) -> None:
        if self.history_bound and len(records) > self.history_bound:
            del records[:-self.history_bound]

    # -------------------------------------------------------------- workers
    def worker_rec(self, wid: str) -> WorkerRecord:
        with self.lock:
            rec = self.workers.get(wid)
            if rec is None:
                rec = self.workers[wid] = WorkerRecord(wid)
            return rec

    def rejoin(self, wid: str) -> WorkerRecord:
        """A worker re-introduced itself (a fresh ``hello``): clear the
        departure flags a previous incarnation under the same stable id
        left behind — without this, a restarted worker is treated as
        departed forever (its state pruned each pass, its grants
        black-holed). ``drained`` stays STICKY on purpose: a
        poison-drained worker must not re-admit itself by reconnecting.
        """
        with self.lock:
            rec = self.worker_rec(wid)
            rec.dead = False
            rec.bye = False
            return rec

    def live_workers(self) -> List[str]:
        """Worker ids currently eligible for grants: registered, not
        departed (dead/bye), not poison-drained."""
        with self.lock:
            return [w.wid for w in self.workers.values()
                    if not (w.dead or w.bye or w.drained)]

    def restart_clock(self) -> None:
        """Re-anchor the run clock (clients call this at ``start()`` so
        reported wall time measures SERVING, not construction — resume
        journal scans and caller setup between construction and start
        must not inflate it)."""
        with self.lock:
            self._t0 = time.monotonic()

    def mark_resumed(self, index: int, worker: Optional[str] = None,
                     epoch: Optional[int] = None) -> None:
        """Settle one resource as resumed (a prior run's durable commit
        was folded in) before any grants happen."""
        with self.lock:
            res = self.resources[index]
            res.status = "resumed"
            res.worker = worker
            res.epoch = epoch
            try:
                self._pending.remove(index)
            except ValueError:
                pass
            self._settle_locked()

    # ---------------------------------------------------------------- grant
    def select(self, wid: str) -> Tuple[str, Optional[Resource], int]:
        """Phase one of a grant: pick a resource for ``wid`` and reserve
        the next epoch. Returns ``(verdict, resource, epoch)`` with
        verdict one of "drained" / "done" / "wait" / "grant" — only
        "grant" carries a resource. The caller fires its fault point
        outside the lock, then calls :meth:`install` (success) or
        :meth:`requeue` (abort)."""
        with self.lock:
            worker = self.worker_rec(wid)
            if worker.drained:
                return ("drained", None, 0)
            if self.done_event.is_set():
                return ("done", None, 0)
            # a worker is not handed back a resource it already failed —
            # UNLESS it is the only non-drained live worker left (the
            # reassignment bound then ends the ping-pong in quarantine).
            # Departed workers (clean bye included) are NOT alive: a
            # sole survivor skipping its failed resource forever would
            # leave the run unsettleable.
            others_alive = any(
                w.wid != wid and not w.drained and not w.dead
                and not w.bye
                for w in self.workers.values()
            )
            # fairness cap: a worker already holding its share of the
            # CONCURRENT leases (ceil(resources / alive workers)) waits
            # while an under-loaded live peer exists — this is what
            # makes a scale-out rebalance deterministic (the freed
            # partition goes to the recruit, not back to the loaded
            # holder that freed it). Map workers hold one lease at a
            # time, so with shards >= workers the cap never binds there
            # (grant behavior unchanged, gauntlet-pinned).
            if others_alive:
                held_per: Dict[str, int] = {}
                for res in self.resources:
                    for lease in res.leases.values():
                        held_per[lease.worker] = (
                            held_per.get(lease.worker, 0) + 1
                        )
                alive = [
                    w.wid for w in self.workers.values()
                    if not (w.drained or w.dead or w.bye)
                ]
                cap = -(-len(self.resources) // max(len(alive), 1))
                if held_per.get(wid, 0) >= cap and any(
                    held_per.get(w, 0) < cap
                    for w in alive if w != wid
                ):
                    return ("wait", None, 0)
            chosen = None
            for _ in range(len(self._pending)):
                idx = self._pending.popleft()
                cand = self.resources[idx]
                if cand.settled:
                    continue  # a straggler dup whose original won
                if wid in cand.failed_workers and others_alive:
                    self._pending.append(idx)  # someone else's to retry
                    continue
                chosen = cand
                break
            if chosen is None:
                return ("wait", None, 0)
            epoch = chosen.next_epoch
            chosen.next_epoch += 1
            return ("grant", chosen, epoch)

    def requeue(self, resource: Resource) -> None:
        """Abort a reserved grant (the fault point vetoed it): put the
        resource back at the FRONT of the queue unless it settled in
        the window."""
        with self.lock:
            if not resource.settled:
                self._pending.appendleft(resource.index)

    def install(self, resource: Resource, epoch: int,
                wid: str) -> Optional[Lease]:
        """Phase two of a grant: install the lease. None when the
        resource settled while the caller was outside the lock (the
        straggler-dup race) — the grant is then void."""
        now = time.monotonic()
        with self.lock:
            if resource.settled:
                return None
            lease = Lease(wid, epoch, now, self.policy.lease_ttl_s)
            resource.leases[epoch] = lease
            resource.status = "leased"
            resource.assignments += 1
            if resource.first_granted_at is None:
                resource.first_granted_at = now
            if self.on_transition is not None:
                self.on_transition(resource, lease, "held")
            self._count("leases_granted")
            return lease

    # ------------------------------------------------------------- liveness
    def current_lease(self, index: int, epoch: int,
                      wid: str) -> Optional[Lease]:
        with self.lock:
            if not (0 <= index < len(self.resources)):
                return None
            res = self.resources[index]
            if res.settled:
                return None
            lease = res.leases.get(epoch)
            if lease is None or lease.worker != wid:
                return None
            return lease

    def heartbeat(self, wid: str, index: int, epoch: int) -> bool:
        """Extend one lease's expiry; False == the epoch is stale (the
        caller should drop its local claim)."""
        with self.lock:
            lease = self.current_lease(index, epoch, wid)
            if lease is None:
                return False
            # expiry extension is memory-only: durable lease records are
            # advisory (rewritten on grant/revoke/commit/fail) and a
            # per-beat disk write under the protocol lock would
            # serialize every worker's beat on disk latency
            lease.expires_at = time.monotonic() + self.policy.lease_ttl_s
            lease.hb += 1
            return True

    def record_fence(self, index: int, wid: str, epoch: int,
                     op: str) -> None:
        """One stale-epoch rejection record (op: precommit|commit)."""
        with self.lock:
            key = (
                self.resources[index].key
                if 0 <= index < len(self.resources) else f"#{index}"
            )
            self.fenced.append({
                self.key_field: key, "index": index, "worker": wid,
                "epoch": epoch, "op": op,
            })
            self._trim_locked(self.fenced)
            self._count("fenced_rejections")

    # ------------------------------------------------------------ terminals
    def commit(self, wid: str, index: int,
               epoch: int) -> Optional[Tuple[Resource, Lease]]:
        """Fence-checked commit. None == stale (a fence record was
        written; the client decides what to do about any durable marker
        the loser slipped to disk). On success the resource is settled
        under (wid, epoch) and every outstanding lease on it cleared;
        the client fills its payload fields under the same lock hold."""
        with self.lock:
            lease = self.current_lease(index, epoch, wid)
            if lease is None:
                self.record_fence(index, wid, epoch, "commit")
                return None
            res = self.resources[index]
            res.status = "committed"
            res.worker = wid
            res.epoch = epoch
            res.wall_s = time.monotonic() - (
                res.first_granted_at or lease.granted_at
            )
            if self.on_transition is not None:
                self.on_transition(res, lease, "committed")
            res.leases.clear()
            self.worker_rec(wid).committed += 1
            self._count(f"{self._noun}s_committed")
            self._settle_locked()
            return res, lease

    def fail(self, wid: str, index: int, epoch: int,
             causes: Optional[List[dict]] = None) -> dict:
        """A worker reports it could not serve its leased resource.
        Reassigns under cause ``poison_worker`` and drains the worker
        past the policy bound. Returns {"stale": bool, "drained": bool}.
        """
        with self.lock:
            lease = self.current_lease(index, epoch, wid)
            if lease is None:
                return {"stale": True, "drained": False}
            res = self.resources[index]
            res.leases.pop(epoch, None)
            res.failures.append({"worker": wid, "causes": causes or []})
            res.failed_workers.add(wid)
            worker = self.worker_rec(wid)
            worker.failed.add(index)
            if self.on_transition is not None:
                self.on_transition(res, lease, "failed")
            self._reassign_locked(res, lease, "poison_worker")
            if len(worker.failed) >= self.policy.poison_failures \
                    and not worker.drained:
                worker.drained = True
                self._count("workers_drained")
                self.revoke_worker(wid, "poison_worker")
            return {"stale": False, "drained": worker.drained}

    def bye(self, wid: str) -> None:
        with self.lock:
            self.worker_rec(wid).bye = True

    def control_closed(self, wid: str, clean: bool) -> None:
        """The worker's control connection ended. A dirty close (no
        ``bye``) with leases held is a crashed/killed worker — reassign
        everything it was running immediately."""
        with self.lock:
            worker = self.worker_rec(str(wid))
            if clean or worker.bye:
                return
            worker.dead = True
            self.revoke_worker(str(wid), "worker_exit")

    def revoke_worker(self, wid: str, cause: str) -> List[Resource]:
        """Revoke every lease ``wid`` holds; returns the resources that
        went back into play."""
        revoked: List[Resource] = []
        with self.lock:
            for res in self.resources:
                for epoch, lease in list(res.leases.items()):
                    if lease.worker == wid:
                        res.leases.pop(epoch, None)
                        res.next_epoch = max(res.next_epoch, epoch + 1)
                        if self.on_transition is not None:
                            self.on_transition(res, lease, "revoked")
                        self._reassign_locked(res, lease, cause)
                        revoked.append(res)
        return revoked

    def revoke_lease(self, index: int, epoch: int, cause: str) -> bool:
        """Revoke one specific lease (a scale-out rebalance); False when
        the (index, epoch) lease no longer exists."""
        with self.lock:
            if not (0 <= index < len(self.resources)):
                return False
            res = self.resources[index]
            lease = res.leases.pop(epoch, None)
            if lease is None:
                return False
            res.next_epoch = max(res.next_epoch, epoch + 1)
            if self.on_transition is not None:
                self.on_transition(res, lease, "revoked")
            self._reassign_locked(res, lease, cause)
            return True

    def _reassign_locked(self, res: Resource, lease: Lease,
                         cause: str) -> None:
        """Record one reassignment and put the resource back in play (or
        quarantine it once it has bounced past the policy bound)."""
        self.reassignments.append({
            self.key_field: res.key, "index": res.index,
            "worker": lease.worker, "epoch": lease.epoch, "cause": cause,
        })
        self._trim_locked(self.reassignments)
        res.reassigns += 1
        self._count("reassignments")
        if res.settled:
            return
        exhausted = (
            res.reassigns > self.policy.max_reassigns
            or len(res.failed_workers)
            >= self.policy.resource_fail_workers
        )
        if exhausted and not res.leases:
            res.status = "quarantined"
            self._count(f"{self._noun}s_quarantined")
            if self.on_transition is not None:
                self.on_transition(res, lease, "quarantined")
            self._settle_locked()
            return
        if not res.leases:
            res.status = "pending"
        if res.index not in self._pending and not exhausted:
            self._pending.appendleft(res.index)

    # -------------------------------------------------------- monitor passes
    def expire_pass(self) -> None:
        """Revoke every lease whose heartbeat went stale past the TTL
        (cause ``stale_heartbeat``)."""
        now = time.monotonic()
        with self.lock:
            for res in self.resources:
                for epoch, lease in list(res.leases.items()):
                    if now > lease.expires_at:
                        res.leases.pop(epoch, None)
                        if self.on_transition is not None:
                            self.on_transition(res, lease, "revoked")
                        self._reassign_locked(res, lease,
                                              "stale_heartbeat")

    def elect_straggler(self) -> Optional[Tuple[Resource, Lease]]:
        """Phase one of speculative re-execution: pick the one resource
        whose single lease has outlived the rolling-median bound. The
        caller fires its fault point outside the lock, then
        :meth:`confirm_steal` or :meth:`veto_steal`."""
        now = time.monotonic()
        with self.lock:
            if self.policy.straggler_factor <= 0:
                return None
            walls = sorted(
                r.wall_s for r in self.resources
                if r.status == "committed" and r.wall_s > 0
            )
            if len(walls) < max(self.policy.straggler_min_done, 1):
                return None
            n = len(walls)
            median = walls[n // 2] if n % 2 else 0.5 * (
                walls[n // 2 - 1] + walls[n // 2]
            )
            bound = max(self.policy.straggler_min_s,
                        self.policy.straggler_factor * median)
            for res in self.resources:
                if res.settled or res.straggled or len(res.leases) != 1:
                    continue
                (lease,) = res.leases.values()
                if now - lease.granted_at > bound:
                    res.straggled = True
                    return res, lease
        return None

    def confirm_steal(self, res: Resource, lease: Lease) -> None:
        with self.lock:
            if res.settled or not res.leases:
                return
            self.reassignments.append({
                self.key_field: res.key, "index": res.index,
                "worker": lease.worker, "epoch": lease.epoch,
                "cause": "straggler",
            })
            self._trim_locked(self.reassignments)
            res.reassigns += 1  # straggler dups count toward the bound
            self._count("reassignments")
            self._count("stragglers")
            if res.index not in self._pending:
                self._pending.appendleft(res.index)

    def veto_steal(self, res: Resource) -> None:
        with self.lock:
            res.straggled = False  # election vetoed; retry later

    # --------------------------------------------------------------- settle
    def _settle_locked(self) -> None:
        self._settled = sum(1 for r in self.resources if r.settled)
        if self._settled == len(self.resources):
            self.wall_s = time.monotonic() - self._t0
            self.done_event.set()

    @property
    def settled_count(self) -> int:
        with self.lock:
            return self._settled

    def take_cleanup_targets(self) -> List[Resource]:
        """Quarantined resources not yet swept (marks them swept): the
        client's sweep runs OUTSIDE the lock."""
        with self.lock:
            targets = [
                r for r in self.resources
                if r.status == "quarantined" and not r.cleaned
            ]
            for res in targets:
                res.cleaned = True
            return targets

    def pending_snapshot(self) -> List[int]:
        with self.lock:
            return list(self._pending)

    def run_wall_s(self) -> float:
        with self.lock:
            return self.wall_s or (time.monotonic() - self._t0)

    def holder(self, index: int) -> Optional[Tuple[str, int]]:
        """(worker, epoch) of the resource's single active lease, None
        while unheld (pending / being rebalanced). Resources under a
        straggler duplicate report the newest epoch."""
        with self.lock:
            if not (0 <= index < len(self.resources)):
                return None
            leases = self.resources[index].leases
            if not leases:
                return None
            epoch = max(leases)
            return leases[epoch].worker, epoch


# --------------------------------------------------------- wire protocol
#: the JSON-lines plain-socket protocol the lease clients share (the
#: elastic map coordinator and its workers, in either package): one JSON
#: document per line, request/response on a persistent control
#: connection, fresh one-shot connections for heartbeats.
def send_line(sock: socket.socket, doc: dict) -> None:
    sock.sendall((json.dumps(doc) + "\n").encode())


def recv_line(f) -> Optional[dict]:
    line = f.readline()
    if not line:
        return None
    return json.loads(line)


def connect_timeout(default: float = 5.0) -> float:
    """The explicit connect timeout (``TMR_ELASTIC_CONNECT_TIMEOUT_S``,
    read lazily) every lease-protocol dial uses: a black-holed
    coordinator address must fail a worker FAST — the OS default connect
    timeout can park a worker in ``hello`` for minutes."""
    return max(_env_float("TMR_ELASTIC_CONNECT_TIMEOUT_S", default), 0.05)


def oneshot(address: Tuple[str, int], doc: dict,
            timeout: float = 10.0) -> dict:
    """One request/response on a fresh connection (heartbeats use this
    so beats never interleave with the control channel). The dial is
    bounded by :func:`connect_timeout`; ``timeout`` bounds the exchange
    after the connection is up."""
    with socket.create_connection(
        address, timeout=connect_timeout(min(timeout, 5.0))
    ) as sock:
        sock.settimeout(timeout)
        send_line(sock, doc)
        with sock.makefile("rb") as f:
            reply = recv_line(f)
    if reply is None:
        raise ConnectionError("coordinator closed the connection")
    return reply
