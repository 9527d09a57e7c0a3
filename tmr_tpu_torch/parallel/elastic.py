"""Elastic map phase (counterpart of ``tmr_tpu/parallel/elastic.py``): lease-based
coordinator/worker shard execution.

The single-host executor (``parallel/mapreduce.py``) makes the map phase crash-proof on
one host walking a static shard list; the reference's Hadoop Streaming layer also
re-ran dead mappers and speculatively re-executed slow ones. This module is that layer,
built on the durable journal so that nothing about the single-process correctness
contract changes:

- the **coordinator** owns the shard queue as *leases*: an atomically written
  ``<journal>/_leases/<stem>.json`` record (``atomicio.atomic_write``) carrying worker
  id, a monotonically increasing per-shard **epoch**, and an expiry. It serves a small
  JSON-lines TCP protocol (plain sockets, no CUDA), the JAX package's protocol, so port
  workers run against a JAX coordinator and the other way round;
- **workers** (separate processes or threads) lease one shard at a time, run it through
  the single-host executor's shard-attempt machinery unchanged
  (``mapreduce._run_stream_impl``: retry, backoff, stall timeout, quarantine),
  heartbeat the lease on an interval (``obs.flight.Heartbeat``: the emit callable sends
  the beat), and commit the journal done-marker before releasing;
- **liveness**: a lease whose heartbeat goes stale past the TTL is revoked and the shard
  reassigned under an incremented epoch (cause ``stale_heartbeat``); a worker whose
  control connection drops while it holds a lease is reassigned at once
  (``worker_exit``);
- **fencing** makes that safe: every journal commit is fenced on the CURRENT lease epoch
  (``journal.record(fence=...)``: a precommit round trip). A paused-then-resumed worker
  whose lease was revoked raises :class:`StaleLeaseError` before its marker touches
  disk, so it can never corrupt the table, and the rejection is counted in the report.
  The journal's digest and ``atomic_save_npy`` make a second execution of the feature
  writes harmless;
- **stragglers**: when a shard's runtime exceeds a rolling-median bound, the
  coordinator duplicate-leases it (cause ``straggler``); the first committed marker
  wins and the fence rejects the loser;
- **poison workers**: a worker that reports failures on N distinct shards is drained
  (its lease requests refused, its leases redistributed); a shard failed by several
  distinct workers is quarantined, as the single-process executor would.

The lease/epoch/heartbeat/reassignment state machine is
:class:`~tmr_tpu_torch.parallel.leases.LeaseService`.

The final stats table folds one float64 contribution per shard in shard-list order,
exactly the single-process fold, so an elastic run over any number of workers, kills
and reassignments gives a **byte-identical** table (``python -m
tmr_tpu_torch.chaos_probe --elastic`` shows it under kill -9 and SIGSTOP). The run is
accounted in one validated ``elastic_report/v1`` document
(``diagnostics.validate_elastic_report``).

Environment knobs, all read lazily: ``TMR_ELASTIC_TTL_S``, ``TMR_ELASTIC_HB_S``,
``TMR_ELASTIC_CHECK_S``, ``TMR_ELASTIC_STRAGGLER_FACTOR``,
``TMR_ELASTIC_STRAGGLER_MIN_S``, ``TMR_ELASTIC_MAX_REASSIGNS``,
``TMR_ELASTIC_POISON_FAILURES``, ``TMR_ELASTIC_CONNECT_TIMEOUT_S`` (every protocol
dial: a black-holed coordinator address fails a worker fast).

A ``tcp://host:port`` ``features_out`` streams every worker's features into a
``serve/gallery.FeatureSinkServer`` (``mapreduce.make_feature_sinks``), the
coordinator's quarantine cleanup evicting a shard's features there. Not ported, and
refused by name: the fleet observability plane (``TMR_FLEET_OBS``, ROADMAP A7, with the
fleet). Nothing here imports torch at module load: the map executor (and through it torch)
is imported where a worker or the table needs it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import socketserver
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from tmr_tpu_torch import obs
from tmr_tpu_torch.diagnostics import ELASTIC_REPORT_SCHEMA, validate_elastic_report
from tmr_tpu_torch.obs.tracing import _env_flag
from tmr_tpu_torch.parallel.journal import ShardJournal, StaleLeaseError, shard_stem
from tmr_tpu_torch.parallel.leases import (
    Lease,
    LeasePolicy,
    LeaseService,
    Resource,
    _env_float,
    _env_int,
    connect_timeout,
    oneshot,
    recv_line,
    send_line,
)
from tmr_tpu_torch.utils import faults
from tmr_tpu_torch.utils.atomicio import atomic_write

#: schema tag stamped on every lease record under ``_leases/``
LEASE_SCHEMA = "lease/v1"


def _refuse_fleet_obs() -> None:
    """The JAX package's fleet observability plane rides this protocol under
    ``TMR_FLEET_OBS``; the port has no fleet, so a run asking for it stops here rather
    than running without what it asked for."""
    if _env_flag("TMR_FLEET_OBS"):
        raise NotImplementedError(
            "TMR_FLEET_OBS: the fleet observability plane (obs/fleetobs.py) is not "
            "ported yet (ROADMAP A7, with the fleet); unset it to run the elastic map "
            "phase")


@dataclasses.dataclass(frozen=True)
class ElasticPolicy:
    """Liveness / straggler / poison knobs for one elastic run.

    ``lease_ttl_s`` is the heartbeat budget: a lease not heartbeated for this long is
    revoked and its shard reassigned. ``hb_interval_s`` is the worker's beat cadence
    (default TTL/4 so one dropped beat never revokes). ``straggler_factor`` scales the
    rolling median of completed shard wall times into the speculative-re-execution
    bound (0 disables); ``straggler_min_done`` completed shards are required before the
    median means anything. ``max_reassigns`` bounds how many times one shard may bounce
    before it is quarantined outright; ``poison_failures`` distinct failed shards drain
    a worker; ``shard_fail_workers`` distinct workers failing one shard quarantine the
    shard (the deterministic-poison-data verdict)."""

    lease_ttl_s: float = 10.0
    hb_interval_s: float = 2.5
    check_interval_s: float = 1.0
    straggler_factor: float = 3.0
    straggler_min_s: float = 5.0
    straggler_min_done: int = 3
    max_reassigns: int = 4
    poison_failures: int = 3
    shard_fail_workers: int = 2

    @classmethod
    def from_env(cls, **overrides) -> "ElasticPolicy":
        """Resolve defaults from the TMR_ELASTIC_* env knobs (read lazily, at call
        time), then apply explicit overrides."""
        ttl = _env_float("TMR_ELASTIC_TTL_S", 10.0)
        base = dict(
            lease_ttl_s=ttl,
            hb_interval_s=_env_float("TMR_ELASTIC_HB_S", ttl / 4.0),
            check_interval_s=_env_float("TMR_ELASTIC_CHECK_S", ttl / 10.0),
            straggler_factor=_env_float("TMR_ELASTIC_STRAGGLER_FACTOR", 3.0),
            straggler_min_s=_env_float("TMR_ELASTIC_STRAGGLER_MIN_S", 5.0),
            max_reassigns=_env_int("TMR_ELASTIC_MAX_REASSIGNS", 4),
            poison_failures=_env_int("TMR_ELASTIC_POISON_FAILURES", 3),
        )
        base.update(overrides)
        return cls(**base)

    def lease_policy(self) -> LeasePolicy:
        """This policy in the generic LeaseService vocabulary."""
        return LeasePolicy(
            lease_ttl_s=self.lease_ttl_s,
            hb_interval_s=self.hb_interval_s,
            check_interval_s=self.check_interval_s,
            straggler_factor=self.straggler_factor,
            straggler_min_s=self.straggler_min_s,
            straggler_min_done=self.straggler_min_done,
            max_reassigns=self.max_reassigns,
            poison_failures=self.poison_failures,
            resource_fail_workers=self.shard_fail_workers,
        )


# --------------------------------------------------------- coordinator state
class _Shard(Resource):
    """A map shard as a leasable resource: the generic lease fields plus the map
    payload (path, category, the committed journal entry)."""

    __slots__ = ("path", "category", "stem", "entry", "images")

    def __init__(self, index: int, path: str, category: int):
        super().__init__(index, os.path.basename(path))
        self.path = path
        self.category = category
        self.stem = shard_stem(os.path.basename(path))
        self.entry: Optional[dict] = None
        self.images = 0


class _Handler(socketserver.StreamRequestHandler):
    """One thread per connection; JSON lines in, JSON lines out. The first ``hello``
    marks the connection as a worker's control channel: EOF on a control channel with
    leases still held is the kill -9 signature and triggers immediate reassignment."""

    def handle(self):
        coord = self.server.coordinator  # type: ignore[attr-defined]
        control_worker = None
        clean = False
        try:
            while True:
                try:
                    msg = recv_line(self.rfile)
                except (OSError, ValueError):
                    break
                if msg is None:
                    break
                if msg.get("op") == "hello":
                    control_worker = msg.get("worker")
                if msg.get("op") == "bye":
                    clean = True
                reply = coord.dispatch(msg)
                try:
                    send_line(self.connection, reply)
                except OSError:
                    break
                if clean:
                    break
        finally:
            if control_worker is not None:
                coord.control_closed(control_worker, clean=clean)


class _Server(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class ElasticCoordinator:
    """Owns the shard queue as epoch-fenced leases and serves the worker protocol. The
    lease/liveness state machine is a :class:`LeaseService` (``self._svc``): all
    mutable run state lives behind ITS lock; socket I/O and fault-point firing happen
    outside it."""

    def __init__(
        self,
        shard_paths: Sequence[str],
        journal_dir: str,
        *,
        features_out: Optional[str] = None,
        data_dir: Optional[str] = None,
        image_size: int = 1024,
        batch_size: int = 8,
        resume: bool = False,
        policy: Optional[ElasticPolicy] = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        from tmr_tpu_torch.parallel.mapreduce import category_of, make_feature_sinks

        _refuse_fleet_obs()
        self.policy = policy or ElasticPolicy.from_env()
        self.journal = ShardJournal(journal_dir)
        self.lease_dir = os.path.join(self.journal.directory, "_leases")
        os.makedirs(self.lease_dir, exist_ok=True)
        # like the shard paths: workers resolve this from their own cwd, so a relative
        # features tree would scatter across worker cwds (a tcp:// target is not a path:
        # it reaches make_feature_sinks as given)
        self.features_out = (
            features_out if not features_out or str(features_out).startswith("tcp://")
            else os.path.abspath(features_out)
        )
        # the cleanup sinks are built once
        self._feature_sinks = make_feature_sinks(self.features_out)
        self.data_dir = data_dir
        self.image_size = int(image_size)
        self.batch_size = int(batch_size)
        self._host, self._port = host, int(port)
        self._lock = threading.RLock()
        # workers may run in any cwd on any host sharing the filesystem: a lease must
        # hand them a path that resolves from anywhere
        self._shards = [
            _Shard(i, os.path.abspath(p), category_of(p))
            for i, p in enumerate(shard_paths)
        ]
        stems = [s.stem for s in self._shards]
        if len(set(stems)) != len(stems):
            raise ValueError(
                "duplicate shard journal keys cannot be leased unambiguously; rename "
                "the shards")
        self._svc = LeaseService(
            self._shards, self.policy.lease_policy(),
            metrics_prefix="elastic", noun="shard", key_field="shard",
            on_transition=self._on_transition,
        )
        self._server: Optional[_Server] = None
        self._server_thread: Optional[threading.Thread] = None
        self._monitor_thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        if resume:
            for shard in self._shards:
                entry = self.journal.done(os.path.basename(shard.path))
                if entry is not None:
                    with self._svc.lock:
                        shard.entry = entry
                        shard.images = int(entry.get("images", 0))
                        self._svc.mark_resumed(
                            shard.index, worker=entry.get("worker"),
                            epoch=entry.get("epoch"))

    def _on_transition(self, shard: _Shard, lease: Lease, state: str) -> None:
        """LeaseService transition hook (fires under the service lock): the durable
        lease record tracks held/revoked/committed/failed; quarantine invalidates the
        journal marker. The feature-tree removal is deferred to
        :meth:`_sweep_quarantined` (an rmtree here would hold the protocol lock through
        disk I/O and stall every worker's heartbeat)."""
        if state == "quarantined":
            self.journal.invalidate(os.path.basename(shard.path))
            return
        self._write_lease(shard, lease, state)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> Tuple[str, int]:
        """Bind the server + liveness monitor; returns (host, port)."""
        server = _Server((self._host, self._port), _Handler)
        server.coordinator = self  # type: ignore[attr-defined]
        server_thread = threading.Thread(
            target=server.serve_forever, kwargs={"poll_interval": 0.05},
            name="elastic-coordinator", daemon=True)
        monitor_thread = threading.Thread(
            target=self._monitor_loop, name="elastic-monitor", daemon=True)
        with self._lock:
            self._server = server
            self._server_thread = server_thread
            self._monitor_thread = monitor_thread
        # wall_s measures serving: the resume journal scan in __init__ (and any caller
        # delay before start) must not count
        self._svc.restart_clock()
        server_thread.start()
        monitor_thread.start()
        return self.address

    @property
    def address(self) -> Tuple[str, int]:
        with self._lock:
            assert self._server is not None, "coordinator not started"
            return self._server.server_address[:2]

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every shard is settled (committed / resumed / quarantined); True
        when it happened within ``timeout``. A settled wait also runs the quarantine
        feature sweep, so disk reconciles with the table before the caller reads
        either."""
        done = self._svc.done_event.wait(timeout)
        if done:
            self._sweep_quarantined()
        return done

    def stop(self) -> None:
        self._stop_event.set()
        with self._lock:
            server = self._server
            monitor = self._monitor_thread
        if server is not None:
            server.shutdown()
            server.server_close()
        if monitor is not None:
            monitor.join(timeout=5.0)

    # ------------------------------------------------------------- protocol
    def dispatch(self, msg: dict) -> dict:
        op = msg.get("op")
        handler = {
            "hello": self._op_hello,
            "lease": self._op_lease,
            "heartbeat": self._op_heartbeat,
            "precommit": self._op_precommit,
            "commit": self._op_commit,
            "fail": self._op_fail,
            "bye": self._op_bye,
            "state": lambda m: self.state(),
        }.get(op)
        if handler is None:
            return {"ok": False, "error": f"unknown op {op!r}"}
        try:
            return handler(msg)
        except Exception as e:  # the protocol must answer, never wedge
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    def _op_hello(self, msg: dict) -> dict:
        # a fresh hello clears a prior incarnation's departure flags (stable worker ids
        # may reconnect); a drained worker stays drained
        self._svc.rejoin(str(msg.get("worker")))
        return {
            "ok": True,
            "journal_dir": self.journal.directory,
            "features_out": self.features_out,
            "data_dir": self.data_dir,
            "image_size": self.image_size,
            "batch_size": self.batch_size,
            "ttl_s": self.policy.lease_ttl_s,
            "hb_interval_s": self.policy.hb_interval_s,
            "shards": len(self._shards),
        }

    def _op_lease(self, msg: dict) -> dict:
        wid = str(msg.get("worker"))
        wait = {"shard": None, "wait_s": max(self.policy.check_interval_s, 0.05)}
        verdict, shard, epoch = self._svc.select(wid)
        if verdict == "drained":
            return {"shard": None, "drained": True}
        if verdict == "done":
            return {"shard": None, "done": True}
        if verdict != "grant":
            return wait
        # the lease fault point fires OUTSIDE the lock (latency specs sleep here); an
        # injected grant failure re-queues the shard
        try:
            with faults.shard_scope(shard.index, epoch):
                faults.fire("lease")
        except Exception as e:
            self._svc.requeue(shard)
            wait = dict(wait)
            wait["error"] = f"{type(e).__name__}: {e}"
            return wait
        if self._svc.install(shard, epoch, wid) is None:
            return wait  # committed while we were firing faults
        return {
            "shard": shard.path,
            "index": shard.index,
            "epoch": epoch,
            "ttl_s": self.policy.lease_ttl_s,
            "hb_interval_s": self.policy.hb_interval_s,
        }

    def _op_heartbeat(self, msg: dict) -> dict:
        wid = str(msg.get("worker"))
        index, epoch = int(msg.get("index", -1)), int(msg.get("epoch", -1))
        if not self._svc.heartbeat(wid, index, epoch):
            return {"ok": False, "cause": "stale_epoch"}
        return {"ok": True}

    def _op_precommit(self, msg: dict) -> dict:
        wid = str(msg.get("worker"))
        index, epoch = int(msg.get("index", -1)), int(msg.get("epoch", -1))
        with self._svc.lock:
            if self._svc.current_lease(index, epoch, wid) is None:
                self._svc.record_fence(index, wid, epoch, "precommit")
                return {"ok": False, "cause": "stale_epoch"}
            return {"ok": True}

    def _op_commit(self, msg: dict) -> dict:
        wid = str(msg.get("worker"))
        index, epoch = int(msg.get("index", -1)), int(msg.get("epoch", -1))
        entry = msg.get("entry")
        with self._svc.lock:
            if self._svc.current_lease(index, epoch, wid) is None \
                    or not isinstance(entry, dict):
                self._svc.record_fence(index, wid, epoch, "commit")
                self._invalidate_stale_marker(index, epoch)
                return {"ok": False, "cause": "stale_epoch"}
            shard, _lease = self._svc.commit(wid, index, epoch)
            shard.entry = entry
            shard.images = int(entry.get("images", 0))
            return {"ok": True}

    def _invalidate_stale_marker(self, index: int, epoch: int) -> None:
        """A stale writer that slipped a marker to disk in the precommit/commit race
        window must not leave it vouching. When the shard IS committed, the fix is a
        rewrite, not an unlink: the coordinator re-stamps the WINNER's accepted entry
        (it holds the full payload), so a committed shard always keeps a valid marker
        for crash-resume. Only an unsettled shard's stale marker is dropped."""
        if not (0 <= index < len(self._shards)):
            return
        shard = self._shards[index]
        name = os.path.basename(shard.path)
        entry = self.journal.done(name)
        if entry is None or entry.get("epoch") != epoch or epoch == shard.epoch:
            return
        if shard.status == "committed" and shard.entry is not None:
            win = shard.entry
            self.journal.record(
                name, category=win["category"], sums=win["sums"],
                images=win.get("images", 0),
                skipped_images=win.get("skipped_images", 0),
                skipped_members=win.get("skipped_members", 0),
                nonfinite_images=win.get("nonfinite_images", 0),
                attempts=win.get("attempts", 1),
                wall_s=win.get("wall_s", 0.0),
                worker=shard.worker, epoch=shard.epoch)
        else:
            self.journal.invalidate(name)

    def _op_fail(self, msg: dict) -> dict:
        wid = str(msg.get("worker"))
        index, epoch = int(msg.get("index", -1)), int(msg.get("epoch", -1))
        causes = msg.get("causes") or []
        res = self._svc.fail(wid, index, epoch, causes)
        if res["stale"]:
            return {"ok": True, "stale": True}
        return {"ok": True, "drained": res["drained"]}

    def _op_bye(self, msg: dict) -> dict:
        self._svc.bye(str(msg.get("worker")))
        return {"ok": True}

    def control_closed(self, wid: str, clean: bool) -> None:
        """The worker's control connection ended. A dirty close (no ``bye``) with
        leases held is a crashed/killed worker: reassign everything it was running at
        once."""
        self._svc.control_closed(str(wid), clean)

    # ------------------------------------------------------------- liveness
    def _sweep_quarantined(self) -> None:
        """Remove quarantined shards' feature files. The coordinator is the ONLY party
        allowed to (workers cannot tell their own stale failure from another worker's
        success). Runs OUTSIDE the protocol lock; the monitor calls it every pass and
        ``wait`` once more at settle. Best effort: feature writes are idempotent but
        unfenced, so a paused writer resuming after the sweep can recreate files; the
        journal fence keeps the TABLE exact regardless."""
        targets = self._svc.take_cleanup_targets()
        if not targets:
            return
        _save, cleanup, _sync = self._feature_sinks
        if cleanup is None:
            return
        for shard in targets:
            try:
                cleanup(os.path.basename(shard.path))
            except Exception:
                pass

    def _monitor_loop(self) -> None:
        while not self._stop_event.wait(self.policy.check_interval_s):
            if not self._svc.done_event.is_set():
                self._monitor_pass()
            self._sweep_quarantined()  # outside the protocol lock

    def _monitor_pass(self) -> None:
        self._svc.expire_pass()
        candidate = self._svc.elect_straggler()
        if candidate is None:
            return
        shard, lease = candidate
        try:
            # speculative duplicate election: its own fault point, fired outside the
            # lock (latency specs sleep)
            with faults.shard_scope(shard.index, lease.epoch):
                faults.fire("steal")
        except Exception:
            self._svc.veto_steal(shard)
            return
        self._svc.confirm_steal(shard, lease)

    def _write_lease(self, shard: _Shard, lease: Lease, state: str) -> None:
        """The durable lease record (atomic, not fsynced: on a coordinator crash the
        journal is the source of truth; leases only need to never be half-written)."""
        doc = {
            "schema": LEASE_SCHEMA,
            "shard": os.path.basename(shard.path),
            "index": shard.index,
            "worker": lease.worker,
            "epoch": lease.epoch,
            "granted_at": lease.granted_at,
            "expires_at": lease.expires_at,
            "hb": lease.hb,
            "state": state,
        }
        path = os.path.join(self.lease_dir, shard.stem + ".json")
        try:
            atomic_write(path, lambda f: json.dump(doc, f), fsync=False)
        except OSError:
            pass  # lease records are advisory; memory state is canonical

    # ------------------------------------------------------------- results
    def table(self) -> np.ndarray:
        """The folded (4, 5) stats table: one float64 addition per settled shard in
        shard-list order, the single-process fold, so the result is byte-identical to a
        fault-free ``run_stream``."""
        from tmr_tpu_torch.parallel.mapreduce import StatAccumulator

        acc = StatAccumulator()
        with self._svc.lock:
            for shard in self._shards:
                if shard.entry is not None and shard.status in ("committed", "resumed"):
                    acc.add_totals(shard.category, shard.entry["sums"])
        return acc.table

    def state(self) -> dict:
        """Mid-run introspection for probes and tests (NOT the report): held leases,
        live tallies, settled counts."""
        with self._svc.lock:
            return {
                "ok": True,
                "settled": self._svc.settled_count,
                "shards": len(self._shards),
                "pending": self._svc.pending_snapshot(),
                "leases": {
                    shard.index: [
                        {"worker": ls.worker, "epoch": ls.epoch, "hb": ls.hb}
                        for ls in shard.leases.values()
                    ]
                    for shard in self._shards if shard.leases
                },
                "statuses": {os.path.basename(s.path): s.status for s in self._shards},
                "reassignments": [dict(r) for r in self._svc.reassignments],
                "fenced_rejections": [dict(r) for r in self._svc.fenced],
                "workers": {
                    w.wid: {"committed": w.committed, "failed": sorted(w.failed),
                            "drained": w.drained, "dead": w.dead}
                    for w in self._svc.workers.values()
                },
            }

    def report(self) -> dict:
        """The final ``elastic_report/v1`` document (call after :meth:`wait`;
        ``diagnostics.validate_elastic_report`` checks it, including the exact totals
        reconciliation)."""
        with self._svc.lock:
            shards = [{
                "index": s.index,
                "shard": os.path.basename(s.path),
                "category": int(s.category),
                "status": s.status,
                "worker": s.worker,
                "epoch": s.epoch,
                "assignments": s.assignments,
                "failures": [dict(f) for f in s.failures],
                "images": s.images,
                "wall_s": round(s.wall_s, 6),
            } for s in self._shards]
            workers = {
                w.wid: {
                    "committed": w.committed,
                    "failed_shards": sorted(w.failed),
                    "drained": w.drained,
                    "dead": w.dead,
                } for w in self._svc.workers.values()
            }

            def count(status):
                return sum(1 for s in self._shards if s.status == status)

            totals = {
                "shards": len(self._shards),
                "committed": count("committed"),
                "resumed": count("resumed"),
                "quarantined": count("quarantined"),
                "reassignments": len(self._svc.reassignments),
                "fenced_rejections": len(self._svc.fenced),
                "workers": len(self._svc.workers),
                "drained_workers": sum(1 for w in self._svc.workers.values()
                                       if w.drained),
                "wall_s": round(self._svc.run_wall_s(), 6),
            }
            return {
                "schema": ELASTIC_REPORT_SCHEMA,
                "shards": shards,
                "workers": workers,
                "reassignments": [dict(r) for r in self._svc.reassignments],
                "fenced_rejections": [dict(r) for r in self._svc.fenced],
                "quarantined": [os.path.basename(s.path) for s in self._shards
                                if s.status == "quarantined"],
                "resumed": [os.path.basename(s.path) for s in self._shards
                            if s.status == "resumed"],
                "totals": totals,
                "metrics": obs.get_registry().snapshot(),
            }

    def write_report(self, path: str) -> dict:
        doc = self.report()
        problems = validate_elastic_report(doc)
        if problems:  # emit-then-validate: never write a broken document
            raise ValueError(f"elastic_report failed validation: {problems}")

        def dump(f):
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")

        atomic_write(path, dump)
        return doc


# ----------------------------------------------------------------- worker
class WorkerClient:
    """The worker side of the protocol: one persistent control connection for
    lease/commit/fail (serial request/response) plus fresh one-shot connections for
    heartbeats. Thread-safe: the lock serializes the control socket. The DIAL is bounded
    by ``TMR_ELASTIC_CONNECT_TIMEOUT_S`` (``leases.connect_timeout``) so a black-holed
    coordinator address fails fast; ``timeout`` bounds each exchange once connected."""

    def __init__(self, address: Tuple[str, int], worker_id: str, timeout: float = 30.0):
        _refuse_fleet_obs()
        self.address = (address[0], int(address[1]))
        self.worker_id = worker_id
        self._lock = threading.Lock()
        self._sock = socket.create_connection(
            self.address, timeout=connect_timeout(min(timeout, 5.0)))
        self._sock.settimeout(timeout)
        self._file = self._sock.makefile("rb")
        self.config = self._call({"op": "hello"})

    def _call(self, doc: dict) -> dict:
        doc = dict(doc)
        doc.setdefault("worker", self.worker_id)
        with self._lock:
            send_line(self._sock, doc)
            reply = recv_line(self._file)
        if reply is None:
            raise ConnectionError("coordinator closed the connection")
        return reply

    def lease(self) -> dict:
        return self._call({"op": "lease"})

    def heartbeat(self, index: int, epoch: int) -> dict:
        """One beat on a fresh connection (never blocks the control channel; a killed
        worker's missing beats are the liveness signal)."""
        return oneshot(self.address, {"op": "heartbeat", "worker": self.worker_id,
                                      "index": index, "epoch": epoch})

    def precommit(self, index: int, epoch: int) -> dict:
        return self._call({"op": "precommit", "index": index, "epoch": epoch})

    def commit(self, index: int, epoch: int, entry: dict) -> dict:
        return self._call({"op": "commit", "index": index, "epoch": epoch,
                           "entry": entry})

    def fail(self, index: int, epoch: int, causes: List[dict]) -> dict:
        return self._call({"op": "fail", "index": index, "epoch": epoch,
                           "causes": causes})

    def close(self) -> None:
        with self._lock:
            try:
                send_line(self._sock, {"op": "bye", "worker": self.worker_id})
                self._file.readline()
            except OSError:
                pass
            try:
                self._file.close()
                self._sock.close()
            except OSError:
                pass


class LeasedJournal(ShardJournal):
    """ShardJournal whose every commit is fenced on the worker's CURRENT lease epoch:
    ``record`` round-trips a precommit to the coordinator and raises
    :class:`StaleLeaseError` when the epoch was revoked, before any marker byte touches
    disk."""

    def __init__(self, directory: str, client: WorkerClient):
        super().__init__(directory)
        self._client = client
        self._fence_lock = threading.Lock()
        self._index: Optional[int] = None
        self._epoch: Optional[int] = None

    def set_lease(self, index: int, epoch: int) -> None:
        with self._fence_lock:
            self._index, self._epoch = index, epoch

    def record(self, shard_name, *args, **kw):
        with self._fence_lock:
            index, epoch = self._index, self._epoch

        def fence():
            reply = self._client.precommit(index, epoch)
            if not reply.get("ok"):
                raise StaleLeaseError(
                    f"lease for shard {shard_name!r} epoch {epoch} was revoked "
                    f"({reply.get('cause', 'stale_epoch')}) — commit fenced")

        kw.setdefault("worker", self._client.worker_id)
        kw.setdefault("epoch", epoch)
        kw.setdefault("fence", fence)
        return super().record(shard_name, *args, **kw)

    def invalidate(self, shard_name: str) -> None:
        """No-op ON PURPOSE: marker-invalidation authority stays with the coordinator.
        The executor invalidates on local quarantine, but a worker quarantined by the
        fence CANNOT tell its own stale failure from another worker's success, so
        letting it unlink the marker would delete the winner's valid commit (the same
        reason workers get ``cleanup_features=None``)."""


#: numpy's float32 ``x / 255`` for each uint8 value: the quotients the JAX package's
#: loader hands its encoder and the port's encoder computes on the card
_U8_SCALE = np.arange(256, dtype=np.float32) / np.float32(255.0)


def stub_encode_stats_fn(delay_s: float = 0.0, slow_shards: Sequence[str] = (),
                         slow_delay_s: float = 0.0,
                         fail_shards: Sequence[str] = ()) -> Callable:
    """A numpy encoder stand-in (no model, no device): the uint8 images as float32 ``x /
    255`` (the quotients the JAX package's loader hands its stub), 4x-decimated, minus
    0.5, as 'features', plus the exact feature-stats math in float32 numpy; returned as
    CPU tensors, as the executor takes them. Deterministic, and the JAX package's stub
    bit for bit, so a single-process run and any elastic run over the same shards, in
    either package, give byte-identical tables. ``delay_s`` sleeps per batch (paces
    shards so kills/stalls land mid-shard); ``slow_shards``/``fail_shards`` match on
    substrings of the current shard, set by the worker loop via the returned fn's
    ``context`` attribute."""
    import torch

    def encode(images):
        shard = getattr(encode, "context", "")
        if any(s in shard for s in fail_shards):
            raise RuntimeError(f"stub encoder poisoned for {shard!r}")
        d = delay_s + (slow_delay_s if any(s in shard for s in slow_shards) else 0.0)
        if d:
            time.sleep(d)
        feats = _U8_SCALE[np.asarray(images, np.uint8)][:, ::4, ::4, :] - 0.5
        b = feats.shape[0]
        flat = feats.reshape(b, -1)
        mean = flat.mean(axis=1)
        std = np.sqrt(((flat - mean[:, None]) ** 2).mean(axis=1))
        mx = flat.max(axis=1)
        spar = (flat <= 0).mean(axis=1)
        stats = np.stack([mean, std, mx, spar], axis=1)
        return torch.from_numpy(np.ascontiguousarray(feats)), torch.from_numpy(stats)

    encode.context = ""
    return encode


def run_worker(
    address: Tuple[str, int],
    worker_id: str,
    encode_stats_fn: Callable,
    *,
    retry=None,
    hb_path: Optional[str] = None,
    batch_size: Optional[int] = None,
    image_size: Optional[int] = None,
    features_out: Optional[str] = None,
    max_idle_s: float = 60.0,
) -> dict:
    """One worker's whole life: hello, then lease → run the shard through the unchanged
    ``_run_stream_impl`` attempt machinery → fenced commit (or fail report) → release,
    until the coordinator says done (or drains us). Returns a summary dict.

    The lease is heartbeated by an ``obs.flight.Heartbeat`` whose emit callable sends
    the beat (and logs it to ``hb_path`` JSONL when given); the ``heartbeat`` fault
    point fires inside emit, so an injected latency stalls beats exactly like a SIGSTOP
    would. An encoder that raises (a kernel that fails to build or launch) fails the
    attempt like any other exception: retried, then reported with its causes."""
    from tmr_tpu_torch.obs.flight import Heartbeat
    from tmr_tpu_torch.parallel.mapreduce import (
        MapReport,
        RetryPolicy,
        _load_shard_python,
        _run_stream_impl,
        make_feature_sinks,
    )
    from tmr_tpu_torch.utils.profiling import log_progress, log_warning

    client = WorkerClient(address, worker_id)
    cfg = client.config
    journal = LeasedJournal(cfg["journal_dir"], client)
    feat_dir = features_out if features_out is not None else cfg.get("features_out")
    # cleanup authority stays with the COORDINATOR: a worker whose local attempt
    # quarantines (a stale fence included) must never delete feature files another
    # worker may have just committed
    save, _cleanup_unused, sync = make_feature_sinks(feat_dir)
    batch = int(batch_size or cfg.get("batch_size") or 8)
    size = int(image_size or cfg.get("image_size") or 1024)
    hb_interval = float(cfg.get("hb_interval_s") or 2.5)
    retry = retry or RetryPolicy()
    summary = {"worker": worker_id, "committed": 0, "failed": 0, "fenced": 0,
               "leases": 0, "drained": False}
    idle_since: Optional[float] = None
    try:
        while True:
            try:
                grant = client.lease()
            except (ConnectionError, OSError) as e:
                # coordinator gone (the run settled and it exited, or it crashed): a
                # worker outliving it is normal, not fatal
                log_warning(f"elastic worker {worker_id}: coordinator unreachable "
                            f"({e}); exiting")
                break
            if grant.get("done") or grant.get("drained"):
                summary["drained"] = bool(grant.get("drained"))
                break
            if grant.get("shard") is None:
                if idle_since is None:
                    idle_since = time.monotonic()
                elif time.monotonic() - idle_since > max_idle_s:
                    log_warning(f"elastic worker {worker_id}: idle past {max_idle_s}s "
                                "with the run unfinished; exiting")
                    break
                time.sleep(float(grant.get("wait_s", 0.2)))
                continue
            idle_since = None
            summary["leases"] += 1
            path = grant["shard"]
            index, epoch = int(grant["index"]), int(grant["epoch"])
            shard_base = os.path.basename(path)
            journal.set_lease(index, epoch)
            if hasattr(encode_stats_fn, "context"):
                encode_stats_fn.context = shard_base

            def emit(index=index, epoch=epoch, shard=shard_base):
                with faults.shard_scope(index, epoch):
                    faults.fire("heartbeat")
                reply = client.heartbeat(index, epoch)
                return {"worker": worker_id, "shard": shard, "epoch": epoch,
                        "ok": bool(reply.get("ok"))}

            hb = Heartbeat(
                emit,
                hb_path or os.path.join(journal.directory, "_leases",
                                        f"hb_{worker_id}.jsonl"),
                interval_s=hb_interval)
            report = MapReport()
            try:
                _run_stream_impl(
                    [path], encode_stats_fn, batch, size, save,
                    1, _load_shard_python, retry, journal, False, report,
                    cleanup_features=None, sync_features=sync)
            finally:
                hb.stop(timeout=hb_interval + 5.0)
            rec = report.document()["shards"][0]
            if rec["status"] == "ok":
                entry = journal.done(shard_base)
                try:
                    reply = client.commit(index, epoch, entry)
                except (ConnectionError, OSError) as e:
                    log_warning(f"elastic worker {worker_id}: coordinator unreachable "
                                f"at commit ({e}); exiting")
                    break
                if reply.get("ok"):
                    summary["committed"] += 1
                    log_progress(f"elastic worker {worker_id}: committed {shard_base} "
                                 f"(epoch {epoch})")
                else:
                    summary["fenced"] += 1  # lost the commit race
            elif any("StaleLeaseError" in str(c.get("error", ""))
                     for c in rec["causes"]):
                # fenced at precommit: the coordinator already counted the rejection
                # and reassigned; nothing to report
                summary["fenced"] += 1
                log_progress(f"elastic worker {worker_id}: fenced off {shard_base} "
                             f"(epoch {epoch}); moving on")
            else:
                summary["failed"] += 1
                try:
                    client.fail(index, epoch, rec["causes"])
                except (ConnectionError, OSError) as e:
                    log_warning(f"elastic worker {worker_id}: coordinator unreachable "
                                f"at fail report ({e}); exiting")
                    break
    finally:
        client.close()
    return summary
