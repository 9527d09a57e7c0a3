"""The port's lease service (``tmr_tpu_torch.parallel.leases``) against
``tmr_tpu.parallel.leases`` on the same scripted sequences.

Each script drives both ``LeaseService``s through the same calls with ``time.monotonic``
replaced, in both modules alike, by one stepped clock; the return values, the transition
hook's calls, the ``obs`` counters each package recorded, the reassignment and fence
records, ``holder()``, ``pending_snapshot()``, ``settled_count``, ``live_workers()`` and
every resource's and worker's fields must be equal, exactly (no tolerance: the same
integer and float operations on the same clock readings).
"""

import itertools
import types

import pytest

import tmr_tpu.parallel.leases as jleases
from tmr_tpu import obs as jobs
from tmr_tpu_torch import obs as pobs
from tmr_tpu_torch.parallel import leases as pleases

_PREFIX = itertools.count()


class _Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t


def _norm(v):
    """Return values as plain data: resources and leases by their fields."""
    if isinstance(v, (jleases.Resource, pleases.Resource)):
        return ("resource", v.index, v.key, v.status)
    if isinstance(v, (jleases.Lease, pleases.Lease)):
        return ("lease", v.worker, v.epoch, v.granted_at, v.expires_at, v.hb)
    if isinstance(v, (jleases.WorkerRecord, pleases.WorkerRecord)):
        return ("worker", v.wid, v.committed, sorted(v.failed), v.drained, v.dead, v.bye)
    if isinstance(v, (tuple, list)):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    return v


def _counters(mod, prefix):
    reg = (jobs if mod is jleases else pobs).get_registry()
    return {k: v for k, v in reg.snapshot()["counters"].items()
            if k.startswith(prefix + ".")}


def _drive(mod, monkeypatch, n, policy, script, prefix):
    clock = _Clock()
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=clock.monotonic))
    transitions = []
    svc = mod.LeaseService(
        [mod.Resource(i, f"r{i}.tar") for i in range(n)], mod.LeasePolicy(**policy),
        metrics_prefix=prefix, noun="shard", key_field="shard",
        on_transition=lambda r, ls, s: transitions.append((r.index, ls.worker, ls.epoch,
                                                           s)))
    out = []
    for op, *args in script:
        if op == "tick":
            clock.t += args[0]
            continue
        if op == "grant":  # select, then install (or requeue when asked)
            verdict, res, epoch = svc.select(args[0])
            got = [verdict, _norm(res), epoch]
            if verdict == "grant":
                got.append(_norm(svc.requeue(res) if args[1:] == ["requeue"]
                                 else svc.install(res, epoch, args[0])))
            out.append(got)
        elif op == "steal":  # elect, then confirm or veto
            cand = svc.elect_straggler()
            out.append(_norm(cand))
            if cand is not None:
                (svc.confirm_steal(*cand) if args[0] == "confirm"
                 else svc.veto_steal(cand[0]))
        elif op == "install_settled":  # a grant whose resource settled meanwhile
            verdict, res, epoch = svc.select(args[0])
            out.append([verdict, _norm(res), epoch])
            svc.mark_resumed(res.index)
            out.append(_norm(svc.install(res, epoch, args[0])))
        else:
            out.append(_norm(getattr(svc, op)(*args)))
    state = {
        "out": out,
        "transitions": transitions,
        "reassignments": svc.reassignments,
        "fenced": svc.fenced,
        "holders": [svc.holder(i) for i in range(-1, n + 1)],
        "pending": svc.pending_snapshot(),
        "settled": svc.settled_count,
        "live": svc.live_workers(),
        "done": svc.done_event.is_set(),
        "wall": svc.run_wall_s(),
        "resources": [
            {k: (sorted(getattr(r, k)) if k == "failed_workers" else
                 _norm(getattr(r, k))) for k in jleases.Resource.__slots__}
            for r in svc.resources],
        "workers": {w: _norm(rec) for w, rec in svc.workers.items()},
        "counters": _counters(mod, prefix),
    }
    return state


def _both(monkeypatch, n, policy, script):
    prefix = f"leasetest{next(_PREFIX)}"
    got = {tag: _drive(mod, monkeypatch, n, policy, script, f"{prefix}{tag}")
           for tag, mod in (("j", jleases), ("p", pleases))}
    got["j"]["counters"] = {k.replace(f"{prefix}j.", ""): v
                            for k, v in got["j"]["counters"].items()}
    got["p"]["counters"] = {k.replace(f"{prefix}p.", ""): v
                            for k, v in got["p"]["counters"].items()}
    assert got["p"] == got["j"]
    return got["p"]


def test_grants_heartbeats_expiry_and_worker_exit(monkeypatch):
    script = [
        ("rejoin", "w0"), ("rejoin", "w1"),
        ("grant", "w0"), ("grant", "w1"), ("grant", "w2", "requeue"),
        ("tick", 4.0), ("heartbeat", "w0", 0, 1), ("heartbeat", "w1", 1, 1),
        ("heartbeat", "w1", 0, 1), ("heartbeat", "w0", 0, 7), ("heartbeat", "w0", 9, 1),
        ("current_lease", 0, 1, "w0"), ("current_lease", 5, 1, "w0"),
        ("tick", 11.0), ("heartbeat", "w0", 0, 1), ("expire_pass",),  # w1 went stale
        ("tick", 2.0), ("control_closed", "w0", False),  # w0 dies holding r0
        ("commit", "w1", 1, 1),  # stale epoch: fenced
        ("record_fence", 7, "w1", 1, "precommit"),
        ("grant", "w2"), ("grant", "w3"), ("grant", "w2"),
        ("tick", 1.5), ("commit", "w2", 0, 2), ("commit", "w3", 1, 2),
        ("grant", "w2"), ("grant", "w3"), ("tick", 0.5),
        ("commit", "w3", 3, 1),  # w2 holds r3: fenced
        ("commit", "w2", 2, 2), ("commit", "w2", 3, 1), ("grant", "w3"),
        ("bye", "w3"), ("control_closed", "w3", True), ("control_closed", "w2", False),
    ]
    state = _both(monkeypatch, 4, dict(lease_ttl_s=10.0), script)
    assert [r["cause"] for r in state["reassignments"]] == ["stale_heartbeat",
                                                             "worker_exit"]
    assert state["settled"] == 4 and state["done"]
    assert state["counters"]["shards_committed"] == 4
    assert state["fenced"][0]["op"] == "commit"


def test_straggler_steal_confirmed_and_vetoed(monkeypatch):
    policy = dict(lease_ttl_s=100.0, straggler_factor=2.0, straggler_min_s=1.0,
                  straggler_min_done=2)
    script = [
        ("grant", "a"), ("grant", "b"), ("grant", "c"), ("grant", "d"),
        ("tick", 1.0), ("commit", "a", 0, 1), ("commit", "b", 1, 1),
        ("steal", "confirm"),  # median 1.0, bound 2.0: nobody past it yet
        ("tick", 2.5), ("steal", "veto"), ("steal", "confirm"),
        ("steal", "confirm"),  # both elected already
        ("grant", "a"),  # the duplicate of the confirmed one
        ("holder", 3), ("tick", 0.5),
        ("commit", "a", 3, 2),  # the duplicate commits first
        ("commit", "d", 3, 1),  # the original is fenced
        ("steal", "confirm"),  # the vetoed one may be elected again
        ("grant", "b"), ("tick", 0.5), ("commit", "c", 2, 1),
        ("commit", "b", 2, 2),
    ]
    state = _both(monkeypatch, 4, policy, script)
    causes = [r["cause"] for r in state["reassignments"]]
    assert causes.count("straggler") == 2
    assert state["counters"]["stragglers"] == 2
    assert [(f["worker"], f["op"]) for f in state["fenced"]] == [("d", "commit"),
                                                                ("b", "commit")]


def test_poison_drain_max_reassigns_and_quarantine(monkeypatch):
    policy = dict(lease_ttl_s=5.0, poison_failures=2, max_reassigns=2,
                  resource_fail_workers=2)
    script = [
        ("rejoin", "good"), ("rejoin", "bad"),
        ("grant", "bad"), ("fail", "bad", 0, 1, [{"cause": "exception"}]),
        ("grant", "bad"),  # skips r0, which it failed, while a peer lives: r1
        ("grant", "good"),  # r2
        ("fail", "bad", 1, 1, []),  # the second distinct failure drains "bad"
        ("grant", "bad"), ("live_workers",),
        ("grant", "good"),  # r1 again, epoch 2
        # r2 bounces past max_reassigns by stale heartbeats, r1 once
        ("tick", 6.0), ("expire_pass",),
        ("grant", "good"), ("tick", 6.0), ("expire_pass",),
        ("grant", "good"), ("tick", 6.0), ("expire_pass",),
        ("take_cleanup_targets",), ("take_cleanup_targets",),
        ("grant", "good"), ("commit", "good", 1, 3),
        ("grant", "good"), ("commit", "good", 3, 1),
        # r0 failed by a second worker: quarantined
        ("grant", "good"), ("fail", "good", 0, 2, [{"cause": "timeout"}]),
        ("fail", "good", 0, 2, []),  # stale
        ("take_cleanup_targets",),
        ("rejoin", "bad"), ("grant", "bad"),  # drained stays drained
    ]
    state = _both(monkeypatch, 4, policy, script)
    statuses = [r["status"] for r in state["resources"]]
    assert statuses == ["quarantined", "committed", "quarantined", "committed"]
    assert state["workers"]["bad"][4] is True  # drained
    assert state["counters"]["workers_drained"] == 1
    assert state["counters"]["shards_quarantined"] == 2


def test_rejoin_resume_and_install_after_settle(monkeypatch):
    script = [
        ("mark_resumed", 1, "old", 3), ("mark_resumed", 1),
        ("rejoin", "w0"), ("grant", "w0"), ("control_closed", "w0", False),
        ("live_workers",), ("grant", "w1"), ("rejoin", "w0"), ("live_workers",),
        ("worker_rec", "w0"), ("grant", "w0"),
        ("install_settled", "w2"), ("commit", "w1", 0, 2),
        ("bye", "w1"), ("live_workers",), ("rejoin", "w1"), ("live_workers",),
        ("revoke_lease", 2, 1, "scale_out"), ("revoke_lease", 2, 1, "scale_out"),
        ("revoke_lease", 9, 1, "scale_out"),
        ("grant", "w1"), ("revoke_worker", "w1", "worker_exit"),
        ("grant", "w1"), ("commit", "w1", 2, 3), ("grant", "w0"),
        ("restart_clock",), ("tick", 0.25), ("commit", "w0", 3, 1), ("grant", "w0"),
    ]
    state = _both(monkeypatch, 4, dict(lease_ttl_s=10.0), script)
    assert state["done"] and state["settled"] == 4
    assert [r["status"] for r in state["resources"]] == ["committed", "resumed",
                                                         "committed", "resumed"]
    assert [r["cause"] for r in state["reassignments"]] == ["worker_exit", "scale_out",
                                                             "worker_exit"]
    assert state["live"] == ["w0", "w1", "w2"]


def test_duplicate_keys_and_env_policy_match(monkeypatch):
    for mod in (jleases, pleases):
        with pytest.raises(ValueError, match="duplicate"):
            mod.LeaseService([mod.Resource(0, "a"), mod.Resource(1, "a")])
    monkeypatch.setenv("TMR_ELASTIC_TTL_S", "8")
    monkeypatch.setenv("TMR_ELASTIC_MAX_REASSIGNS", "junk")
    monkeypatch.setenv("TMR_ELASTIC_CONNECT_TIMEOUT_S", "0.01")
    assert pleases.LeasePolicy.from_env(poison_failures=9) == \
        pleases.LeasePolicy(**vars(jleases.LeasePolicy.from_env(poison_failures=9)))
    assert pleases.connect_timeout() == jleases.connect_timeout() == 0.05
    assert pleases.REASSIGN_CAUSES == jleases.REASSIGN_CAUSES
