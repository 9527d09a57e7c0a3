"""The port's elastic map phase (``tmr_tpu_torch.parallel.elastic``,
``tmr_tpu_torch.elastic_map``) on the numpy stub encoder and the TINY SAM encoder, against
itself and against ``tmr_tpu.parallel.elastic``.

Every scenario of ``tests/test_elastic.py`` runs against the port: byte-identical tables
across worker counts, dead-worker (``worker_exit``) reassignment, stale-heartbeat
revocation with journal fencing, straggler duplicate leases with first-commit-wins, the
poison-worker drain, the journal's worker/epoch fields, resume, the stale-marker race,
fault-point parity, the ``elastic_report/v1`` validator, the bounded dial and an
unknown op. Across packages (one protocol): port workers against a JAX coordinator and
JAX workers against the port's give the same table bytes, journal markers and
``_leases/*.json`` records; the stub tables equal the JAX elastic run's byte for byte;
the TINY encoder through ``run_worker`` equals the port's own ``run_stream`` byte for
byte and the JAX elastic run within ``test_torch_mapreduce``'s f32 bound (1e-4 x the
largest |value|, counts exact). Liveness cases are driven by fault points
(``heartbeat:latency=...``), not by sleeps racing a TTL; every wait has its own timeout.
"""

import io
import json
import os
import re
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tmr_tpu.diagnostics as jdiag  # noqa: E402
import tmr_tpu.parallel.elastic as jel  # noqa: E402
import tmr_tpu.parallel.mapreduce as jmr  # noqa: E402
from tmr_tpu.models.vit import SamViT as JSamViT  # noqa: E402
from tmr_tpu.utils import faults as jfaults  # noqa: E402
from tmr_tpu_torch import elastic_map  # noqa: E402
from tmr_tpu_torch.chaos_probe import make_tar  # noqa: E402
from tmr_tpu_torch.diagnostics import (  # noqa: E402
    ELASTIC_REASSIGN_CAUSES,
    validate_elastic_report,
)
from tmr_tpu_torch.models.vit import SamViT  # noqa: E402
from tmr_tpu_torch.parallel import elastic  # noqa: E402
from tmr_tpu_torch.parallel import mapreduce as mr  # noqa: E402
from tmr_tpu_torch.parallel.journal import ShardJournal, StaleLeaseError  # noqa: E402
from tmr_tpu_torch.utils import faults  # noqa: E402
from tmr_tpu_torch.utils.weights import params_from_jax  # noqa: E402

SIZE = 16
REPO = Path(__file__).resolve().parent.parent
TINY = dict(embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,), window_size=2,
            out_chans=8, pretrain_img_size=32)
TINY_SIZE = 32
TINY_TOL = 1e-4  # test_torch_mapreduce's f32 bound, relative to the largest |value|
#: lease-record fields that hold clock readings (each coordinator's own monotonic clock)
_CLOCK_FIELDS = ("granted_at", "expires_at", "hb")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _clean_schedules():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture
def shards(tmp_path):
    return [make_tar(str(tmp_path), name, n, seed, side=20)
            for seed, (name, n) in enumerate((("Easy_0.tar", 3), ("Easy_1.tar", 4),
                                              ("Normal_0.tar", 2), ("Normal_1.tar", 3),
                                              ("Hard_0.tar", 2)))]


def _fast_policy(mod=elastic, **kw):
    kw.setdefault("lease_ttl_s", 0.6)
    kw.setdefault("hb_interval_s", 0.15)
    kw.setdefault("check_interval_s", 0.05)
    kw.setdefault("straggler_factor", 0.0)
    return mod.ElasticPolicy(**kw)


def _fast_retry(mod=mr, **kw):
    kw.setdefault("max_attempts", 2)
    kw.setdefault("backoff_base", 0.01)
    kw.setdefault("backoff_jitter", 0.0)
    return mod.RetryPolicy(**kw)


def _ref_table(shards):
    return mr.reducer_table(mr.run_stream(shards, elastic.stub_encode_stats_fn(),
                                          batch_size=2, image_size=SIZE).table)


def _coordinator(shards, tmp_path, mod=elastic, size=SIZE, **kw):
    kw.setdefault("policy", _fast_policy(mod))
    coord = mod.ElasticCoordinator(shards, str(tmp_path / "_journal"), image_size=size,
                                   batch_size=2, **kw)
    coord.start()
    return coord


def _start_worker(coord, wid, fn=None, mod=elastic, **kw):
    kw.setdefault("retry", _fast_retry(jmr if mod is jel else mr))
    kw.setdefault("max_idle_s", 15.0)
    t = threading.Thread(target=mod.run_worker,
                         args=(coord.address, wid, fn or mod.stub_encode_stats_fn()),
                         kwargs=kw, daemon=True)
    t.start()
    return t


def _poll(predicate, timeout_s=10.0, interval_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(interval_s)
    return predicate()


def _finish(coord, threads, timeout=30.0, validate=validate_elastic_report):
    assert coord.wait(timeout=timeout), "elastic run did not settle"
    for t in threads:
        t.join(timeout=15.0)
        assert not t.is_alive(), "a worker thread did not finish"
    doc = coord.report()
    table = coord.table()
    coord.stop()
    assert validate(doc) == []
    return doc, table


# ------------------------------------------------------------- happy path
def test_elastic_two_workers_byte_identical_table(shards, tmp_path):
    ref = _ref_table(shards)
    coord = _coordinator(shards, tmp_path)
    threads = [_start_worker(coord, f"w{i}") for i in range(2)]
    doc, table = _finish(coord, threads)
    assert mr.reducer_table(table) == ref
    t = doc["totals"]
    assert t["committed"] == len(shards) and t["quarantined"] == 0
    assert sum(w["committed"] for w in doc["workers"].values()) == len(shards)
    assert all(s["status"] == "committed" and s["worker"] for s in doc["shards"])
    assert doc["metrics"]["counters"]["elastic.shards_committed"] >= len(shards)


# -------------------------------------------------- dead worker (kill -9)
def test_dead_worker_lease_reassigned_worker_exit(shards, tmp_path):
    ref = _ref_table(shards)
    coord = _coordinator(shards, tmp_path)
    # a worker that leases a shard and dies without a word: a dirty socket close while
    # the lease is held, the kill -9 signature
    fake = elastic.WorkerClient(coord.address, "casualty")
    grant = fake.lease()
    assert grant["shard"] is not None
    fake._sock.shutdown(socket.SHUT_RDWR)
    fake._sock.close()
    assert _poll(lambda: any(r["cause"] == "worker_exit" and r["index"] == grant["index"]
                             for r in coord.state()["reassignments"])), \
        "dirty disconnect did not trigger worker_exit reassignment"
    doc, table = _finish(coord, [_start_worker(coord, "survivor")])
    assert mr.reducer_table(table) == ref
    rec = doc["shards"][grant["index"]]
    assert rec["status"] == "committed" and rec["worker"] == "survivor"
    assert rec["epoch"] > grant["epoch"]  # re-run under a higher epoch
    assert doc["workers"]["casualty"]["dead"] is True


# ------------------------------------- stale heartbeat + journal fencing
def test_stale_heartbeat_revokes_and_fences_commit(shards, tmp_path):
    ref = _ref_table(shards)
    coord = _coordinator(shards, tmp_path)
    fake = elastic.WorkerClient(coord.address, "paused")
    grant = fake.lease()
    assert grant["shard"] is not None
    fake.heartbeat(grant["index"], grant["epoch"])
    # the paused worker never beats again: revoked once the TTL passes
    assert _poll(lambda: any(r["cause"] == "stale_heartbeat"
                             and r["index"] == grant["index"]
                             for r in coord.state()["reassignments"]), timeout_s=5.0)
    # the paused worker resumes and tries to commit: the fenced journal must reject
    # BEFORE any marker byte lands
    journal = elastic.LeasedJournal(str(tmp_path / "_journal"), fake)
    journal.set_lease(grant["index"], grant["epoch"])
    shard_base = os.path.basename(grant["shard"])
    with pytest.raises(StaleLeaseError):
        journal.record(shard_base, category=0, sums=[1.0] * 5, images=3)
    assert journal.done(shard_base) is None
    doc, table = _finish(coord, [_start_worker(coord, "healthy")])
    assert mr.reducer_table(table) == ref
    assert doc["totals"]["fenced_rejections"] >= 1
    assert any(r["op"] == "precommit" and r["worker"] == "paused"
               for r in doc["fenced_rejections"])
    # a stale worker's local quarantine calls journal.invalidate, which on a
    # LeasedJournal must be a no-op, or the loser would unlink the WINNER's marker
    assert journal.done(shard_base) is not None
    journal.invalidate(shard_base)
    assert journal.done(shard_base) is not None
    fake.close()


def test_heartbeat_fault_stalls_a_worker_into_a_fenced_commit(shards, tmp_path):
    """The in-process SIGSTOP stand-in: shard 0's first holder stalls its beats past the
    TTL through the ``heartbeat`` fault point; its lease is revoked, its commit fenced,
    and the table stays exact."""
    ref = _ref_table(shards)
    faults.configure("heartbeat:shard=0:attempts=2:latency=1.6")
    coord = _coordinator(shards, tmp_path)
    slow = elastic.stub_encode_stats_fn(slow_shards=("Easy_0",), slow_delay_s=0.5)
    threads = [_start_worker(coord, "t0", fn=slow)]
    assert _poll(lambda: 0 in coord.state()["leases"], timeout_s=10.0)
    threads.append(_start_worker(coord, "t1"))
    doc, table = _finish(coord, threads)
    assert mr.reducer_table(table) == ref
    assert ("heartbeat", "latency") in {(f["point"], f["action"])
                                        for f in faults.fired()}
    assert any(r["index"] == 0 and r["cause"] == "stale_heartbeat" and r["worker"] == "t0"
               for r in doc["reassignments"])
    assert any(r["worker"] == "t0" and r["index"] == 0 for r in doc["fenced_rejections"])
    assert doc["shards"][0]["epoch"] >= 2


# ------------------------------------- straggler: first committed wins
def test_straggler_duplicate_lease_first_commit_wins(shards, tmp_path):
    ref = _ref_table(shards)
    coord = _coordinator(shards, tmp_path, policy=_fast_policy(
        straggler_factor=2.0, straggler_min_s=0.25, straggler_min_done=2))
    # the slow worker starts alone so it owns Easy_0, then stalls on it
    slow = _start_worker(coord, "slow", fn=elastic.stub_encode_stats_fn(
        slow_shards=("Easy_0",), slow_delay_s=1.2))
    assert _poll(lambda: 0 in coord.state()["leases"]), "slow worker never leased Easy_0"
    fast = _start_worker(coord, "fast")
    doc, table = _finish(coord, [slow, fast])
    assert mr.reducer_table(table) == ref
    dup = [r for r in doc["reassignments"] if r["cause"] == "straggler"]
    assert dup and dup[0]["shard"] == "Easy_0.tar"
    rec = doc["shards"][0]
    assert rec["status"] == "committed" and rec["worker"] == "fast"
    assert any(r["worker"] == "slow" for r in doc["fenced_rejections"])
    assert doc["totals"]["committed"] == len(shards)


def test_steal_fault_vetoes_the_election(shards, tmp_path):
    faults.configure("steal:shard=0:raise=RuntimeError")
    coord = _coordinator(shards, tmp_path, policy=_fast_policy(
        straggler_factor=2.0, straggler_min_s=0.25, straggler_min_done=2))
    slow = _start_worker(coord, "slow", fn=elastic.stub_encode_stats_fn(
        slow_shards=("Easy_0",), slow_delay_s=1.2))
    assert _poll(lambda: 0 in coord.state()["leases"])
    doc, table = _finish(coord, [slow, _start_worker(coord, "fast")])
    assert mr.reducer_table(table) == _ref_table(shards)
    assert ("steal", "raise") in {(f["point"], f["action"]) for f in faults.fired()}
    assert not [r for r in doc["reassignments"] if r["cause"] == "straggler"]
    assert doc["shards"][0]["worker"] == "slow"


# ----------------------------------------------- poison worker drained
def test_poison_worker_drained_and_shards_redistributed(shards, tmp_path):
    ref = _ref_table(shards)
    coord = _coordinator(shards, tmp_path, policy=_fast_policy(poison_failures=2))
    # pace the healthy worker (~0.2 s a shard) so that the instantly failing poison
    # worker reaches its second distinct failure while work remains
    healthy = _start_worker(coord, "healthy", fn=elastic.stub_encode_stats_fn(
        slow_shards=(".tar",), slow_delay_s=0.2))
    assert _poll(lambda: "healthy" in coord.state()["workers"])
    poison = _start_worker(coord, "poison",
                           fn=elastic.stub_encode_stats_fn(fail_shards=(".tar",)),
                           retry=_fast_retry(max_attempts=1))
    doc, table = _finish(coord, [healthy, poison])
    assert mr.reducer_table(table) == ref
    assert doc["workers"]["poison"]["drained"] is True
    assert doc["totals"]["drained_workers"] == 1
    assert len([r for r in doc["reassignments"] if r["cause"] == "poison_worker"]) >= 2
    assert doc["totals"]["committed"] == len(shards)
    assert doc["workers"]["healthy"]["committed"] == len(shards)


def test_lease_fault_requeues_the_grant(shards, tmp_path):
    faults.configure("lease:shard=1:attempts=2:raise=OSError")
    coord = _coordinator(shards, tmp_path)
    doc, table = _finish(coord, [_start_worker(coord, "w0")])
    assert mr.reducer_table(table) == _ref_table(shards)
    assert ("lease", "raise") in {(f["point"], f["action"]) for f in faults.fired()}
    assert doc["shards"][1]["epoch"] == 2 and doc["shards"][1]["assignments"] == 1


# --------------------------------------------------- journal satellites
def test_journal_worker_epoch_fields_roundtrip_and_backcompat(tmp_path):
    journal = ShardJournal(str(tmp_path))
    journal.record("Easy_0.tar", category=0, sums=[1, 2, 3, 4, 5], images=5,
                   worker="w0", epoch=3)
    entry = journal.done("Easy_0.tar")
    assert entry is not None and entry["worker"] == "w0" and entry["epoch"] == 3
    journal.record("Easy_1.tar", category=0, sums=[1, 1, 1, 1, 2], images=2)
    old = journal.done("Easy_1.tar")
    assert old is not None and "worker" not in old and "epoch" not in old


def test_journal_markers_are_the_jax_bytes_with_worker_and_epoch(tmp_path):
    """A marker the port writes with worker/epoch is the JAX marker byte for byte, and
    each package reads the other's."""
    from tmr_tpu.parallel.journal import ShardJournal as JShardJournal

    kw = dict(category=1, sums=[0.1, 0.2, 0.30000000000000004, 1e-300, 7.0], images=7,
              skipped_images=1, skipped_members=2, nonfinite_images=3, attempts=2,
              wall_s=0.125, worker="host-12", epoch=4)
    ShardJournal(str(tmp_path / "p")).record("Normal_3.tar", **kw)
    JShardJournal(str(tmp_path / "j")).record("Normal_3.tar", **kw)
    assert (tmp_path / "p" / "Normal_3.json").read_bytes() == \
        (tmp_path / "j" / "Normal_3.json").read_bytes()
    assert JShardJournal(str(tmp_path / "p")).done("Normal_3.tar")["epoch"] == 4
    assert ShardJournal(str(tmp_path / "j")).done("Normal_3.tar")["worker"] == "host-12"


def test_stale_epoch_commit_rejected_leaves_no_marker(tmp_path):
    journal = ShardJournal(str(tmp_path))
    calls = []

    def fence():
        calls.append(faults.fired())
        raise StaleLeaseError("epoch 1 revoked")

    faults.configure("journal:latency=0.001")
    with pytest.raises(StaleLeaseError):
        journal.record("Easy_0.tar", category=0, sums=[1] * 5, images=3, worker="w0",
                       epoch=1, fence=fence)
    assert journal.done("Easy_0.tar") is None
    assert os.listdir(str(tmp_path)) == []  # not even a tmp file
    # the fence ran after the journal fault point
    assert [f["point"] for f in calls[0]] == ["journal"]


def test_coordinator_resume_folds_old_markers_unchanged(shards, tmp_path):
    ref = _ref_table(shards)
    journal_dir = str(tmp_path / "_journal")
    # every shard journaled in the single-host marker format (no worker/epoch)
    acc = mr.run_stream(shards, elastic.stub_encode_stats_fn(), batch_size=2,
                        image_size=SIZE, journal=ShardJournal(journal_dir))
    assert mr.reducer_table(acc.table) == ref
    coord = elastic.ElasticCoordinator(shards, journal_dir, image_size=SIZE, batch_size=2,
                                       resume=True, policy=_fast_policy())
    coord.start()
    assert coord.wait(timeout=5.0)  # settles with zero workers
    doc = coord.report()
    table = coord.table()
    coord.stop()
    assert validate_elastic_report(doc) == []
    assert mr.reducer_table(table) == ref
    assert doc["totals"]["resumed"] == len(shards) and doc["totals"]["committed"] == 0


def test_resume_after_a_cut_reencodes_only_unmarked_shards(shards, tmp_path):
    """A coordinator cut after some commits, then ``resume=True`` with one worker: the
    table is byte-identical and only the shards without a marker are leased again."""
    ref = _ref_table(shards)
    coord = _coordinator(shards, tmp_path)
    fake = elastic.WorkerClient(coord.address, "early")
    for _ in range(2):  # two commits through the real worker protocol
        grant = fake.lease()
        journal = elastic.LeasedJournal(str(tmp_path / "_journal"), fake)
        journal.set_lease(grant["index"], grant["epoch"])
        acc = mr.run_stream([grant["shard"]], elastic.stub_encode_stats_fn(), 2, SIZE,
                            journal=journal)
        assert fake.commit(grant["index"], grant["epoch"],
                           journal.done(os.path.basename(grant["shard"])))["ok"]
        assert acc.table[:, 4].sum() > 0
    fake.close()
    coord.stop()  # the cut
    seen = []
    fn = elastic.stub_encode_stats_fn()

    def encode(images):  # run_worker sets encode.context to the leased shard
        seen.append(encode.context)
        return fn(images)

    encode.context = ""
    resumed = _coordinator(shards, tmp_path, resume=True)
    doc, table = _finish(resumed, [_start_worker(resumed, "late", fn=encode)])
    assert mr.reducer_table(table) == ref
    assert doc["resumed"] == ["Easy_0.tar", "Easy_1.tar"]
    assert sorted(set(seen)) == ["Hard_0.tar", "Normal_0.tar", "Normal_1.tar"]
    assert doc["workers"]["late"]["committed"] == 3


def test_stale_marker_race_rewrites_winner_not_unlink(shards, tmp_path):
    """The straggler commit race: the loser's marker landed on disk LAST, then its
    commit was rejected. The coordinator re-stamps the winner's marker; an unsettled
    shard's stale marker is dropped."""
    journal_dir = str(tmp_path / "_journal")
    coord = elastic.ElasticCoordinator(shards, journal_dir, image_size=SIZE, batch_size=2,
                                       policy=_fast_policy())
    shard = coord._shards[0]
    win = {"shard": "Easy_0.tar", "category": 0, "sums": [1.0, 2.0, 3.0, 4.0, 3.0],
           "images": 3, "skipped_images": 0, "skipped_members": 0,
           "nonfinite_images": 0, "attempts": 1, "wall_s": 0.1}
    shard.status = "committed"
    shard.entry = win
    shard.worker, shard.epoch = "winner", 2
    ShardJournal(journal_dir).record("Easy_0.tar", category=0, sums=win["sums"], images=3,
                                     worker="loser", epoch=1)
    coord._invalidate_stale_marker(0, 1)
    entry = coord.journal.done("Easy_0.tar")
    assert entry is not None, "committed shard lost its marker"
    assert entry["worker"] == "winner" and entry["epoch"] == 2
    shard2 = coord._shards[1]
    ShardJournal(journal_dir).record("Easy_1.tar", category=0, sums=[1] * 5, images=4,
                                     worker="loser", epoch=1)
    shard2.next_epoch = 2  # epoch 1 was revoked
    coord._invalidate_stale_marker(1, 1)
    assert coord.journal.done("Easy_1.tar") is None


# ------------------------------------------------- fault-point parity
#: the fault points of the JAX serving fleet and gallery, which the port has not
_UNPORTED_POINTS = {"fleet.route", "fleet.commit", "fleet.recruit", "serve.link",
                    "gallery.replica", "gallery.beat"}


def test_fault_point_vocabulary_matches_fire_call_sites():
    """``faults.POINTS`` is the JAX vocabulary; the port fires every point of it at a
    literal call site except the fleet's and the gallery's, and its docstring table
    names every point."""
    pattern = re.compile(r"faults\.(?:fire|corrupt_bytes|poison)\(\s*[\"']([\w.]+)[\"']")
    found = set()
    for path in (REPO / "tmr_tpu_torch").rglob("*.py"):
        found |= set(pattern.findall(path.read_text()))
    assert found == set(faults.POINTS) - _UNPORTED_POINTS
    assert faults.POINTS == jfaults.POINTS
    for point in faults.POINTS:
        assert point in (faults.__doc__ or ""), point
    for point in ("lease", "heartbeat", "steal"):
        assert "parallel/elastic" in faults.__doc__.split(f"    {point} ")[1][:40]


def test_new_fault_points_parse_and_fire():
    faults.configure("lease:shard=1:attempts=2:raise=OSError;"
                     "heartbeat:latency=0;steal:shard=0:raise=RuntimeError")
    with faults.shard_scope(1, 1):
        with pytest.raises(OSError):
            faults.fire("lease")
    with faults.shard_scope(1, 2):
        faults.fire("lease")  # epoch 2: past the attempts bound
    with faults.shard_scope(0, 1):
        with pytest.raises(RuntimeError):
            faults.fire("steal")
    assert {f["point"] for f in faults.fired()} == {"lease", "steal"}


# ---------------------------------------------------- report validator
def test_elastic_report_validator_rejects_drift():
    doc = {
        "schema": "elastic_report/v1",
        "shards": [{"index": 0, "shard": "Easy_0.tar", "status": "committed",
                    "worker": "w0", "epoch": 1, "assignments": 1, "failures": [],
                    "images": 3, "wall_s": 0.1}],
        "workers": {"w0": {"committed": 1, "failed_shards": [], "drained": False}},
        "reassignments": [], "fenced_rejections": [], "quarantined": [], "resumed": [],
        "totals": {"shards": 1, "committed": 1, "resumed": 0, "quarantined": 0,
                   "reassignments": 0, "fenced_rejections": 0, "workers": 1,
                   "drained_workers": 0, "wall_s": 0.1},
    }
    bad = dict(doc, reassignments=[{"shard": "Easy_0.tar", "worker": "w0", "epoch": 1,
                                    "cause": "cosmic_rays"}])
    bad["totals"] = dict(doc["totals"], reassignments=1)
    fleet_only = dict(doc, reassignments=[{"shard": "Easy_0.tar", "index": 0,
                                           "worker": "w0", "epoch": 1,
                                           "cause": "scale_out"}])
    fleet_only["totals"] = dict(doc["totals"], reassignments=1)
    bad2 = dict(doc, totals=dict(doc["totals"], committed=0, resumed=1))
    bad3 = dict(doc, fenced_rejections=[{"shard": "x", "worker": "w", "epoch": 1,
                                         "op": "later"}], metrics={"schema": "nope"})
    for d in (doc, bad, fleet_only, bad2, bad3, [], {"schema": "elastic_report/v1"}):
        assert validate_elastic_report(d) == jdiag.validate_elastic_report(d)
    assert validate_elastic_report(doc) == []
    assert any("bad cause" in p for p in validate_elastic_report(bad))
    assert any("bad cause" in p for p in validate_elastic_report(fleet_only))
    assert "scale_out" in ELASTIC_REASSIGN_CAUSES
    assert ELASTIC_REASSIGN_CAUSES == jdiag.ELASTIC_REASSIGN_CAUSES
    assert any("committed" in p for p in validate_elastic_report(bad2))
    assert any("metrics" in p for p in validate_elastic_report(bad3))


def test_connect_timeout_bounds_every_dial(monkeypatch):
    """The protocol dial is bounded by TMR_ELASTIC_CONNECT_TIMEOUT_S: a refused port
    errors fast, and every dial (the control connection, a one-shot beat) passes the
    knob's bound to the connect, never the OS default."""
    monkeypatch.setenv("TMR_ELASTIC_CONNECT_TIMEOUT_S", "0.5")
    assert elastic.connect_timeout() == 0.5
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    t0 = time.monotonic()
    with pytest.raises(OSError):
        elastic.WorkerClient(("127.0.0.1", port), "nobody")
    assert time.monotonic() - t0 < 3.0
    dials = []

    def dial(address, timeout=None):
        dials.append(timeout)
        raise TimeoutError("timed out")

    from tmr_tpu_torch.parallel import leases

    monkeypatch.setattr(leases.socket, "create_connection", dial)
    with pytest.raises(OSError):
        elastic.oneshot(("127.0.0.1", port), {"op": "heartbeat"}, timeout=30.0)
    with pytest.raises(OSError):
        elastic.WorkerClient(("127.0.0.1", port), "nobody", timeout=30.0)
    assert dials == [0.5, 0.5]


def test_worker_client_refuses_unknown_op(shards, tmp_path):
    coord = _coordinator(shards[:1], tmp_path)
    fake = elastic.WorkerClient(coord.address, "probe")
    assert fake._call({"op": "frobnicate"})["ok"] is False
    assert fake._call({"op": "state"})["shards"] == 1
    fake.close()
    coord.stop()


# ------------------------------------------------------- across packages
def _lease_records(journal_dir):
    out = {}
    for path in sorted(Path(journal_dir, "_leases").glob("*.json")):
        doc = json.loads(path.read_text())
        out[path.name] = {k: v for k, v in doc.items() if k not in _CLOCK_FIELDS}
    return out


def _markers(journal_dir):
    return {p.name: {k: v for k, v in json.loads(p.read_text()).items() if k != "wall_s"}
            for p in sorted(Path(journal_dir).glob("*.json"))}


@pytest.mark.parametrize("coord_pkg,worker_pkg", [("jax", "port"), ("port", "jax")])
def test_protocol_is_shared_across_packages(shards, tmp_path, coord_pkg, worker_pkg):
    """One worker of one package against the other package's coordinator: the table
    bytes, the journal markers and the lease records equal those of a run within
    either package alone."""
    mods = {"jax": jel, "port": elastic}
    runs = {}
    for tag, (c, w) in {"mixed": (coord_pkg, worker_pkg), "jax": ("jax", "jax"),
                        "port": ("port", "port")}.items():
        root = tmp_path / tag
        coord = _coordinator(shards, root, mod=mods[c], policy=_fast_policy(mods[c]),
                             features_out=str(root / "features"))
        thread = _start_worker(coord, "w0", mod=mods[w])
        doc, table = _finish(coord, [thread], validate=(
            validate_elastic_report if c == "port" else jdiag.validate_elastic_report))
        runs[tag] = (table.tobytes(), _markers(root / "_journal"),
                     _lease_records(root / "_journal"), doc["totals"]["committed"])
    assert runs["mixed"] == runs["jax"] == runs["port"]
    assert runs["port"][3] == len(shards)
    assert {r["state"] for r in runs["port"][2].values()} == {"committed"}


def test_stub_tables_equal_the_jax_elastic_run_byte_for_byte(shards, tmp_path):
    """Two workers in each package over the same shards: the same table bytes, and the
    port's stub is the JAX stub bit for bit (uint8 images through numpy's x / 255)."""
    tables = {}
    for tag, mod in (("jax", jel), ("port", elastic)):
        coord = _coordinator(shards, tmp_path / tag, mod=mod, policy=_fast_policy(mod))
        threads = [_start_worker(coord, f"w{i}", mod=mod) for i in range(2)]
        _doc, table = _finish(coord, threads, validate=lambda d: [])
        tables[tag] = table.tobytes()
    assert tables["port"] == tables["jax"]
    rng = np.random.default_rng(5)
    u8 = rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8)
    pf, ps = elastic.stub_encode_stats_fn()(u8)
    jf, js = jel.stub_encode_stats_fn()(np.asarray(u8, np.float32) / 255.0)
    assert pf.numpy().tobytes() == np.asarray(jf).tobytes()
    assert ps.numpy().tobytes() == np.asarray(js).tobytes()


_TINY = {}


def _tiny():
    if not _TINY:
        jmodel = JSamViT(**TINY, dtype=jnp.float32)
        params = jmodel.init(jax.random.key(0),
                             jnp.zeros((1, TINY_SIZE, TINY_SIZE, 3)))["params"]
        rng = np.random.default_rng(1)

        def fill(tree):
            for name, val in tree.items():
                if isinstance(val, dict):
                    fill(val)
                elif name in ("rel_pos_h", "rel_pos_w", "pos_embed"):
                    tree[name] = (rng.standard_normal(np.shape(val)) * 0.3).astype(
                        np.float32)
            return tree

        params = fill(jax.tree_util.tree_map(lambda a: np.array(a, np.float32), params))
        model = SamViT(**TINY, dtype=torch.float32)
        model.load_state_dict(params_from_jax(params))
        _TINY.update(jfn=jmr.make_encode_stats_fn(jmodel, params),
                     fn=mr.make_encode_stats_fn(model.eval()))
    return _TINY


def _tree(root):
    return {str(p.relative_to(root)): np.load(p) for p in sorted(Path(root).rglob("*.npy"))}


def test_tiny_encoder_through_run_worker(shards, tmp_path):
    """The TINY SAM encoder on the CPU through ``run_worker`` (two workers): the table
    and feature tree equal the port's own ``run_stream`` byte for byte, and the JAX
    elastic run on the same weights within 1e-4 x the largest |value| (counts exact)."""
    enc = _tiny()
    save = mr.make_feature_sinks(str(tmp_path / "single"))[0]
    single = mr.run_stream(shards, enc["fn"], batch_size=2, image_size=TINY_SIZE,
                           save_features=save, feeder_threads=2)
    got = {}
    for tag, mod, fn in (("port", elastic, enc["fn"]), ("jax", jel, enc["jfn"])):
        root = tmp_path / tag
        coord = _coordinator(shards, root, mod=mod, size=TINY_SIZE,
                             policy=_fast_policy(mod), features_out=str(root / "f"))
        threads = [_start_worker(coord, f"w{i}", fn=fn, mod=mod) for i in range(2)]
        _doc, table = _finish(coord, threads, timeout=60.0, validate=lambda d: [])
        got[tag] = (table, _tree(root / "f"))
    assert got["port"][0].tobytes() == single.table.tobytes()
    single_tree = _tree(tmp_path / "single")
    assert sorted(got["port"][1]) == sorted(single_tree)
    for name, arr in single_tree.items():
        assert got["port"][1][name].tobytes() == arr.tobytes()
    (pt, ptree), (jt, jtree) = got["port"], got["jax"]
    np.testing.assert_array_equal(pt[:, 4], jt[:, 4])
    assert np.abs(pt - jt).max() <= TINY_TOL * np.abs(jt).max()
    assert sorted(ptree) == sorted(jtree)
    for name in jtree:
        want = np.asarray(jtree[name], np.float64)
        assert np.abs(ptree[name] - want).max() <= TINY_TOL * np.abs(want).max()


# ---------------------------------------------------------------- the CLI
def test_coordinator_cli_prints_the_single_host_records(shards, tmp_path):
    """``elastic_map coordinator`` in a subprocess (shards on stdin), two port workers
    in this process: stdout carries the same records as ``mapreduce``'s single-host run,
    and the report it writes validates."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO),
               TMR_ELASTIC_TTL_S="2", TMR_ELASTIC_CHECK_S="0.05")
    names = tmp_path / "shards.txt"
    names.write_text("".join(os.path.basename(s) + "\n" for s in shards))
    with open(names) as stdin:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tmr_tpu_torch.elastic_map", "coordinator",
             "--data_dir", str(tmp_path), "--features_out", str(tmp_path / "f"),
             "--image_size", str(SIZE), "--batch_size", "2", "--wait_timeout_s", "60",
             "--report_out", str(tmp_path / "report.json")],
            stdin=stdin, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=REPO)
    try:
        address = None
        deadline = time.monotonic() + 60
        while address is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            m = re.search(r"shards at ([\d.]+):(\d+)", line)
            if m:
                address = (m.group(1), int(m.group(2)))
            elif not line and proc.poll() is not None:
                break
        assert address, "the coordinator never said where it listens"
        threads = [threading.Thread(target=elastic.run_worker,
                                    args=(address, f"w{i}", elastic.stub_encode_stats_fn()),
                                    kwargs={"retry": _fast_retry(), "max_idle_s": 15.0},
                                    daemon=True) for i in range(2)]
        for t in threads:
            t.start()
        proc.wait(timeout=90)
        out = proc.stdout.read()
        for t in threads:
            t.join(timeout=15)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stdout.close()
        proc.stderr.close()
    assert proc.returncode == 0
    single = mr.run_stream(shards, elastic.stub_encode_stats_fn(), 2, SIZE)
    assert out.splitlines() == single.emit_lines()
    doc = json.loads((tmp_path / "report.json").read_text())
    assert validate_elastic_report(doc) == [] and doc["totals"]["committed"] == len(shards)


def test_worker_cli_stub_exit_codes(shards, tmp_path):
    coord = _coordinator(shards[:2], tmp_path)
    argv = ["worker", "--coordinator", "%s:%d" % coord.address, "--worker_id", "cli",
            "--encoder", "stub", "--max_idle_s", "10"]
    assert elastic_map.main(argv) == 0
    assert coord.wait(timeout=10)
    coord.stop()
    poisoned = _coordinator(shards[:2], tmp_path / "p",
                            policy=_fast_policy(poison_failures=1))
    faults.configure("encode:raise=RuntimeError")
    rc = elastic_map.main(["worker", "--coordinator", "%s:%d" % poisoned.address,
                           "--encoder", "stub", "--max_attempts", "1", "--max_idle_s",
                           "5"])
    assert rc == 1  # drained
    poisoned.stop()


# -------------------------------------------------------- refused by name
def test_unported_parts_are_refused_by_name(shards, tmp_path, monkeypatch):
    """``TMR_FLEET_OBS`` stays refused. A ``tcp://`` target is taken as given by the
    coordinator (not made a path) and builds network sinks, which raise for retry on a
    dead address; the coordinator CLI takes it. ``worker --artifact`` is ported (the
    payload test of ``tests/test_torch_chaos_probe.py`` runs it), and without a GPU it
    refuses the CPU unless ``--device cpu`` is given, before it dials."""
    import socket

    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            elastic_map.main(["worker", "--coordinator", "127.0.0.1:9", "--artifact",
                              str(tmp_path / "enc.pt2")])
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    s.close()
    coord = elastic.ElasticCoordinator(shards, str(tmp_path / "j"), features_out=dead)
    assert coord.features_out == dead
    with pytest.raises(ConnectionError, match="unreachable"):
        coord._feature_sinks[1]("Easy_0.tar")  # the quarantine cleanup dials the sink
    monkeypatch.setattr("sys.stdin", io.StringIO("Easy_0.tar\n"))
    assert elastic_map.main(["coordinator", "--data_dir", str(tmp_path), "--features_out",
                             dead, "--journal_dir", str(tmp_path / "cj"),
                             "--wait_timeout_s", "0.2"]) == 1  # no worker: unsettled
    monkeypatch.setenv("TMR_FLEET_OBS", "1")
    with pytest.raises(NotImplementedError, match="TMR_FLEET_OBS.*ROADMAP A7"):
        elastic.ElasticCoordinator(shards, str(tmp_path / "j"))
    with pytest.raises(NotImplementedError, match="TMR_FLEET_OBS.*ROADMAP A7"):
        elastic.WorkerClient(("127.0.0.1", 9), "w")
    monkeypatch.setenv("TMR_FLEET_OBS", "0")  # off: the plain path runs
    coord = _coordinator(shards[:1], tmp_path / "off")
    coord.stop()


def test_worker_refuses_the_cpu_unless_asked(shards, tmp_path, monkeypatch):
    """``worker`` without ``--device cpu`` on a machine with no GPU raises before it
    dials; with ``--device cpu`` it runs the plain versions."""
    import tmr_tpu_torch.models

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elastic_map.main(["worker", "--coordinator", "127.0.0.1:9"])
    built = []

    def fake_build(model_type, checkpoint, device=None):
        built.append((model_type, checkpoint, device))
        return SamViT(**TINY, dtype=torch.float32).eval()

    monkeypatch.setattr(tmr_tpu_torch.models, "build_sam_encoder", fake_build)
    coord = _coordinator(shards[:1], tmp_path, size=TINY_SIZE)
    assert elastic_map.main(["worker", "--coordinator", "%s:%d" % coord.address,
                             "--device", "cpu", "--checkpoint", "x.pth",
                             "--max_idle_s", "10"]) == 0
    assert coord.wait(timeout=30)
    coord.stop()
    assert built == [("vit_b", "x.pth", "cpu")]
