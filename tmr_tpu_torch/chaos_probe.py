"""Chaos gauntlets for the fault-tolerant map phase (counterpart of the repo's
``scripts/chaos_probe.py``, run against the port).

``python -m tmr_tpu_torch.chaos_probe`` runs the synthetic-shard extraction under
canned deterministic fault schedules (``utils/faults.py``) covering every map-phase
injection point (I/O error, hung shard, corrupt member, NaN encoder output, failed
save/journal commits, crash + resume) and exits non-zero unless:

- every injected fault was observed (``faults.fired()``) and is accounted for in the
  ``map_report/v1`` document;
- transient faults are retried to success: the reducer table and the per-image feature
  files come out byte-identical to the fault-free run;
- permanent faults quarantine with a recorded cause (or, for data damage, show up
  exactly in the skipped/non-finite counters), and the table equals the
  journal-predicted contribution of the unaffected shards;
- a crash mid-run + resume yields a byte-identical table, re-encoding only unjournaled
  shards, with no partial ``.npy`` anywhere.

``--elastic`` runs the elastic gauntlet instead (``parallel/elastic.py``): 3 worker
processes (``python -m tmr_tpu_torch.elastic_map worker --encoder stub``) over 8 shards,
one kill -9'd mid-shard and another SIGSTOPped past the heartbeat window (then
SIGCONTed, so that its fenced commit is tried and rejected), plus an in-process
lease/heartbeat fault round; it exits non-zero unless the run completes, the final
table is byte-identical to the single-process run, the validated ``elastic_report/v1``
reconciles exactly (every reassignment carries a cause from the closed list; >= 1
fenced rejection in the SIGSTOP scenario), and the feature tree matches byte for byte.

Both gauntlets run on the CPU in seconds, on tiny synthetic PNGs and the numpy stand-in
encoder (``parallel/elastic.stub_encode_stats_fn``: no model, no card). The PNGs are written with ``zlib`` alone; decoding
goes through the map phase's own ``transforms.decode_image``. The JAX gauntlet's check
of a ``metrics`` snapshot in the map report has no counterpart until the port's map
phase records into ``obs`` (ROADMAP A8).
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import io
import os
import shutil
import signal
import struct
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
import zlib

import numpy as np

SIZE = 16  # decode size: tiny keeps the whole gauntlet in seconds
SHARDS = (  # (name, n_images): index order is the fault 'shard=' key
    ("Easy_0.tar", 4),
    ("Easy_1.tar", 3),
    ("Normal_0.tar", 4),
    ("Normal_1.tar", 2),
    ("Hard_0.tar", 3),
    ("misc.tar", 2),
)
ELASTIC_SHARDS = (  # 8 shards: index order is the fault 'shard=' key. Every shard has
    # >= 3 images so at batch 2 each worker spends >= 2 stub-delayed batches per shard,
    # and kills/stops land mid-shard
    ("Easy_0.tar", 4), ("Easy_1.tar", 3), ("Easy_2.tar", 3),
    ("Normal_0.tar", 4), ("Normal_1.tar", 3), ("Normal_2.tar", 3),
    ("Hard_0.tar", 3), ("Hard_1.tar", 3),
)
#: the directory that holds the ``tmr_tpu_torch`` package (workers' PYTHONPATH)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit RGB PNG (every row filter 0) made with ``zlib`` and ``struct``."""
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def make_tar(dirpath: str, name: str, n_images: int, seed: int, side: int = 24) -> str:
    """A tar shard of ``n_images`` random ``side`` x ``side`` RGB PNGs."""
    rng = np.random.default_rng(seed)
    path = os.path.join(dirpath, name)
    with tarfile.open(path, "w") as tar:
        for i in range(n_images):
            data = png_bytes(rng.integers(0, 255, (side, side, 3), dtype=np.uint8))
            info = tarfile.TarInfo(f"img_{i}.png")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return path


def manifest(features_dir: str) -> dict:
    """{relpath: sha256} over every .npy under features_dir."""
    out = {}
    for path in sorted(glob.glob(os.path.join(features_dir, "**", "*.npy"),
                                 recursive=True)):
        with open(path, "rb") as f:
            out[os.path.relpath(path, features_dir)] = hashlib.sha256(f.read()).hexdigest()
    return out


def _tmp_leftovers(root: str) -> list:
    return glob.glob(os.path.join(root, "**", "*.tmp.*"), recursive=True)


def _run(paths, encode, out_dir, *, resume=False, retry=None, expect_crash=False):
    from tmr_tpu_torch.parallel.journal import ShardJournal
    from tmr_tpu_torch.parallel.mapreduce import (
        MapReport,
        RetryPolicy,
        make_feature_sinks,
        reducer_table,
        run_stream,
    )

    features = os.path.join(out_dir, "features")
    save = make_feature_sinks(features)[0]
    journal = ShardJournal(os.path.join(out_dir, "features", "_journal"))
    report = MapReport()
    retry = retry or RetryPolicy(max_attempts=3, shard_timeout=2.0, backoff_base=0.01,
                                 backoff_jitter=0.0)
    crashed = False
    acc = None
    try:
        acc = run_stream(paths, encode, batch_size=2, image_size=SIZE,
                         save_features=save, feeder_threads=2, retry=retry,
                         journal=journal, resume=resume, report=report)
    except KeyboardInterrupt:
        crashed = True
        if not expect_crash:
            raise
    return {
        "table": reducer_table(acc.table) if acc is not None else None,
        "manifest": manifest(features),
        "report": report.document() if not crashed else None,
        "journal": journal,
        "crashed": crashed,
    }


def _checker():
    problems = []

    def check(ok, msg):
        print(f"[{'ok' if ok else 'FAIL'}] {msg}", file=sys.stderr, flush=True)
        if not ok:
            problems.append(msg)

    return problems, check


def _verdict(name: str, problems: list, work: str, args) -> int:
    if problems:
        print(f"{name}: {len(problems)} FAILED check(s):", file=sys.stderr)
        for msg in problems:
            print(f"  - {msg}", file=sys.stderr)
        return 1
    print(f"{name}: all checks passed", file=sys.stderr)
    if not args.keep and args.work_dir is None:
        shutil.rmtree(work, ignore_errors=True)
    return 0


# ------------------------------------------------------- elastic gauntlet
def poll(predicate, timeout_s: float, interval_s: float = 0.02):
    """Poll until predicate() is truthy; returns its value (falsy on timeout)."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(interval_s)
    return predicate()


def _spawn_stub_worker(wid, address):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    env.pop("TMR_FAULTS", None)  # the process gauntlet runs fault-free
    return subprocess.Popen(
        [sys.executable, "-m", "tmr_tpu_torch.elastic_map", "worker",
         "--coordinator", f"{address[0]}:{address[1]}", "--worker_id", wid,
         "--encoder", "stub", "--shard_delay_s", "0.45", "--max_attempts", "2",
         "--max_idle_s", "30"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def held_leases(coord) -> dict:
    """{worker_id: (index, epoch, hb)} for every currently held lease."""
    out = {}
    for index, leases in coord.state()["leases"].items():
        for lease in leases:
            out[lease["worker"]] = (int(index), lease["epoch"], lease["hb"])
    return out


def _elastic_main(args) -> int:
    """The elastic chaos gauntlet (see the module docstring)."""
    from tmr_tpu_torch.diagnostics import ELASTIC_REASSIGN_CAUSES, validate_elastic_report
    from tmr_tpu_torch.parallel.elastic import (
        ElasticCoordinator,
        ElasticPolicy,
        run_worker,
        stub_encode_stats_fn,
    )
    from tmr_tpu_torch.parallel.journal import ShardJournal
    from tmr_tpu_torch.parallel.mapreduce import (
        RetryPolicy,
        make_feature_sinks,
        reducer_table,
        run_stream,
    )
    from tmr_tpu_torch.utils import faults

    work = args.work_dir or tempfile.mkdtemp(prefix="chaos_elastic_")
    os.makedirs(work, exist_ok=True)
    problems, check = _checker()
    data = os.path.join(work, "shards")
    os.makedirs(data, exist_ok=True)
    paths = [make_tar(data, name, n, seed=i) for i, (name, n) in enumerate(ELASTIC_SHARDS)]

    # ------------------------------------------- baseline: single process
    faults.clear()
    base_feats = os.path.join(work, "base_features")
    save, cleanup, sync = make_feature_sinks(base_feats)
    base_acc = run_stream(paths, stub_encode_stats_fn(), batch_size=2, image_size=SIZE,
                          save_features=save, cleanup_features=cleanup,
                          sync_features=sync)
    base_table = reducer_table(base_acc.table)
    base_manifest = manifest(base_feats)
    check(base_manifest, "elastic baseline: single-process run completed")

    # ---------------- process gauntlet: 3 workers, kill -9 + SIGSTOP/CONT
    feats = os.path.join(work, "features")
    coord = ElasticCoordinator(
        paths, os.path.join(feats, "_journal"), features_out=feats, image_size=SIZE,
        batch_size=2, policy=ElasticPolicy(lease_ttl_s=1.0, hb_interval_s=0.2,
                                           check_interval_s=0.05, straggler_factor=0.0))
    address = coord.start()
    workers = {f"w{i}": _spawn_stub_worker(f"w{i}", address) for i in range(3)}
    try:
        # victims: two distinct workers holding FRESH leases (few heartbeats in), so the
        # signals land mid-shard rather than racing the commit
        held = poll(lambda: (lambda h: h if len(
            [w for w, (_, _, hb) in h.items() if hb <= 2]) >= 2 else None)(
                held_leases(coord)), timeout_s=60.0)
        check(bool(held), "elastic: >=2 workers leased shards concurrently")
        victims = sorted(w for w, (_, _, hb) in (held or {}).items() if hb <= 2)[:2]
        kill_wid = victims[0] if victims else None
        stop_wid = victims[1] if len(victims) > 1 else None
        kill_shard = held[kill_wid][0] if kill_wid else None
        stop_shard = held[stop_wid][0] if stop_wid else None
        if kill_wid:
            os.kill(workers[kill_wid].pid, signal.SIGKILL)  # mid-shard
        if stop_wid:
            os.kill(workers[stop_wid].pid, signal.SIGSTOP)  # past the hb window

        def cause_for(index, cause):
            return lambda: any(r["index"] == index and r["cause"] == cause
                               for r in coord.state()["reassignments"])

        check(bool(poll(cause_for(kill_shard, "worker_exit"), 20.0)),
              "elastic: kill -9 worker reassigned with cause worker_exit")
        check(bool(poll(cause_for(stop_shard, "stale_heartbeat"), 20.0)),
              "elastic: SIGSTOPped worker's lease revoked as stale_heartbeat")
        if stop_wid:
            os.kill(workers[stop_wid].pid, signal.SIGCONT)
        check(bool(poll(lambda: coord.state()["fenced_rejections"], 30.0)),
              "elastic: resumed (paused) worker's commit attempt was fenced")
        check(coord.wait(timeout=90.0), "elastic: run settled")
        for wid, proc in workers.items():
            try:
                proc.wait(timeout=10 if wid == kill_wid else 30)
            except subprocess.TimeoutExpired:
                check(False, f"elastic: worker {wid} had to be killed")
    finally:
        for proc in workers.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGCONT)
                proc.kill()
                proc.wait(timeout=10)
    doc = coord.report()
    table = reducer_table(coord.table())
    coord.stop()

    check(validate_elastic_report(doc) == [],
          "elastic: elastic_report/v1 valid (totals reconcile exactly)")
    check(table == base_table, "elastic: stats table byte-identical to single-process run")
    check(manifest(feats) == base_manifest,
          "elastic: feature files byte-identical to single-process run")
    # the fenced loser must not have unlinked the winner's done-marker: a coordinator
    # crash right now must be resumable from the journal
    journal = ShardJournal(os.path.join(feats, "_journal"))
    missing = [r["shard"] for r in doc["shards"]
               if r["status"] == "committed" and journal.done(r["shard"]) is None]
    check(not missing, f"elastic: every committed shard keeps a valid journal marker for "
                       f"crash-resume (missing: {missing})")
    totals = doc["totals"]
    check(totals["committed"] + totals["resumed"] + totals["quarantined"]
          == totals["shards"] == len(ELASTIC_SHARDS) and totals["quarantined"] == 0,
          "elastic: every shard settled exactly once (committed)")
    check(doc["reassignments"] and all(r["cause"] in ELASTIC_REASSIGN_CAUSES
                                       for r in doc["reassignments"]),
          "elastic: every reassignment carries a closed-vocab cause")
    check(totals["fenced_rejections"] >= 1,
          "elastic: >=1 fenced-commit rejection in the SIGSTOP scenario")
    killed = doc["shards"][kill_shard] if kill_shard is not None else None
    check(killed is not None and killed["status"] == "committed"
          and killed["worker"] != kill_wid,
          "elastic: the killed worker's shard was committed by another worker")
    # kill -9 can orphan *.tmp.<pid> files mid-atomic-write; they must all belong to the
    # two victim processes, never a healthy writer
    victim_pids = {str(workers[w].pid) for w in victims if w}
    stray = [p for p in _tmp_leftovers(feats) if p.rsplit(".", 1)[-1] not in victim_pids]
    check(not stray, f"elastic: no orphan .tmp files from healthy workers ({stray})")

    # --------------- in-process round: lease + heartbeat fault injection
    faults.configure(
        # the grant of shard 1 fails once (epoch 1) and succeeds on the re-grant
        "lease:shard=1:attempts=2:raise=OSError;"
        # shard 2's first holder stalls its heartbeats past the TTL (epoch 1 only): the
        # in-process SIGSTOP stand-in
        "heartbeat:shard=2:attempts=2:latency=1.6")
    feats2 = os.path.join(work, "features_faults")
    coord2 = ElasticCoordinator(
        paths, os.path.join(feats2, "_journal"), features_out=feats2, image_size=SIZE,
        batch_size=2, policy=ElasticPolicy(lease_ttl_s=0.6, hb_interval_s=0.15,
                                           check_interval_s=0.05, straggler_factor=0.0))
    address2 = coord2.start()
    retry = RetryPolicy(max_attempts=2, backoff_base=0.01, backoff_jitter=0.0)
    threads = [threading.Thread(target=run_worker,
                                args=(address2, f"t{i}", stub_encode_stats_fn()),
                                kwargs={"retry": retry, "max_idle_s": 20.0}, daemon=True)
               for i in range(2)]
    for t in threads:
        t.start()
    check(coord2.wait(timeout=60.0), "faults: injected run settled")
    for t in threads:
        t.join(timeout=20)
    doc2 = coord2.report()
    table2 = reducer_table(coord2.table())
    coord2.stop()
    fired = {(f["point"], f["action"]) for f in faults.fired()}
    check(("lease", "raise") in fired, "faults: lease grant fault fired")
    check(("heartbeat", "latency") in fired, "faults: heartbeat stall fault fired")
    check(validate_elastic_report(doc2) == [], "faults: elastic_report/v1 valid")
    check(table2 == base_table, "faults: stats table byte-identical under injected faults")
    check(any(r["index"] == 2 and r["cause"] == "stale_heartbeat"
              for r in doc2["reassignments"]),
          "faults: stalled-heartbeat lease revoked and reassigned")
    faults.clear()
    return _verdict("chaos_probe --elastic", problems, work, args)


def main(argv=None) -> int:
    from tmr_tpu_torch.diagnostics import validate_map_report
    from tmr_tpu_torch.parallel.elastic import stub_encode_stats_fn
    from tmr_tpu_torch.parallel.mapreduce import CATEGORIES, RetryPolicy, reducer_table
    from tmr_tpu_torch.utils import faults

    ap = argparse.ArgumentParser(prog="python -m tmr_tpu_torch.chaos_probe",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--work_dir", default=None,
                    help="scratch dir (default: a fresh tempdir, removed on success)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the scratch dir for inspection")
    ap.add_argument("--elastic", action="store_true",
                    help="run the elastic coordinator/worker gauntlet (kill -9 / SIGSTOP "
                         "/ lease+heartbeat faults) instead of the single-process one")
    args = ap.parse_args(argv)
    if args.elastic:
        return _elastic_main(args)

    work = args.work_dir or tempfile.mkdtemp(prefix="chaos_probe_")
    os.makedirs(work, exist_ok=True)
    problems, check = _checker()
    data = os.path.join(work, "shards")
    os.makedirs(data, exist_ok=True)
    paths = [make_tar(data, name, n, seed=i) for i, (name, n) in enumerate(SHARDS)]
    encode = stub_encode_stats_fn()

    # ---------------------------------------------------- 0: fault-free
    faults.clear()
    base = _run(paths, encode, os.path.join(work, "baseline"))
    base_entries = base["journal"].load_all()
    check(base["table"] is not None, "baseline: completed")
    check(len(base_entries) == len(SHARDS), "baseline: every shard journaled")

    # --------------------------- 1: transient faults -> retried to success
    faults.configure(
        "tar.open:shard=0:attempts=2:raise=OSError;"   # I/O error x2
        "tar.open:shard=1:attempts=1:latency=1.5;"     # hung shard (timeout)
        "save:shard=2:attempts=1:raise=OSError;"       # save dies mid-shard
        "journal:shard=3:attempts=1:raise=OSError;"    # journal commit fails
        "encode:shard=4:attempts=1:raise=RuntimeError"  # encoder fault
    )
    t = _run(paths, encode, os.path.join(work, "transient"),
             retry=RetryPolicy(max_attempts=3, shard_timeout=0.3, backoff_base=0.01,
                               backoff_jitter=0.0))
    fired_points = {f["point"] for f in faults.fired()}
    for point in ("tar.open", "save", "journal", "encode"):
        check(point in fired_points, f"transient: fault at {point} fired")
    doc = t["report"]
    check(validate_map_report(doc) == [], "transient: map_report/v1 valid")
    check(t["table"] == base["table"], "transient: reducer table identical to fault-free run")
    check(t["manifest"] == base["manifest"],
          "transient: feature files byte-identical to fault-free run")
    check(not _tmp_leftovers(os.path.join(work, "transient")),
          "transient: no partial .tmp files on disk")
    check(all(r["status"] == "ok" for r in doc["shards"]),
          "transient: every faulted shard retried to success")
    causes = {r["shard"]: [c["cause"] for c in r["causes"]] for r in doc["shards"]}
    check(causes.get("Easy_1.tar") == ["timeout"],
          "transient: hung shard recorded a timeout cause within budget")
    check(doc["totals"]["retries"] >= 5,
          "transient: every injected failure cost a recorded retry")

    # ------------- 2: permanent damage -> quarantine / exact accounting
    faults.configure(
        "decode:shard=0:corrupt=1;"      # every Easy_0 image undecodable
        "encode:shard=1:nan=1;"          # every Easy_1 stat non-finite
        "tar.open:shard=2:raise=OSError"  # Normal_0 permanently unreadable
    )
    p = _run(paths, encode, os.path.join(work, "permanent"))
    doc = p["report"]
    by_shard = {r["shard"]: r for r in doc["shards"]}
    fired_actions = {(f["point"], f["action"]) for f in faults.fired()}
    check(("decode", "corrupt") in fired_actions, "permanent: corrupt-member fault fired")
    check(("encode", "nan") in fired_actions, "permanent: NaN-poison fault fired")
    check(validate_map_report(doc) == [], "permanent: map_report/v1 valid")
    check(by_shard["Easy_0.tar"]["skipped_images"] == base_entries["Easy_0.tar"]["images"],
          "permanent: corrupt members all counted as skipped")
    check(by_shard["Easy_1.tar"]["nonfinite_images"]
          == base_entries["Easy_1.tar"]["images"],
          "permanent: NaN outputs all counted as non-finite")
    check(by_shard["Normal_0.tar"]["status"] == "quarantined"
          and [c["cause"] for c in by_shard["Normal_0.tar"]["causes"]] == ["exception"] * 3,
          "permanent: unreadable shard quarantined with recorded causes")
    check(doc["quarantined"] == ["Normal_0.tar"], "permanent: quarantine list exact")
    # the table must equal the journal-predicted sum of the unaffected shards
    unaffected = [n for n, _ in SHARDS
                  if n not in ("Easy_0.tar", "Easy_1.tar", "Normal_0.tar")]
    want = np.zeros((len(CATEGORIES), 5), np.float64)
    for name in unaffected:
        e = base_entries[name]
        want[e["category"]] += np.asarray(e["sums"], np.float64)
    check(p["table"] == reducer_table(want),
          "permanent: table equals journal-predicted unaffected shards")

    # --------------------------------------------- 3: crash, then resume
    faults.configure("tar.open:shard=3:raise=KeyboardInterrupt")
    crash_dir = os.path.join(work, "crash")
    c = _run(paths, encode, crash_dir, expect_crash=True)
    check(c["crashed"], "crash: injected crash killed the run")
    done_before = set(c["journal"].load_all())
    check(done_before and "Normal_1.tar" not in done_before,
          f"crash: journal holds only pre-crash shards ({sorted(done_before)})")
    faults.clear()
    r = _run(paths, encode, crash_dir, resume=True)
    doc = r["report"]
    check(set(doc["resumed"]) == done_before, "resume: exactly the journaled shards skipped")
    check(r["table"] == base["table"],
          "resume: reducer table byte-identical to fault-free run")
    check(r["manifest"] == base["manifest"],
          "resume: feature files byte-identical, no duplicates/partials")
    check(not _tmp_leftovers(crash_dir), "resume: no partial .tmp files")
    faults.clear()
    return _verdict("chaos_probe", problems, work, args)


if __name__ == "__main__":
    raise SystemExit(main())
