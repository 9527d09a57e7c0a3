"""Elastic map phase CLI (counterpart of the repo's ``scripts/elastic_map.py``):
coordinator/worker shard execution over the lease protocol (``parallel/elastic.py``).

Coordinator (owns the shard queue; shard names on stdin like ``mapreduce map``, the same
Hadoop-streaming stat records on stdout, so ``| python -m
tmr_tpu_torch.parallel.mapreduce reduce`` keeps working)::

    cat list_tars.txt | python -m tmr_tpu_torch.elastic_map coordinator \\
        --data_dir /data/tars --features_out features_output \\
        --port 7077 --report_out elastic_report.json [--resume]

Workers (any number, on any host that shares the filesystem; each leases one shard at a
time, heartbeats it, and commits the journal marker under an epoch fence)::

    python -m tmr_tpu_torch.elastic_map worker --coordinator HOST:7077 \\
        --checkpoint sam_vit_b.pth [--model_type vit_b|vit_h] [--device cuda]

A worker encodes with the port's SAM encoder on the GPU (``--device cuda``, the
default, raises without one; ``--device cpu`` runs the plain versions when asked), or
with an exported encoder (``--artifact``, ``python -m tmr_tpu_torch.export_encoder``; no
model built, no checkpoint read), which runs from the unpacked worker payload
(``utils/package.py``).
``--encoder stub`` runs the numpy stand-in encoder (drills and protocol debugging; no
model, no device). Both packages speak one protocol, so port workers serve a JAX
coordinator and JAX workers a port one.

Lease knobs ride the TMR_ELASTIC_* environment variables: TTL, heartbeat cadence,
liveness check interval, straggler bound, reassignment and poison-worker limits. Fault
drills: TMR_FAULTS schedules with the ``lease`` / ``heartbeat`` / ``steal`` points
(``utils/faults.py``) inject grant failures, stalled heartbeats and straggler-election
faults; ``python -m tmr_tpu_torch.chaos_probe --elastic`` is the canned gauntlet.

Exit codes: the coordinator 1 when the run did not settle within ``--wait_timeout_s``;
a worker 1 when it was drained or failed every shard it touched.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _parse_address(text: str):
    host, _, port = text.rpartition(":")
    return (host or "127.0.0.1", int(port))


def _install_faults() -> None:
    from tmr_tpu_torch.utils import faults
    from tmr_tpu_torch.utils.profiling import log_warning

    if faults.install_from_env():
        log_warning(f"fault injection ACTIVE (TMR_FAULTS="
                    f"{os.environ.get('TMR_FAULTS', '')!r})")


def _cli_coordinator(args) -> int:
    from tmr_tpu_torch.parallel.elastic import ElasticCoordinator, ElasticPolicy
    from tmr_tpu_torch.parallel.mapreduce import StatAccumulator
    from tmr_tpu_torch.utils.atomicio import atomic_write
    from tmr_tpu_torch.utils.profiling import log_info, log_warning

    _install_faults()
    names = [ln.strip() for ln in sys.stdin if ln.strip()]
    paths = [n if os.path.isabs(n) else os.path.join(args.data_dir, n) for n in names]
    journal_dir = args.journal_dir
    if journal_dir is None and args.features_out:
        journal_dir = os.path.join(args.features_out, "_journal")
    if journal_dir is None:
        log_warning("coordinator: no --journal_dir/--features_out; using ./_journal")
        journal_dir = "_journal"
    coord = ElasticCoordinator(
        paths, journal_dir, features_out=args.features_out, data_dir=args.data_dir,
        image_size=args.image_size, batch_size=args.batch_size, resume=args.resume,
        policy=ElasticPolicy.from_env(), host=args.host, port=args.port)
    host, port = coord.start()
    log_info(f"elastic coordinator: {len(paths)} shards at {host}:{port} "
             f"(journal {journal_dir})")
    settled = coord.wait(timeout=args.wait_timeout_s if args.wait_timeout_s > 0 else None)
    doc = coord.report()
    if args.report_out:
        if settled:
            doc = coord.write_report(args.report_out)  # validated
        else:
            # an unsettled run cannot produce a valid (all-settled) report: dump the raw
            # state for a postmortem instead
            atomic_write(args.report_out,
                         lambda f: json.dump(doc, f, indent=1, sort_keys=True))
            log_warning(f"elastic: run unsettled; {args.report_out} holds the RAW "
                        "(unvalidated) state")
    t = doc["totals"]
    log_info(f"elastic: {t['committed']} committed / {t['resumed']} resumed / "
             f"{t['quarantined']} quarantined of {t['shards']} shards; "
             f"{t['reassignments']} reassignments, {t['fenced_rejections']} fenced "
             f"rejections, {t['workers']} workers ({t['drained_workers']} drained)")
    acc = StatAccumulator()
    acc.table = coord.table()
    for line in acc.emit_lines():
        sys.stdout.write(line + "\n")  # the Hadoop-streaming record form
    sys.stdout.flush()
    coord.stop()
    if not settled:
        log_warning("elastic: run did NOT settle within --wait_timeout_s")
        return 1
    return 0


def _cli_worker(args) -> int:
    from tmr_tpu_torch.parallel.elastic import run_worker, stub_encode_stats_fn
    from tmr_tpu_torch.parallel.mapreduce import RetryPolicy
    from tmr_tpu_torch.utils.profiling import log_info, log_warning

    _install_faults()
    if args.encoder == "stub":
        fn = stub_encode_stats_fn(delay_s=args.shard_delay_s)
    elif args.artifact:
        from tmr_tpu_torch.parallel.mapreduce import make_encode_stats_fn_from_artifact

        fn = make_encode_stats_fn_from_artifact(args.artifact, args.device)
    else:
        from tmr_tpu_torch.models import build_sam_encoder
        from tmr_tpu_torch.parallel.mapreduce import make_encode_stats_fn

        if not args.checkpoint:
            log_warning("worker: no --artifact/--checkpoint, random weights")
        fn = make_encode_stats_fn(build_sam_encoder(args.model_type, args.checkpoint,
                                                    device=args.device))

    worker_id = args.worker_id or f"{os.uname().nodename}-{os.getpid()}"
    retry = RetryPolicy(
        max_attempts=max(1, args.max_attempts),
        shard_timeout=args.shard_timeout if args.shard_timeout > 0 else None,
        backoff_base=args.backoff_base)
    summary = run_worker(
        _parse_address(args.coordinator), worker_id, fn, retry=retry,
        hb_path=args.hb_path, batch_size=args.batch_size or None,
        image_size=args.image_size or None, max_idle_s=args.max_idle_s)
    log_info(f"elastic worker {worker_id}: {summary['committed']} committed, "
             f"{summary['failed']} failed, {summary['fenced']} fenced over "
             f"{summary['leases']} leases" + (" (drained)" if summary["drained"] else ""))
    # a drained worker, or one that failed everything it touched, must not look
    # successful to the calling script (`worker ... && next`)
    if summary["drained"] or (summary["failed"] > 0 and summary["committed"] == 0):
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tmr_tpu_torch.elastic_map", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("coordinator", help="serve the shard lease queue (shards on stdin)")
    c.add_argument("--data_dir", default=".",
                   help="prefix for shard names read from stdin")
    c.add_argument("--features_out", default=None,
                   help="per-image feature .npy tree (workers write it; same layout as "
                        "mapreduce map)")
    c.add_argument("--journal_dir", default=None,
                   help="done-marker + _leases directory (default <features_out>/_journal)")
    c.add_argument("--host", default="127.0.0.1")
    c.add_argument("--port", default=0, type=int,
                   help="listen port (0 = ephemeral, printed at start)")
    c.add_argument("--image_size", default=1024, type=int)
    c.add_argument("--batch_size", default=8, type=int)
    c.add_argument("--resume", action="store_true",
                   help="fold valid journal done-markers instead of re-leasing those "
                        "shards (byte-identical table)")
    c.add_argument("--report_out", default=None,
                   help="write the validated elastic_report/v1 here")
    c.add_argument("--wait_timeout_s", default=0.0, type=float,
                   help="give up (rc 1) when the run has not settled after this long; 0 "
                        "waits forever")

    w = sub.add_parser("worker", help="lease and run shards")
    w.add_argument("--coordinator", required=True, help="HOST:PORT of the coordinator")
    w.add_argument("--worker_id", default=None,
                   help="stable worker identity (default host-pid)")
    w.add_argument("--encoder", default="model", choices=("model", "stub"),
                   help="'stub' = numpy stand-in encoder (drills; no device)")
    w.add_argument("--artifact", default=None,
                   help="exported encoder (.pt2) in place of the model: no model built, "
                        "no checkpoint read")
    w.add_argument("--checkpoint", default=None,
                   help="SAM(-HQ) .pth; without it the weights are seeded")
    w.add_argument("--model_type", default="vit_b")
    w.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    w.add_argument("--batch_size", default=0, type=int,
                   help="override the coordinator's batch size")
    w.add_argument("--image_size", default=0, type=int,
                   help="override the coordinator's image size")
    w.add_argument("--max_attempts", default=3, type=int)
    w.add_argument("--shard_timeout", default=600.0, type=float)
    w.add_argument("--backoff_base", default=0.5, type=float)
    w.add_argument("--shard_delay_s", default=0.0, type=float,
                   help="stub encoder: sleep per batch (drill pacing)")
    w.add_argument("--hb_path", default=None,
                   help="heartbeat JSONL log (default under _leases/)")
    w.add_argument("--max_idle_s", default=60.0, type=float,
                   help="exit after this long with no lease available")

    args = p.parse_args(argv)
    return _cli_coordinator(args) if args.cmd == "coordinator" else _cli_worker(args)


if __name__ == "__main__":
    raise SystemExit(main())
