"""Report schemas and validators (counterpart of the map, metrics and health parts of
``tmr_tpu/diagnostics.py``).

``map_report/v1`` is the map phase's structured report (``parallel/mapreduce.MapReport``,
written by ``map --report_out``): per-shard status, attempts and causes, the quarantined
and resumed lists, skipped-image and non-finite counts, retry totals and wall seconds
per shard. The JAX package's report also carries a ``metrics`` key (a
``metrics_report/v1`` snapshot) and, under its flight recorder, an ``mfu`` key; the
port's map phase is not instrumented until the port has the measurement plane (ROADMAP
A8), and :func:`validate_map_report` refuses both by name when they are present rather
than passing them unchecked.

``elastic_report/v1`` is the elastic map phase's run document
(``parallel/elastic.ElasticCoordinator.report``): per-shard final status and winning
worker/epoch, per-worker tallies, every reassignment with a cause from a closed list,
every fenced commit, totals that reconcile exactly, and the ``obs`` registry's snapshot
under ``metrics`` (:func:`validate_elastic_report`, the JAX package's rules).

``metrics_report/v1`` is a metrics-registry snapshot (``obs/metrics.py``) and
``health_report/v1`` the serving engine's health document (``ServeEngine.health()``):
queue depths, per-device batches, cache stats, compile-event tallies (the port's are
its ``nvcc`` builds) and the anomalies its health watch fired. The JAX engine's
``mfu_totals`` input and the mesh sections have no counterpart until ROADMAP A8 and A7;
:func:`validate_health_report` refuses a ``mesh`` section by name.

``gate_probe/v1`` records say why a gate refused a program (the JAX package's
``record_gate_refusal`` / ``gate_refused``, the part the port's one gate needs:
``serve/gallery.gallery_fused_ok``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

MAP_REPORT_SCHEMA = "map_report/v1"

#: closed per-shard status vocabulary in a map_report/v1 document
MAP_SHARD_STATUSES = ("ok", "quarantined", "resumed")

#: closed per-attempt failure-cause vocabulary ("timeout": the shard's load made no
#: progress for the stall budget; "exception" carries class and message)
MAP_FAILURE_CAUSES = ("timeout", "exception")

#: attachments of the JAX package's report that the port cannot validate yet
_UNPORTED_ATTACHMENTS = {"metrics": "metrics_report/v1", "mfu": "mfu_report/v1"}


def validate_map_report(doc: dict) -> List[str]:
    """Structural check of a map_report/v1 document; returns the problems (empty: valid).
    Imports nothing of the map phase, so a harness can gate on a report alone."""
    problems: List[str] = [
        f"{key}: a {schema} attachment cannot be validated until the measurement plane "
        "is ported (ROADMAP A8)"
        for key, schema in _UNPORTED_ATTACHMENTS.items() if key in doc]
    if doc.get("schema") != MAP_REPORT_SCHEMA:
        problems.append(f"schema != {MAP_REPORT_SCHEMA}: {doc.get('schema')!r}")
    shards = doc.get("shards")
    if not isinstance(shards, list):
        return problems + ["shards: not a list"]
    for i, rec in enumerate(shards):
        where = f"shards[{i}]"
        if not isinstance(rec, dict):
            problems.append(f"{where}: not a dict")
            continue
        for key in ("shard", "status", "attempts", "images", "skipped_images",
                    "nonfinite_images", "wall_s"):
            if key not in rec:
                problems.append(f"{where}: missing {key!r}")
        if rec.get("status") not in MAP_SHARD_STATUSES:
            problems.append(f"{where}: bad status {rec.get('status')!r}")
        causes = rec.get("causes", ())
        if not isinstance(causes, (list, tuple)):
            problems.append(f"{where}.causes: not a list")
            causes = ()
        for j, cause in enumerate(causes):
            if not isinstance(cause, dict):
                problems.append(f"{where}.causes[{j}]: not a dict")
            elif cause.get("cause") not in MAP_FAILURE_CAUSES:
                problems.append(f"{where}.causes[{j}]: bad cause {cause.get('cause')!r}")
    totals = doc.get("totals")
    if not isinstance(totals, dict):
        problems.append("totals: not a dict")
    else:
        for key in ("shards", "ok", "quarantined", "resumed", "images", "skipped_images",
                    "nonfinite_images", "retries"):
            if key not in totals:
                problems.append(f"totals: missing {key!r}")
    for key in ("quarantined", "resumed"):
        if not isinstance(doc.get(key), list):
            problems.append(f"{key}: not a list")
    return problems


#: schema tag of a metrics-registry snapshot (``obs.metrics.MetricsRegistry.snapshot``)
METRICS_REPORT_SCHEMA = "metrics_report/v1"


def validate_metrics_report(doc: dict) -> List[str]:
    """Structural check of a metrics_report/v1 document; returns the problems (empty:
    valid)."""
    if not isinstance(doc, dict):
        return [f"not a dict: {type(doc).__name__}"]
    problems: List[str] = []
    if doc.get("schema") != METRICS_REPORT_SCHEMA:
        problems.append(f"schema != {METRICS_REPORT_SCHEMA}: {doc.get('schema')!r}")
    for section in ("counters", "gauges", "histograms"):
        if not isinstance(doc.get(section), dict):
            problems.append(f"{section}: not a dict")
    for section in ("counters", "gauges"):
        for name, v in (doc.get(section) or {}).items():
            if not _number(v):
                problems.append(f"{section}[{name!r}]: not a number")
    for name, h in (doc.get("histograms") or {}).items():
        where = f"histograms[{name!r}]"
        if not isinstance(h, dict):
            problems.append(f"{where}: not a dict")
            continue
        for key in ("buckets_le", "counts", "count", "sum", "p50", "p95", "p99"):
            if key not in h:
                problems.append(f"{where}: missing {key!r}")
        bounds, counts = h.get("buckets_le"), h.get("counts")
        if isinstance(bounds, list) and isinstance(counts, list) \
                and len(counts) != len(bounds) + 1:
            problems.append(f"{where}: counts must have len(buckets_le)+1 entries "
                            "(overflow bucket)")
    return problems


def _number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


#: closed anomaly vocabulary of the health watch (``obs/flight.HealthWatch``):
#: recompile_storm = key-change compile events over a threshold in one window;
#: latency_regression = window p99 over factor x a rolling baseline; queue_saturation =
#: batcher depth over a threshold; cache_hit_collapse = window hit rate under factor x a
#: rolling baseline; mfu_drop = achieved FLOP/s under factor x a rolling baseline (no
#: input in the port until ``devtime`` is, ROADMAP A8, so it never fires)
ANOMALY_KINDS = ("recompile_storm", "latency_regression", "queue_saturation",
                 "cache_hit_collapse", "mfu_drop")


def validate_anomaly(rec: dict) -> List[str]:
    """Structural check of one anomaly record: kind, message, numeric evidence."""
    if not isinstance(rec, dict):
        return [f"not a dict: {type(rec).__name__}"]
    problems: List[str] = []
    if rec.get("anomaly") not in ANOMALY_KINDS:
        problems.append(f"anomaly: bad kind {rec.get('anomaly')!r}")
    if not isinstance(rec.get("message"), str) or not rec.get("message"):
        problems.append("message: not a non-empty string")
    if not isinstance(rec.get("evidence"), dict):
        problems.append("evidence: not a dict")
    return problems


#: schema tag of the serving engine's health document (``ServeEngine.health()``)
HEALTH_REPORT_SCHEMA = "health_report/v1"

#: ``quant`` attachment modes (``Predictor.quant_stamp()``): the in-program arm and
#: whether the weights are stored as int8
QUANT_STAMP_MODES = ("off", "int8")


def _validate_quant_attachment(doc: dict) -> List[str]:
    if "quant" not in doc:
        return []
    q = doc["quant"]
    if not isinstance(q, dict):
        return ["quant: not a dict"]
    problems: List[str] = []
    for key in ("mode", "storage"):
        if q.get(key) not in QUANT_STAMP_MODES:
            problems.append(f"quant.{key}: bad value {q.get(key)!r}")
    if q.get("storage") == "int8":
        if not isinstance(q.get("digest"), str) or not q.get("digest"):
            problems.append("quant.digest: not a non-empty string under storage=int8")
        for key in ("quantized_leaves", "weight_bytes", "f32_weight_bytes"):
            v = q.get(key)
            if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                problems.append(f"quant.{key}: not a positive int")
    return problems


def validate_health_report(doc: dict) -> List[str]:
    """Structural check of a health_report/v1 document; returns the problems (empty:
    valid)."""
    if not isinstance(doc, dict):
        return [f"not a dict: {type(doc).__name__}"]
    problems = _validate_quant_attachment(doc)
    if "mesh" in doc:
        problems.append("mesh: mesh serving is not ported (ROADMAP A7)")
    if doc.get("schema") != HEALTH_REPORT_SCHEMA:
        problems.append(f"schema != {HEALTH_REPORT_SCHEMA}: {doc.get('schema')!r}")
    for key, typ in (("ts", (int, float)), ("uptime_s", (int, float)),
                     ("closed", bool), ("inflight", int)):
        v = doc.get(key)
        if not isinstance(v, typ) or (typ is int and isinstance(v, bool)):
            problems.append(f"{key}: not a {typ}")
    queues = doc.get("queues")
    if not isinstance(queues, dict) or not isinstance(queues.get("pending"), int) \
            or not isinstance(queues.get("per_bucket"), dict):
        problems.append("queues: missing pending/per_bucket")
    if not isinstance(doc.get("devices"), list):
        problems.append("devices: not a list")
    if not isinstance(doc.get("per_device_batches"), dict):
        problems.append("per_device_batches: not a dict")
    caches = doc.get("caches")
    if not isinstance(caches, dict):
        problems.append("caches: not a dict")
    else:
        for which in ("result", "feature"):
            sub = caches.get(which)
            if not isinstance(sub, dict) or not all(
                    k in sub for k in ("hits", "misses", "evictions")):
                problems.append(f"caches.{which}: missing hits/misses/evictions")
    counters = doc.get("counters")
    if not isinstance(counters, dict) or not all(_number(v) for v in counters.values()):
        problems.append("counters: not a dict of numbers")
    compiled = doc.get("compile")
    if not isinstance(compiled, dict) or not all(
            isinstance(compiled.get(k), int) for k in ("total", "cold", "key_change")):
        problems.append("compile: missing total/cold/key_change ints")
    anomalies = doc.get("anomalies")
    if not isinstance(anomalies, list):
        problems.append("anomalies: not a list")
    else:
        for i, rec in enumerate(anomalies):
            problems += [f"anomalies[{i}]: {p}" for p in validate_anomaly(rec)]
    adm = doc.get("admission", {"enabled": 0, "max_pending": 0, "in_system": 0})
    if not isinstance(adm, dict) or not all(
            k in adm for k in ("enabled", "max_pending", "in_system")):
        problems.append("admission: missing enabled/max_pending/in_system")
    deg = doc.get("degrade", {"level": 0, "steps": []})
    if not isinstance(deg, dict) or not isinstance(deg.get("level"), int) \
            or not isinstance(deg.get("steps"), list):
        problems.append("degrade: missing level/steps")
    return problems


#: schema tag of the elastic map phase's run document: per-shard final status + winning
#: worker/epoch, per-worker commit/failure tallies with drain flags, every lease
#: reassignment with a closed-vocab cause, every fenced (stale-epoch) commit rejection,
#: and totals that must reconcile exactly — shards = committed + resumed + quarantined,
#: with reassigned shards counted once under whoever finally committed them
ELASTIC_REPORT_SCHEMA = "elastic_report/v1"

#: closed reassignment-cause vocabulary shared by the lease-service clients:
#: stale_heartbeat = the lease's heartbeat went stale past the TTL (dead or paused
#: worker); worker_exit = the worker left while it held the lease (a dropped control
#: connection: kill -9 / crash); straggler = a speculative duplicate lease was issued
#: because the shard's runtime exceeded the rolling-median-based bound; poison_worker =
#: the worker reported the resource failed (after N distinct such failures the worker is
#: drained); scale_out = a resource moved to a newly recruited worker (the JAX serving
#: fleet's rebalance, never emitted by the map client)
ELASTIC_REASSIGN_CAUSES = (
    "stale_heartbeat", "worker_exit", "straggler", "poison_worker", "scale_out",
)

#: the map client's subset: a map-shard reassignment tagged scale_out is a drift
MAP_REASSIGN_CAUSES = ("stale_heartbeat", "worker_exit", "straggler", "poison_worker")

#: closed final per-shard status vocabulary in an elastic_report/v1
ELASTIC_SHARD_STATUSES = ("committed", "resumed", "quarantined")

#: closed fence-op vocabulary: where a stale-epoch writer was rejected ("precommit" =
#: before its marker was written, the normal path; "commit" = at result submission, the
#: narrow in-flight race window)
ELASTIC_FENCE_OPS = ("precommit", "commit")


def validate_elastic_report(doc: dict) -> List[str]:
    """Structural + reconciliation check of an elastic_report/v1 document; returns the
    problems (empty: valid). Dependency-free like the other validators."""
    if not isinstance(doc, dict):
        return [f"not a dict: {type(doc).__name__}"]
    problems: List[str] = [f"metrics: {p}" for p in
                           validate_metrics_report(doc["metrics"])] if "metrics" in doc else []
    if doc.get("schema") != ELASTIC_REPORT_SCHEMA:
        problems.append(f"schema != {ELASTIC_REPORT_SCHEMA}: {doc.get('schema')!r}")
    shards = doc.get("shards")
    if not isinstance(shards, list):
        problems.append("shards: not a list")
        shards = []
    by_status = {s: 0 for s in ELASTIC_SHARD_STATUSES}
    for i, rec in enumerate(shards):
        where = f"shards[{i}]"
        if not isinstance(rec, dict):
            problems.append(f"{where}: not a dict")
            continue
        for key in ("index", "shard", "status", "worker", "epoch", "assignments",
                    "failures", "images", "wall_s"):
            if key not in rec:
                problems.append(f"{where}: missing {key!r}")
        status = rec.get("status")
        if status not in ELASTIC_SHARD_STATUSES:
            problems.append(f"{where}: bad status {status!r}")
        else:
            by_status[status] += 1
        if status == "committed" and not rec.get("worker"):
            problems.append(f"{where}: committed without a worker")
        fails = rec.get("failures", ())
        if not isinstance(fails, (list, tuple)):
            problems.append(f"{where}.failures: not a list")
            fails = ()
        for j, f in enumerate(fails):
            if not isinstance(f, dict) or "worker" not in f:
                problems.append(f"{where}.failures[{j}]: missing worker")
    workers = doc.get("workers")
    if not isinstance(workers, dict):
        problems.append("workers: not a dict")
        workers = {}
    for wid, w in workers.items():
        if not isinstance(w, dict) or not all(
                k in w for k in ("committed", "failed_shards", "drained")):
            problems.append(f"workers[{wid!r}]: missing committed/failed_shards/drained")
    reassignments = doc.get("reassignments")
    if not isinstance(reassignments, list):
        problems.append("reassignments: not a list")
        reassignments = []
    for i, r in enumerate(reassignments):
        where = f"reassignments[{i}]"
        if not isinstance(r, dict):
            problems.append(f"{where}: not a dict")
            continue
        for key in ("shard", "worker", "epoch", "cause"):
            if key not in r:
                problems.append(f"{where}: missing {key!r}")
        if r.get("cause") not in MAP_REASSIGN_CAUSES:
            problems.append(f"{where}: bad cause {r.get('cause')!r}")
    fenced = doc.get("fenced_rejections")
    if not isinstance(fenced, list):
        problems.append("fenced_rejections: not a list")
        fenced = []
    for i, r in enumerate(fenced):
        where = f"fenced_rejections[{i}]"
        if not isinstance(r, dict):
            problems.append(f"{where}: not a dict")
            continue
        for key in ("shard", "worker", "epoch", "op"):
            if key not in r:
                problems.append(f"{where}: missing {key!r}")
        if r.get("op") not in ELASTIC_FENCE_OPS:
            problems.append(f"{where}: bad op {r.get('op')!r}")
    for key in ("quarantined", "resumed"):
        if not isinstance(doc.get(key), list):
            problems.append(f"{key}: not a list")
    totals = doc.get("totals")
    if not isinstance(totals, dict):
        problems.append("totals: not a dict")
    else:
        for key in ("shards", "committed", "resumed", "quarantined", "reassignments",
                    "fenced_rejections", "workers", "drained_workers", "wall_s"):
            if key not in totals:
                problems.append(f"totals: missing {key!r}")
        # exact reconciliation: every shard settled exactly once, and the totals agree
        # with the per-shard records and event lists — a reassigned-and-committed shard
        # counts once, under its winner
        if isinstance(shards, list) and shards and not problems:
            if totals.get("shards") != len(shards):
                problems.append("totals.shards != len(shards)")
            for status in ELASTIC_SHARD_STATUSES:
                if totals.get(status) != by_status[status]:
                    problems.append(f"totals.{status} != per-shard {status} count")
            if (totals.get("committed", 0) + totals.get("resumed", 0)
                    + totals.get("quarantined", 0)) != len(shards):
                problems.append("totals: committed + resumed + quarantined != shards")
            if totals.get("reassignments") != len(reassignments):
                problems.append("totals.reassignments != len(reassignments)")
            if totals.get("fenced_rejections") != len(fenced):
                problems.append("totals.fenced_rejections != len(fenced_rejections)")
    return problems


GATE_PROBE_SCHEMA = "gate_probe/v1"
#: the refusal log keeps the newest this many records
_MAX_GATE_REFUSALS = 256
_GATE_REFUSALS: List[dict] = []


def record_gate_refusal(gate: str, cause: str, message: str = "",
                        exception: Optional[str] = None,
                        config: Optional[Dict[str, object]] = None) -> dict:
    """Append one ``gate_probe/v1`` refusal record and return it. ``cause`` is from the
    JAX package's closed list: "forward-mismatch" (the program is not what the gate
    requires) or "exception" (the check raised; ``exception`` then names the class).
    ``config`` is the gate's cache key. The record's backend is the device kind the
    port runs on (``cuda`` with the card's name, or ``cpu``)."""
    rec: dict = {"schema": GATE_PROBE_SCHEMA, "gate": gate, "cause": cause,
                 "message": message, "exception": exception,
                 "config": dict(config or {})}
    try:  # the device's identity is best effort: diagnostics never raise
        import torch

        on_card = torch.cuda.is_available()
        rec["backend"] = "cuda" if on_card else "cpu"
        rec["device_kind"] = torch.cuda.get_device_name(0) if on_card else "cpu"
    except Exception:
        rec["backend"] = rec["device_kind"] = None
    _GATE_REFUSALS.append(rec)
    del _GATE_REFUSALS[:-_MAX_GATE_REFUSALS]
    return rec


def gate_refused(gate: str, reason: str, cause: str,
                 config: Optional[Dict[str, object]] = None,
                 exception: Optional[str] = None) -> bool:
    """:func:`record_gate_refusal`, plus a stderr line under ``TMR_GATE_DEBUG``; returns
    False, so a gate can ``return gate_refused(...)``."""
    import os
    import sys

    record_gate_refusal(gate, cause, message=reason, exception=exception, config=config)
    if os.environ.get("TMR_GATE_DEBUG"):
        print(f"[gate] {gate}: refused - {reason}", file=sys.stderr)
    return False


def gate_refusals() -> List[dict]:
    """The recorded refusals, oldest first (not cleared)."""
    return list(_GATE_REFUSALS)


def drain_gate_refusals() -> List[dict]:
    """The recorded refusals, oldest first, and the log cleared."""
    out = list(_GATE_REFUSALS)
    _GATE_REFUSALS.clear()
    return out
