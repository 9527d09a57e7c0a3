"""Map-report schema and validator (counterpart of the map part of
``tmr_tpu/diagnostics.py``).

``map_report/v1`` is the map phase's structured report (``parallel/mapreduce.MapReport``,
written by ``map --report_out``): per-shard status, attempts and causes, the quarantined
and resumed lists, skipped-image and non-finite counts, retry totals and wall seconds
per shard. The JAX package's report also carries a ``metrics`` key (a
``metrics_report/v1`` snapshot) and, under its flight recorder, an ``mfu`` key; the
port's report has neither until the port has the measurement plane (ROADMAP A8), and
:func:`validate_map_report` refuses them by name when they are present rather than
passing them unchecked.
"""

from __future__ import annotations

from typing import List

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
