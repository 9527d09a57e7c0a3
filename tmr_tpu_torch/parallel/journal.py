"""Durable per-shard journal of the map phase (counterpart of
``tmr_tpu/parallel/journal.py``): the crash-resume ledger.

One small JSON done-marker per shard, written atomically after the shard's last feature
``.npy`` has landed. A marker holds what the reducer needs from the shard (the float64
category sums, the image count, the skipped and non-finite tallies) and a sha256 digest
over those fields, so ``map --resume`` folds journaled shards into the table without
re-encoding them and still gives a byte-identical table (float64 values survive the
JSON round trip; a truncated or edited marker fails the digest and the shard re-runs).
The marker's bytes are the JAX package's: the same fields, the same digest, the same
``map_journal/v1`` tag, so either package resumes from the other's journal.

Layout: ``<features_out>/_journal/<shard-stem>.json`` (``--journal_dir`` overrides).
Order is the contract: features first, marker last. The elastic map phase
(``parallel/elastic.py``) also writes ``worker`` / ``epoch`` fields (outside the digest,
so markers with and without them read alike in both packages) and fences each commit on
the worker's current lease epoch: ``record(fence=...)`` runs the fence after the
``journal`` fault point and before any marker byte touches disk, and a fence that raises
:class:`StaleLeaseError` leaves no marker. The map executor treats that error as a
failure that retrying cannot heal.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Dict, Optional

from tmr_tpu_torch.utils import faults
from tmr_tpu_torch.utils.atomicio import atomic_write

#: schema tag stamped on every done-marker — bump on incompatible change
MAP_JOURNAL_SCHEMA = "map_journal/v1"


class StaleLeaseError(RuntimeError):
    """A journal commit was fenced: the committing worker's lease epoch
    is no longer current (revoked after a stale heartbeat / worker exit,
    or the shard was already committed by a straggler duplicate). The
    attempt must NOT retry — the shard belongs to someone else now —
    so the map executor treats this as non-retryable."""

#: payload fields covered by the digest (order matters — it is the
#: canonical serialization the digest is computed over)
_DIGEST_FIELDS = (
    "shard", "category", "images", "skipped_images", "skipped_members",
    "nonfinite_images", "sums",
)


def _digest(entry: dict) -> str:
    blob = json.dumps(
        [entry.get(k) for k in _DIGEST_FIELDS], sort_keys=True
    ).encode()
    return hashlib.sha256(blob).hexdigest()


def shard_stem(shard_name: str) -> str:
    """Marker filename stem for a shard (path separators flattened so a
    nested shard name cannot escape the journal directory)."""
    base = os.path.basename(shard_name)
    if base.endswith(".tar"):
        base = base[: -len(".tar")]
    return base.replace(os.sep, "_").replace("/", "_") or "_unnamed"


class ShardJournal:
    """Read/write the per-shard done-markers under one directory."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, shard_name: str) -> str:
        return os.path.join(self.directory, shard_stem(shard_name) + ".json")

    def record(
        self,
        shard_name: str,
        category: int,
        sums,
        images: int,
        skipped_images: int = 0,
        skipped_members: int = 0,
        nonfinite_images: int = 0,
        attempts: int = 1,
        wall_s: float = 0.0,
        worker: Optional[str] = None,
        epoch: Optional[int] = None,
        fence: Optional[Callable[[], None]] = None,
    ) -> dict:
        """Atomically commit the done-marker for one shard. The ``journal``
        fault point fires before anything touches disk, so an injected
        journal failure leaves no marker at all (the shard re-runs).
        ``fence`` (when given) runs after the fault point and before the
        write: raising (StaleLeaseError) aborts the commit marker-less —
        the stale-epoch rejection the elastic coordinator counts."""
        faults.fire("journal")
        if fence is not None:
            fence()
        entry = {
            "schema": MAP_JOURNAL_SCHEMA,
            "shard": shard_name,
            "category": int(category),
            "images": int(images),
            "skipped_images": int(skipped_images),
            "skipped_members": int(skipped_members),
            "nonfinite_images": int(nonfinite_images),
            "sums": [float(v) for v in sums],
            "attempts": int(attempts),
            "wall_s": float(wall_s),
        }
        if worker is not None:
            entry["worker"] = str(worker)
        if epoch is not None:
            entry["epoch"] = int(epoch)
        entry["digest"] = _digest(entry)
        atomic_write(self._path(shard_name), lambda f: json.dump(entry, f))
        return entry

    def invalidate(self, shard_name: str) -> None:
        """Remove a shard's done-marker (if any) — called when the shard
        is quarantined so a marker from an EARLIER successful run cannot
        vouch for features a later run just cleaned up."""
        try:
            os.unlink(self._path(shard_name))
        except FileNotFoundError:
            pass

    def done(self, shard_name: str) -> Optional[dict]:
        """The validated done-marker for a shard, or None when missing,
        unparseable, schema-mismatched, or digest-corrupt — all of which
        mean 'not done, run it again'."""
        path = self._path(shard_name)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                entry = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(entry, dict):
            return None
        if entry.get("schema") != MAP_JOURNAL_SCHEMA:
            return None
        if entry.get("digest") != _digest(entry):
            return None
        return entry

    def load_all(self) -> Dict[str, dict]:
        """Every valid marker in the directory, keyed by recorded shard
        name (diagnostics/debug — resume uses per-shard ``done``)."""
        out: Dict[str, dict] = {}
        for fn in sorted(os.listdir(self.directory)):
            if not fn.endswith(".json"):
                continue
            stem = fn[: -len(".json")]
            entry = self.done(stem + ".tar")
            if entry is not None:
                out[entry["shard"]] = entry
        return out
