"""The map phase: streaming feature extraction over tar shards (counterpart of
``tmr_tpu/parallel/mapreduce.py``, the reference's Hadoop mapper.py + reducer.py).

Reference pipeline: a shard list on stdin -> per tar, per image, the SAM ViT-B encoder
-> 4 statistics (mean, std, max, sparsity; mapper.py:103-114) summed per category, and
the features dumped as ``.npy`` -> ``category\\tsum_mean,sum_std,sum_max,sum_spar,count``
records (:138) -> the reducer's per-category averages table (reducer.py:25-27).

The port: host feeder threads read and decode shards (``tarfile``, or the native C++
reader of ``data/native_io.py``) while the main thread drives the card; the encoder runs
on fixed batches (a short tail padded with zero images, whose rows are dropped from the
statistics and the dumps); the statistics are computed on the card, and the features
come to the host in one copy per batch, only when they are saved. Features are NHWC
``(S/16, S/16, 256)`` float32 per image, as the JAX encoder gives them (the port's
``SamViT`` returns NCHW; the batch is permuted once on the card).

Fault tolerance, as in the JAX package: each shard runs through a retrying executor
(attempts with capped exponential backoff and deterministic jitter; a stall timeout on
the load half that measures heartbeats, not wall time; quarantine with a recorded cause
after the last attempt or on a failure that retrying cannot heal, its partial feature
files removed). Feature writes are atomic; the journal (``parallel/journal.py``) commits
a done-marker after a shard's last feature, and ``resume=True`` folds journaled shards
into the table without re-encoding them. Shard sums are folded into the float64 table
once per shard, in shard-list order, so a resumed table is byte-identical to an
uninterrupted one. Non-finite per-image statistics are excluded and counted. The run is
described by a ``map_report/v1`` document (``diagnostics.py``), and the fault points of
``utils/faults.py`` are threaded through it.

``--artifact`` (``make_encode_stats_fn_from_artifact``) encodes with an exported encoder
(``utils/export.py``, ``python -m tmr_tpu_torch.export_encoder``) in place of the model:
no model is built and no checkpoint is read. ``--features_out tcp://host:port`` streams
the features into a serve-side ``serve/gallery.FeatureSinkServer`` (the JAX package's
wire: a JAX sink takes a port worker's stream and the other way round) in place of
``.npy`` files. Not ported yet, and refused by name: ``allreduce_stats`` (ROADMAP A7,
``torch.distributed``). The JAX package's ``obs`` counters, spans and flight records of
the executor, and the report's ``metrics`` key, wait for the measurement plane (A8).
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import shutil
import socket
import sys
import tarfile
import threading
import time
from collections import Counter, deque
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from tmr_tpu_torch.data import transforms
from tmr_tpu_torch.diagnostics import MAP_REPORT_SCHEMA
from tmr_tpu_torch.parallel.journal import ShardJournal, StaleLeaseError, shard_stem
from tmr_tpu_torch.utils import faults
from tmr_tpu_torch.utils.atomicio import atomic_write, fsync_dir
from tmr_tpu_torch.utils.profiling import log_info, log_progress, log_warning

CATEGORIES = ("Easy", "Normal", "Hard", "Unknown")  # mapper.py:15-20
STAT_NAMES = ("sum_mean", "sum_std", "sum_max", "sum_spar", "count")
IMAGE_SUFFIXES = (".png", ".jpg", ".jpeg")

#: failures that retrying cannot heal (a structurally corrupt tar, a missing shard, a
#: journal commit fenced off by a revoked lease): quarantined on first sight
_NON_RETRYABLE = (tarfile.ReadError, FileNotFoundError, NotADirectoryError,
                  IsADirectoryError, StaleLeaseError)

#: the ROADMAP items of what the port refuses
_REFUSED = {
    "allreduce": "allreduce_stats needs the torch.distributed port (ROADMAP A7)",
}


def category_of(shard_name: str) -> int:
    folder = os.path.basename(shard_name).replace(".tar", "")
    for i, c in enumerate(CATEGORIES[:3]):
        if folder.startswith(c + "_"):
            return i
    return 3


def preprocess_image(data: bytes, size: int = 1024) -> Optional[np.ndarray]:
    """The mapper's preprocessing (mapper.py:22-30) up to the divide: decode to RGB
    (``transforms.decode_image``), Pillow's BICUBIC resize to (size, size)
    (``transforms.resize_bicubic_u8``): uint8 (size, size, 3), or None for an image that
    cannot be decoded. The encoder divides by 255 on the card (:func:`make_encode_stats_fn`),
    giving the JAX package's float32 ``/ 255`` values exactly."""
    faults.fire("decode")
    data = faults.corrupt_bytes("decode", data)
    try:
        return transforms.resize_bicubic_u8(transforms.decode_image(data), size, size)
    except Exception:
        return None  # a bad image is skipped, like mapper.py:31-32


def _bump(counts: Optional[dict], key: str) -> None:
    if counts is not None:
        counts[key] = counts.get(key, 0) + 1


def iter_tar_images(path: str, size: int = 1024, counts: Optional[dict] = None,
                    heartbeat: Optional[Callable[[], None]] = None
                    ) -> Iterator[tuple[str, np.ndarray]]:
    """Stream (member name, uint8 image) from a tar shard, skipping what cannot be read.

    ``counts`` tallies what was dropped: ``skipped_members`` (image members whose
    payload could not be read out of the tar) and ``skipped_images`` (payloads that do
    not decode). ``heartbeat`` is called once per member scanned, skipped ones too, so
    the executor's stall detector sees every step of the read."""
    with tarfile.open(path, "r") as tar:
        for member in tar:
            if heartbeat is not None:
                heartbeat()
            if not member.isfile() or not member.name.lower().endswith(IMAGE_SUFFIXES):
                continue
            data = tar.extractfile(member)
            if data is None:
                _bump(counts, "skipped_members")
                continue
            raw = data.read()
            faults.fire("tar.member")
            raw = faults.corrupt_bytes("tar.member", raw)
            img = preprocess_image(raw, size)
            if img is None:
                _bump(counts, "skipped_images")
                continue
            yield member.name, img


def feature_stats(features: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> (B, 4) float32 [mean, std, max, sparsity] per image, on the
    features' device. Sparsity is the share of elements <= 0 (mapper.py:107); std is
    the population std, as ``np.std``. The layout of the features does not matter."""
    flat = features.reshape(features.shape[0], -1).float()
    mean = flat.mean(dim=1)
    std = torch.sqrt(((flat - mean[:, None]) ** 2).mean(dim=1))
    return torch.stack([mean, std, flat.amax(dim=1), (flat <= 0).float().mean(dim=1)],
                       dim=1)


def _to_unit(device: torch.device) -> Callable:
    """(uint8 images, numpy) -> float32 ``x / 255`` on ``device``: the images go there as
    uint8 and are looked up in a table of numpy's quotients (a CUDA divide by a scalar is
    a reciprocal multiply, an ulp off)."""
    lut = torch.from_numpy(np.arange(256, dtype=np.float32) / np.float32(255.0)).to(device)
    return lambda images: lut[torch.from_numpy(np.ascontiguousarray(images)).to(
        device).long()]


def make_encode_stats_fn(encoder: torch.nn.Module) -> Callable:
    """(uint8 images (B, S, S, 3), numpy) -> (features (B, S/16, S/16, C) float32 NHWC,
    stats (B, 4)), both on the encoder's device."""
    from tmr_tpu_torch.models.vit import nhwc_features

    to_unit = _to_unit(next(encoder.parameters()).device)

    @torch.inference_mode()
    def run(images: np.ndarray):
        feats = nhwc_features(encoder, to_unit(images))
        return feats, feature_stats(feats)

    return run


def make_encode_stats_fn_from_artifact(path: str, device=None) -> Callable:
    """:func:`make_encode_stats_fn` from an exported encoder (``utils/export.py``), the
    onnxruntime session of mapper.py:40-45: the worker needs the artifact and the port's
    ops package, no model code and no weights. It runs on ``device`` (the card unless
    ``"cpu"`` is asked for); its features equal the eager encoder's bit for bit."""
    from tmr_tpu_torch.models import resolve_device
    from tmr_tpu_torch.utils.export import load_exported

    device = resolve_device(device)
    encoder = load_exported(path, device)
    to_unit = _to_unit(device)

    @torch.inference_mode()
    def run(images: np.ndarray):
        feats = encoder(to_unit(images))
        return feats, feature_stats(feats)

    return run


def allreduce_stats(table, axis_name: str = "data"):
    raise NotImplementedError(_REFUSED["allreduce"])


class StatAccumulator:
    """Per-category running sums: a dense float64 (4 categories x 5 values) table."""

    def __init__(self):
        self.table = np.zeros((len(CATEGORIES), len(STAT_NAMES)), np.float64)

    def add_totals(self, category: int, sums) -> None:
        """Fold one shard's finished (5,) float64 sums in as one addition: a journaled
        shard replays the addition its live run made, so resumed tables are
        byte-identical."""
        self.table[category] += np.asarray(sums, np.float64)

    def emit_lines(self) -> list[str]:
        """The mapper's shuffle records (mapper.py:138)."""
        lines = []
        for i, cat in enumerate(CATEGORIES):
            m, s, x, sp, n = self.table[i]
            if n > 0:
                lines.append(f"{cat}\t{m},{s},{x},{sp},{int(n)}")
        return lines


def format_stats_table(sums_by_key: dict) -> str:
    """The averages table over {key: (5,) sums}, as reducer.py:25-27 prints it."""
    out = [
        f"{'CATEGORY':<12} | {'IMAGES':>6} | {'AVG_MEAN':>8} | {'AVG_STD':>8} | "
        f"{'AVG_MAX':>8} | {'SPARSITY':>9}",
        "-" * 70,
    ]
    for cat, sums in sums_by_key.items():
        n = sums[4]
        if n <= 0:
            continue
        avg = np.asarray(sums[:4]) / n
        out.append(f"{cat:<12} | {int(n):>6} | {avg[0]:>8.4f} | {avg[1]:>8.4f} | "
                   f"{avg[2]:>8.4f} | {avg[3]:>7.2%}")
    return "\n".join(out)


def reducer_table(table: np.ndarray) -> str:
    """The table of a StatAccumulator matrix (reducer.py:25-27,39-42)."""
    return format_stats_table({cat: table[i] for i, cat in enumerate(CATEGORIES)})


def reduce_lines(lines: Iterable[str]) -> dict:
    """The reducer's group-by-key sums (reducer.py:47-92) over
    ``category\\tsum_mean,sum_std,sum_max,sum_spar,count`` records, read as they come;
    unsorted input is fine, and malformed lines are logged and skipped."""
    sums: dict = {}
    for raw in lines:
        line = raw.strip()
        if not line:
            continue
        try:
            key, payload = line.split("\t")
            vals = [float(v) for v in payload.split(",")]
            if len(vals) != 5:
                raise ValueError(f"expected 5 values, got {len(vals)}")
        except Exception as e:
            log_warning(f"skipping malformed line {line!r}: {e}")
            continue
        acc = sums.setdefault(key, np.zeros(5, np.float64))
        acc += np.asarray(vals, np.float64)
    return sums


# ------------------------------------------------------------ retry policy
def backoff_delay(attempt: int, base: float = 0.5, cap: float = 30.0,
                  jitter: float = 0.5, key: int = 0) -> float:
    """Delay before retry ``attempt`` (1 = the first retry): ``min(cap, base *
    2**(attempt-1))`` plus a deterministic jitter share in [0, jitter] of it, keyed on
    (key, attempt), so replays sleep alike and concurrent runs spread out."""
    d = min(cap, base * (2.0 ** max(attempt - 1, 0)))
    if jitter > 0.0:
        d *= 1.0 + jitter * random.Random(int(key) * 1000003 + attempt).random()
    return d


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """The executor's knobs. ``shard_timeout`` is a stall budget on each attempt's load
    half: the attempt fails when the loader makes no member progress for that many
    seconds (None: no budget). ``max_attempts`` bounds the tries before quarantine."""

    max_attempts: int = 3
    shard_timeout: Optional[float] = None
    backoff_base: float = 0.5
    backoff_max: float = 30.0
    backoff_jitter: float = 0.5
    seed: int = 0

    def delay(self, shard_index: int, attempt: int) -> float:
        return backoff_delay(attempt, base=self.backoff_base, cap=self.backoff_max,
                             jitter=self.backoff_jitter,
                             key=(self.seed << 20) ^ shard_index)


class MapReport:
    """Assembles the ``map_report/v1`` document: per-shard records in shard-list order
    and their totals (``diagnostics.validate_map_report`` checks it)."""

    def __init__(self):
        self.shards: List[dict] = []

    def add(self, record: dict) -> None:
        self.shards.append(record)

    def document(self) -> dict:
        shards = sorted(self.shards, key=lambda r: r.get("index", 0))

        def count(status):
            return sum(1 for r in shards if r["status"] == status)

        totals = {
            "shards": len(shards),
            "ok": count("ok"),
            "quarantined": count("quarantined"),
            "resumed": count("resumed"),
            "images": sum(r["images"] for r in shards),
            "skipped_images": sum(r["skipped_images"] for r in shards),
            "skipped_members": sum(r.get("skipped_members", 0) for r in shards),
            "nonfinite_images": sum(r["nonfinite_images"] for r in shards),
            "retries": sum(max(r["attempts"] - 1, 0) for r in shards),
            "wall_s": sum(r["wall_s"] for r in shards),
        }
        return {
            "schema": MAP_REPORT_SCHEMA,
            "shards": shards,
            "quarantined": [r["shard"] for r in shards if r["status"] == "quarantined"],
            "resumed": [r["shard"] for r in shards if r["status"] == "resumed"],
            "totals": totals,
        }

    def write(self, path: str) -> None:
        doc = self.document()

        def dump(f):
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")

        atomic_write(path, dump)

    def summary_line(self) -> str:
        t = self.document()["totals"]
        return (f"map: {t['ok']} ok / {t['resumed']} resumed / {t['quarantined']} "
                f"quarantined of {t['shards']} shards; {t['images']} images encoded, "
                f"{t['skipped_images']} undecodable skipped, {t['skipped_members']} "
                f"unreadable members, {t['nonfinite_images']} non-finite excluded, "
                f"{t['retries']} retries")


def atomic_save_npy(path: str, arr: np.ndarray) -> None:
    """Write a ``.npy`` through tmp + fsync + ``os.replace``, without the directory
    fsync: one :func:`fsync_dir` per shard, right before its journal commit, makes the
    renames durable."""
    atomic_write(path, lambda f: np.save(f, arr), mode="wb", sync_dir=False)


def make_feature_sinks(features_out: Optional[str]):
    """(save, cleanup, sync) callables writing each image's features to
    ``features_out/<category>/<shard>/<image>.npy`` (mapper.py:126-130), the JAX
    package's layout; all None when features are off. A ``tcp://host:port`` target
    streams them to a feature sink instead (:func:`_network_feature_sinks`)."""
    if not features_out:
        return None, None, None
    if str(features_out).startswith("tcp://"):
        return _network_feature_sinks(str(features_out))

    def shard_dir(shard: str) -> str:
        return os.path.join(features_out, CATEGORIES[category_of(shard)],
                            shard.replace(".tar", ""))

    def save(shard: str, name: str, feat) -> None:
        d = shard_dir(shard)
        os.makedirs(d, exist_ok=True)
        base = os.path.splitext(os.path.basename(name))[0]
        atomic_save_npy(os.path.join(d, base + ".npy"), feat)

    def cleanup(shard: str) -> None:
        shutil.rmtree(shard_dir(shard), ignore_errors=True)

    def sync(shard: str) -> None:
        fsync_dir(shard_dir(shard))

    return save, cleanup, sync


def _network_feature_sinks(url: str):
    """(save, cleanup, sync) streaming over the JSON-lines protocol to a
    ``serve/gallery.FeatureSinkServer`` at ``tcp://host:port`` (the JAX
    ``parallel/elastic._network_feature_sinks``, byte for byte the same lines).

    ``save`` pipelines one feature line per image with no ack; ``sync``, called before
    the shard's journal marker commits, waits for the one ack that vouches for every
    feature sent before it on the same ordered connection. A dirty ack or any socket
    error raises ``ConnectionError``, failing the shard attempt, so the executor's
    retries stream the shard again. One connection per process, dialed lazily and
    dropped on error; ``cleanup`` is the quarantine eviction."""
    from tmr_tpu_torch.parallel.leases import connect_timeout, recv_line, send_line
    from tmr_tpu_torch.serve.fleet import pack_array

    host, _, port_s = url[len("tcp://"):].rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        port = None
    if not host or port is None:
        raise ValueError(f"feature-sink url {url!r}: expected tcp://host:port")
    state = {"sock": None, "file": None}
    lock = threading.Lock()

    def _drop_locked() -> None:
        for key in ("file", "sock"):
            obj, state[key] = state[key], None
            if obj is not None:
                try:
                    obj.close()
                except OSError:
                    pass

    def _conn_locked():
        if state["sock"] is None:
            sock = socket.create_connection((host, port), timeout=connect_timeout())
            # a dead sink must fail the shard attempt (retried), never wedge the worker
            sock.settimeout(60.0)
            f = sock.makefile("rb")
            state["sock"], state["file"] = sock, f
            send_line(sock, {"op": "hello", "worker": f"map-{os.getpid()}"})
            reply = recv_line(f)
            if not (reply and reply.get("ok")):
                _drop_locked()
                raise ConnectionError(f"feature sink {host}:{port} refused hello: "
                                      f"{reply!r}")
        return state["sock"], state["file"]

    def _exchange(doc: dict, want_ack: bool) -> Optional[dict]:
        with lock:
            try:
                sock, f = _conn_locked()
                send_line(sock, doc)
                if not want_ack:
                    return None
                reply = recv_line(f)
            except (OSError, ValueError) as e:
                _drop_locked()
                raise ConnectionError(f"feature sink {host}:{port} unreachable: {e}") from e
            if reply is None:
                _drop_locked()
                raise ConnectionError(f"feature sink {host}:{port} closed mid-exchange")
            return reply

    def save(shard: str, name: str, feat) -> None:
        base = os.path.splitext(os.path.basename(name))[0]
        _exchange({"op": "feature", "shard": shard_stem(shard), "name": base,
                   "array": pack_array(feat)}, want_ack=False)

    def cleanup(shard: str) -> None:
        _exchange({"op": "evict", "shard": shard_stem(shard)}, want_ack=True)

    def sync(shard: str) -> None:
        reply = _exchange({"op": "sync", "shard": shard_stem(shard)}, want_ack=True)
        if not reply.get("ok"):
            # the retry dials afresh rather than inheriting a half-streamed connection
            with lock:
                _drop_locked()
            raise ConnectionError(f"feature sink {host}:{port} reported "
                                  f"{reply.get('errors')} failed features for {shard}")

    return save, cleanup, sync


# --------------------------------------------------------- shard executor
@dataclasses.dataclass
class _ShardTask:
    index: int
    path: str
    category: int
    attempt: int = 0
    causes: List[dict] = dataclasses.field(default_factory=list)


class _LoadBox:
    """Result slot of one shard-load attempt on a daemon thread (a wedged read parks the
    thread instead of blocking exit). ``progress`` is the heartbeat the loader bumps per
    tar member: the executor's timeout measures a stall, not the total load time."""

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None
        self.progress = 0


def _spawn_load(task: _ShardTask, loader: Callable, image_size: int) -> _LoadBox:
    box = _LoadBox()

    def run():
        try:
            with faults.shard_scope(task.index, task.attempt):
                box.value = loader(task.path, image_size, box)
        except BaseException as e:  # noqa: BLE001 - classified by the executor
            box.error = e
        finally:
            box.event.set()

    threading.Thread(target=run, daemon=True,
                     name=f"shard-load-{task.index}-a{task.attempt}").start()
    return box


def _wait_or_stall(box: _LoadBox, stall_timeout: Optional[float]) -> bool:
    """Wait for the load; False when it went ``stall_timeout`` seconds without finishing
    or advancing its heartbeat."""
    if stall_timeout is None:
        box.event.wait()
        return True
    seen = box.progress
    while True:
        if box.event.wait(stall_timeout):
            return True
        if box.progress == seen:
            return False
        seen = box.progress


def _load_shard_python(path: str, image_size: int, box: _LoadBox):
    """One shard through ``tarfile``: ([(name, image)], counts). The whole decoded shard
    is held, so that the shard is the unit of retry and journal; peak memory is about
    ``feeder_threads + 1`` decoded shards."""
    faults.fire("tar.open")
    counts = {"skipped_members": 0, "skipped_images": 0}

    def beat():
        box.progress += 1

    return list(iter_tar_images(path, image_size, counts=counts, heartbeat=beat)), counts


def _load_shard_native(path: str, image_size: int, box: _LoadBox):
    """One shard through the native reader (``data/native_io.py``), one single-thread
    stream a shard. The C++ parser flags an unreadable stream, not single members, so
    ``skipped_members`` stays 0 on this path."""
    from tmr_tpu_torch.data.native_io import NativeTarStream

    faults.fire("tar.open")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)  # non-retryable, as on the Python path
    counts = {"skipped_members": 0, "skipped_images": 0}
    images = []
    with NativeTarStream([path], threads=1) as stream:
        for _, member, data in stream:
            box.progress += 1
            if not member.lower().endswith(IMAGE_SUFFIXES):
                continue
            faults.fire("tar.member")
            data = faults.corrupt_bytes("tar.member", data)
            img = preprocess_image(data, image_size)
            if img is None:
                counts["skipped_images"] += 1
                continue
            images.append((member, img))
        if stream.errors:
            # structural corruption is deterministic: the class tarfile would raise
            raise tarfile.ReadError(f"native IO: unreadable shard {path}")
    return images, counts


def _encode_shard(task: _ShardTask, images, encode_stats_fn: Callable, batch_size: int,
                  save_features):
    """Encode one loaded shard: its (5,) float64 sums and its non-finite count. Images
    whose statistics are not finite are left out of the sums and the dumps, and counted.
    The features come to the host once per batch, and only when they are saved."""
    shard_base = os.path.basename(task.path)
    sums = np.zeros(len(STAT_NAMES), np.float64)
    nonfinite = 0
    with faults.shard_scope(task.index, task.attempt):
        for i in range(0, len(images), batch_size):
            chunk = images[i:i + batch_size]
            names = [n for n, _ in chunk]
            arr = np.stack([im for _, im in chunk])
            real = len(arr)
            if real < batch_size:  # pad to the batch shape with zero images
                arr = np.concatenate(
                    [arr, np.zeros((batch_size - real,) + arr.shape[1:], arr.dtype)])
            faults.fire("encode")
            feats, stats = encode_stats_fn(arr)
            if save_features is not None:
                feats = feats[:real].cpu().numpy()
                feats, stats = faults.poison("encode", feats,
                                             stats[:real].cpu().numpy())
            else:
                stats = faults.poison("encode", stats[:real].cpu().numpy())
            finite = np.isfinite(stats).all(axis=1)
            nonfinite += int((~finite).sum())
            sums[:4] += stats[finite].sum(axis=0)
            sums[4] += int(finite.sum())
            if save_features is not None:
                for name, feat, keep in zip(names, feats, finite):
                    if keep:
                        faults.fire("save")
                        save_features(shard_base, name, feat)
    return sums, nonfinite


def _cleanup_quarantined(task: _ShardTask, cleanup_features) -> None:
    """A quarantined shard added nothing to the table: its orphaned feature files go."""
    if cleanup_features is None:
        return
    try:
        cleanup_features(os.path.basename(task.path))
    except Exception as e:
        log_warning(f"could not clean quarantined shard features for "
                    f"{os.path.basename(task.path)}: {e}")


def _resumed_record(index: int, path: str, entry: dict) -> dict:
    return {
        "index": index,
        "shard": os.path.basename(path),
        "category": CATEGORIES[entry["category"]],
        "status": "resumed",
        "attempts": 0,
        "causes": [],
        "images": entry["images"],
        "skipped_images": entry["skipped_images"],
        "skipped_members": entry.get("skipped_members", 0),
        "nonfinite_images": entry["nonfinite_images"],
        "wall_s": 0.0,
    }


def _run_stream_impl(shard_paths: Sequence[str], encode_stats_fn: Callable,
                     batch_size: int, image_size: int, save_features,
                     feeder_threads: int, loader: Callable, retry: Optional[RetryPolicy],
                     journal, resume: bool, report: Optional[MapReport],
                     cleanup_features=None, sync_features=None) -> StatAccumulator:
    retry = retry or RetryPolicy()
    if journal is not None:
        # markers are keyed on the shard's stem: two paths sharing one would share a
        # marker, so refuse before corrupting the resume ledger
        dupes = [n for n, c in Counter(shard_stem(p) for p in shard_paths).items()
                 if c > 1]
        if dupes:
            raise ValueError(f"duplicate shard journal keys {dupes!r} cannot be journaled "
                             "unambiguously; rename the shards or disable the journal")
    acc = StatAccumulator()
    # (index, category, sums) per finished shard, folded into the table at the end in
    # shard-list order: a resumed run makes the fault-free run's float64 additions in
    # the same order even when its journaled shards are not a prefix
    contributions: List[tuple] = []

    live: List[_ShardTask] = []
    for index, path in enumerate(shard_paths):
        entry = (journal.done(os.path.basename(path))
                 if journal is not None and resume else None)
        if entry is None:
            live.append(_ShardTask(index, path, category_of(path)))
            continue
        contributions.append((index, entry["category"], entry["sums"]))
        log_progress(f"shard {os.path.basename(path)}: resumed from journal "
                     f"({entry['images']} images)")
        if report is not None:
            report.add(_resumed_record(index, path, entry))

    pending = deque(live)
    inflight: deque = deque()

    def launch_next() -> None:
        if pending:
            task = pending.popleft()
            inflight.append((task, _spawn_load(task, loader, image_size)))

    for _ in range(max(feeder_threads, 1) + 1):
        launch_next()

    # shards are processed strictly in list order (retries inline): the journal is
    # always a prefix of the list minus quarantines, so a resume re-does only the work
    # that was in flight
    while inflight:
        task, box = inflight.popleft()
        t_start = time.monotonic()
        status = "quarantined"
        sums = None
        counts = {"skipped_members": 0, "skipped_images": 0}
        nonfinite = 0
        n_images = 0
        shard_base = os.path.basename(task.path)
        while True:
            failure: Optional[dict] = None
            if not _wait_or_stall(box, retry.shard_timeout):
                failure = {"attempt": task.attempt, "cause": "timeout",
                           "error": f"shard load stalled: no progress for "
                                    f"{retry.shard_timeout}s"}
            elif box.error is not None:
                err = box.error
                if isinstance(err, (KeyboardInterrupt, SystemExit)):
                    raise err  # a crash is a crash: resume handles it
                failure = {"attempt": task.attempt, "cause": "exception",
                           "error": f"{type(err).__name__}: {err}"}
                if isinstance(err, _NON_RETRYABLE):
                    failure["retryable"] = False
            else:
                images, counts = box.value
                log_progress(f"shard {shard_base}: {len(images)} images "
                             f"({CATEGORIES[task.category]}, attempt {task.attempt + 1})")
                try:
                    sums, nonfinite = _encode_shard(task, images, encode_stats_fn,
                                                    batch_size, save_features)
                    n_images = int(sums[4])
                    if journal is not None:
                        if sync_features is not None:
                            # one directory fsync makes the shard's feature renames
                            # durable before the marker that vouches for them
                            sync_features(shard_base)
                        with faults.shard_scope(task.index, task.attempt):
                            journal.record(
                                shard_base, category=task.category, sums=sums,
                                images=n_images, skipped_images=counts["skipped_images"],
                                skipped_members=counts["skipped_members"],
                                nonfinite_images=nonfinite, attempts=task.attempt + 1,
                                wall_s=time.monotonic() - t_start)
                    status = "ok"
                    break
                except Exception as e:
                    failure = {"attempt": task.attempt, "cause": "exception",
                               "error": f"{type(e).__name__}: {e}"}
                    if isinstance(e, _NON_RETRYABLE):
                        failure["retryable"] = False

            task.causes.append(failure)
            task.attempt += 1
            retryable = failure.pop("retryable", True)
            if task.attempt >= retry.max_attempts or not retryable:
                log_warning(f"quarantining shard {shard_base} after {task.attempt} "
                            f"attempt(s): {failure['error']}")
                break
            time.sleep(retry.delay(task.index, task.attempt))
            box = _spawn_load(task, loader, image_size)

        if status == "ok":
            contributions.append((task.index, task.category, sums))
        else:
            if journal is not None:
                # a marker of an earlier run must not vouch for features just cleaned
                journal.invalidate(shard_base)
            _cleanup_quarantined(task, cleanup_features)
        launch_next()
        if report is not None:
            # a quarantined shard added nothing to the table, even when a late attempt
            # got through its encode: zeros keep the totals equal to the table's counts
            ok = status == "ok"
            report.add({
                "index": task.index,
                "shard": shard_base,
                "category": CATEGORIES[task.category],
                "status": status,
                "attempts": task.attempt + (1 if ok else 0),
                "causes": task.causes,
                "images": n_images if ok else 0,
                "skipped_images": counts["skipped_images"] if ok else 0,
                "skipped_members": counts["skipped_members"] if ok else 0,
                "nonfinite_images": nonfinite if ok else 0,
                "wall_s": time.monotonic() - t_start,
            })
    for _, category, sums in sorted(contributions, key=lambda c: c[0]):
        acc.add_totals(category, sums)
    return acc


def run_stream(shard_paths: Sequence[str], encode_stats_fn: Callable, batch_size: int = 8,
               image_size: int = 1024,
               save_features: Optional[Callable[[str, str, np.ndarray], None]] = None,
               feeder_threads: int = 4, *, retry: Optional[RetryPolicy] = None,
               journal=None, resume: bool = False, report: Optional[MapReport] = None,
               cleanup_features=None, sync_features=None) -> StatAccumulator:
    """The map phase over tar shards on one card, reading them with ``tarfile``.

    Feeder threads decode shards ahead of the card; the encoder runs on batches of
    ``batch_size`` (short tails padded and left out). ``save_features(shard, image_name,
    features)`` dumps each image's features (mapper.py:117-118). ``retry`` (attempts,
    backoff, stall timeout, quarantine), ``journal`` (``ShardJournal``) with ``resume``,
    ``report`` (``MapReport``), ``cleanup_features(shard)`` for quarantined shards and
    ``sync_features(shard)`` before each journal commit are the fault-tolerance hooks."""
    return _run_stream_impl(shard_paths, encode_stats_fn, batch_size, image_size,
                            save_features, feeder_threads, _load_shard_python, retry,
                            journal, resume, report, cleanup_features, sync_features)


def run_stream_native(shard_paths: Sequence[str], encode_stats_fn: Callable,
                      batch_size: int = 8, image_size: int = 1024,
                      save_features: Optional[Callable[[str, str, np.ndarray], None]] = None,
                      feeder_threads: int = 4, *, retry: Optional[RetryPolicy] = None,
                      journal=None, resume: bool = False,
                      report: Optional[MapReport] = None, cleanup_features=None,
                      sync_features=None) -> StatAccumulator:
    """:func:`run_stream` with the tars parsed by the native C++ reader, outside the GIL;
    the same semantics and the same table."""
    return _run_stream_impl(shard_paths, encode_stats_fn, batch_size, image_size,
                            save_features, feeder_threads, _load_shard_native, retry,
                            journal, resume, report, cleanup_features, sync_features)


# --------------------------------------------------------------------- CLI
# Hadoop-Streaming-compatible, as the JAX package's:
#   cat list_tars.txt | python -m tmr_tpu_torch.parallel.mapreduce map \
#       --data_dir /data/tars --features_out features_output \
#   | sort | python -m tmr_tpu_torch.parallel.mapreduce reduce
# map reads shard names on stdin (relative ones under --data_dir), writes the features
# under features_out/<category>/<shard>/ and prints the aggregated records on stdout,
# which carries nothing else; reduce prints the averages table. Logs go to stderr.
# TMR_FAULTS / TMR_FAULTS_SEED install a fault schedule (utils/faults.py).


def _cli_map(args) -> int:
    if faults.install_from_env():
        # loud: a schedule left over from a drill would corrupt a run that exits 0
        log_warning(f"fault injection ACTIVE (TMR_FAULTS="
                    f"{os.environ.get('TMR_FAULTS', '')!r})")
    save, cleanup, sync = make_feature_sinks(args.features_out)

    names = [ln.strip() for ln in sys.stdin if ln.strip()]
    paths = [n if os.path.isabs(n) else os.path.join(args.data_dir, n) for n in names]
    log_info(f"map: {len(paths)} shards from stdin")

    if args.artifact:
        fn = make_encode_stats_fn_from_artifact(args.artifact, args.device)
    else:
        from tmr_tpu_torch.models import build_sam_encoder

        if not args.checkpoint:
            log_warning("map: no --artifact/--checkpoint, random weights")
        fn = make_encode_stats_fn(build_sam_encoder(args.model_type, args.checkpoint,
                                                    device=args.device))

    journal_dir = args.journal_dir
    if journal_dir is None and args.features_out:
        journal_dir = os.path.join(args.features_out, "_journal")
    journal = ShardJournal(journal_dir) if journal_dir else None
    if args.resume and journal is None:
        log_warning("map: --resume without --journal_dir/--features_out has no journal "
                    "to resume from; running everything")
    retry = RetryPolicy(
        max_attempts=max(1, args.max_attempts),
        shard_timeout=args.shard_timeout if args.shard_timeout > 0 else None,
        backoff_base=args.backoff_base, backoff_max=args.backoff_max)
    report = MapReport()

    use_native = not args.no_native
    if use_native:
        from tmr_tpu_torch.data import native_io

        use_native = native_io.available()
        if not use_native:
            log_info("native IO unavailable; using the Python tarfile path")
    runner = run_stream_native if use_native else run_stream
    acc = runner(paths, fn, batch_size=args.batch_size, image_size=args.image_size,
                 save_features=save, feeder_threads=args.feeder_threads, retry=retry,
                 journal=journal, resume=args.resume, report=report,
                 cleanup_features=cleanup, sync_features=sync)
    log_info(report.summary_line())
    if args.report_out:
        report.write(args.report_out)
    for line in acc.emit_lines():
        sys.stdout.write(line + "\n")  # stdout is the record protocol
    sys.stdout.flush()
    return 0


def _cli_reduce(_args) -> int:
    sys.stdout.write(format_stats_table(reduce_lines(sys.stdin)) + "\n")
    sys.stdout.flush()
    return 0


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m tmr_tpu_torch.parallel.mapreduce",
        description="Streaming feature extraction (Hadoop mapper/reducer replacement)")
    sub = p.add_subparsers(dest="cmd", required=True)
    m = sub.add_parser("map", help="tar names on stdin -> stat records")
    m.add_argument("--data_dir", default=".",
                   help="prefix for shard names (the HDFS tar directory)")
    m.add_argument("--artifact", default=None,
                   help="exported encoder (.pt2, python -m tmr_tpu_torch.export_encoder) "
                        "in place of the model: no model built, no checkpoint read")
    m.add_argument("--checkpoint", default=None,
                   help="SAM(-HQ) .pth; without it the weights are seeded")
    m.add_argument("--model_type", default="vit_b")
    m.add_argument("--features_out", default=None,
                   help="write per-image feature .npy under <dir>/<category>/<shard>/ "
                        "(mapper.py:126-130)")
    m.add_argument("--batch_size", default=8, type=int)
    m.add_argument("--image_size", default=1024, type=int)
    m.add_argument("--feeder_threads", default=4, type=int)
    m.add_argument("--no_native", action="store_true",
                   help="read tars with Python's tarfile, not the native C++ reader")
    m.add_argument("--max_attempts", default=3, type=int,
                   help="per-shard attempts before quarantine")
    m.add_argument("--shard_timeout", default=600.0, type=float,
                   help="per-attempt stall budget (s) of a shard's load: it fails only "
                        "when the load makes no member progress for this long; 0 "
                        "disables")
    m.add_argument("--backoff_base", default=0.5, type=float,
                   help="first-retry backoff (s), doubled per retry")
    m.add_argument("--backoff_max", default=30.0, type=float, help="backoff cap (s)")
    m.add_argument("--resume", action="store_true",
                   help="skip shards journaled as done; their journaled sums keep the "
                        "table byte-identical")
    m.add_argument("--journal_dir", default=None,
                   help="done-marker directory (default <features_out>/_journal)")
    m.add_argument("--report_out", default=None,
                   help="write the map_report/v1 JSON document here")
    m.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a GPU) or 'cpu'")
    sub.add_parser("reduce", help="stat records on stdin -> averages table")
    args = p.parse_args(argv)
    return _cli_map(args) if args.cmd == "map" else _cli_reduce(args)


if __name__ == "__main__":
    raise SystemExit(main())
