"""The gallery tier: standing pattern banks matched against image streams with one
encoder pass per frame (counterpart of ``tmr_tpu/serve/gallery.py``).

Users serve standing pattern sets (watchlists, catalog SKUs, defect libraries) against
image streams; a naive deployment pays one full request, encoder included, per (frame,
pattern) pair. The tier closes that multiplier over the ``Predictor``'s gallery
programs:

- **Bank registry** (:class:`GalleryBank`): register and evict named exemplar sets.
  Registration does the per-pattern work once: the capacity bucket from the exemplar
  geometry, the rows padded onto their k bucket, entries grouped by (capacity,
  k_bucket), each group's pattern tensors placed on the predictor's device at the next
  search, so per-frame work moves only the frame.
- **Fused matching**: a cold frame over a one-group bank runs
  ``Predictor._get_gallery_fn``: the encoder once, the heads and decode over N x k rows
  and one union NMS per entry, each entry's result that of the N-loop of
  ``predict_multi_exemplar`` (the same ops per row), behind the trace-only gate
  :func:`gallery_fused_ok`. Other frames run the encoder program once
  (``_get_backbone_fn``), then ``_get_gallery_heads_fn`` per group, with the engine's
  second-sighting promotion into the feature cache (a ``ServeEngine``'s own, when shared).
  Bank sizes pad to the ``N_BUCKETS`` rungs.
- **Coarse prefilter** (``TMR_GALLERY_PREFILTER_TOPK``; off = exact): a channel-sketched,
  low-resolution correlation score per entry (``ops/xcorr.coarse_prefilter_scores``)
  ranks which entries earn the full match. Entries outside the top-k return empty
  results carrying ``degrade_steps: ["prefilter"]``: approximation is never silent.
- **Sketch index** (``TMR_GALLERY_INDEX``; off = the linear scan): the prefilter's
  two-level index (``serve/gallery_index.py``) scores each cluster's probes in one call
  and rescores only the best ``nprobe`` clusters' members, before the same top-k. An
  index failure falls back to the linear scan, counted (``index_fallbacks``); a failed
  program falls back to one ``predict_multi_exemplar`` per entry, counted
  (``nloop_fallback_frames``). Both fallbacks run on the predictor's device.
- **Feature sink** (:class:`FeatureSinkServer`): map workers stream extracted features
  into a serve-side index over the JSON-lines protocol of the JAX package
  (``parallel/mapreduce.make_feature_sinks`` with a ``tcp://`` target), so a JAX worker
  streams into this server and a port worker into the JAX one.

Environment knobs, read lazily, with the JAX package's defaults (the port has no
``ENV_KNOBS`` table): ``TMR_GALLERY_PREFILTER_TOPK`` (0 / unset = off; an int = that
top-k; ``auto``, the measured winner, is ROADMAP A8 and raises),
``TMR_GALLERY_NMAX`` (the N-rung ladder cap; unset = the last rung, 32, as in JAX when
nothing is measured), ``TMR_GALLERY_FEATURE_CACHE`` (frame-feature cache entries,
default 8), ``TMR_GALLERY_FEATURE_CACHE_MB`` (a byte bound on it), ``TMR_GALLERY_INDEX``
(the sketch index, off by default), ``TMR_GALLERY_INDEX_NPROBE`` (clusters probed per
query; 0 = max(2 ceil(sqrt(C)), min(C, topk))), ``TMR_GALLERY_INDEX_MIN_N`` (banks below
it stay linear, default 256), ``TMR_GALLERY_INDEX_REBUILD`` (the churn fraction that
reclusters, default 0.25).
"""

from __future__ import annotations

import copy
import os
import socketserver
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tmr_tpu_torch.obs.metrics import MetricsRegistry
from tmr_tpu_torch.serve.caches import LRUCache, array_digest
from tmr_tpu_torch.serve.gallery_index import SketchIndex, entry_sketch

#: detection fields a gallery result carries: the fixed four and the device tail's count
_DET_FIELDS = ("boxes", "scores", "refs", "valid", "count")

#: the bank's counters, ``gallery.<name>`` in its registry
_COUNTER_NAMES = (
    "searches", "fused_frames", "heads_frames", "backbone_fills",
    "registered", "evicted", "full_match_entries", "prefilter_runs",
    "prefilter_skipped", "nloop_fallback_frames", "index_queries",
    "index_probes", "index_hits", "index_candidates", "index_rebuilds",
    "index_fallbacks",
)

#: above this many scored entries the score dict keeps only the selected entries
_SCORE_TAIL_MAX = 4096

#: batched prefilter calls chunk at this many entries per call: the coarse map is
#: repeated per (entry, row)
_INDEX_CHUNK = 1024


def _topk_flat(scores: np.ndarray, k: int) -> np.ndarray:
    """Top-k indices of ``scores``: every entry strictly above the k-th value, then the
    k-th-valued ties in ascending order (a stable descending sort's selection)."""
    n = int(scores.shape[0])
    if k >= n:
        return np.arange(n)
    kth = np.partition(scores, n - k)[n - k]
    above = np.flatnonzero(scores > kth)
    ties = np.flatnonzero(scores == kth)
    return np.concatenate([above, ties[: k - above.size]])


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


# ---------------------------------------------------------------- the gate
_GATE_CACHE: dict = {}
_GATE_LOCK = threading.Lock()


class _ConvCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the convolutions whose input has 3 channels: the encoder's entry
    convolution, the only one that takes the image. (Under ``inference_mode`` a
    convolution reaches the mode as ``aten.conv2d``, else as ``aten.convolution``.)"""

    _CONVS = (torch.ops.aten.convolution, torch.ops.aten.conv2d)

    def __init__(self):
        super().__init__()
        self.entry_convs = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self._CONVS and args[0].dim() == 4 \
                and args[0].shape[1] == 3:
            self.entry_convs += 1
        return func(*args, **(kwargs or {}))


def gallery_fused_ok(predictor, capacity: int, n_bucket: int, k_bucket: int) -> bool:
    """Trace-only gate of the fused gallery program: run it under ``FakeTensorMode``
    (shapes only, no launch; the ``tmr::`` ops answer with their fake implementations) at
    this geometry, without refinement, as the JAX gate traces it, and require exactly one
    convolution of the 3-channel image: the encoder once per frame, the amortization the
    tier exists for. A refusal records a ``gate_probe/v1`` cause
    (``diagnostics.gate_refused``) and cold frames take the features arm. Verdicts are
    cached per geometry."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from tmr_tpu_torch.diagnostics import gate_refused

    key = (int(capacity), int(n_bucket), int(k_bucket), int(predictor.cfg.image_size),
           str(predictor.cfg.backbone))
    with _GATE_LOCK:
        if key in _GATE_CACHE:
            return _GATE_CACHE[key]
    config = {"capacity": key[0], "n_bucket": key[1], "k_bucket": key[2],
              "image_size": key[3], "backbone": key[4]}
    try:
        probe = copy.copy(predictor)
        probe.refiner = None  # the refiner's slot gather has a data-dependent size
        fn = probe._get_gallery_fn(key[0], key[1], key[2])
        dev, size = predictor.device, key[3]
        counter = _ConvCounter()
        with FakeTensorMode(allow_non_fake_inputs=True), counter:
            fn(torch.empty((1, size, size, 3), device=dev),
               torch.empty((key[1], key[2], 4), device=dev),
               torch.ones((key[1],), dtype=torch.int32, device=dev), key[1])
        if counter.entry_convs == 1:
            ok = True
        else:
            ok = gate_refused(
                "gallery_fused_ok",
                f"backbone entry conv traced {counter.entry_convs}x (amortization "
                "requires exactly once per frame)",
                "forward-mismatch", config=config)
    except Exception as e:
        ok = gate_refused("gallery_fused_ok", f"{type(e).__name__}: {e}", "exception",
                          config=config, exception=type(e).__name__)
    with _GATE_LOCK:
        _GATE_CACHE[key] = ok
    return ok


# ------------------------------------------------------------- the registry
class GalleryEntry:
    """One registered pattern: its name, its rows padded onto the k bucket, and the
    capacity bucket picked at registration."""

    __slots__ = ("name", "exemplars", "k_real", "k_bucket", "capacity")

    def __init__(self, name: str, exemplars: np.ndarray, k_real: int, k_bucket: int,
                 capacity: int):
        self.name = name
        self.exemplars = exemplars  # (k_bucket, 4) f32, rows from k_real on pad
        self.k_real = int(k_real)
        self.k_bucket = int(k_bucket)
        self.capacity = int(capacity)


class _Group:
    """One (capacity, k_bucket) chunk of the bank, padded to its N rung, with the
    pattern tensors on the predictor's device."""

    __slots__ = ("capacity", "k_bucket", "names", "n_real", "n_bucket", "host_ex",
                 "host_k", "ex_dev", "k_dev")

    def __init__(self, capacity: int, k_bucket: int, members: List[GalleryEntry],
                 n_bucket: int, device):
        self.capacity = capacity
        self.k_bucket = k_bucket
        self.names = [e.name for e in members]
        self.n_real = len(members)
        self.n_bucket = n_bucket
        ex = np.stack([e.exemplars for e in members], axis=0)
        kr = np.asarray([e.k_real for e in members], np.int32)
        pad = n_bucket - len(members)
        if pad:
            ex = np.concatenate([ex, np.tile(ex[-1:], (pad, 1, 1))], axis=0)
            kr = np.concatenate([kr, np.ones((pad,), np.int32)])
        self.host_ex = ex
        self.host_k = kr
        # on the device once per (re)build: a search moves only the frame
        self.ex_dev = torch.as_tensor(ex, device=device)
        self.k_dev = torch.as_tensor(kr, device=device)


def _host_dets(dets: dict) -> Dict[str, np.ndarray]:
    return {name: dets[name].cpu().numpy() for name in _DET_FIELDS if name in dets}


class GalleryBank:
    """A standing pattern set over one ``Predictor``, searched per frame with one encoder
    pass (the module docstring has the architecture).

    Parameters
    ----------
    predictor: a ``Predictor`` whose weights were set.
    image_size: the stream's frame size (None -> ``cfg.image_size``); a bank's capacity
        buckets belong to one feature grid, and ``search`` refuses other sizes.
    prefilter_topk: the prefilter's top-k (None -> ``TMR_GALLERY_PREFILTER_TOPK``; 0 =
        off = exact).
    feature_cache: an int capacity (None -> ``TMR_GALLERY_FEATURE_CACHE``, default 8; 0
        disables) or an :class:`LRUCache` to share, such as a ``ServeEngine``'s
        ``feature_cache``: both derive the same ``feature_stamp`` keys.
    feature_cache_mb: a byte bound on an owned cache (None ->
        ``TMR_GALLERY_FEATURE_CACHE_MB``).
    max_n_bucket: the N-rung cap (None -> ``TMR_GALLERY_NMAX`` -> 32); larger groups
        chunk into several calls.
    index, index_nprobe, index_min_n, index_rebuild_frac: the sketch index's switch and
        knobs (None -> ``TMR_GALLERY_INDEX``, ``_NPROBE``, ``_MIN_N``, ``_REBUILD``).
    """

    def __init__(self, predictor, *, image_size: Optional[int] = None,
                 prefilter_topk: Optional[int] = None, feature_cache: Any = None,
                 feature_cache_mb: Optional[float] = None,
                 max_n_bucket: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None,
                 index: Optional[bool] = None, index_nprobe: Optional[int] = None,
                 index_min_n: Optional[int] = None,
                 index_rebuild_frac: Optional[float] = None):
        if not getattr(predictor, "weights_set", False):
            raise RuntimeError("predictor has no weights set")
        self._pred = predictor
        self.image_size = int(image_size or predictor.cfg.image_size)
        self._lock = threading.RLock()
        self._entries: "OrderedDict[str, GalleryEntry]" = OrderedDict()
        self._groups: Optional[List[_Group]] = None
        self._topk_arg = prefilter_topk
        self._index: Optional[SketchIndex] = None
        self._index_arg = index
        self._index_nprobe_arg = index_nprobe
        self._index_min_n_arg = index_min_n
        self._index_rebuild_arg = index_rebuild_frac
        self.metrics = MetricsRegistry() if registry is None else registry
        self._m = {name: self.metrics.counter(f"gallery.{name}") for name in _COUNTER_NAMES}
        self._g_rebuild_wall = self.metrics.gauge("gallery.index_rebuild_wall_s")
        if isinstance(feature_cache, LRUCache):
            self.feature_cache = feature_cache
        else:
            mb = (_env_float("TMR_GALLERY_FEATURE_CACHE_MB", 0.0)
                  if feature_cache_mb is None else float(feature_cache_mb))
            self.feature_cache = LRUCache(
                _env_int("TMR_GALLERY_FEATURE_CACHE", 8)
                if feature_cache is None else int(feature_cache),
                registry=self.metrics, name="gallery.cache.feature",
                max_bytes=int(mb * (1 << 20)) if mb > 0 else None)
        self._seen = LRUCache(max(4 * max(self.feature_cache.capacity, 1), 16))
        # the feature key's provenance: a cache shared with a ServeEngine over the same
        # predictor derives the same stamp
        self._feat_stamp = tuple(predictor.feature_stamp())
        # the JAX package's measured cap (utils/autotune) is ROADMAP A8: unset takes the
        # ladder's last rung, as JAX does when nothing is measured
        nmax = int(max_n_bucket) if max_n_bucket is not None else _env_int(
            "TMR_GALLERY_NMAX", 0)
        ladder = tuple(predictor.N_BUCKETS)
        self.max_n_bucket = (max(b for b in ladder if b <= nmax) if nmax > 0
                             else ladder[-1])

    # ------------------------------------------------------------ registry
    def register(self, name: str, exemplars, k_real: Optional[int] = None) -> dict:
        """Register (or replace) one named pattern set: its k-bucket padding and capacity
        bucket are resolved here, once. Returns the entry's buckets."""
        ex = np.asarray(exemplars, np.float32).reshape(-1, 4)
        k = int(k_real) if k_real is not None else len(ex)
        if not 1 <= k <= len(ex):
            raise ValueError(f"k_real={k} out of range for {len(ex)} exemplar rows")
        ex = ex[:k]
        k_bucket = int(next((b for b in self._pred.K_BUCKETS if b >= k), k))
        cap = self._pred.pick_capacity(ex, self.image_size)
        padded = np.concatenate([ex, np.tile(ex[-1:], (k_bucket - k, 1))], axis=0)
        with self._lock:
            self._entries[str(name)] = GalleryEntry(str(name), padded, k, k_bucket, cap)
            if self._index is not None:
                self._index.add(str(name), entry_sketch(padded, k))
            self._groups = None  # rebuilt (and placed) at the next search
        self._m["registered"].inc()
        return {"name": str(name), "capacity": cap, "k_bucket": k_bucket, "k_real": k}

    def evict(self, name: str) -> bool:
        """Drop one named pattern; True when it existed. The group tensors rebuild at the
        next search."""
        with self._lock:
            existed = self._entries.pop(str(name), None) is not None
            if existed:
                if self._index is not None:
                    self._index.remove(str(name))
                self._groups = None
        if existed:
            self._m["evicted"].inc()
        return existed

    def names(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return str(name) in self._entries

    def _groups_locked(self) -> List[_Group]:
        """The (capacity, k_bucket) groups of the registry, rebuilt only after a change;
        groups larger than the ladder cap chunk."""
        with self._lock:
            if self._groups is not None:
                return self._groups
            buckets: "OrderedDict[tuple, List[GalleryEntry]]" = OrderedDict()
            for e in self._entries.values():
                buckets.setdefault((e.capacity, e.k_bucket), []).append(e)
            ladder = tuple(self._pred.N_BUCKETS)
            groups: List[_Group] = []
            for (cap, kb), members in buckets.items():
                for i in range(0, len(members), self.max_n_bucket):
                    chunk = members[i:i + self.max_n_bucket]
                    rung = int(next((b for b in ladder if b >= len(chunk)), len(chunk)))
                    groups.append(_Group(cap, kb, chunk, rung, self._pred.device))
            self._groups = groups
            return groups

    def _feature_key(self, digest: str, size: int) -> tuple:
        """The frame-feature key: image digest, size and the predictor's stamp."""
        return (digest, size) + self._feat_stamp

    # -------------------------------------------------------------- search
    def _resolve_topk(self, override: Optional[int]) -> int:
        if override is not None:
            return max(int(override), 0)
        if self._topk_arg is not None:
            return max(int(self._topk_arg), 0)
        raw = os.environ.get("TMR_GALLERY_PREFILTER_TOPK", "")
        if not raw or raw in ("0", "off", "false"):
            return 0
        if raw == "auto":
            raise NotImplementedError(
                "TMR_GALLERY_PREFILTER_TOPK=auto (the measured top-k) is not ported to "
                "tmr_tpu_torch (ROADMAP A8); give an int")
        try:
            return max(int(raw), 0)
        except ValueError:
            raise ValueError(f"TMR_GALLERY_PREFILTER_TOPK={raw!r}: expected off|auto|<int>")

    # ------------------------------------------------------- sketch index
    def _index_enabled(self) -> bool:
        if self._index_arg is not None:
            return bool(self._index_arg)
        raw = os.environ.get("TMR_GALLERY_INDEX", "")
        return bool(raw) and raw not in ("0", "off", "false")

    def _index_min_n_resolved(self) -> int:
        if self._index_min_n_arg is not None:
            return max(int(self._index_min_n_arg), 0)
        return max(_env_int("TMR_GALLERY_INDEX_MIN_N", 256), 0)

    def _resolve_nprobe(self, n_centroids: int, topk: int) -> int:
        nprobe = (int(self._index_nprobe_arg) if self._index_nprobe_arg is not None
                  else _env_int("TMR_GALLERY_INDEX_NPROBE", 0))
        if nprobe <= 0:
            # auto: 2 ceil(sqrt(C)), but never fewer clusters than the top-k may need
            nprobe = max(2 * int(np.ceil(np.sqrt(max(n_centroids, 1)))),
                         min(n_centroids, topk))
        return max(1, min(nprobe, n_centroids))

    def _ensure_index(self) -> SketchIndex:
        """The bank's SketchIndex, made at the first indexed query and seeded with every
        registered entry; register and evict keep it in step after that."""
        with self._lock:
            if self._index is None:
                frac = (float(self._index_rebuild_arg)
                        if self._index_rebuild_arg is not None
                        else _env_float("TMR_GALLERY_INDEX_REBUILD", 0.25))
                idx = SketchIndex(rebuild_frac=frac)
                for e in self._entries.values():
                    idx.add(e.name, entry_sketch(e.exemplars, e.k_real))
                self._index = idx
            return self._index

    def _prefilter_select(self, feats, groups: List[_Group], topk: int
                          ) -> Tuple[set, Dict[str, float]]:
        """Elect the top-k entries for the full match: the index path where it is on and
        the bank large enough, falling back to the linear scan on any failure,
        counted."""
        total = sum(g.n_real for g in groups)
        if self._index_enabled() and total >= self._index_min_n_resolved():
            try:
                return self._index_select(feats, groups, topk)
            except Exception:
                self._m["index_fallbacks"].inc()
        return self._linear_select(feats, groups, topk)

    def _linear_select(self, feats, groups: List[_Group], topk: int
                       ) -> Tuple[set, Dict[str, float]]:
        """The exact scan: one prefilter call per group, then the top-k."""
        names: List[str] = []
        chunks: List[np.ndarray] = []
        for g in groups:
            fn = self._pred._get_gallery_prefilter_fn(g.n_bucket, g.k_bucket)
            s = fn(feats, g.ex_dev, g.k_dev, g.n_real).cpu().numpy()
            names.extend(g.names)
            chunks.append(s[:g.n_real])
        flat = np.concatenate(chunks)
        sel_idx = _topk_flat(flat, topk)
        selected = {names[i] for i in sel_idx}
        keep = range(flat.shape[0]) if flat.shape[0] <= _SCORE_TAIL_MAX else sel_idx
        return selected, {names[i]: float(flat[i]) for i in keep}

    def _index_select(self, feats, groups: List[_Group], topk: int
                      ) -> Tuple[set, Dict[str, float]]:
        """The indexed election: one batched call scores every cluster's probes (medoid
        and anti-medoid), the best ``nprobe`` clusters by their probes' max are rescored
        exactly, and the same top-k runs over those candidates."""
        idx = self._ensure_index()
        if idx.needs_rebuild():
            # racing searches may both recluster: deterministic, and both counted
            stamp = idx.rebuild()
            self._m["index_rebuilds"].inc()
            self._g_rebuild_wall.set(stamp["wall_s"])
        snap = idx.snapshot()
        if not snap["built"] or not snap["probes"]:
            raise RuntimeError("sketch index has no built clustering")
        with self._lock:
            entries = dict(self._entries)
        # flat (group, member) positions: the linear scan's tie order, and the filter
        # that keeps a stale index from returning an entry this search does not serve
        pos: Dict[str, int] = {}
        for g in groups:
            for nm in g.names:
                pos[nm] = len(pos)
        spans: List[Tuple[int, int]] = []
        pnames: List[str] = []
        for plist in snap["probes"]:
            spans.append((len(pnames), len(plist)))
            pnames.extend(plist)
        if any(nm not in entries for nm in pnames):
            raise RuntimeError("index probes out of sync with registry")
        self._m["index_queries"].inc()
        kpad = max(g.k_bucket for g in groups)
        pscores = self._score_flat(feats, [entries[nm] for nm in pnames], kpad)
        bucket_scores = np.asarray([pscores[s:s + ln].max() for s, ln in spans],
                                   np.float32)
        probe = _topk_flat(bucket_scores, self._resolve_nprobe(len(spans), topk))
        self._m["index_probes"].inc(int(probe.size))
        cand_set = {nm for ci in probe for nm in snap["members"][int(ci)]
                    if nm in pos and nm in entries}
        if not cand_set:
            raise RuntimeError("index probe produced no candidates")
        cand = sorted(cand_set, key=pos.__getitem__)
        self._m["index_candidates"].inc(len(cand))
        cscores = self._score_flat(feats, [entries[nm] for nm in cand], kpad)
        sel_local = _topk_flat(cscores, topk)
        selected = {cand[i] for i in sel_local}
        keep = range(len(cand)) if len(cand) <= _SCORE_TAIL_MAX else sel_local
        scores = {cand[i]: float(cscores[i]) for i in keep}
        self._m["index_hits"].inc(sum(
            1 for ci in probe if any(nm in selected for nm in snap["members"][int(ci)])))
        return selected, scores

    def _score_flat(self, feats, ents: List[GalleryEntry], kpad: int) -> np.ndarray:
        """Exact coarse scores for any entry list: rows pad to the bank-wide ``kpad``
        (k_real masks them) and entries chunk at ``_INDEX_CHUNK`` a call on power-of-two
        rungs."""
        out = np.empty((len(ents),), np.float32)
        done = 0
        while done < len(ents):
            chunk = ents[done:done + _INDEX_CHUNK]
            m = len(chunk)
            rung = 1 << max(m - 1, 0).bit_length()
            ex = np.stack([
                e.exemplars if e.exemplars.shape[0] == kpad else np.concatenate(
                    [e.exemplars, np.tile(e.exemplars[-1:],
                                          (kpad - e.exemplars.shape[0], 1))])
                for e in chunk])
            kr = np.asarray([e.k_real for e in chunk], np.int32)
            if rung > m:
                ex = np.concatenate([ex, np.tile(ex[-1:], (rung - m, 1, 1))])
                kr = np.concatenate([kr, np.ones((rung - m,), np.int32)])
            fn = self._pred._get_gallery_prefilter_fn(rung, kpad)
            out[done:done + m] = fn(feats, ex, kr, m).cpu().numpy()[:m]
            done += m
        return out

    def search(self, image, prefilter_topk: Optional[int] = None) -> Dict[str, dict]:
        """Match every registered pattern against one frame (S, S, 3) or (1, S, S, 3).
        Returns ``{name: dets}``: numpy fixed-slot detections with leading dim 1 per
        entry (``count`` under the device tail). Entries the prefilter skipped return
        empty detections with ``degrade_steps: ["prefilter"]``. With the prefilter off
        (the default) a cold one-group frame equals the N-loop of
        ``predict_multi_exemplar``; the features arm runs the same ops after the
        encoder."""
        img = np.asarray(image, np.float32)
        if img.ndim == 4 and img.shape[0] == 1:
            img = img[0]
        if img.ndim != 3 or img.shape[0] != img.shape[1] or img.shape[2] != 3:
            raise ValueError(f"expected one square (S, S, 3) frame, got {img.shape}")
        size = int(img.shape[0])
        if size != self.image_size:
            raise ValueError(
                f"frame size {size} != bank size {self.image_size} (a bank's capacity "
                "buckets belong to one grid; build a second bank for a second stream "
                "geometry)")
        groups = self._groups_locked()
        total = sum(g.n_real for g in groups)
        if total == 0:
            return {}
        self._m["searches"].inc()
        topk = self._resolve_topk(prefilter_topk)
        prefilter_on = 0 < topk < total
        digest = array_digest(img)
        feats = (self.feature_cache.get(self._feature_key(digest, size))
                 if self.feature_cache.capacity > 0 else None)

        if feats is None and not prefilter_on and len(groups) == 1 \
                and (digest, size) not in self._seen:
            g = groups[0]
            if gallery_fused_ok(self._pred, g.capacity, g.n_bucket, g.k_bucket):
                # a cold frame over one group: the fused arm
                self._seen.put((digest, size), True)
                try:
                    fn = self._pred._get_gallery_fn(g.capacity, g.n_bucket, g.k_bucket)
                    dets = fn(img[None], g.ex_dev, g.k_dev, g.n_real)
                except Exception:
                    return self._nloop_fallback(img, groups)
                self._m["fused_frames"].inc()
                self._m["full_match_entries"].inc(g.n_real)
                return self._unpack(g, dets)

        # the features arm: the encoder program once, the gallery tails on its output
        computed = False
        if feats is None:
            try:
                feats = self._pred._get_backbone_fn()(img[None])
            except Exception:
                return self._nloop_fallback(img, groups)
            computed = True
            self._m["backbone_fills"].inc()
        if computed and self.feature_cache.capacity > 0:
            # second-sighting promotion, as the serving engine does
            if (digest, size) in self._seen:
                self.feature_cache.put(self._feature_key(digest, size), feats)
            else:
                self._seen.put((digest, size), True)

        selected: Optional[set] = None
        scores: Dict[str, float] = {}
        if prefilter_on:
            self._m["prefilter_runs"].inc()
            selected, scores = self._prefilter_select(feats, groups, topk)

        results: Dict[str, dict] = {}
        ran_heads = False
        for g in groups:
            keep = (list(range(g.n_real)) if selected is None
                    else [i for i in range(g.n_real) if g.names[i] in selected])
            if keep:
                try:
                    dets = self._run_group_heads(g, feats, keep)
                except Exception:
                    return self._nloop_fallback(img, groups)
                ran_heads = True
                self._m["full_match_entries"].inc(len(keep))
                results.update(self._unpack(g, dets, keep=keep))
            if selected is not None:
                for i in sorted(set(range(g.n_real)) - set(keep)):
                    results[g.names[i]] = self._empty_result(scores.get(g.names[i]))
                    self._m["prefilter_skipped"].inc()
        if ran_heads:
            self._m["heads_frames"].inc()  # once per frame, not per group
        return results

    def _run_group_heads(self, g: _Group, feats, keep: List[int]):
        """The full match for ``keep``'s entries of one group on the frame's features,
        padded to the smallest rung that holds them."""
        if len(keep) == g.n_real:
            ex, kr, n, rung = g.ex_dev, g.k_dev, g.n_real, g.n_bucket
        else:
            rung = int(next((b for b in self._pred.N_BUCKETS if b >= len(keep)),
                            len(keep)))
            ex, kr, n = g.host_ex[keep], g.host_k[keep], len(keep)
            pad = rung - len(keep)
            if pad:
                ex = np.concatenate([ex, np.tile(ex[-1:], (pad, 1, 1))])
                kr = np.concatenate([kr, np.ones((pad,), np.int32)])
        fn = self._pred._get_gallery_heads_fn(g.capacity, rung, g.k_bucket,
                                              self.image_size)
        return fn(feats, ex, kr, n)

    def _nloop_fallback(self, img: np.ndarray, groups: List[_Group]) -> Dict[str, dict]:
        """The exact per-entry fallback: one ``predict_multi_exemplar`` call per entry
        on the predictor's device. The amortization is lost, so it is counted."""
        self._m["nloop_fallback_frames"].inc()
        results: Dict[str, dict] = {}
        for g in groups:
            for i in range(g.n_real):
                results[g.names[i]] = _host_dets(self._pred.predict_multi_exemplar(
                    img[None], g.host_ex[i], k_real=int(g.host_k[i])))
            self._m["full_match_entries"].inc(g.n_real)
        return results

    def _unpack(self, g: _Group, dets: dict, keep: Optional[List[int]] = None
                ) -> Dict[str, dict]:
        host = _host_dets(dets)
        names = g.names if keep is None else [g.names[i] for i in keep]
        # .copy(): a row view would keep the whole padded batch alive per entry
        return {name: {field: host[field][row:row + 1].copy() for field in host}
                for row, name in enumerate(names)}

    def _empty_result(self, score: Optional[float]) -> dict:
        out = {"boxes": np.zeros((1, 0, 4), np.float32),
               "scores": np.zeros((1, 0), np.float32),
               "refs": np.zeros((1, 0, 2), np.float32),
               "valid": np.zeros((1, 0), bool),
               "degrade_steps": ["prefilter"]}
        if score is not None:
            out["prefilter_score"] = score
        return out

    # --------------------------------------------------------------- stats
    @property
    def counters(self) -> Dict[str, int]:
        return {name: c.value for name, c in self._m.items()}

    def index_stats(self) -> dict:
        """The sketch index's state and query metrics (no group rebuild)."""
        with self._lock:
            idx = self._index
        probes = self._m["index_probes"].value
        hits = self._m["index_hits"].value
        out = {"enabled": self._index_enabled(), "min_n": self._index_min_n_resolved(),
               "queries": self._m["index_queries"].value,
               "hit_rate": round(hits / probes, 4) if probes else None,
               "rebuild_wall_s": self._g_rebuild_wall.value, "built": False}
        if idx is not None:
            out.update(idx.stats())
        return out

    def index_stamps(self) -> List[dict]:
        """The rebuild stamps (empty before the first indexed query builds the index)."""
        with self._lock:
            idx = self._index
        return [] if idx is None else idx.stamps()

    def stats(self) -> dict:
        groups = self._groups_locked()
        return {"image_size": self.image_size, "entries": len(self),
                "groups": [{"capacity": g.capacity, "k_bucket": g.k_bucket,
                            "n_real": g.n_real, "n_bucket": g.n_bucket} for g in groups],
                "max_n_bucket": self.max_n_bucket,
                "prefilter_topk": self._resolve_topk(None),
                "feature_cache": self.feature_cache.stats(),
                "index": self.index_stats(), **self.counters}


# ------------------------------------------------------------ feature sink
class _SinkHandler(socketserver.StreamRequestHandler):
    """One worker's connection: JSON lines in, acks out (features are pipelined)."""

    def handle(self):
        from tmr_tpu_torch.parallel.leases import recv_line, send_line

        state = {"features": 0, "errors": 0}
        while True:
            try:
                doc = recv_line(self.rfile)
            except (ValueError, OSError):
                # a peer dying mid-write leaves a truncated line or a reset socket: a
                # link error, counted, never raised out of the handler
                self.server.sink._count_link_error()
                break
            if doc is None:
                break
            try:
                reply = self.server.sink._dispatch(doc, state)
            except Exception:
                break
            if reply is not None:
                try:
                    send_line(self.connection, reply)
                except OSError:
                    break
            if doc.get("op") == "bye":
                break


class _SinkServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


class FeatureSinkServer:
    """Serve-side feature sink: map workers stream extracted features into a feature
    index over the JSON-lines protocol of the JAX package (``serve.fleet.pack_array``
    payloads), in place of ``.npy`` trees.

    Protocol (one JSON document a line):

    - ``{"op": "hello", "worker": id}`` -> ``{"ok": true}``;
    - ``{"op": "feature", "shard": s, "name": n, "array": ...}`` -> no reply (pipelined:
      TCP's order lets the next sync ack vouch for every feature before it);
    - ``{"op": "sync", "shard": s}`` -> ``{"ok": <no errors since the last sync>,
      "features": n, "errors": e}``: the worker's journal marker commits only after a
      clean ack, and a dirty one fails the shard attempt so that it is streamed again;
    - ``{"op": "evict", "shard": s}`` -> ack; drops the shard's features;
    - ``{"op": "bye"}`` -> ack, and the connection closes.

    Any successful round trip (sync, evict, hello, an ``on_request`` op) resets the
    connection's accounting window, so an error fails the attempt that streamed it and no
    later one. ``index`` is any :class:`LRUCache`-shaped store keyed ``(shard stem, image
    stem)``; ``on_feature(shard, name, array)`` is an optional push hook.
    ``on_request(doc, state)`` makes the sink an online request/response link (ported: the
    feature tier's data plane, ``serve/feature_tier.py``, composes it): an op the table
    above does not know goes to it, and its reply (carrying ``"ok"``) is sent back on the
    same connection and closes the window like any ack; an exception becomes a counted
    ``ok: false`` reply, and None falls through to the unknown-op error. Backpressure is
    the caller's side: a client keeps a bounded in-flight window and fails fast.
    """

    def __init__(self, index: Optional[LRUCache] = None, *, host: str = "127.0.0.1",
                 port: int = 0, max_entries: int = 4096, max_bytes: Optional[int] = None,
                 on_feature=None, on_request=None):
        self.index = LRUCache(max_entries, max_bytes=max_bytes) if index is None else index
        self._on_feature = on_feature
        self._on_request = on_request
        self._lock = threading.Lock()
        self._host, self._port = host, int(port)
        self._server: Optional[_SinkServer] = None
        self._thread: Optional[threading.Thread] = None
        self._shards: Dict[str, set] = {}
        self._counters = {"connections": 0, "features": 0, "bytes": 0, "syncs": 0,
                          "evicted_shards": 0, "errors": 0, "link_errors": 0}

    def start(self) -> Tuple[str, int]:
        with self._lock:
            if self._server is not None:
                return self._server.server_address
            server = _SinkServer((self._host, self._port), _SinkHandler)
            server.sink = self
            thread = threading.Thread(target=server.serve_forever,
                                      kwargs={"poll_interval": 0.1},
                                      name="feature-sink", daemon=True)
            self._server, self._thread = server, thread
        thread.start()
        return server.server_address

    @property
    def address(self) -> Tuple[str, int]:
        with self._lock:
            if self._server is None:
                raise RuntimeError("feature sink not started")
            return self._server.server_address

    @property
    def url(self) -> str:
        host, port = self.address
        return f"tcp://{host}:{port}"

    def close(self) -> None:
        with self._lock:
            server, self._server = self._server, None
            thread, self._thread = self._thread, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def _count_link_error(self) -> None:
        with self._lock:
            self._counters["link_errors"] += 1

    # ------------------------------------------------------------ protocol
    @staticmethod
    def _ack(state: dict, reply: dict) -> dict:
        """A successful round trip closes the connection's accounting window."""
        if reply.get("ok") is True:
            state["features"] = 0
            state["errors"] = 0
        return reply

    def _dispatch(self, doc: dict, state: dict) -> Optional[dict]:
        op = doc.get("op")
        if op == "feature":
            try:
                from tmr_tpu_torch.serve.fleet import unpack_array

                shard = str(doc.get("shard", ""))
                name = str(doc.get("name", ""))
                arr = unpack_array(doc["array"])
                if self._on_feature is not None:
                    self._on_feature(shard, name, arr)
                self.index.put((shard, name), arr)
                state["features"] += 1
                with self._lock:
                    self._counters["features"] += 1
                    self._counters["bytes"] += int(arr.nbytes)
                    self._shards.setdefault(shard, set()).add(name)
            except Exception:
                state["errors"] += 1
                with self._lock:
                    self._counters["errors"] += 1
            return None  # pipelined: the sync ack vouches
        if op == "sync":
            with self._lock:
                self._counters["syncs"] += 1
            reply = {"op": "sync", "ok": state["errors"] == 0, "shard": doc.get("shard"),
                     "features": state["features"], "errors": state["errors"]}
            # a sync closes the window even when dirty: its errors fail this attempt
            state["features"] = 0
            state["errors"] = 0
            return reply
        if op == "evict":
            shard = str(doc.get("shard", ""))
            with self._lock:
                names = self._shards.pop(shard, set())
                self._counters["evicted_shards"] += 1
            for name in names:
                self.index.pop((shard, name))
            return self._ack(state, {"op": "evict", "ok": True, "shard": shard,
                                     "dropped": len(names)})
        if op == "hello":
            with self._lock:
                self._counters["connections"] += 1
            return self._ack(state, {"op": "hello", "ok": True})
        if op == "bye":
            return self._ack(state, {"op": "bye", "ok": True})
        if self._on_request is not None:
            # online ops go to the composing server; its successful replies close the
            # window like any other ack
            try:
                reply = self._on_request(doc, state)
            except Exception as e:
                state["errors"] += 1
                with self._lock:
                    self._counters["errors"] += 1
                return {"op": op, "ok": False, "error": f"{type(e).__name__}: {e}"}
            if reply is not None:
                return self._ack(state, reply)
        return {"ok": False, "error": f"unknown op {op!r}"}
