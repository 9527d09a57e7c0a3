"""Coarse-to-fine sketch index over gallery entries (counterpart of
``tmr_tpu/serve/gallery_index.py``, ported unchanged in behaviour: the same clusters,
probes, stamps and digest for the same insertion history).

The linear prefilter scores every registered entry's Rademacher sketch against the
frame, O(N) device work per frame. This module holds the host-side half of the sublinear
replacement: a two-level IVF-style index.

The coarse prefilter score (``ops/xcorr.coarse_prefilter_scores``) is a function of the
frame's features and the exemplar box geometry only (the template is extracted from the
frame's own feature map at the entry's boxes), so entries with nearby boxes score nearby.
Entries are clustered by an 8-dim box-geometry vector; each cluster is probed by its
*medoid* (nearest the centroid) and *anti-medoid* (farthest); all ~2 sqrt(N) probes are
scored in one batched device call, buckets rank by their probes' max, and the exact
sketch correlation runs only over the best ``nprobe`` buckets' members.

Determinism: k-means runs over name-sorted entries with a pinned seed and a fixed Lloyd
iteration count, empty clusters reseed deterministically, and medoid ties break toward
the lexicographically smallest name, so the same entry set gives byte-identical
clustering whatever the registration order.

Maintenance is incremental: register/evict assign/unassign against the built clustering
and bump a churn counter; past ``rebuild_frac * built_n`` churn the owner calls
``rebuild()``, which returns a *stamp* (entries, centroids, wall seconds, entry-set
digest) kept in a bounded log.

Everything here is host-side numpy; device scoring stays in ``GalleryBank``
(``serve/gallery.py``), which owns the knobs (``TMR_GALLERY_INDEX*``) and the
fallback to the linear scan.
"""

import hashlib
import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np

# dims of the per-entry geometry vector: mean/std of box centers and
# extents over the entry's real exemplar rows
SKETCH_DIMS = 8

# pinned k-means seed — part of the cross-replica determinism contract
DEFAULT_SEED = 20260807

_LLOYD_ITERS = 8
_DIST_CHUNK = 8192


def entry_sketch(exemplars, k_real) -> np.ndarray:
    """The (SKETCH_DIMS,) float32 geometry vector for one entry.

    ``exemplars`` is the (possibly padded) (K, 4) normalized-xyxy box
    array; only the first ``k_real`` rows are real. The vector captures
    where the entry's crops sit on the frame (centers) and how big they
    are (extents) — exactly the quantities the coarse sketch score
    depends on.
    """
    ex = np.asarray(exemplars, np.float32).reshape(-1, 4)
    k = max(int(k_real), 1)
    ex = ex[: min(k, ex.shape[0])]
    cx = (ex[:, 0] + ex[:, 2]) * 0.5
    cy = (ex[:, 1] + ex[:, 3]) * 0.5
    w = ex[:, 2] - ex[:, 0]
    h = ex[:, 3] - ex[:, 1]
    return np.asarray(
        [cx.mean(), cy.mean(), w.mean(), h.mean(),
         cx.std(), cy.std(), w.std(), h.std()],
        np.float32,
    )


def _pairwise_d2(x: np.ndarray, cent: np.ndarray) -> np.ndarray:
    """Squared L2 distances (n, C), chunked so a 10^5-entry rebuild
    never materializes more than ``_DIST_CHUNK * C`` floats at once."""
    out = np.empty((x.shape[0], cent.shape[0]), np.float32)
    cn = (cent * cent).sum(axis=1)
    for lo in range(0, x.shape[0], _DIST_CHUNK):
        xs = x[lo:lo + _DIST_CHUNK]
        out[lo:lo + xs.shape[0]] = (
            (xs * xs).sum(axis=1)[:, None] - 2.0 * (xs @ cent.T) + cn[None, :]
        )
    return out


def _kmeans(x: np.ndarray, n_clusters: int, seed: int):
    """Deterministic Lloyd k-means: pinned-seed init over the (already
    name-sorted) rows, fixed iteration count, empty clusters reseeded
    to the globally worst-fit point (lowest index on ties via argmax).
    Returns (centroids (C, D), assignment (n,))."""
    n = x.shape[0]
    n_clusters = max(1, min(int(n_clusters), n))
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.permutation(n)[:n_clusters])
    cent = x[pick].astype(np.float32).copy()
    assign = np.zeros((n,), np.int64)
    for _ in range(_LLOYD_ITERS):
        d2 = _pairwise_d2(x, cent)
        assign = d2.argmin(axis=1)
        own = d2[np.arange(n), assign]
        for c in range(n_clusters):
            mask = assign == c
            if mask.any():
                cent[c] = x[mask].mean(axis=0)
            else:
                far = int(own.argmax())
                cent[c] = x[far]
                assign[far] = c
                own[far] = 0.0
    return cent, assign


class SketchIndex:
    """Two-level IVF index over entry geometry sketches (host side).

    Thread-safe: every public method takes the index lock; callers
    (GalleryBank under its own lock, the fleet worker's bank) may share
    one instance freely.
    """

    def __init__(self, *, seed: int = DEFAULT_SEED,
                 rebuild_frac: float = 0.25, min_centroids: int = 1,
                 max_stamps: int = 64):
        self._lock = threading.Lock()
        self._seed = int(seed)
        self._rebuild_frac = float(rebuild_frac)
        self._min_centroids = max(int(min_centroids), 1)
        self._max_stamps = max(int(max_stamps), 1)
        self._vectors: Dict[str, np.ndarray] = {}
        self._centroids: Optional[np.ndarray] = None
        self._medoids: List[Optional[str]] = []
        self._antis: List[Optional[str]] = []
        self._members: List[List[str]] = []
        self._assign: Dict[str, int] = {}
        self._churn = 0
        self._built_n = 0
        self._rebuilds = 0
        self._stamps: List[dict] = []

    def __len__(self) -> int:
        with self._lock:
            return len(self._vectors)

    @property
    def built(self) -> bool:
        with self._lock:
            return self._centroids is not None

    def add(self, name: str, vector: np.ndarray) -> None:
        """Register (or re-register) one entry's sketch vector. Against
        a built clustering the entry is assigned to its nearest
        centroid immediately — queries see it before any rebuild."""
        name = str(name)
        v = np.asarray(vector, np.float32).reshape(-1)
        with self._lock:
            self._unassign_locked(name)
            self._vectors[name] = v
            if self._centroids is not None:
                d2 = ((self._centroids - v[None, :]) ** 2).sum(axis=1)
                ci = int(d2.argmin())
                self._assign[name] = ci
                self._members[ci].append(name)
                # probes stay EXACT extrema over the member set (not
                # merely updated-if-better): order-independent, so an
                # incrementally maintained index and a fresh rebuild
                # over the same entries elect the same probes
                self._medoids[ci] = self._pick_medoid_locked(ci)
                self._antis[ci] = self._pick_anti_locked(ci)
            self._churn += 1

    def remove(self, name: str) -> bool:
        """Drop one entry. Returns True if it was indexed. Evicted
        entries leave the posting lists immediately, so a stale-but-
        built index can never hand an evicted name back to a query."""
        name = str(name)
        with self._lock:
            if name not in self._vectors:
                return False
            self._unassign_locked(name)
            del self._vectors[name]
            self._churn += 1
            return True

    def _unassign_locked(self, name: str) -> None:
        ci = self._assign.pop(name, None)
        if ci is None:
            return
        try:
            self._members[ci].remove(name)
        except ValueError:
            pass
        if self._medoids[ci] == name:
            self._medoids[ci] = self._pick_medoid_locked(ci)
        if self._antis[ci] == name:
            self._antis[ci] = self._pick_anti_locked(ci)

    def _pick_medoid_locked(self, ci: int) -> Optional[str]:
        members = self._members[ci]
        if not members:
            return None
        cent = self._centroids[ci]
        return min(
            members,
            key=lambda nm: (
                float(((self._vectors[nm] - cent) ** 2).sum()), nm),
        )

    def _pick_anti_locked(self, ci: int) -> Optional[str]:
        """The boundary probe: the member FARTHEST from the centroid
        (ties toward the lexicographically largest name — any fixed
        rule keeps replicas byte-identical)."""
        members = self._members[ci]
        if not members:
            return None
        cent = self._centroids[ci]
        return max(
            members,
            key=lambda nm: (
                float(((self._vectors[nm] - cent) ** 2).sum()), nm),
        )

    def needs_rebuild(self) -> bool:
        """True when the index has never been built, or incremental
        churn since the last build exceeds ``rebuild_frac`` of the
        built entry count."""
        with self._lock:
            if not self._vectors:
                return False
            if self._centroids is None:
                return True
            return self._churn > max(1.0,
                                     self._rebuild_frac * self._built_n)

    def rebuild(self, reason: str = "churn") -> dict:
        """Recluster from scratch (deterministic — see module doc) and
        return the journaled rebuild stamp."""
        t0 = time.perf_counter()
        with self._lock:
            names = sorted(self._vectors)
            n = len(names)
            if n == 0:
                self._centroids = None
                self._medoids, self._members, self._assign = [], [], {}
                self._antis = []
                self._built_n, self._churn = 0, 0
                stamp = self._stamp_locked(reason, 0, 0, t0, names)
                return stamp
            x = np.stack([self._vectors[nm] for nm in names])
            n_clusters = max(self._min_centroids,
                             int(round(math.sqrt(float(n)))))
            cent, assign = _kmeans(x, n_clusters, self._seed)
            members: List[List[str]] = [[] for _ in range(cent.shape[0])]
            for i, nm in enumerate(names):
                members[int(assign[i])].append(nm)
            self._centroids = cent
            self._members = members
            self._assign = {nm: int(assign[i]) for i, nm in enumerate(names)}
            self._medoids = [self._pick_medoid_locked(ci)
                             for ci in range(cent.shape[0])]
            self._antis = [self._pick_anti_locked(ci)
                           for ci in range(cent.shape[0])]
            self._built_n = n
            self._churn = 0
            stamp = self._stamp_locked(reason, n, int(cent.shape[0]), t0,
                                       names)
            return stamp

    def _stamp_locked(self, reason: str, entries: int, centroids: int,
                      t0: float, names: List[str]) -> dict:
        self._rebuilds += 1
        digest = hashlib.sha256(
            ("|".join(names) + f"|seed={self._seed}|c={centroids}").encode()
        ).hexdigest()[:16]
        stamp = {
            "rebuild": self._rebuilds,
            "reason": str(reason),
            "entries": int(entries),
            "centroids": int(centroids),
            "wall_s": round(time.perf_counter() - t0, 6),
            "digest": digest,
        }
        self._stamps.append(stamp)
        if len(self._stamps) > self._max_stamps:
            del self._stamps[: len(self._stamps) - self._max_stamps]
        return dict(stamp)

    def snapshot(self) -> dict:
        """A query-time view: parallel ``medoids`` / ``probes`` /
        ``members`` lists for every non-empty cluster (``probes[i]`` is
        the medoid plus the anti-medoid when distinct — a bucket is
        ranked by its probes' MAX score). Safe to use outside the lock
        — the inner lists are copies."""
        with self._lock:
            if self._centroids is None:
                return {"built": False, "medoids": [], "probes": [],
                        "members": [], "centroids": 0}
            meds, probes, mems = [], [], []
            for ci, medoid in enumerate(self._medoids):
                if medoid is not None and self._members[ci]:
                    meds.append(medoid)
                    anti = self._antis[ci]
                    probes.append(
                        [medoid] if anti in (None, medoid)
                        else [medoid, anti]
                    )
                    mems.append(list(self._members[ci]))
            return {"built": True, "medoids": meds, "probes": probes,
                    "members": mems, "centroids": len(meds)}

    def stats(self) -> dict:
        with self._lock:
            return {
                "built": self._centroids is not None,
                "entries": len(self._vectors),
                "centroids": (0 if self._centroids is None
                              else int(self._centroids.shape[0])),
                "built_n": self._built_n,
                "churn": self._churn,
                "rebuilds": self._rebuilds,
                "rebuild_frac": self._rebuild_frac,
                "seed": self._seed,
                "last_rebuild": (dict(self._stamps[-1])
                                 if self._stamps else None),
            }

    def stamps(self) -> List[dict]:
        """The bounded journal of rebuild stamps, oldest first."""
        with self._lock:
            return [dict(s) for s in self._stamps]
