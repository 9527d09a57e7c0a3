"""Content-addressed LRU caches for the serving layer (counterpart of
``tmr_tpu/serve/caches.py``).

Two instances back the engine (``serve/engine.py``):

- the **result cache**, keyed by (bucket, image digest, exemplar digest, k), holding
  finished per-request detections (numpy): a user re-querying the same pattern on the
  same image skips the device, and a hit returns the very dict the first request got;
- the **feature cache**, keyed by (image digest, image size) and the predictor's
  ``feature_stamp()``, holding the encoder's pre-upsample feature map on the device: the
  multi-query-same-image pattern re-runs only the heads (``Predictor._get_heads_fn``).

Both count hits, misses, evictions and inserts (``stats()``) and are thread-safe: the
engine's submit path and its completion thread touch them concurrently. The counters
live in the engine's metrics registry when one is passed (``<name>.hits`` ...).
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Hashable, Optional

import numpy as np

from tmr_tpu_torch.obs.metrics import Counter, MetricsRegistry


def _host_array(a) -> tuple:
    """The host bytes of an array or a tensor on any device; a bf16 tensor is read as
    its 16-bit words under the name ``bfloat16``, as numpy's ml_dtypes names it."""
    import sys

    torch = sys.modules.get("torch")
    if torch is not None and torch.is_tensor(a):
        a = a.detach().cpu().contiguous()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy(), "bfloat16"
        return a.numpy(), None
    return a, None


def array_digest(*arrays) -> str:
    """Content digest of arrays (numpy, or tensors by their host bytes): dtype + shape +
    bytes, so two logically different arrays that share a byte pattern (a (4,) f32 and a
    (16,) u8) never collide onto one key; the same numpy input digests to the JAX
    package's hex string."""
    h = hashlib.sha1()
    for a in arrays:
        a, dtype = _host_array(a)
        a = np.ascontiguousarray(a)
        h.update((dtype or str(a.dtype)).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def value_nbytes(value) -> int:
    """Byte size of a cached value: arrays and tensors (anything with ``.nbytes``) count
    their elements, containers sum their leaves, everything else counts zero. Every value
    the serving layer caches (feature maps, detection dicts) counts exactly."""
    nbytes = getattr(value, "nbytes", None)
    if nbytes is not None:
        try:
            return int(nbytes)
        except (TypeError, ValueError):
            return 0
    if isinstance(value, dict):
        return sum(value_nbytes(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(value_nbytes(v) for v in value)
    return 0


class LRUCache:
    """Bounded LRU mapping with observable counters.

    ``capacity <= 0`` constructs a disabled cache: every ``get`` misses,
    ``put`` is a no-op — callers never need an "is caching on" branch.

    ``registry``/``name``: when given, the hit/miss/eviction/insert
    counters are registered as ``<name>.hits`` etc. in that
    MetricsRegistry (they then travel in its ``snapshot()``); otherwise
    the cache keeps private Counter instances. ``stats()`` reads the same
    shape either way.

    ``max_bytes``: optional residency bound on top of the entry-count
    bound: the on-device feature cache holds whole feature maps, so a
    count-only bound lets large frames fill device memory unseen
    (``TMR_SERVE_FEATURE_CACHE_MB`` wires this on the engine). When set,
    inserts evict LRU-first until the tracked total fits; an entry alone
    bigger than the bound is dropped up front without disturbing the
    resident working set (insert + eviction both counted: observable,
    never a silent no-op), and ``stats()`` additionally reports
    ``bytes`` / ``max_bytes``. Unset (0/None) keeps the count-only
    behavior and stats shape.
    """

    def __init__(self, capacity: int,
                 registry: Optional[MetricsRegistry] = None,
                 name: str = "",
                 max_bytes: Optional[int] = None):
        self.capacity = int(capacity)
        self.max_bytes = int(max_bytes) if max_bytes else 0
        self._data: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._sizes: dict = {}
        self._bytes = 0
        self._lock = threading.Lock()
        if registry is not None and name:
            make = lambda which: registry.counter(f"{name}.{which}")  # noqa: E731
        else:
            make = lambda which: Counter()  # noqa: E731
        self._hits = make("hits")
        self._misses = make("misses")
        self._evictions = make("evictions")
        self._inserts = make("inserts")

    # counter values as attributes (diagnostic consumers read cache.hits)
    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    @property
    def evictions(self) -> int:
        return self._evictions.value

    @property
    def inserts(self) -> int:
        return self._inserts.value

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self._hits.inc()
                return self._data[key]
            self._misses.inc()
            return None

    def put(self, key: Hashable, value: Any) -> None:
        if self.capacity <= 0:
            return
        size = value_nbytes(value) if self.max_bytes else 0
        with self._lock:
            if self.max_bytes and size > self.max_bytes:
                # an entry alone over the bound is dropped WITHOUT
                # touching the resident working set (evicting hot
                # entries to make room for something that can never fit
                # would wipe the cache); counted as insert + eviction so
                # the drop is observable, and a previous value under
                # the same key is removed: the caller replaced it
                if key in self._data:
                    self._bytes -= self._sizes.pop(key, 0)
                    del self._data[key]
                self._inserts.inc()
                self._evictions.inc()
                return
            if key in self._data:
                self._data.move_to_end(key)
                self._bytes -= self._sizes.pop(key, 0)
            self._data[key] = value
            if self.max_bytes:
                self._sizes[key] = size
                self._bytes += size
            self._inserts.inc()
            while self._data and (
                len(self._data) > self.capacity
                or (self.max_bytes and self._bytes > self.max_bytes)
            ):
                dead, _ = self._data.popitem(last=False)
                self._bytes -= self._sizes.pop(dead, 0)
                self._evictions.inc()

    def pop(self, key: Hashable) -> Optional[Any]:
        """Remove one entry (bytes accounted); the value, or None when absent. Touches
        neither the traffic counters nor the eviction tally (evictions count capacity
        pressure, not removals)."""
        with self._lock:
            if key not in self._data:
                return None
            self._bytes -= self._sizes.pop(key, 0)
            return self._data.pop(key)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key: Hashable) -> bool:
        """Presence probe that does NOT touch the hit/miss counters (or
        recency): bookkeeping lookups must not masquerade as traffic."""
        with self._lock:
            return key in self._data

    def stats(self) -> dict:
        with self._lock:
            hits, misses = self._hits.value, self._misses.value
            total = hits + misses
            out = {
                "capacity": self.capacity,
                "size": len(self._data),
                "hits": hits,
                "misses": misses,
                "evictions": self._evictions.value,
                "inserts": self._inserts.value,
                "hit_rate": (hits / total) if total else 0.0,
            }
            if self.max_bytes:
                # present only under byte accounting: the default stats
                # shape stays the JAX package's
                out["bytes"] = self._bytes
                out["max_bytes"] = self.max_bytes
            return out
