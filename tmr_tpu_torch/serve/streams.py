"""Stream sessions: per-stream temporal feature reuse behind a cheap host-side delta
check (counterpart of ``tmr_tpu/serve/streams.py``).

Video traffic is frame t+1 ≈ frame t almost always, yet the fused serving path pays a
full encoder pass per frame. A :class:`StreamRouter` in front of one ``ServeEngine``
keeps one session per stream id, and each ``submit_stream`` frame takes a block-mean
delta check against the session's anchor frame:

- **changed** (delta > ``TMR_STREAM_DELTA``), the session's first frame, or reuse
  disabled: the frame goes through ``engine.submit`` untouched (bit for bit the
  frame-independent path) and becomes the session's new anchor;
- **reused** (delta within the threshold): the anchor's encoder features come from the
  router's byte-bounded cache (``TMR_STREAM_CACHE_MB``; filled once per anchor, locally
  or through the engine's feature tier when it is armed, and kept on the engine's
  device) and the frame submits with ``features=``: it skips the encoder, and its
  result, cache entry included, carries ``degrade_steps: ["temporal_reuse"]`` under a
  result-cache key of its own, so a reused answer is never served to a
  frame-independent query.

Reuse is off by default (``TMR_STREAM_REUSE=0``; the constructor's ``reuse=True`` or
``TMR_STREAM_REUSE=1`` enables it). Reuse never crosses stream ids: the feature cache is
keyed by stream id and each session's features derive only from its own anchor.
Sessions idle past ``TMR_STREAM_IDLE_S`` are evicted lazily on the next submit (counted).
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, Optional

import numpy as np
import torch

from tmr_tpu_torch.serve.caches import LRUCache, array_digest

#: block grid of the delta signature: per-block per-channel means on an (at most)
#: GRID x GRID partition of the frame, 192 floats a frame
_SIG_GRID = 8


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def block_signature(frame: np.ndarray, grid: int = _SIG_GRID) -> np.ndarray:
    """The delta check's content signature: per-block per-channel means over an (at most)
    ``grid`` x ``grid`` partition of the frame, float32 on the host. Two equal frames have
    equal signatures, so an exact repeat always reads delta 0.0."""
    arr = np.asarray(frame, np.float32)
    g = max(min(int(grid), arr.shape[0], arr.shape[1]), 1)
    rows = []
    for band in np.array_split(arr, g, axis=0):
        for block in np.array_split(band, g, axis=1):
            rows.append(block.reshape(-1, arr.shape[-1]).mean(axis=0))
    return np.stack(rows).astype(np.float32)


class _Session:
    """One stream's state: the anchor frame (the last frame that went through the full
    path), its signature and digest, and the idle clock."""

    __slots__ = ("anchor", "signature", "anchor_digest", "last_active", "frames")

    def __init__(self, anchor: np.ndarray, signature: np.ndarray, anchor_digest: str):
        self.anchor = anchor
        self.signature = signature
        self.anchor_digest = anchor_digest
        self.last_active = time.monotonic()
        self.frames = 0


class StreamRouter:
    """Per-stream temporal feature reuse in front of one ``ServeEngine`` (the module
    docstring has the contract).

    Parameters
    ----------
    engine: the ServeEngine every frame submits to.
    reuse: the election switch (None -> ``TMR_STREAM_REUSE``, default off). Off,
        ``submit_stream`` is a counted passthrough to ``engine.submit``.
    delta: the block-mean delta threshold (None -> ``TMR_STREAM_DELTA``, default 0.02). A
        frame with delta strictly above it is "changed" (full path, new anchor); at or
        below it reuses.
    idle_s: the session idle bound (None -> ``TMR_STREAM_IDLE_S``, default 300).
    cache_mb: the byte bound of the anchor-feature cache (None -> ``TMR_STREAM_CACHE_MB``,
        default 64); streams beyond it refill on their next reused frame.
    """

    def __init__(self, engine, *, reuse: Optional[bool] = None,
                 delta: Optional[float] = None, idle_s: Optional[float] = None,
                 cache_mb: Optional[float] = None):
        self._engine = engine
        self.reuse = (_env_int("TMR_STREAM_REUSE", 0) != 0 if reuse is None
                      else bool(reuse))
        self.delta = _env_float("TMR_STREAM_DELTA", 0.02) if delta is None else float(delta)
        self.idle_s = (_env_float("TMR_STREAM_IDLE_S", 300.0) if idle_s is None
                       else float(idle_s))
        mb = (_env_float("TMR_STREAM_CACHE_MB", 64.0) if cache_mb is None
              else float(cache_mb))
        self._lock = threading.RLock()
        self._sessions: Dict[str, _Session] = {}
        #: anchor features keyed by stream id (the value carries the anchor digest it
        #: derives from): no key lets stream A read stream B's features
        self._features = LRUCache(4096, registry=engine.metrics,
                                  name="stream.cache.feature",
                                  max_bytes=int(mb * (1 << 20)) if mb > 0 else None)
        #: ``stream.*`` counters on the engine's registry, created on their first event
        self._mx: Dict[str, Any] = {}

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            c = self._mx.get(name)
            if c is None:
                c = self._mx[name] = self._engine.metrics.counter(f"stream.{name}")
        c.inc(n)

    # -------------------------------------------------------------- submit
    def submit_stream(self, stream_id: str, frame, exemplars, priority: int = 0,
                      deadline_ms: Optional[float] = None) -> Future:
        """Submit one frame of one stream; returns the engine's Future. Single exemplar
        only (reuse rides the heads-only program)."""
        sid = str(stream_id)
        self._count("frames")
        if not self.reuse:
            return self._engine.submit(frame, exemplars, priority=priority,
                                       deadline_ms=deadline_ms)
        arr = np.asarray(frame, np.float32)
        if arr.ndim == 4 and arr.shape[0] == 1:
            arr = arr[0]
        self._sweep_idle()
        sig = block_signature(arr)
        with self._lock:
            sess = self._sessions.get(sid)
            if sess is None:
                verdict = "first"
            else:
                d = float(np.max(np.abs(sig - sess.signature)))
                verdict = "changed" if d > self.delta else "reused"
            if verdict == "reused":
                sess.last_active = time.monotonic()
                sess.frames += 1
                anchor, anchor_digest = sess.anchor, sess.anchor_digest
            else:
                # full path: this frame becomes the anchor, and the old anchor's cached
                # features drop
                anchor = np.ascontiguousarray(arr)
                anchor_digest = array_digest(anchor)
                fresh = _Session(anchor, sig, anchor_digest)
                if sess is not None:
                    fresh.frames = sess.frames + 1
                self._sessions[sid] = fresh
                self._features.pop((sid,))
        if verdict != "reused":
            self._count("first_frames" if verdict == "first" else "changed_frames")
            return self._engine.submit(arr, exemplars, priority=priority,
                                       deadline_ms=deadline_ms)
        features = self._anchor_features(sid, anchor, anchor_digest)
        self._count("reused_frames")
        return self._engine.submit(arr, exemplars, priority=priority,
                                   deadline_ms=deadline_ms, features=features)

    def _anchor_features(self, sid: str, anchor: np.ndarray,
                         anchor_digest: str) -> torch.Tensor:
        """The anchor's encoder features, filled once per anchor into the byte-bounded
        cache on the engine's device: through the engine's feature tier when it is armed
        and holding (counted ``remote_fills``), else one local encoder call
        (``local_fills``). The device call runs outside the router's lock; a racing
        duplicate fill computes the same value twice, which is harmless."""
        with self._lock:
            entry = self._features.get((sid,))
        if entry is not None and entry[0] == anchor_digest:
            return entry[1]
        size = int(anchor.shape[0])
        feats = None
        client = getattr(self._engine, "_feature_client", None)
        if client is not None:
            try:
                feats = client.fetch(anchor, anchor_digest, size)
            except Exception:
                feats = None
            if feats is not None:
                self._count("remote_fills")
        if feats is None:
            # np.stack, not [None]: a new axis gets stride 0, and the CPU convolutions
            # pick their path by the input's strides
            feats = self._engine._pred._get_backbone_fn()(np.stack([anchor]))
            self._count("local_fills")
        feats = torch.as_tensor(feats, device=self._engine.device)
        with self._lock:
            self._features.put((sid,), (anchor_digest, feats))
        return feats

    # ----------------------------------------------------------- lifecycle
    def _sweep_idle(self) -> None:
        """Lazy idle eviction: every submit drops the sessions inactive past
        ``idle_s``."""
        if self.idle_s <= 0:
            return
        now = time.monotonic()
        with self._lock:
            dead = [sid for sid, s in self._sessions.items()
                    if now - s.last_active > self.idle_s]
            for sid in dead:
                del self._sessions[sid]
                self._features.pop((sid,))
        if dead:
            self._count("evicted_sessions", len(dead))

    def evict(self, stream_id: str) -> bool:
        """Drop one session and its cached features now; True when it existed."""
        sid = str(stream_id)
        with self._lock:
            existed = self._sessions.pop(sid, None) is not None
            self._features.pop((sid,))
        if existed:
            self._count("evicted_sessions")
        return existed

    def sessions(self) -> Dict[str, dict]:
        with self._lock:
            return {sid: {"frames": s.frames,
                          "idle_s": round(time.monotonic() - s.last_active, 3),
                          "anchor_digest": s.anchor_digest}
                    for sid, s in self._sessions.items()}

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {name: int(c.value) for name, c in self._mx.items()}

    def stats(self) -> dict:
        with self._lock:
            n = len(self._sessions)
        return {"reuse": self.reuse, "delta": self.delta, "idle_s": self.idle_s,
                "sessions": n, "feature_cache": self._features.stats(), **self.counters()}
