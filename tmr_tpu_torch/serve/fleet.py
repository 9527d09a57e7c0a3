"""The gallery fleet's wire helpers (the part of ``tmr_tpu/serve/fleet.py`` that the
feature sink needs): arrays as JSON documents of base64 bytes, dtype and shape, the
format of the JSON-lines protocol the JAX package speaks, so the two packages' map
workers and feature sinks interoperate. The fleet itself (replicated banks, routing,
``GalleryFleetClient``) is ROADMAP A7.4.
"""

from __future__ import annotations

import base64

import numpy as np


def pack_array(a) -> dict:
    """An array as ``{"b64", "dtype", "shape"}`` (C-order bytes)."""
    arr = np.ascontiguousarray(np.asarray(a))
    return {"b64": base64.b64encode(arr.tobytes()).decode("ascii"),
            "dtype": str(arr.dtype), "shape": list(arr.shape)}


def unpack_array(doc: dict) -> np.ndarray:
    """The array of :func:`pack_array`'s document (a writable copy)."""
    raw = base64.b64decode(doc["b64"])
    return np.frombuffer(raw, dtype=np.dtype(doc["dtype"])).reshape(doc["shape"]).copy()
