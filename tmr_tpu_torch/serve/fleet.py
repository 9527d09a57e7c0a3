"""The pieces of ``tmr_tpu/serve/fleet.py`` that the feature sink and the feature tier
need: the wire helpers (arrays and detections as JSON documents of base64 bytes, dtype
and shape, the format of the JSON-lines protocol the JAX package speaks, so the two
packages' map workers, feature sinks and feature workers interoperate), the fleet's
lease policy, and the numpy stub predictor the tier's drills run. The fleet itself
(``ServeFleet``, ``FleetWorker``, their partitions, routing and recruitment) is ROADMAP
A7.4.
"""

from __future__ import annotations

import base64
import time
from typing import Optional

import numpy as np

from tmr_tpu_torch.parallel.leases import LeasePolicy
from tmr_tpu_torch.serve.caches import _host_array

#: detection fields the data plane ships (the engine's four and the device tail's count)
_DET_FIELDS = ("boxes", "scores", "refs", "valid", "count")


# ----------------------------------------------------------- wire helpers
def pack_array(a) -> dict:
    """An array as ``{"b64", "dtype", "shape"}`` (C-order bytes). A tensor on any device is
    read from the host; a bf16 one travels as its 16-bit words under the dtype name
    ``"bfloat16"``, as the JAX package writes a bf16 array, never upcast."""
    arr, dtype = _host_array(a)
    arr = np.ascontiguousarray(np.asarray(arr))
    return {"b64": base64.b64encode(arr.tobytes()).decode("ascii"),
            "dtype": dtype or str(arr.dtype), "shape": list(arr.shape)}


def unpack_array(doc: dict):
    """The array of :func:`pack_array`'s document (a writable copy): numpy, except that
    ``"bfloat16"`` becomes a CPU ``torch.bfloat16`` tensor of the same bits (numpy has no
    bfloat16 without ml_dtypes)."""
    raw = base64.b64decode(doc["b64"])
    if doc["dtype"] == "bfloat16":
        import torch

        words = np.frombuffer(raw, dtype=np.int16).reshape(doc["shape"]).copy()
        return torch.from_numpy(words).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=np.dtype(doc["dtype"])).reshape(doc["shape"]).copy()


def pack_detections(dets: dict) -> dict:
    return {name: pack_array(dets[name]) for name in _DET_FIELDS if name in dets}


def unpack_detections(doc: dict) -> dict:
    return {name: unpack_array(rec) for name, rec in doc.items()}


# ----------------------------------------------------------------- policy
def fleet_policy(policy: Optional[LeasePolicy] = None) -> LeasePolicy:
    """The fleet's lease policy: the shared TMR_ELASTIC_* liveness knobs, with straggler
    speculation off (a long-held partition is normal, not a straggler) and the
    reassignment bound effectively unbounded (partitions move many times over a fleet's
    life; quarantining one would blackhole its traffic)."""
    if policy is not None:
        return policy
    return LeasePolicy.from_env(straggler_factor=0.0, max_reassigns=1_000_000_000,
                                resource_fail_workers=1_000_000_000)


# ------------------------------------------------------------ stub engine
def _np32(a) -> np.ndarray:
    """An f32 numpy view of an array or a tensor (read from its device)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


class StubFleetPredictor:
    """Numpy-only ``Predictor`` stand-in on the CPU for fleet and tier drills: instant
    host "programs" with the port's program signatures (no weights argument), returning
    CPU tensors. Row 0 of each image's detections carries the image's mean as its score,
    a deterministic per-image signature computed as the JAX stub does (numpy float32), so
    a drill can verify every routed result came from its image. ``delay_s`` paces each
    program call."""

    weights_set = True

    def __init__(self, delay_s: float = 0.0, slots: int = 8):
        import torch

        self.device = torch.device("cpu")
        self.delay_s = float(delay_s)
        self.slots = int(slots)

    def bucket_key(self, size, ex, multi=False, k_real=None):
        ex = np.asarray(ex, np.float32).reshape(-1, 4)
        k = int(k_real) if k_real is not None else len(ex)
        if multi:
            return ("multi", int(size), 9, k)
        return ("single", int(size), 9, len(ex))

    def _dets(self, images) -> dict:
        import torch

        arr = _np32(images)
        b = arr.shape[0]
        sig = arr.reshape(b, -1).mean(axis=1)
        scores = np.zeros((b, self.slots), np.float32)
        scores[:, 0] = sig
        valid = np.zeros((b, self.slots), bool)
        valid[:, 0] = True
        return {"boxes": torch.zeros(b, self.slots, 4), "scores": torch.from_numpy(scores),
                "refs": torch.zeros(b, self.slots, 2), "valid": torch.from_numpy(valid)}

    def _run(self, images):
        if self.delay_s:
            time.sleep(self.delay_s)
        return self._dets(images)

    def _get_fn(self, capacity):
        return lambda image, ex, *a: self._run(image)

    def _get_multi_batched_fn(self, capacity, k):
        return lambda image, ex, k_real: self._run(image)

    def _get_backbone_fn(self):
        import torch

        return lambda image: torch.zeros(int(image.shape[0]), 2, 2, 4)

    def _get_heads_fn(self, capacity, size):
        return lambda feats, ex: self._run(np.zeros((int(feats.shape[0]), 1, 1, 3),
                                                    np.float32))

    def __call__(self, image, exemplars):
        image = _np32(image)
        return self._run(image[None] if image.ndim == 3 else image)

    def predict_multi_exemplar(self, image, exemplars, k_real=None):
        return self._run(image)


def stub_signature(image) -> float:
    """The per-image signature :class:`StubFleetPredictor` stamps into ``scores[0, 0]``:
    the float32 mean, computed as the stub computes it."""
    arr = np.asarray(image, np.float32)
    return float(arr.reshape(1, -1).mean(axis=1)[0])
