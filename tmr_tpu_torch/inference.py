"""End-to-end inference (counterpart of ``tmr_tpu/inference.py``, single-exemplar path).

``Predictor.__call__`` runs the body of the JAX ``Predictor._single_pipeline``:
forward -> ``decode_detections`` -> ``batched_nms``, eagerly, with the template
capacity bucket picked on the host from the exemplar geometry. Outputs are
fixed-shape tensors (boxes, scores, refs, valid); :func:`detections_to_numpy` turns
them into per-image ragged lists (the host tail).

Devices: everything runs on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU and no explicit ``"cpu"`` the constructor raises, it never carries on on the
CPU.

int8 storage (``cfg.quant_storage="int8"``, the counterpart of ``_storage_state`` /
``exec_params``): the weights are set in f32 (``init_params``, ``load_jax_params`` or
``load_state_dict``), then the decoder and head kernels are quantized once and the model
keeps only their int8 copies and scales (:meth:`MatchingNet.store_int8`);
:meth:`Predictor.quant_stamp` gives their byte counts.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from tmr_tpu_torch.models import build_model, resolve_device
from tmr_tpu_torch.models.matching_net import select_capacity_bucket
from tmr_tpu_torch.ops.postprocess import batched_nms, decode_detections
from tmr_tpu_torch.utils.weights import init_params, params_from_jax


class Predictor:
    """Single-exemplar detector over one ``Config``."""

    def __init__(self, cfg, device=None, model: Optional[torch.nn.Module] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = model if model is not None else build_model(cfg, device=self.device)
        self.model = model.to(self.device).eval()
        self._stamp: Optional[dict] = None

    def _weights_set(self) -> None:
        if self.cfg.quant_storage == "int8":
            self._stamp = self.model.store_int8()

    def _check_settable(self) -> None:
        if self._stamp is not None:
            raise RuntimeError("the int8-stored weights are set once; build a new "
                               "Predictor for other weights")

    def init_params(self, seed: int = 0) -> None:
        """Seeded random weights on the predictor's device (no JAX involved)."""
        self._check_settable()
        init_params(self.model, seed)
        self._weights_set()

    def load_jax_params(self, tree: Mapping) -> None:
        """Load a flax param tree (numpy leaves) through the weight bridge."""
        self.load_state_dict(params_from_jax(tree))

    def load_state_dict(self, state_dict: Mapping) -> None:
        """Load the f32 ``state_dict`` of an unquantized model of the same geometry."""
        self._check_settable()
        self.model.load_state_dict(state_dict)
        self._weights_set()

    def quant_stamp(self) -> Optional[dict]:
        """Which quantization the model runs, and under int8 storage the int8 bytes of
        the stored kernels beside the f32 bytes they replace; None when exact."""
        if self._stamp is not None:
            return dict(self._stamp)
        if self.cfg.quant == "int8":
            return {"mode": "int8", "storage": "off"}
        return None

    def feature_hw(self, image_size: int) -> int:
        base = image_size // self.model.backbone.patch_size
        return base * 2 if self.cfg.feature_upsample else base

    def pick_capacity(self, exemplars, image_size: int) -> int:
        """Template bucket for a batch: the largest per-exemplar need."""
        hw = self.feature_hw(int(image_size))
        need = 1
        for ex in np.asarray(exemplars, dtype=np.float32).reshape(-1, 4):
            need = max(need, select_capacity_bucket(ex, hw, hw,
                                                    self.cfg.template_buckets))
        return int(need)

    def bucket_key(self, image_size: int, exemplars) -> Tuple[str, int, int, int]:
        """``("single", image_size, capacity, K)``: the static bucket of a request."""
        exemplars = np.asarray(exemplars, np.float32).reshape(-1, 4)
        return ("single", int(image_size), self.pick_capacity(exemplars, image_size),
                len(exemplars))

    def _inputs(self, image, exemplars):
        """Device tensors and the template bucket, picked from the host copy of the
        exemplars (reading them back from the device would wait for it to drain)."""
        host_ex = exemplars.cpu().numpy() if torch.is_tensor(exemplars) else exemplars
        cap = self.pick_capacity(host_ex, int(image.shape[1]))
        image = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        exemplars = torch.as_tensor(exemplars, dtype=torch.float32, device=self.device)
        return image, exemplars, cap

    @torch.inference_mode()
    def forward(self, image, exemplars) -> dict:
        """Model outputs (objectness (B, H, W), regressions (B, H, W, 4), f32)."""
        return self.model(*self._inputs(image, exemplars))

    @torch.inference_mode()
    def __call__(self, image, exemplars) -> dict:
        """image (B, S, S, 3) f32 normalized, NHWC; exemplars (B, K, 4) normalized xyxy.
        Returns boxes (B, K', 4), scores, refs (B, K', 2), valid (B, K') on the device."""
        image, exemplars, cap = self._inputs(image, exemplars)
        out = self.model(image, exemplars, cap)
        cfg = self.cfg
        dets = decode_detections(
            out["objectness"], out["regressions"], exemplars[:, 0, :],
            cls_threshold=cfg.NMS_cls_threshold, max_detections=cfg.max_detections,
            box_reg=cfg.box_reg, scale_imgsize=cfg.regression_scaling_imgsize,
            scale_wh_only=cfg.regression_scaling_WH_only,
        )
        return batched_nms(dets, cfg.NMS_iou_threshold)


def detections_to_numpy(dets: dict) -> list:
    """Fixed-slot detections -> per-image ragged numpy dicts (boxes, scores, refs)."""
    boxes = dets["boxes"].cpu().numpy()
    scores = dets["scores"].cpu().numpy()
    refs = dets["refs"].cpu().numpy()
    if "count" in dets:
        count = dets["count"].cpu().numpy()
        return [{"boxes": boxes[b][:n].copy(), "scores": scores[b][:n].copy(),
                 "refs": refs[b][:n].copy()} for b, n in enumerate(count.tolist())]
    valid = dets["valid"].cpu().numpy()
    return [{"boxes": boxes[b][v], "scores": scores[b][v], "refs": refs[b][v]}
            for b, v in enumerate(valid)]
