"""End-to-end inference (counterpart of ``tmr_tpu/inference.py``).

The JAX ``Predictor``'s inference programs, run eagerly, with the template capacity
bucket picked on the host from the exemplar geometry:

- ``__call__``: the single-exemplar program (``_single_pipeline``): forward ->
  ``decode_detections`` -> ``batched_nms``;
- :meth:`Predictor.predict_multi_exemplar` / :meth:`Predictor.predict_multi_batch`: the
  few-shot contract (reference ``trainer.py:75-121``): the encoder once per image, the
  heads and the decode once per exemplar row, one NMS over each image's union of rows;
- :meth:`Predictor._get_backbone_fn` / :meth:`Predictor._get_heads_fn`: the split
  programs behind a feature cache (the encoder alone; the rest on its features).

All four end in the same tail (:meth:`Predictor._refine_nms`): NMS, then, under
``cfg.decode_tail="device"``, the survivors compacted to the leading slots with a
``count`` per image. Outputs are fixed-shape tensors (boxes, scores, refs, valid[,
count]); :func:`detections_to_numpy` turns them into per-image ragged lists. The port has
no SAM refiner yet: ``cfg.refine_box`` raises ``NotImplementedError``.

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

from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from tmr_tpu_torch.models import build_model, resolve_device
from tmr_tpu_torch.models.matching_net import select_capacity_bucket
from tmr_tpu_torch.ops.postprocess import batched_nms, compact_detections, decode_detections
from tmr_tpu_torch.utils.weights import init_params, params_from_jax

#: static exemplar-count buckets of the multi-exemplar programs (the JAX
#: ``Predictor.K_BUCKETS``): k real rows pad up to the next bucket and the padded rows'
#: detections are masked out. The paper's contract is k <= 3; 16 and 32 are the gallery
#: tier's rungs.
K_BUCKETS = (1, 2, 3, 4, 6, 8, 16, 32)


def k_bucket(k: int) -> int:
    """The bucket k real exemplar rows pad up to (k itself past the last bucket)."""
    return int(next((b for b in K_BUCKETS if b >= k), k))


def _host(a) -> np.ndarray:
    """An f32 numpy copy of exemplars given as an array or a tensor on any device."""
    return np.asarray(a.cpu() if torch.is_tensor(a) else a, np.float32)


class Predictor:
    """The detector's inference entry points over one ``Config``."""

    K_BUCKETS = K_BUCKETS

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

    def bucket_key(self, image_size: int, exemplars, multi: bool = False,
                   k_real: Optional[int] = None) -> Tuple[str, int, int, int]:
        """The static bucket of a request: ``("single", image_size, capacity, K)`` for
        ``__call__`` (the capacity from every carried row), or ``("multi", image_size,
        capacity, k_bucket)`` for the multi-exemplar programs (the capacity from the
        ``k_real`` real rows only)."""
        image_size = int(image_size)
        exemplars = _host(exemplars).reshape(-1, 4)
        if multi:
            k = int(k_real) if k_real is not None else len(exemplars)
            return ("multi", image_size, self.pick_capacity(exemplars[:k], image_size),
                    k_bucket(k))
        return ("single", image_size, self.pick_capacity(exemplars, image_size),
                len(exemplars))

    def _inputs(self, image, exemplars):
        """Device tensors and the template bucket, picked from the host copy of the
        exemplars (reading them back from the device would wait for it to drain)."""
        cap = self.pick_capacity(_host(exemplars), int(image.shape[1]))
        image = torch.as_tensor(image, dtype=torch.float32, device=self.device)
        exemplars = torch.as_tensor(exemplars, dtype=torch.float32, device=self.device)
        return image, exemplars, cap

    def _decode(self, out: dict, exemplars: torch.Tensor) -> dict:
        """Peak-pick and decode the model's maps into fixed slots; exemplars (rows, 4),
        one per row of the maps (shared by every program)."""
        cfg = self.cfg
        return decode_detections(
            out["objectness"], out["regressions"], exemplars,
            cls_threshold=cfg.NMS_cls_threshold, max_detections=cfg.max_detections,
            box_reg=cfg.box_reg, scale_imgsize=cfg.regression_scaling_imgsize,
            scale_wh_only=cfg.regression_scaling_WH_only,
        )

    def _refine_nms(self, dets: dict) -> dict:
        """The tail every program shares: NMS per image, then under
        ``decode_tail="device"`` the survivors compacted to the leading slots (the
        per-image lists are those of the host tail)."""
        if self.cfg.refine_box:
            raise NotImplementedError("refine_box: the port has no SAM refiner yet")
        dets = batched_nms(dets, self.cfg.NMS_iou_threshold)
        if self.cfg.decode_tail == "device":
            dets = compact_detections(dets)
        return dets

    @torch.inference_mode()
    def forward(self, image, exemplars) -> dict:
        """Model outputs (objectness (B, H, W), regressions (B, H, W, 4), f32)."""
        return self.model(*self._inputs(image, exemplars))

    @torch.inference_mode()
    def __call__(self, image, exemplars) -> dict:
        """image (B, S, S, 3) f32 normalized, NHWC; exemplars (B, K, 4) normalized xyxy.
        Returns boxes (B, K', 4), scores, refs (B, K', 2), valid (B, K') on the device
        (and count (B,) under ``decode_tail="device"``)."""
        image, exemplars, cap = self._inputs(image, exemplars)
        out = self.model(image, exemplars, cap)
        return self._refine_nms(self._decode(out, exemplars[:, 0, :]))

    def predict_multi_exemplar(self, image, exemplars, k_real=None) -> dict:
        """The reference's multi-exemplar eval (``trainer.py:75-121``): a decode per
        exemplar, one NMS over their union. image (1, S, S, 3); exemplars (K, 4), of
        which the first ``k_real`` (default K) are real: a caller may hand over rows
        padded already. The real rows pad up to their k bucket with the last real row,
        masked out after the decode; the capacity comes from the real rows. Returns
        fixed-slot detections with leading dim 1 and k_bucket x ``max_detections``
        slots, exemplar-major."""
        exemplars = _host(exemplars).reshape(-1, 4)
        k = int(k_real) if k_real is not None else len(exemplars)
        if not 1 <= k <= len(exemplars):
            raise ValueError(f"k_real={k} out of range for {len(exemplars)} exemplar rows")
        exemplars = exemplars[:k]
        pad = np.tile(exemplars[-1:], (k_bucket(k) - k, 1))  # masked after the decode
        return self._multi(image, np.concatenate([exemplars, pad])[None], [k],
                           self.pick_capacity(exemplars, int(image.shape[1])))

    def predict_multi_batch(self, images, exemplars, k_real) -> dict:
        """The batched form of :meth:`predict_multi_exemplar`: images (B, S, S, 3),
        exemplars (B, k_bucket, 4) padded to one k bucket already, k_real (B,) real rows
        per image. The capacity comes from every carried row; each image masks its own
        padded rows and gets its own union NMS. (The JAX program's ``donate`` is an XLA
        buffer-donation flag with no eager counterpart, so there is none here.)"""
        return self._multi(images, exemplars, k_real,
                           self.pick_capacity(_host(exemplars), int(images.shape[1])))

    @torch.inference_mode()
    def _multi(self, images, exemplars, k_real, cap: int) -> dict:
        """Encoder once per image, its feature repeated image-major to the B x k_bucket
        exemplar rows, heads and decode over those rows, padded rows masked, then the
        rows of each image merged into one union for the tail (``_multi_batched_pipeline``
        of the JAX package)."""
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        ex = torch.as_tensor(exemplars, dtype=torch.float32, device=self.device)
        k_real = torch.as_tensor(k_real, device=self.device)
        b, kb = ex.shape[:2]
        rows = ex.reshape(b * kb, 4)
        feat = self.model.backbone_features(images).repeat_interleave(kb, dim=0)
        out = self.model(None, rows[:, None, :], cap, features=feat)
        dets = self._decode(out, rows)
        row_ok = torch.arange(kb, device=self.device)[None, :] < k_real[:, None]
        dets["valid"] = dets["valid"] & row_ok.reshape(-1)[:, None]
        return self._refine_nms({name: dets[name].reshape((b, -1) + dets[name].shape[2:])
                                 for name in ("boxes", "scores", "refs", "valid")})

    def _get_backbone_fn(self) -> Callable:
        """The encoder-only program: image (B, S, S, 3) -> pre-upsample features
        (B, h, w, C), what a feature cache stores and :meth:`_get_heads_fn` takes. The
        JAX program's ``params`` argument has no counterpart: the model holds its
        weights."""

        @torch.inference_mode()
        def run(image):
            return self.model.backbone_features(
                torch.as_tensor(image, dtype=torch.float32, device=self.device))

        return run

    def _get_heads_fn(self, capacity: int, image_size: int) -> Callable:
        """The program on precomputed features for one capacity bucket: (features
        (B, h, w, C), exemplars (B, K, 4)) -> the detections of ``__call__``, through the
        same launches, so they equal it bit for bit. ``image_size`` names the bucket's
        input size (the JAX program hands it to the refiner, which the port lacks)."""
        capacity = int(capacity)

        @torch.inference_mode()
        def run(features, exemplars):
            ex = torch.as_tensor(exemplars, dtype=torch.float32, device=self.device)
            out = self.model(None, ex, capacity, features=torch.as_tensor(
                features, dtype=torch.float32, device=self.device))
            return self._refine_nms(self._decode(out, ex[:, 0, :]))

        return run


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
