"""End-to-end inference (counterpart of ``tmr_tpu/inference.py``).

The JAX ``Predictor``'s inference programs, run eagerly, with the template capacity
bucket picked on the host from the exemplar geometry:

- ``__call__``: the single-exemplar program (:meth:`Predictor._get_fn`, the JAX
  ``_single_pipeline``): forward -> ``decode_detections`` -> ``batched_nms``; with a
  ``loss_fn`` it also returns the losses of the same forward (the eval step);
- :meth:`Predictor.predict_multi_exemplar` / :meth:`Predictor.predict_multi_batch`: the
  few-shot contract (reference ``trainer.py:75-121``): the encoder once per image, the
  heads and the decode once per exemplar row, one NMS over each image's union of rows
  (with a ``loss_fn``, the losses of the real rows summed);
- :meth:`Predictor._get_backbone_fn` / :meth:`Predictor._get_heads_fn`: the split
  programs behind a feature cache (the encoder alone; the rest on its features);
- :meth:`Predictor.predict_gallery`: one frame against N standing exemplar sets (the
  gallery tier, ``serve/gallery.py``): the encoder once, the heads and the decode over
  the N x k_bucket rows, one union NMS per entry; the fused arm
  (:meth:`Predictor._get_gallery_fn`) or, on features from the backbone program, the
  features arm (:meth:`Predictor._get_gallery_heads_fn`); the coarse prefilter's scores
  (:meth:`Predictor._get_gallery_prefilter_fn`).

All four end in the same tail (:meth:`Predictor._refine_nms`): with a ``refiner``
(``refine.SamRefineModule``) and ``cfg.refine_box``, SAM box refinement on the encoder's
pre-upsample feature (one per image: the multi programs hand over the encoder's output,
not its copies per exemplar row), then NMS, then, under ``cfg.decode_tail="device"``, the
survivors compacted to the leading slots with a ``count`` per image (the reference's
test-step order, trainer.py:143-150). ``cfg.refine_box`` without a refiner refines
nothing, as in the JAX package. Outputs are fixed-shape tensors (boxes, scores, refs,
valid[, count]); :func:`detections_to_numpy` turns them into per-image ragged lists.

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

import hashlib
from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch

from tmr_tpu_torch.models import build_model, resolve_device
from tmr_tpu_torch.models.matching_net import select_capacity_bucket
from tmr_tpu_torch.ops.postprocess import batched_nms, compact_detections, decode_detections
from tmr_tpu_torch.ops.xcorr import coarse_prefilter_scores
from tmr_tpu_torch.utils.weights import init_params, params_from_jax

#: static exemplar-count buckets of the multi-exemplar programs (the JAX
#: ``Predictor.K_BUCKETS``): k real rows pad up to the next bucket and the padded rows'
#: detections are masked out. The paper's contract is k <= 3; 16 and 32 are the gallery
#: tier's rungs.
K_BUCKETS = (1, 2, 3, 4, 6, 8, 16, 32)
#: static entry-count buckets of the gallery programs (the JAX ``Predictor.N_BUCKETS``):
#: N bank entries pad up to a rung and the padded entries are masked out
N_BUCKETS = (1, 2, 4, 8, 16, 32)


def k_bucket(k: int) -> int:
    """The bucket k real exemplar rows pad up to (k itself past the last bucket)."""
    return int(next((b for b in K_BUCKETS if b >= k), k))


def n_bucket(n: int) -> int:
    """The rung n bank entries pad up to (n itself past the last rung)."""
    return int(next((b for b in N_BUCKETS if b >= n), n))


def _host(a) -> np.ndarray:
    """An f32 numpy copy of exemplars given as an array or a tensor on any device."""
    return np.asarray(a.cpu() if torch.is_tensor(a) else a, np.float32)


class Predictor:
    """The detector's inference entry points over one ``Config``."""

    K_BUCKETS = K_BUCKETS
    N_BUCKETS = N_BUCKETS

    def __init__(self, cfg, device=None, model: Optional[torch.nn.Module] = None,
                 refiner: Optional[torch.nn.Module] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = model if model is not None else build_model(cfg, device=self.device)
        self.model = model.to(self.device).eval()
        self.refiner = None if refiner is None else refiner.to(self.device).eval()
        self._stamp: Optional[dict] = None
        #: set once the weights are (``init_params``, ``load_state_dict``,
        #: ``load_jax_params``): the JAX ``Predictor.params is not None``, which the
        #: serving engine requires
        self.weights_set = False
        self._digest: Optional[str] = None

    def _weights_set(self) -> None:
        if self.cfg.quant_storage == "int8":
            self._stamp = self.model.store_int8()
        self.weights_set = True
        self._digest = None

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
        the stored kernels beside the f32 bytes they replace and the digest of the
        stored weights; None when exact."""
        if self._stamp is not None:
            return dict(self._stamp, digest=self.weights_digest())
        if self.cfg.quant == "int8":
            return {"mode": "int8", "storage": "off"}
        return None

    def weights_digest(self) -> str:
        """sha1 of the model's state (every entry's name, dtype, shape and host bytes,
        in ``state_dict`` order), computed once per setting of the weights."""
        if self._digest is None:
            h = hashlib.sha1()
            for name, t in self.model.state_dict().items():
                t = t.detach().cpu().contiguous()
                h.update(f"{name}:{t.dtype}:{tuple(t.shape)}".encode())
                h.update(t.view(-1).view(torch.uint8).numpy().tobytes()
                         if t.numel() else b"")
            self._digest = h.hexdigest()
        return self._digest

    def feature_stamp(self) -> tuple:
        """Cache-key provenance of extracted backbone features (the JAX ``:184``):
        ``(weights digest, backbone formulation)``. A serving feature-cache key carries
        it beside the image digest, so features extracted under other weights are
        never served."""
        return (self.weights_digest(), str(self.cfg.backbone))

    def feature_hw(self, image_size: int) -> int:
        """The matcher's map side at ``image_size``: the backbone's ``feature_stride`` (a
        ResNet's) or ``patch_size`` (a SAM ViT's), x2 under ``feature_upsample``."""
        bb = self.model.backbone
        stride = getattr(bb, "feature_stride", None) or getattr(bb, "patch_size", 16)
        base = image_size // stride
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

    def _refine_nms(self, dets: dict, feature: torch.Tensor,
                    image_hw: Tuple[int, int]) -> dict:
        """The tail every program shares: with a refiner and ``cfg.refine_box``, SAM box
        refinement on ``feature`` (B, h, w, C), the encoder's output for the B images
        of ``dets``, at ``image_hw``; NMS per image; then under ``decode_tail="device"``
        the survivors compacted to the leading slots (the per-image lists are those of
        the host tail)."""
        if self.refiner is not None and self.cfg.refine_box:
            dets = self.refiner.refine(feature, dets, image_hw)
        dets = batched_nms(dets, self.cfg.NMS_iou_threshold)
        if self.cfg.decode_tail == "device":
            dets = compact_detections(dets)
        return dets

    @torch.inference_mode()
    def forward(self, image, exemplars) -> dict:
        """Model outputs (objectness (B, H, W), regressions (B, H, W, 4), f32)."""
        return self.model(*self._inputs(image, exemplars))

    def __call__(self, image, exemplars) -> dict:
        """image (B, S, S, 3) f32 normalized, NHWC; exemplars (B, K, 4) normalized xyxy.
        Returns boxes (B, K', 4), scores, refs (B, K', 2), valid (B, K') on the device
        (and count (B,) under ``decode_tail="device"``)."""
        image, exemplars, cap = self._inputs(image, exemplars)
        return self._get_fn(cap)(image, exemplars)

    def _get_fn(self, capacity: int, loss_fn: Optional[Callable] = None) -> Callable:
        """The single-exemplar program for one template-capacity bucket: (image,
        exemplars) -> detections, forward -> decode -> NMS. With ``loss_fn(model_out,
        exemplars, *extra) -> losses`` the program also returns the losses of the same
        forward, as ``(losses, detections)``, and takes the extra loss inputs after the
        exemplars (the eval step's ``gt_boxes``, ``gt_valid``): one forward per eval
        image, as the reference's each_step (trainer.py:123-153)."""
        capacity = int(capacity)

        @torch.inference_mode()
        def run(image, exemplars, *extra):
            image = torch.as_tensor(image, dtype=torch.float32, device=self.device)
            ex = torch.as_tensor(exemplars, dtype=torch.float32, device=self.device)
            out = self.model(image, ex, capacity)
            dets = self._refine_nms(self._decode(out, ex[:, 0, :]), out["backbone_feature"],
                                    (image.shape[1], image.shape[2]))
            if loss_fn is None:
                return dets
            extra = [torch.as_tensor(e, device=self.device) for e in extra]
            return loss_fn(out, ex, *extra), dets

        return run

    def predict_multi_exemplar(self, image, exemplars, loss_fn: Optional[Callable] = None,
                               loss_args=(), k_real=None):
        """The reference's multi-exemplar eval (``trainer.py:75-121``): a decode per
        exemplar, one NMS over their union. image (1, S, S, 3); exemplars (K, 4), of
        which the first ``k_real`` (default K) are real: a caller may hand over rows
        padded already. The real rows pad up to their k bucket with the last real row,
        masked out after the decode; the capacity comes from the real rows. Returns
        fixed-slot detections with leading dim 1 and k_bucket x ``max_detections``
        slots, exemplar-major. With ``loss_fn(out_k, exemplar_k (1, 1, 4), *loss_args)``
        (``_get_fn``'s, on one exemplar row's B = 1 slice of the heads' output) it
        returns ``(losses, detections)``, the losses summed over the real rows (the
        reference sums per-exemplar losses, trainer.py:102-104,121)."""
        exemplars = _host(exemplars).reshape(-1, 4)
        k = int(k_real) if k_real is not None else len(exemplars)
        if not 1 <= k <= len(exemplars):
            raise ValueError(f"k_real={k} out of range for {len(exemplars)} exemplar rows")
        exemplars = exemplars[:k]
        pad = np.tile(exemplars[-1:], (k_bucket(k) - k, 1))  # masked after the decode
        cap = self.pick_capacity(exemplars, int(image.shape[1]))
        dets, out, rows = self._multi(image, np.concatenate([exemplars, pad])[None], [k],
                                      cap)
        if loss_fn is None:
            return dets
        with torch.inference_mode():
            extra = [torch.as_tensor(e, device=self.device) for e in loss_args]
            per_row = []
            for j in range(k):
                out_j = {name: None if v is None else v[j:j + 1] for name, v in out.items()}
                per_row.append(loss_fn(out_j, rows[j:j + 1, None, :], *extra))
            losses = {name: torch.stack([r[name] for r in per_row]).sum()
                      for name in per_row[0]}
        return losses, dets

    def predict_multi_batch(self, images, exemplars, k_real) -> dict:
        """The batched form of :meth:`predict_multi_exemplar`: images (B, S, S, 3),
        exemplars (B, k_bucket, 4) padded to one k bucket already, k_real (B,) real rows
        per image. The capacity comes from every carried row; each image masks its own
        padded rows and gets its own union NMS. (The JAX program's ``donate`` is an XLA
        buffer-donation flag with no eager counterpart, so there is none here.)"""
        return self._multi(images, exemplars, k_real,
                           self.pick_capacity(_host(exemplars), int(images.shape[1])))[0]

    def _get_multi_batched_fn(self, capacity: int, k_bucket: int) -> Callable:
        """The batched multi-exemplar program for one (capacity, k bucket):
        (images (B, S, S, 3), exemplars (B, k_bucket, 4), k_real (B,)) -> the detections
        of :meth:`predict_multi_batch`, at the capacity given rather than one picked from
        the rows (a serving batch's padded rows must not move its bucket). The JAX
        program's ``donate`` has no eager counterpart."""
        capacity, k_bucket = int(capacity), int(k_bucket)

        def run(images, exemplars, k_real):
            if exemplars.shape[1] != k_bucket:
                raise ValueError(f"exemplars carry {exemplars.shape[1]} rows, the "
                                 f"program's k bucket is {k_bucket}")
            return self._multi(images, exemplars, k_real, capacity)[0]

        return run

    @torch.inference_mode()
    def _multi(self, images, exemplars, k_real, cap: int):
        """Encoder once per image, then :meth:`_union_tail` over its k_bucket exemplar
        rows (``_multi_batched_pipeline`` of the JAX package). Returns (detections, the
        heads' output over the rows, the rows (B * k_bucket, 4) on the device)."""
        images = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        ex = torch.as_tensor(exemplars, dtype=torch.float32, device=self.device)
        feat = self.model.backbone_features(images)
        return self._union_tail(feat, ex, torch.as_tensor(k_real, device=self.device),
                                cap, (images.shape[1], images.shape[2]))

    def _union_tail(self, feat, ex, k_real, cap: int, image_hw, n_real=None):
        """The one body of the multi-exemplar and gallery programs. ``feat`` (G, h, w, C)
        is the encoder's output for each of G groups of exemplar rows ``ex``
        (G, k_bucket, 4), of which the first ``k_real[g]`` are real: the feature is
        repeated group-major to the G x k_bucket rows, the heads and decode run over the
        rows, the padded rows (and the groups from ``n_real`` on, when given) are masked,
        and each group's rows merge into one union for :meth:`_refine_nms` (which refines
        on ``feat``). Returns (detections, the heads' output, the rows (G * k_bucket,
        4))."""
        g, kb = ex.shape[:2]
        rows = ex.reshape(g * kb, 4)
        out = self.model(None, rows[:, None, :], cap,
                         features=feat.repeat_interleave(kb, dim=0))
        dets = self._decode(out, rows)
        ok = torch.arange(kb, device=self.device)[None, :] < k_real[:, None]
        if n_real is not None:
            ok = ok & (torch.arange(g, device=self.device) < n_real)[:, None]
        dets["valid"] = dets["valid"] & ok.reshape(-1)[:, None]
        dets = self._refine_nms({name: dets[name].reshape((g, -1) + dets[name].shape[2:])
                                 for name in ("boxes", "scores", "refs", "valid")},
                                feat, image_hw)
        return dets, out, rows

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
        same launches, so they equal it bit for bit. ``image_size`` is the bucket's
        input size, which the refiner takes with the features."""
        capacity, image_size = int(capacity), int(image_size)

        @torch.inference_mode()
        def run(features, exemplars):
            ex = torch.as_tensor(exemplars, dtype=torch.float32, device=self.device)
            out = self.model(None, ex, capacity, features=torch.as_tensor(
                features, dtype=torch.float32, device=self.device))
            return self._refine_nms(self._decode(out, ex[:, 0, :]),
                                    out["backbone_feature"], (image_size, image_size))

        return run

    # ------------------------------------------------------------------ gallery
    # One frame against a standing bank of N exemplar sets (``serve/gallery.py``): the
    # encoder once, then the heads and decode over N x k_bucket rows and one union NMS
    # per entry, the N-entry generalization of the multi program (entry i's slice runs
    # the ops of ``predict_multi_exemplar`` on its exemplars). N pads to a
    # ``N_BUCKETS`` rung; the padded entries are masked like padded rows.

    def _gallery_tail(self, feat, exemplars, k_real, n_real: int, cap: int, image_hw):
        """The tail both gallery arms share: feat (1, h, w, C); exemplars (n_bucket,
        k_bucket, 4); k_real (n_bucket,); n_real the real entries. The feature stands for
        every entry (a view; repeated n_bucket times only when a refiner refines on
        it, as in JAX). Returns detections with leading dim n_bucket."""
        nb = exemplars.shape[0]
        feat = feat.expand((nb,) + tuple(feat.shape[1:]))
        if self.refiner is not None and self.cfg.refine_box:
            feat = feat.contiguous()
        return self._union_tail(feat, exemplars, k_real, cap, image_hw, n_real)[0]

    def _gallery_inputs(self, exemplars, k_real):
        return (torch.as_tensor(exemplars, dtype=torch.float32, device=self.device),
                torch.as_tensor(k_real, device=self.device))

    def _get_gallery_fn(self, capacity: int, n_bucket: int, k_bucket: int) -> Callable:
        """The fused gallery program: (image (1, S, S, 3), exemplars (n_bucket, k_bucket,
        4), k_real (n_bucket,), n_real) -> detections with leading dim n_bucket: the
        encoder once, then :meth:`_gallery_tail`; each real entry's result is the
        N-loop's of ``predict_multi_exemplar`` (the same ops per row). The JAX
        program's ``donate`` has no eager counterpart."""
        capacity, n_bucket, k_bucket = int(capacity), int(n_bucket), int(k_bucket)

        @torch.inference_mode()
        def run(image, exemplars, k_real, n_real):
            image = torch.as_tensor(image, dtype=torch.float32, device=self.device)
            ex, kr = self._gallery_inputs(exemplars, k_real)
            _check_gallery_shape(ex, n_bucket, k_bucket)
            feat = self.model.backbone_features(image)
            return self._gallery_tail(feat, ex, kr, n_real, capacity,
                                      (image.shape[1], image.shape[2]))

        return run

    def _get_gallery_heads_fn(self, capacity: int, n_bucket: int, k_bucket: int,
                              image_size: int) -> Callable:
        """The gallery tail on precomputed features (the feature-cache and prefilter
        arm): (features (1, h, w, C) from :meth:`_get_backbone_fn`, exemplars, k_real,
        n_real) -> the detections of :meth:`_get_gallery_fn`, through the same launches
        after the encoder."""
        capacity, n_bucket, k_bucket = int(capacity), int(n_bucket), int(k_bucket)
        image_size = int(image_size)

        @torch.inference_mode()
        def run(features, exemplars, k_real, n_real):
            feat = torch.as_tensor(features, dtype=torch.float32, device=self.device)
            ex, kr = self._gallery_inputs(exemplars, k_real)
            _check_gallery_shape(ex, n_bucket, k_bucket)
            return self._gallery_tail(feat, ex, kr, n_real, capacity,
                                      (image_size, image_size))

        return run

    def _get_gallery_prefilter_fn(self, n_bucket: int, k_bucket: int) -> Callable:
        """The coarse prefilter program: (features (1, h, w, C), exemplars (n_bucket,
        k_bucket, 4), k_real, n_real) -> (n_bucket,) f32 scores, padded entries -inf
        (``ops/xcorr.coarse_prefilter_scores``). Parameter-free."""
        n_bucket, k_bucket = int(n_bucket), int(k_bucket)

        @torch.inference_mode()
        def run(features, exemplars, k_real, n_real):
            feat = torch.as_tensor(features, dtype=torch.float32, device=self.device)
            ex, kr = self._gallery_inputs(exemplars, k_real)
            _check_gallery_shape(ex, n_bucket, k_bucket)
            return coarse_prefilter_scores(feat, ex, kr, n_real)

        return run

    def predict_gallery(self, image, exemplars, k_real, n_real=None, features=None,
                        image_size=None) -> dict:
        """Match a bank of N exemplar sets against one frame: image (1, S, S, 3);
        exemplars (N, k_bucket, 4) padded to one k rung already; k_real (N,) real rows
        per entry; the first ``n_real`` (default N) entries are real, the rest rung
        padding. With ``features`` ((1, h, w, C) from :meth:`_get_backbone_fn`) and
        ``image_size`` the encoder is skipped (the features arm). Returns fixed-slot
        detections with leading dim the padded N rung; entries from ``n_real`` on keep
        nothing."""
        if not self.weights_set:
            raise RuntimeError("call init_params() or load weights first")
        exemplars = _host(exemplars)
        if exemplars.ndim != 3 or exemplars.shape[-1] != 4:
            raise ValueError(f"expected (N, k_bucket, 4) exemplars, got {exemplars.shape}")
        n = int(n_real) if n_real is not None else exemplars.shape[0]
        if not 1 <= n <= exemplars.shape[0]:
            raise ValueError(f"n_real={n} out of range for {exemplars.shape[0]} bank "
                             "entries")
        k_real = np.asarray(k_real, np.int32).reshape(-1)
        if k_real.shape[0] != exemplars.shape[0]:
            raise ValueError("k_real must have one count per entry")
        kb = int(exemplars.shape[1])
        if not all(1 <= int(k) <= kb for k in k_real[:n]):
            raise ValueError(f"k_real rows must lie in [1, {kb}]")
        nb = n_bucket(n)
        if exemplars.shape[0] < nb:
            pad = nb - exemplars.shape[0]
            exemplars = np.concatenate([exemplars, np.tile(exemplars[-1:], (pad, 1, 1))])
            k_real = np.concatenate([k_real, np.ones((pad,), np.int32)])
        else:
            exemplars, k_real = exemplars[:nb], k_real[:nb]
        if features is None:
            size = int(image.shape[1])
        elif image_size is None:
            raise ValueError("features-arm predict_gallery needs image_size")
        else:
            size = int(image_size)
        rows = np.concatenate([exemplars[i, :int(k_real[i])] for i in range(n)])
        cap = self.pick_capacity(rows, size)
        if features is None:
            return self._get_gallery_fn(cap, nb, kb)(image, exemplars, k_real, n)
        return self._get_gallery_heads_fn(cap, nb, kb, size)(features, exemplars, k_real, n)


def _check_gallery_shape(ex: torch.Tensor, n_bucket: int, k_bucket: int) -> None:
    if tuple(ex.shape) != (n_bucket, k_bucket, 4):
        raise ValueError(f"exemplars {tuple(ex.shape)}, the program's buckets are "
                         f"({n_bucket}, {k_bucket}, 4)")


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
