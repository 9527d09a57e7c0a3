"""The segment-anything surface: model registry, predictor, automatic mask generator and
the deployable decoder (counterpart of ``tmr_tpu/sam.py``; reference
utils/segment_anything/: ``build_sam.py:47-52``, ``predictor.py``,
``automatic_mask_generator.py``, ``utils/onnx.py``).

Built from the port's own parts: the SAM ViT encoder (``models/vit.py``, bf16, through
the attention kernels: the global and windowed kernels at head dim 64 for ``vit_b``,
their D = 80 forms for ``vit_h``), the prompt encoder and mask decoder
(``models/sam_decoder.py``, f32, with the reference's best-IoU selection), SAM's
preprocessing (``data/transforms.sam_longest_side_preprocess``) and NMS
(``ops/nms.nms_keep_mask``, the NMS kernel on the card). As in the JAX package the
predictor encodes an image once and answers any number of prompts from the cached
embedding, and the mask generator decodes its point grid in batches of prompts and
dedupes with the port's NMS. Float mask logits go back to the original resolution
through cv2's float ``INTER_LINEAR`` in numpy (``data/transforms.resize_linear_f32``):
the card's machine has no cv2.

Devices: ``Sam`` is built on ``cuda`` unless the caller passes ``device="cpu"``
(``models.resolve_device``; no GPU and no ``"cpu"`` raises).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tmr_tpu_torch.data.transforms import resize_linear_f32, sam_longest_side_preprocess
from tmr_tpu_torch.models import resolve_device
from tmr_tpu_torch.models.sam_decoder import (MaskDecoder, PromptEncoder, const_f32,
                                              masks_to_boxes, resize_align_corners)
from tmr_tpu_torch.models.vit import build_sam_vit
from tmr_tpu_torch.utils.weights import init_params, params_from_jax


class Sam(nn.Module):
    """Image encoder (bf16 SAM ViT), prompt encoder and mask decoder (f32), on
    ``device``. Their weights are set by :meth:`init_random`, :meth:`from_checkpoint`,
    :meth:`load_jax_params` or ``load_state_dict``. ``image_encoder``,
    ``prompt_encoder`` and ``mask_decoder`` override the registry's modules (the tests
    pass narrow ones)."""

    def __init__(self, model_type: str = "vit_b", image_size: int = 1024, device=None,
                 image_encoder: Optional[nn.Module] = None,
                 prompt_encoder: Optional[PromptEncoder] = None,
                 mask_decoder: Optional[MaskDecoder] = None):
        super().__init__()
        self.model_type = model_type
        self.image_size = image_size
        self.device = resolve_device(device)
        with self.device:
            self.image_encoder = (build_sam_vit(model_type, dtype=torch.bfloat16)
                                  if image_encoder is None else image_encoder)
            self.prompt_encoder = (PromptEncoder() if prompt_encoder is None
                                   else prompt_encoder)
            self.mask_decoder = MaskDecoder() if mask_decoder is None else mask_decoder
        self.to(self.device)
        self.weights_set = False

    def init_random(self, seed: int = 0) -> "Sam":
        """Seeded random weights (``utils.weights.init_params``)."""
        init_params(self, seed)
        self.weights_set = True
        return self.eval()

    def load_state_dict(self, state_dict: Mapping, strict: bool = True, assign=False):
        res = super().load_state_dict(state_dict, strict=strict, assign=assign)
        self.weights_set = True
        self.eval()
        return res

    def load_jax_params(self, tree: Mapping) -> None:
        """A JAX ``Sam`` tree (``image_encoder``, ``prompt_encoder``, ``mask_decoder``)
        through the weight bridge."""
        self.load_state_dict(params_from_jax(tree))

    @classmethod
    def from_checkpoint(cls, path: str, model_type: str = "vit_b", device=None) -> "Sam":
        """From a full SAM/SAM-HQ ``.pth`` (the registry's role, build_sam.py)."""
        from tmr_tpu_torch.utils.convert import (load_torch_state_dict,
                                                 sam_refiner_state_dict,
                                                 sam_vit_state_dict)

        sd = load_torch_state_dict(path)
        sam = cls(model_type, device=device)
        state = {"image_encoder." + k: v
                 for k, v in sam_vit_state_dict(sd, "image_encoder.").items()}
        state.update(sam_refiner_state_dict(sd))
        sam.load_state_dict(state)
        return sam


#: build_sam.py:47-52's registry
sam_model_registry: Dict[str, object] = {
    "vit_b": partial(Sam, "vit_b"),
    "vit_h": partial(Sam, "vit_h"),
    "default": partial(Sam, "vit_h"),
}


class SamPredictor:
    """Encode an image once; answer point and box prompts from the cached embedding
    (predictor.py:26-269). Returns the best-IoU mask per prompt, the reference's patched
    decoder."""

    def __init__(self, sam: Sam):
        if not sam.weights_set:
            raise ValueError("Sam has no weights; call init_random() or "
                             "from_checkpoint() first")
        self.sam = sam
        self.device = sam.device
        self.reset_image()

    def reset_image(self) -> None:
        self.features: Optional[torch.Tensor] = None
        self.orig_hw: Optional[Tuple[int, int]] = None
        self.scale: float = 1.0

    @torch.inference_mode()
    def set_image(self, image: np.ndarray) -> None:
        """image (H, W, 3) uint8 RGB: longest side resized to ``image_size``, SAM
        normalization, padding, and one encoder pass -> ``features`` (1, h, w, C) f32."""
        image = np.asarray(image)
        self.orig_hw = image.shape[:2]
        self.scale = self.sam.image_size / max(self.orig_hw)
        x = sam_longest_side_preprocess(image, self.sam.image_size)
        feat = self.sam.image_encoder(torch.from_numpy(x)[None].to(self.device))
        self.features = feat.float().permute(0, 2, 3, 1).contiguous()

    @torch.inference_mode()
    def _decode(self, points: Optional[torch.Tensor], labels: Optional[torch.Tensor],
                boxes: Optional[torch.Tensor]):
        """Prompts in model space -> (mask logits (N, S, S) on the padded square, iou
        (N,))."""
        pe, s = self.sam.prompt_encoder, self.sam.image_size
        emb_hw = tuple(self.features.shape[1:3])
        parts = []
        if points is not None:
            parts.append(pe.embed_points(points, labels, (s, s)))
        if boxes is not None:
            parts.append(pe.embed_boxes(boxes, (s, s)))
        sparse = torch.cat(parts, dim=1)
        dense = pe.no_mask_dense(sparse.shape[0], emb_hw)
        masks, iou = self.sam.mask_decoder(self.features, pe.dense_pe(emb_hw), sparse,
                                           dense)
        return resize_align_corners(masks, (s, s)), iou

    def predict(self, point_coords: Optional[np.ndarray] = None,
                point_labels: Optional[np.ndarray] = None,
                box: Optional[np.ndarray] = None) -> Tuple[np.ndarray, float]:
        """Prompts in the ORIGINAL image's pixels: point_coords (K, 2), point_labels
        (K,) in {0, 1}; box (4,) xyxy. Returns (mask (H, W) bool at the original
        resolution, predicted IoU)."""
        if self.features is None:
            raise RuntimeError("call set_image() first")
        n_points = 0 if point_coords is None else len(point_coords)
        if not n_points and box is None:
            raise ValueError("give points and/or a box")

        def dev(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(self.device)

        pts = labs = bx = None
        if n_points:
            pts = dev(np.asarray(point_coords, np.float32)[None] * self.scale, np.float32)
            labs = dev(np.asarray(point_labels, np.int32)[None], np.int32)
        if box is not None:
            bx = dev(np.asarray(box, np.float32)[None] * self.scale, np.float32)
        masks, iou = self._decode(pts, labs, bx)
        return self._to_original(masks[0].cpu().numpy()), float(iou[0])

    def _to_original(self, mask_logits: np.ndarray) -> np.ndarray:
        """Padded-square logits -> the original resolution's bool mask (predictor.py's
        postprocessing: unpad, then cv2's float ``INTER_LINEAR``, in numpy)."""
        h, w = self.orig_hw
        # the half-up rounding of sam_longest_side_preprocess
        sh, sw = int(h * self.scale + 0.5), int(w * self.scale + 0.5)
        return resize_linear_f32(mask_logits[:sh, :sw], h, w) > 0


class SamAutomaticMaskGenerator:
    """Grid-prompted whole-image mask proposals (automatic_mask_generator.py:33-372):
    per crop-pyramid layer, a point grid -> batched single-point decodes -> predicted
    IoU, stability and crop-edge filters -> NMS within the crop -> uncrop -> NMS across
    crops (smaller crops preferred) -> optional small-region cleanup -> RLE or binary
    output. The mask bookkeeping is ``tmr_tpu_torch.sam_amg``."""

    def __init__(self, sam: Sam, points_per_side: Optional[int] = 32,
                 points_per_batch: int = 64, pred_iou_thresh: float = 0.88,
                 stability_score_thresh: float = 0.95, stability_score_offset: float = 1.0,
                 box_nms_thresh: float = 0.7, crop_n_layers: int = 0,
                 crop_nms_thresh: float = 0.7, crop_overlap_ratio: float = 512 / 1500,
                 crop_n_points_downscale_factor: int = 1,
                 point_grids: Optional[list] = None, min_mask_region_area: int = 0,
                 output_mode: str = "binary_mask"):
        from tmr_tpu_torch.sam_amg import build_all_layer_point_grids

        if (points_per_side is None) == (point_grids is None):
            raise ValueError("exactly one of points_per_side / point_grids must be set")
        if points_per_side is not None:
            self.point_grids = build_all_layer_point_grids(
                points_per_side, crop_n_layers, crop_n_points_downscale_factor)
        else:
            self.point_grids = point_grids
        if output_mode not in ("binary_mask", "uncompressed_rle", "coco_rle"):
            raise ValueError(f"unknown output_mode {output_mode!r}")
        if output_mode == "coco_rle":
            # fail at construction, as the reference does (automatic_mask_generator.py
            # :119-121)
            from pycocotools import mask as _  # noqa: F401

        self.predictor = SamPredictor(sam)
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode

    @torch.inference_mode()
    def _decode_points_chunk(self, points: torch.Tensor):
        """points (C, 2) px in model space -> per point: mask logits (C, 4h, 4w), iou,
        stability, area, box, nonempty."""
        pred = self.predictor
        pe, s = pred.sam.prompt_encoder, pred.sam.image_size
        emb_hw = tuple(pred.features.shape[1:3])
        labels = torch.ones(points.shape[:1] + (1,), dtype=torch.int32, device=pred.device)
        sparse = pe.embed_points(points[:, None, :], labels, (s, s))
        dense = pe.no_mask_dense(sparse.shape[0], emb_hw)
        masks, iou = pred.sam.mask_decoder(pred.features, pe.dense_pe(emb_hw), sparse,
                                           dense)
        binary = masks > 0
        area = binary.sum(dim=(1, 2))
        # stability: the IoU of the masks thresholded at +/- the offset
        off = self.stability_score_offset
        hi = (masks > off).sum(dim=(1, 2))
        lo = (masks > -off).sum(dim=(1, 2))
        stability = hi / torch.clamp(lo, min=1)
        boxes, nonempty = masks_to_boxes(binary)
        return masks, iou, stability, area, boxes, nonempty

    def _nms_keep(self, boxes: np.ndarray, scores: np.ndarray, thresh: float,
                  scale: float, valid: Optional[np.ndarray] = None) -> np.ndarray:
        from tmr_tpu_torch.ops.nms import nms_keep_mask

        dev = self.predictor.device
        keep = nms_keep_mask(
            torch.as_tensor(np.asarray(boxes / scale, np.float32), device=dev),
            torch.as_tensor(np.asarray(scores, np.float32), device=dev), thresh,
            valid=None if valid is None else torch.as_tensor(valid, device=dev))
        return keep.cpu().numpy()

    def _process_crop(self, image: np.ndarray, crop_box: list, layer_idx: int,
                      orig_size: tuple) -> dict:
        """One crop: embed -> point-grid decodes -> quality and crop-edge filters ->
        NMS within the crop -> uncrop to the image's frame
        (automatic_mask_generator.py:228-271)."""
        from tmr_tpu_torch import sam_amg

        orig_h, orig_w = orig_size
        cx0, cy0, cx1, cy1 = crop_box
        cropped = image[cy0:cy1, cx0:cx1]
        ch, cw = cropped.shape[:2]
        pred = self.predictor
        pred.set_image(cropped)
        s = pred.sam.image_size

        grid_crop = self.point_grids[layer_idx] * np.array([[cw, ch]])
        chunk = self.points_per_batch
        n_pts = len(grid_crop)
        n_pad = math.ceil(n_pts / chunk) * chunk
        grid_model = np.pad(grid_crop * pred.scale, ((0, n_pad - n_pts), (0, 0)))

        masks_crop, boxes_crop, ious, stabs, points = [], [], [], [], []
        for i in range(0, n_pad, chunk):
            pts = torch.as_tensor(np.asarray(grid_model[i:i + chunk], np.float32),
                                  device=pred.device)
            logits, iou, stab, _, _, nonempty = self._decode_points_chunk(pts)
            iou, stab = iou.cpu().numpy(), stab.cpu().numpy()
            # the reference's thresholds: iou strictly above, stability at or above
            keep = ((iou > self.pred_iou_thresh) & (stab >= self.stability_score_thresh)
                    & nonempty.cpu().numpy())
            keep[max(0, n_pts - i):] = False  # padding points
            kept = np.nonzero(keep)[0]
            if len(kept) == 0:
                continue
            # low-res logits -> the padded square, then unpad and resize
            full = resize_align_corners(
                logits[torch.as_tensor(kept, device=pred.device)], (s, s)).cpu().numpy()
            for row, j in enumerate(kept):
                mask = pred._to_original(full[row])  # (ch, cw) bool
                ys_, xs_ = np.nonzero(mask)
                if len(xs_) == 0:
                    continue
                masks_crop.append(mask)
                boxes_crop.append([xs_.min(), ys_.min(), xs_.max(), ys_.max()])
                ious.append(float(iou[j]))
                stabs.append(float(stab[j]))
                points.append(grid_crop[i + j])

        if not masks_crop:
            return {}
        boxes_crop = np.asarray(boxes_crop, np.float32)
        ious = np.asarray(ious, np.float32)
        # drop masks cut by the crop edge (amg.py:78-89) before deduping, as the
        # reference does: an edge-cut mask must never suppress a whole interior one
        keep = ~sam_amg.is_box_near_crop_edge(boxes_crop, crop_box, [0, 0, orig_w, orig_h])
        if keep.any():
            keep &= self._nms_keep(boxes_crop, ious, self.box_nms_thresh, max(ch, cw),
                                   valid=keep)
        idx = np.nonzero(keep)[0]
        if len(idx) == 0:
            return {}
        rles = [sam_amg.mask_to_rle(sam_amg.uncrop_mask(masks_crop[i], crop_box, orig_h,
                                                         orig_w))
                for i in idx]
        return {
            "rles": rles,
            "boxes": sam_amg.uncrop_boxes_xyxy(boxes_crop[idx], crop_box),
            "iou_preds": ious[idx],
            "stability": np.asarray(stabs, np.float32)[idx],
            "points": sam_amg.uncrop_points(np.asarray(points, np.float32)[idx], crop_box),
            "crop_boxes": np.tile(np.asarray(crop_box, np.float32)[None], (len(idx), 1)),
        }

    def _postprocess_small_regions(self, data: dict, min_area: int, nms_thresh: float,
                                   orig_size: tuple) -> dict:
        """Fill small holes and drop small islands, then dedupe again preferring the
        masks left untouched (automatic_mask_generator.py:283-332)."""
        from tmr_tpu_torch import sam_amg

        new_rles, new_boxes, unchanged = [], [], []
        for rle in data["rles"]:
            mask = sam_amg.rle_to_mask(rle)
            mask, ch_holes = sam_amg.remove_small_regions(mask, min_area, "holes")
            mask, ch_isl = sam_amg.remove_small_regions(mask, min_area, "islands")
            new_rles.append(sam_amg.mask_to_rle(mask))
            ys_, xs_ = np.nonzero(mask)
            new_boxes.append([0.0, 0.0, 0.0, 0.0] if len(xs_) == 0
                             else [xs_.min(), ys_.min(), xs_.max(), ys_.max()])
            unchanged.append(not (ch_holes or ch_isl))
        new_boxes = np.asarray(new_boxes, np.float32)
        keep = self._nms_keep(new_boxes, np.asarray(unchanged, np.float32), nms_thresh,
                              max(orig_size))
        data = dict(data, rles=new_rles, boxes=new_boxes)
        return sam_amg.filter_records(data, keep)

    def generate(self, image: np.ndarray) -> list:
        """image (H, W, 3) uint8 -> a list of {segmentation, area, bbox (XYWH px),
        predicted_iou, stability_score, point_coords, crop_box} dicts, deduped by NMS,
        sorted by predicted IoU (automatic_mask_generator.py:122-226)."""
        from tmr_tpu_torch import sam_amg

        orig_h, orig_w = image.shape[:2]
        crop_boxes, layer_idxs = sam_amg.generate_crop_boxes(
            (orig_h, orig_w), self.crop_n_layers, self.crop_overlap_ratio)
        data = sam_amg.cat_records(*[
            self._process_crop(image, cb, li, (orig_h, orig_w))
            for cb, li in zip(crop_boxes, layer_idxs)])
        if not data or len(data["rles"]) == 0:
            return []
        if len(crop_boxes) > 1:
            # dedupe across crops, preferring masks from smaller crops
            cbx = data["crop_boxes"]
            areas = (cbx[:, 2] - cbx[:, 0]) * (cbx[:, 3] - cbx[:, 1])
            keep = self._nms_keep(data["boxes"], 1.0 / np.maximum(areas, 1.0),
                                  self.crop_nms_thresh, max(orig_h, orig_w))
            data = sam_amg.filter_records(data, keep)
        if self.min_mask_region_area > 0:
            data = self._postprocess_small_regions(
                data, self.min_mask_region_area,
                max(self.box_nms_thresh, self.crop_nms_thresh), (orig_h, orig_w))

        out = []
        for i, rle in enumerate(data["rles"]):
            if self.output_mode == "coco_rle":
                seg = sam_amg.coco_encode_rle(rle)
            elif self.output_mode == "binary_mask":
                seg = sam_amg.rle_to_mask(rle)
            else:
                seg = rle
            area = sam_amg.area_from_rle(rle)
            if area == 0:
                continue
            out.append({
                "segmentation": seg,
                "area": area,
                # XYWH with w = x_max - x_min (the reference's batched_mask_to_box and
                # box_xyxy_to_xywh)
                "bbox": sam_amg.box_xyxy_to_xywh(data["boxes"][i]).tolist(),
                "predicted_iou": float(data["iou_preds"][i]),
                "stability_score": float(data["stability"][i]),
                "point_coords": [np.asarray(data["points"][i]).tolist()],
                "crop_box": sam_amg.box_xyxy_to_xywh(
                    np.asarray(data["crop_boxes"][i])).tolist(),
            })
        out.sort(key=lambda d: -d["predicted_iou"])
        return out


class SamDeployDecoder:
    """The deployable prompt -> mask function (utils/segment_anything/utils/onnx.py
    ``SamOnnxModel``): prompt encoding, mask decoding and the mask postprocessing in one
    call on cached image embeddings, with the exporter's input surface. Its call only:
    the JAX package's StableHLO export (``utils/export.export_sam_decoder``) waits for
    the port's ``torch.export`` work."""

    def __init__(self, sam: Sam, return_single_mask: bool,
                 use_stability_score: bool = False, return_extra_metrics: bool = False,
                 stability_score_offset: float = 1.0, mask_threshold: float = 0.0):
        self.sam = sam
        self.return_single_mask = return_single_mask
        self.use_stability_score = use_stability_score
        self.return_extra_metrics = return_extra_metrics
        self.stability_score_offset = stability_score_offset
        self.mask_threshold = mask_threshold

    @staticmethod
    def resize_longest_image_size(orig_hw, longest_side: int):
        """floor(scale * size + 0.5) (onnx.py:41-48)."""
        h, w = orig_hw
        scale = longest_side / max(h, w)
        return (int(scale * h + 0.5), int(scale * w + 0.5))

    def _select_masks(self, masks, iou_preds, num_points: int):
        """Single- vs multi-click token choice without control flow (onnx.py:95-108):
        with <= 2 point slots token 0 loses 500, with more it gains 500."""
        t = masks.shape[1]
        reweight = const_f32(iou_preds, [1000.0] + [0.0] * (t - 1))
        score = iou_preds + (num_points - 2.5) * reweight[None]
        best = torch.argmax(score, dim=1)
        rows = torch.arange(masks.shape[0], device=masks.device)
        return masks[rows, best][:, None], iou_preds[rows, best][:, None]

    def _stability(self, masks):
        off = self.stability_score_offset
        hi = (masks > self.mask_threshold + off).sum((-1, -2))
        lo = (masks > self.mask_threshold - off).sum((-1, -2))
        return hi / torch.clamp(lo, min=1)

    @torch.inference_mode()
    def __call__(self, image_embeddings: torch.Tensor, point_coords: torch.Tensor,
                 point_labels: torch.Tensor, mask_input: torch.Tensor,
                 has_mask_input, orig_im_size):
        """image_embeddings (1, h, w, C); point_coords (N, P, 2) px in model space;
        point_labels (N, P) in {-1, 0, 1}; mask_input (N, 4h, 4w, 1); has_mask_input (N,)
        or a scalar in {0, 1}; orig_im_size (H, W). SamOnnxModel.forward
        (onnx.py:110-144)."""
        sam = self.sam
        s = sam.image_size
        pe = sam.prompt_encoder
        emb_hw = tuple(image_embeddings.shape[1:3])
        sparse = pe.embed_points(point_coords, point_labels, (s, s))
        n = point_coords.shape[0]
        masked = pe.embed_masks(mask_input)
        unmasked = pe.no_mask_dense(n, emb_hw)
        has = torch.as_tensor(has_mask_input, dtype=torch.float32,
                              device=masked.device).expand(n).reshape(n, 1, 1, 1)
        dense = has * masked + (1.0 - has) * unmasked
        masks, scores = sam.mask_decoder(image_embeddings.float(), pe.dense_pe(emb_hw),
                                         sparse, dense, return_all_masks=True)
        if self.use_stability_score:
            scores = self._stability(masks)
        if self.return_single_mask:
            masks, scores = self._select_masks(masks, scores, point_coords.shape[1])
        # 4h grid -> the model's square -> unpad -> the original size (onnx.py:77-93,
        # align_corners=False at both resizes)
        up = F.interpolate(masks, size=(s, s), mode="bilinear", align_corners=False)
        ph, pw = self.resize_longest_image_size(orig_im_size, s)
        out = F.interpolate(up[..., :ph, :pw], size=tuple(orig_im_size), mode="bilinear",
                            align_corners=False)
        if self.return_extra_metrics:
            stab = self._stability(out)
            areas = (out > self.mask_threshold).sum((-1, -2))
            return out, scores, stab, areas, masks
        return out, scores, masks
