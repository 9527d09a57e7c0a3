"""SAM box refinement (counterpart of ``tmr_tpu/refine.py``; reference
utils/box_refine.py).

The reference refiner takes the detector's boxes, decodes them in chunks of 50 as box
prompts with a SAM mask decoder over the frozen encoder's features, turns each mask into
its tight box, and rescores each detection as ``iou_pred * score`` (box_refine.py:22-258,
"type 2" scoring at :253). As in the JAX package, the prompt encoder and mask decoder
are built once and take the image and grid sizes as call arguments, masks are upsampled
to the full image with the reference's ``align_corners=True`` bilinear before the
threshold at 0, and the mask -> box step is a reduction, not a loop over pixels.

Detections arrive as fixed slots (boxes (B, N, 4) normalized xyxy, scores, refs,
valid). The JAX program decodes every slot, padding included (``lax.map`` over static
chunks); an invalid slot's output is its input, so the port decodes only the valid
slots: they are gathered per image, decoded ``chunk`` at a time, and scattered back.
Valid slots take ``iou * score`` and, when their mask is not empty, the mask's box;
invalid slots keep box and score bit for bit; ``refs`` become the box centres.

Everything is f32 and plain PyTorch (matmuls, softmax, einsums): the JAX package runs
none of it in a Pallas kernel, and the port launches none of its own kernels here.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from tmr_tpu_torch.models import resolve_device
from tmr_tpu_torch.models.sam_decoder import (MaskDecoder, PromptEncoder, const_f32,
                                              masks_to_boxes, resize_align_corners)
from tmr_tpu_torch.utils.weights import init_params


def _res(ref: torch.Tensor, image_size: Tuple[int, int]) -> torch.Tensor:
    """(w, h, w, h) f32 on ``ref``'s device: normalized <-> pixel boxes."""
    h, w = image_size
    return const_f32(ref, [w, h, w, h])


def _centres(boxes: torch.Tensor) -> torch.Tensor:
    return torch.stack([(boxes[..., 0] + boxes[..., 2]) / 2,
                        (boxes[..., 1] + boxes[..., 3]) / 2], dim=-1)


class SamRefineModule(nn.Module):
    """The prompt encoder and mask decoder of the refiner, built once, with their
    weights; ``chunk`` prompts per decode (the reference's step of 50,
    box_refine.py:26)."""

    def __init__(self, chunk: int = 50, prompt_encoder: Optional[PromptEncoder] = None,
                 mask_decoder: Optional[MaskDecoder] = None):
        super().__init__()
        self.prompt_encoder = PromptEncoder() if prompt_encoder is None else prompt_encoder
        self.mask_decoder = MaskDecoder() if mask_decoder is None else mask_decoder
        self.chunk = chunk

    def init_params(self, seed: int = 0) -> None:
        """Seeded random weights (``utils.weights.init_params``)."""
        init_params(self, seed)

    def _features(self, features: torch.Tensor) -> torch.Tensor:
        """The encoder's output (B, h, w, C) as the decoder takes it, f32; a width other
        than the decoder's raises (the JAX program fails to broadcast it: every ResNet
        variant but resnet50_layer1 hands over 512 to 2048 channels)."""
        width = self.mask_decoder.transformer_dim
        if features.shape[-1] != width:
            raise ValueError(
                f"refine_box: the SAM mask decoder takes {width}-channel features; the "
                f"backbone gives {features.shape[-1]} (of the ResNet variants only "
                "resnet50_layer1 has 256)")
        return features.float().contiguous()

    def _decode(self, feature: torch.Tensor, image_pe: torch.Tensor,
                boxes_px: torch.Tensor, image_size: Tuple[int, int]) -> tuple:
        """One chunk of box prompts on one image's feature (1, h, w, C) -> (mask logits
        (C, 4h, 4w), iou (C,))."""
        sparse, dense = self.prompt_encoder(boxes_px, image_size, feature.shape[1:3])
        return self.mask_decoder(feature, image_pe, sparse, dense)

    def _decode_chunk(self, feature, image_pe, boxes_px, image_size, mask_size):
        """One chunk -> (mask boxes in pixels (C, 4), iou (C,), nonempty (C,)): logits
        resized to ``mask_size`` (align corners), thresholded at 0, boxed, scaled to
        the image."""
        masks, iou = self._decode(feature, image_pe, boxes_px, image_size)
        masks = resize_align_corners(masks, mask_size) > 0
        boxes, nonempty = masks_to_boxes(masks)
        sy = image_size[0] / mask_size[0]
        sx = image_size[1] / mask_size[1]
        return boxes * const_f32(boxes, [sx, sy, sx, sy]), iou, nonempty

    def _decode_slots(self, feature, boxes_px, image_size, mask_size):
        """Every row of ``boxes_px`` (M, 4), ``chunk`` at a time, on one image."""
        image_pe = self.prompt_encoder.dense_pe(feature.shape[1:3])
        parts = [self._decode_chunk(feature, image_pe, boxes_px[s:s + self.chunk],
                                    image_size, mask_size)
                 for s in range(0, boxes_px.shape[0], self.chunk)]
        return tuple(torch.cat(p) for p in zip(*parts))

    @torch.inference_mode()
    def refine(self, features: torch.Tensor, dets: dict, image_size: Tuple[int, int],
               mask_size: Optional[Tuple[int, int]] = None) -> dict:
        """features (B, h, w, C) NHWC, the frozen encoder's output; dets: boxes
        (B, N, 4) normalized xyxy, scores (B, N), valid (B, N). Returns the same keys:
        valid slots scored ``iou * score`` and boxed by their mask (an empty mask keeps
        the box); invalid slots unchanged; refs the box centres. ``mask_size`` defaults
        to the image size, as the reference upsamples to the full image."""
        mask_size = tuple(image_size) if mask_size is None else tuple(mask_size)
        features = self._features(features)
        boxes, scores, valid = dets["boxes"], dets["scores"], dets["valid"]
        res = _res(boxes, image_size)
        out_boxes, out_scores = boxes.clone(), scores.clone()
        for i in range(boxes.shape[0]):
            idx = torch.nonzero(valid[i])[:, 0]
            if idx.numel() == 0:
                continue
            old = boxes[i].index_select(0, idx)
            new, iou, nonempty = self._decode_slots(features[i:i + 1], old * res,
                                                    image_size, mask_size)
            out_boxes[i, idx] = torch.where(nonempty[:, None], new / res, old)
            out_scores[i, idx] = iou * scores[i].index_select(0, idx)
        out = dict(dets)
        out.update(boxes=out_boxes, scores=out_scores, refs=_centres(out_boxes))
        return out

    @torch.inference_mode()
    def refine_with_exemplar_scaling(self, features: torch.Tensor, dets: dict,
                                     exemplars: torch.Tensor, image_size: Tuple[int, int],
                                     mask_size: Optional[Tuple[int, int]] = None) -> dict:
        """The ``forward_refine`` variant (box_refine.py:64-188): a per-image ltrb scale
        (the exemplar box over its own SAM mask's box, exemplars (B, 4) normalized)
        applied to every refined valid box about its centre; refs stay those of
        :meth:`refine`."""
        mask_size = tuple(image_size) if mask_size is None else tuple(mask_size)
        features = self._features(features)
        exemplars = exemplars.float()
        res = _res(exemplars, image_size)
        scalers = []
        for i in range(features.shape[0]):
            ex = exemplars[i]
            mb, _, nonempty = self._decode_slots(features[i:i + 1], (ex * res)[None],
                                                 image_size, mask_size)
            mb = mb[0] / res
            cx, cy = (mb[0] + mb[2]) / 2, (mb[1] + mb[3]) / 2
            ltrb = torch.stack([cx - mb[0], cy - mb[1], mb[2] - cx, mb[3] - cy])
            ex_ltrb = torch.stack([cx - ex[0], cy - ex[1], ex[2] - cx, ex[3] - cy])
            scaler = ex_ltrb / torch.clamp(ltrb, min=1e-8)
            scalers.append(torch.where(nonempty[0], scaler, torch.ones_like(scaler)))
        scalers = torch.stack(scalers)  # (B, 4)
        refined = self.refine(features, dets, image_size, mask_size)
        boxes = refined["boxes"]
        cx = (boxes[..., 0] + boxes[..., 2]) / 2
        cy = (boxes[..., 1] + boxes[..., 3]) / 2
        ltrb = torch.stack([cx - boxes[..., 0], cy - boxes[..., 1],
                            boxes[..., 2] - cx, boxes[..., 3] - cy], dim=-1)
        ltrb = ltrb * scalers[:, None, :]
        scaled = torch.stack([cx - ltrb[..., 0], cy - ltrb[..., 1],
                              cx + ltrb[..., 2], cy + ltrb[..., 3]], dim=-1)
        refined["boxes"] = torch.where(refined["valid"][..., None], scaled, boxes)
        return refined

    @torch.inference_mode()
    def decode_masks(self, features: torch.Tensor, boxes: torch.Tensor,
                     image_size: Tuple[int, int],
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Union mask per image (B, H, W) bool of the valid slots' masks at full image
        size (the ``save_masks`` path, box_refine.py:260-307, without the file)."""
        features = self._features(features)
        b = boxes.shape[0]
        union = torch.zeros((b,) + tuple(image_size), dtype=torch.bool,
                            device=boxes.device)
        if valid is None:
            valid = torch.ones(boxes.shape[:2], dtype=torch.bool, device=boxes.device)
        res = _res(boxes, image_size)
        for i in range(b):
            idx = torch.nonzero(valid[i])[:, 0]
            if idx.numel() == 0:
                continue
            feature = features[i:i + 1]
            image_pe = self.prompt_encoder.dense_pe(feature.shape[1:3])
            px = boxes[i].index_select(0, idx).float() * res
            for s in range(0, px.shape[0], self.chunk):
                masks, _ = self._decode(feature, image_pe, px[s:s + self.chunk],
                                        image_size)
                union[i] |= (resize_align_corners(masks, image_size) > 0).any(dim=0)
        return union

    def save_masks(self, features: torch.Tensor, dets: dict, image_size: Tuple[int, int],
                   log_path: str, img_names) -> list:
        """Per-image union masks to ``{log_path}/masks/{name}.png``, 255 where some
        detection's mask covers the pixel (box_refine.py:260-307); 8-bit grayscale PNGs
        written with PIL (the JAX package writes them with cv2)."""
        from PIL import Image

        out_dir = os.path.join(log_path, "masks")
        os.makedirs(out_dir, exist_ok=True)
        masks = self.decode_masks(features, dets["boxes"], image_size,
                                  valid=dets.get("valid")).cpu().numpy()
        written = []
        for mask, name in zip(masks, img_names):
            path = os.path.join(out_dir, f"{name}.png")
            Image.fromarray((mask * 255).astype(np.uint8), mode="L").save(path)
            written.append(path)
        return written


def build_refiner(cfg, seed: int = 0, device=None) -> SamRefineModule:
    """The refiner of ``--refine_box`` runs, built once, on ``device``
    (``models.resolve_device``: the GPU unless ``"cpu"`` is asked for), in eval mode.
    With ``cfg.refiner_checkpoint`` its weights come from the SAM ``.pth``
    (``utils.convert.sam_refiner_state_dict``); without one (the reference downloads
    them, box_refine.py:41-60, which an offline machine cannot) they are seeded
    random weights, with a loud warning: the pipeline runs either way."""
    from tmr_tpu_torch.utils.convert import load_torch_state_dict, sam_refiner_state_dict

    device = resolve_device(device)
    with device:
        refiner = SamRefineModule()
    ckpt = getattr(cfg, "refiner_checkpoint", None)
    if ckpt:
        refiner.load_state_dict(sam_refiner_state_dict(load_torch_state_dict(ckpt)))
    else:
        from tmr_tpu_torch.utils.profiling import log_warning

        log_warning("refine_box: no refiner_checkpoint configured; using random-init "
                    "SAM decoder weights (boxes will be refined by an untrained mask "
                    "decoder)")
        refiner.init_params(seed)
    return refiner.eval()

