"""Fixed-capacity detection decoding and NMS (counterpart of ``tmr_tpu/ops/postprocess.py``).

Every image carries a static candidate capacity K: peak scores are ranked into K
slots with a validity mask, decoded, and NMS'd per image. The (scores, boxes, refs,
valid) tuple is the fixed-shape form of the reference's ragged detection lists, in
the same slot order as the JAX package.
"""

from __future__ import annotations

import torch

from tmr_tpu_torch.ops.boxes import decode_regression, grid_centers
from tmr_tpu_torch.ops.nms import batched_keep_mask
from tmr_tpu_torch.ops.peaks import (
    adaptive_kernel,
    masked_maxpool3x3,
    topk_peak_candidates,
)


def decode_detections(
    objectness: torch.Tensor,  # (B, H, W) logits
    regressions,  # (B, H, W, 4) or None
    exemplars: torch.Tensor,  # (B, 4) normalized xyxy (first exemplar)
    cls_threshold: float,
    max_detections: int = 1100,
    box_reg: bool = True,
    scale_imgsize: bool = False,
    scale_wh_only: bool = False,
) -> dict:
    """Peak-pick + decode into K fixed slots per image: boxes (B, K, 4) xyxy, scores
    (B, K), refs (B, K, 2) [cx, cy], valid (B, K); score-descending."""
    ex = exemplars.clamp(0.0, 1.0)
    ex_w = ex[:, 2] - ex[:, 0]
    ex_h = ex[:, 3] - ex[:, 1]
    b, h, w = objectness.shape
    pred = torch.sigmoid(objectness.float())
    peak = masked_maxpool3x3(pred, adaptive_kernel(ex_h, ex_w, h, w)) == pred
    reg = regressions
    if reg is None or not box_reg:
        reg = torch.zeros(objectness.shape + (4,), dtype=torch.float32,
                          device=objectness.device)
    xywh = decode_regression(reg.float(), exemplars, scale_imgsize, scale_wh_only)
    boxes = torch.cat([xywh[..., :2] - xywh[..., 2:] / 2,
                       xywh[..., :2] + xywh[..., 2:] / 2], dim=-1)
    refs = grid_centers(h, w, objectness.device).expand(b, h, w, 2)

    scores = pred.reshape(b, -1)
    k = min(max_detections, scores.shape[1])
    out_scores, top_idx, valid = topk_peak_candidates(
        scores, peak.reshape(b, -1), cls_threshold, k)
    return {
        "boxes": torch.gather(boxes.reshape(b, -1, 4), 1,
                              top_idx[..., None].expand(-1, -1, 4)),
        "scores": out_scores,
        "refs": torch.gather(refs.reshape(b, -1, 2), 1,
                             top_idx[..., None].expand(-1, -1, 2)),
        "valid": valid,
    }


def batched_nms(dets: dict, iou_threshold: float) -> dict:
    """Greedy NMS per image over the fixed slots: ``valid`` loses the suppressed
    slots and their scores become 0."""
    keep = batched_keep_mask(dets["boxes"], dets["scores"], iou_threshold,
                             dets["valid"])
    out = dict(dets)
    out["valid"] = dets["valid"] & keep
    out["scores"] = torch.where(out["valid"], dets["scores"],
                                torch.zeros_like(dets["scores"]))
    return out


def compact_detections(dets: dict) -> dict:
    """Stable valid-first compaction to the leading slots plus a ``count`` (B,)
    vector; dead slots are zeroed. The per-image lists equal the uncompacted ones."""
    valid = dets["valid"]
    k = valid.shape[1]
    idx = torch.arange(k, device=valid.device)[None, :]
    order = torch.sort(torch.where(valid, idx, k + idx), dim=1, stable=True).indices
    count = valid.sum(dim=1).to(torch.int32)
    prefix = idx < count[:, None]
    out = dict(dets)
    for name in ("boxes", "scores", "refs"):
        a = dets[name]
        gathered = torch.gather(
            a, 1, order.view(order.shape + (1,) * (a.dim() - 2)).expand_as(a))
        mask = prefix.view(prefix.shape + (1,) * (a.dim() - 2))
        out[name] = torch.where(mask, gathered, torch.zeros_like(gathered))
    out["valid"] = prefix
    out["count"] = count
    return out
