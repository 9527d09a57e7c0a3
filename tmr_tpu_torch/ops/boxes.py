"""Box codecs and the gIoU loss (counterpart of ``tmr_tpu/ops/boxes.py``: the parts the
inference and eval paths use; the NMS IoU lives with the NMS kernel in
``ops/cuda_nms.py``)."""

from __future__ import annotations

import torch


def grid_centers(h: int, w: int, device=None) -> torch.Tensor:
    """(h, w, 2) [x, y] normalized cell origins, the JAX ``meshgrid(xs, ys)``."""
    xs = torch.arange(w, dtype=torch.float32, device=device) / w
    ys = torch.arange(h, dtype=torch.float32, device=device) / h
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def decode_regression(
    regressions: torch.Tensor,  # (B, H, W, 4)
    exemplars: torch.Tensor,  # (B, 4) normalized xyxy
    scale_imgsize: bool = False,
    scale_wh_only: bool = False,
) -> torch.Tensor:
    """Exemplar-relative decode -> (B, H, W, 4) normalized cxcywh."""
    _, h, w, _ = regressions.shape
    ex = exemplars.clamp(0.0, 1.0)
    ew = ex[:, 2] - ex[:, 0]
    eh = ex[:, 3] - ex[:, 1]
    if scale_imgsize:
        ew = torch.ones_like(ew)
        eh = torch.ones_like(eh)
    exy = torch.stack([ew, eh], dim=-1)[:, None, None, :]
    centers = grid_centers(h, w, regressions.device)[None]
    xy_scale = torch.ones_like(exy) if scale_wh_only else exy
    pred_xy = centers + regressions[..., :2] * xy_scale
    pred_wh = torch.exp(regressions[..., 2:]) * exy
    return torch.cat([pred_xy, pred_wh], dim=-1)


def cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) [cx, cy, w, h] -> [x1, y1, x2, y2]."""
    cxy, wh = boxes[..., :2], boxes[..., 2:]
    return torch.cat([cxy - wh / 2.0, cxy + wh / 2.0], dim=-1)


def generalized_box_iou_loss(pred: torch.Tensor, target: torch.Tensor,
                             eps: float = 1e-13) -> torch.Tensor:
    """Elementwise gIoU loss between aligned (..., 4) xyxy boxes, the semantics of
    ``torchvision.ops.generalized_box_iou_loss`` that the reference's loss calls with
    eps 1e-13 (criterions_TM.py:7-13): 1 - iou + (area_c - union) / (area_c + eps), iou
    = inter / (union + eps)."""
    x1, y1, x2, y2 = pred.unbind(-1)
    x1g, y1g, x2g, y2g = target.unbind(-1)
    xkis1, ykis1 = torch.maximum(x1, x1g), torch.maximum(y1, y1g)
    xkis2, ykis2 = torch.minimum(x2, x2g), torch.minimum(y2, y2g)
    intsct = torch.where((ykis2 > ykis1) & (xkis2 > xkis1),
                         (xkis2 - xkis1) * (ykis2 - ykis1), torch.zeros_like(x1))
    union = (x2 - x1) * (y2 - y1) + (x2g - x1g) * (y2g - y1g) - intsct
    iou = intsct / (union + eps)
    area_c = ((torch.maximum(x2, x2g) - torch.minimum(x1, x1g))
              * (torch.maximum(y2, y2g) - torch.minimum(y1, y1g)))
    return 1.0 - (iou - (area_c - union) / (area_c + eps))
