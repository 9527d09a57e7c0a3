"""The loss, forward only (counterpart of ``tmr_tpu/train/criterion.py``; reference
criterion/criterions_TM.py:7-58).

Masked reductions over the full maps with the reference's normalization: BCE (or focal)
summed over positive and negative locations and gIoU over positive ones, each divided
by the batch's positive count, plus one per image without positives; such an image
adds the degenerate dummy's gIoU loss of exactly 1.0; levels averaged.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tmr_tpu_torch.ops.boxes import (cxcywh_to_xyxy, decode_regression,
                                     generalized_box_iou_loss)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy on logits (the stable form)."""
    return (torch.clamp_min(logits, 0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def focal_loss_elementwise(logits: torch.Tensor, targets: torch.Tensor,
                           alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """WeightedFocalLoss (criterions_TM.py:15-29): at * (1 - pt)^g * BCE, at = alpha for
    target 1 and 1 - alpha for target 0."""
    bce = bce_with_logits(logits, targets)
    at = torch.where(targets > 0.5, torch.full_like(targets, alpha),
                     torch.full_like(targets, 1.0 - alpha))
    pt = torch.exp(-bce)
    return at * (1.0 - pt) ** gamma * bce


def criterion(objectness: Sequence[torch.Tensor], regressions: Sequence,
              targets: Sequence[dict], exemplars: torch.Tensor,
              use_focal_loss: bool = False, scale_imgsize: bool = False,
              scale_wh_only: bool = False) -> dict:
    """Per level: objectness (B, H, W) logits, regressions (B, H, W, 4) or None,
    :func:`assign_targets` output; exemplars (B, 4). Returns loss_ce, loss_giou, loss
    as 0-d f32 tensors."""
    elem = focal_loss_elementwise if use_focal_loss else bce_with_logits
    ce_losses, giou_losses = [], []
    for obj, reg, tgt in zip(objectness, regressions, targets):
        obj = obj.float()
        pos = tgt["positive"].float()
        neg = tgt["negative"].float()
        ce_sum = (elem(obj, torch.ones_like(obj)) * pos
                  + elem(obj, torch.zeros_like(obj)) * neg).sum()
        if reg is None:  # ablation_no_box_regression: zero deltas, exemplar-size boxes
            reg = torch.zeros(obj.shape + (4,), dtype=torch.float32, device=obj.device)
        pred_xywh = decode_regression(reg.float(), exemplars, scale_imgsize,
                                      scale_wh_only)
        giou_map = generalized_box_iou_loss(cxcywh_to_xyxy(pred_xywh),
                                            cxcywh_to_xyxy(tgt["box_target"]))
        pos_per_img = pos.sum(dim=(1, 2))
        empty = (pos_per_img == 0).float().sum()
        num_positive = pos_per_img.sum() + empty
        ce_losses.append(ce_sum / num_positive)
        giou_losses.append(((giou_map * pos).sum() + empty) / num_positive)
    loss_ce = torch.stack(ce_losses).mean()
    loss_giou = torch.stack(giou_losses).mean()
    return {"loss_ce": loss_ce, "loss_giou": loss_giou, "loss": loss_ce + loss_giou}
