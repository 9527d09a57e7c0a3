"""Greedy NMS keep masks (counterpart of ``tmr_tpu/ops/nms.py``).

Keep a box iff no higher-scored kept box overlaps it above the IoU threshold. Boxes
are sorted by descending score (invalid entries sink with ``-inf``; ties keep the
lower index first, a stable sort like ``jnp.argsort``), the greedy sweep runs in
``ops/cuda_nms.py`` (kernel on the card, plain version on the CPU), and the mask is
scattered back to the original order.
"""

from __future__ import annotations

from typing import Optional

import torch

from tmr_tpu_torch.ops.cuda_nms import greedy_keep_sorted


def batched_keep_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """boxes (B, N, 4), scores (B, N), valid (B, N) bool -> keep (B, N) bool in the
    original order."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    sort_scores = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.sort(sort_scores, dim=1, descending=True, stable=True).indices
    b = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)).float()
    v = torch.gather(valid, 1, order)
    keep_sorted = greedy_keep_sorted(b, v, iou_threshold)
    return torch.zeros_like(valid).scatter(1, order, keep_sorted)


def nms_keep_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One image: boxes (N, 4), scores (N,), valid (N,) -> keep (N,) bool."""
    return batched_keep_mask(boxes[None], scores[None], iou_threshold,
                             None if valid is None else valid[None])[0]
