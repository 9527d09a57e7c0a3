"""Target assignment, forward only (counterpart of ``tmr_tpu/train/targets.py``;
reference utils/TM_utils.py GT_map, :20-222).

The whole assignment is one masked computation over a (B, locations, boxes) grid, with
the JAX package's semantics and dtypes (f32 geometry, so comparisons near a threshold
fall the same way): location grid at corner coordinates; nearest-centre one-hot per box
by L1 distance, first minimum winning; diamond in/out tests with ratio -h/w and
threshold-derived biases (the threshold == 1.0 overrides); the exemplar-sized boundary
exclusion with an odd-ified span; ``is_center`` folded into positives on the last level
only; boundary-excluded positives demoted to negatives; the smallest-area box wins a
contested location; ignore = (some box does not claim positive) & (some box does not
claim negative) & in bounds, negatives the complement.
"""

from __future__ import annotations

import torch


def location_centers(h: int, w: int, device=None) -> torch.Tensor:
    """(L, 2) [x, y] normalized corner coordinates, row-major."""
    xs = torch.arange(w, dtype=torch.float32, device=device) / w
    ys = torch.arange(h, dtype=torch.float32, device=device) / h
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=1)


def boundary_mask(exemplars: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """exemplars (B, 4) -> (B, L) bool interior mask (Get_not_in_boundary,
    TM_utils.py:36-54)."""
    ex = exemplars.float().clamp(0.0, 1.0)
    xi1 = torch.floor(ex[:, 0] * w).to(torch.int32)
    xi2 = torch.ceil(ex[:, 2] * w).to(torch.int32)
    yi1 = torch.floor(ex[:, 1] * h).to(torch.int32)
    yi2 = torch.ceil(ex[:, 3] * h).to(torch.int32)
    xi2 = xi2 - ((xi2 - xi1) % 2 == 0).to(torch.int32)
    yi2 = yi2 - ((yi2 - yi1) % 2 == 0).to(torch.int32)
    pad_x = torch.div(xi2 - xi1, 2, rounding_mode="floor")[:, None]
    pad_y = torch.div(yi2 - yi1, 2, rounding_mode="floor")[:, None]
    ys = torch.arange(h, device=exemplars.device)[None, :]
    xs = torch.arange(w, device=exemplars.device)[None, :]
    row = (ys >= pad_y) & (ys < h - pad_y)
    col = (xs >= pad_x) & (xs < w - pad_x)
    return (row[:, :, None] & col[:, None, :]).reshape(exemplars.shape[0], -1)


def assign_targets(gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                   exemplars: torch.Tensor, h: int, w: int, positive_threshold: float,
                   negative_threshold: float, is_last_level: bool = True) -> dict:
    """gt_boxes (B, M, 4) normalized xyxy (padded), gt_valid (B, M) bool, exemplars
    (B, 4) -> positive / negative (B, h, w) bool and box_target (B, h, w, 4) cxcywh."""
    b, m = gt_valid.shape
    gt = gt_boxes.float()
    centers = location_centers(h, w, gt.device)
    cxs, cys = centers[None, :, 0, None], centers[None, :, 1, None]  # (1, L, 1)
    x1, y1, x2, y2 = gt.unbind(-1)  # (B, M)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    bw, bh = x2 - x1, y2 - y1
    rel_x = (cxs - cx[:, None, :]).abs()  # (B, L, M)
    rel_y = (cys - cy[:, None, :]).abs()

    center_idx = torch.argmin(rel_x + rel_y, dim=1)  # (B, M), the first minimum
    is_center = torch.zeros_like(rel_x, dtype=torch.bool).scatter_(
        1, center_idx[:, None, :], True)

    ratio = (-bh / bw)[:, None, :]
    bias_p = (((1 - positive_threshold) / (1 + positive_threshold)) * bh)[:, None, :]
    bias_n = (((1 - negative_threshold) / (1 + negative_threshold)) * bh)[:, None, :]
    is_in_positive = ratio * rel_x + bias_p >= rel_y
    is_in_negative = ratio * rel_x + bias_n < rel_y
    if positive_threshold == 1.0:
        is_in_positive = is_center
    if negative_threshold == 1.0:
        is_in_negative = ~is_center

    in_bounds = boundary_mask(exemplars, h, w)[:, :, None]  # (B, L, 1)
    pos_cand = (is_center | is_in_positive) if is_last_level else is_in_positive
    is_in_negative = is_in_negative | (pos_cand & ~in_bounds)
    pos_cand = pos_cand & in_bounds

    valid = gt_valid[:, None, :]
    area = (bw * bh)[:, None, :]
    area_grid = torch.where(pos_cand & valid, area, torch.full_like(area, 1e8))
    box_id = torch.argmin(area_grid, dim=2)  # (B, L)
    cxcywh = torch.stack([cx, cy, bw, bh], dim=-1)  # (B, M, 4)
    box_target = torch.gather(cxcywh, 1, box_id[..., None].expand(-1, -1, 4))

    positive = (pos_cand & valid).any(dim=2)
    ignore = ((~pos_cand & valid).any(dim=2) & (~is_in_negative & valid).any(dim=2)
              & in_bounds[..., 0])
    negative = ~(positive | ignore)
    return {"positive": positive.reshape(b, h, w), "negative": negative.reshape(b, h, w),
            "box_target": box_target.reshape(b, h, w, 4)}
