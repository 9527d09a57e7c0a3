"""Adaptive-kernel local-max peaks (counterpart of ``tmr_tpu/ops/peaks.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def adaptive_kernel(ex_h: torch.Tensor, ex_w: torch.Tensor, pred_h: int,
                    pred_w: int) -> torch.Tensor:
    """(B,) normalized exemplar extents -> (B, 3, 3) suppression masks."""
    nh = 1.0 / pred_h
    nw = 1.0 / pred_w
    c_full = (ex_h >= 3 * nh) & (ex_w >= 3 * nw)
    c_point = (ex_h < 2 * nh) & (ex_w < 2 * nw)
    c_col = (ex_h < 2 * nh) & (ex_w >= 2 * nw)
    c_row = (ex_h >= 2 * nh) & (ex_w < 2 * nw)
    idx = torch.full_like(ex_h, 4, dtype=torch.long)
    # first matching condition wins, like jnp.select
    for i, cond in reversed(list(enumerate((c_full, c_point, c_col, c_row)))):
        idx = torch.where(cond, torch.full_like(idx, i), idx)
    return _kernels(ex_h.device)[idx]


def _kernels(device) -> torch.Tensor:
    """(5, 3, 3) masks [full, point, column, row, cross], made on ``device`` (a host
    table would be a copy that waits for the device)."""
    yy = torch.arange(3, device=device)[:, None]
    xx = torch.arange(3, device=device)[None, :]
    col, row = (xx == 1).expand(3, 3), (yy == 1).expand(3, 3)
    return torch.stack([torch.ones_like(col), col & row, col, row, col | row]).float()


def masked_maxpool3x3(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """3x3 max over the positions where ``mask`` is 1, zero padding.

    x: (B, H, W); mask: (B, 3, 3)."""
    h, w = x.shape[-2], x.shape[-1]
    p = F.pad(x, (1, 1, 1, 1), value=0.0)
    out = torch.full_like(x, float("-inf"))
    neg = torch.full_like(x, float("-inf"))
    for dy in range(3):
        for dx in range(3):
            use = (mask[:, dy, dx] > 0)[:, None, None]
            out = torch.maximum(out, torch.where(use, p[..., dy:dy + h, dx:dx + w], neg))
    return out


def topk_peak_candidates(scores: torch.Tensor, peak_mask: torch.Tensor,
                         cls_threshold: float, k: int):
    """The k best above-threshold peaks per image, score-descending, ties toward the
    lower flat index (a stable sort, like ``jax.lax.top_k``); invalid slots score 0.
    Returns (top_scores (B, k), top_idx (B, k) int64, valid (B, k) bool)."""
    cand = torch.where(peak_mask & (scores >= cls_threshold), scores,
                       torch.full_like(scores, -1.0))
    top_scores, top_idx = torch.sort(cand, dim=1, descending=True, stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    valid = top_scores > 0.0
    return torch.where(valid, top_scores, torch.zeros_like(top_scores)), top_idx, valid
