"""Box decoding (counterpart of ``tmr_tpu/ops/boxes.py``: the parts the inference path
uses; the NMS IoU lives with the NMS kernel in ``ops/cuda_nms.py``)."""

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
