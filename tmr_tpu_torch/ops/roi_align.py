"""RoIAlign as separable sampling-matrix products (counterpart of
``tmr_tpu/ops/roi_align.py``).

RoIAlign's sample grid is separable, so every pooled bin is ``Ay @ f @ Ax^T`` with
per-ROI averaging matrices of 1-D bilinear weights; the semantics are torchvision's
(``aligned`` offset, adaptive ``ceil(roi / out)`` sampling ratio, bilinear boundary
rules). All geometry arguments are tensors batched over leading dims.
"""

from __future__ import annotations

import torch


def _bilinear_weight_rows(pos: torch.Tensor, size: int) -> torch.Tensor:
    """(...,) sample coordinates -> (..., size) 1-D bilinear weight rows."""
    oob = (pos < -1.0) | (pos > size)
    p = pos.clamp_min(0.0)
    low = torch.floor(p).to(torch.int64)
    at_edge = low >= size - 1
    low = torch.where(at_edge, torch.full_like(low, size - 1), low)
    high = torch.where(at_edge, torch.full_like(low, size - 1), low + 1)
    frac = torch.where(at_edge, torch.zeros_like(p), p - low.to(p.dtype))
    iota = torch.arange(size, device=pos.device)
    w = ((1.0 - frac)[..., None] * (iota == low[..., None])
         + frac[..., None] * (iota == high[..., None]))
    return torch.where(oob[..., None], torch.zeros_like(w), w)


def sampling_matrix(
    start: torch.Tensor,
    length: torch.Tensor,
    n_active,
    n_static: int,
    feat_size: int,
    offset=0,
    sampling_ratio: int = -1,
    max_ratio: int = 2,
) -> torch.Tensor:
    """Per-axis RoIAlign averaging matrix (..., n_static, feat_size).

    ``start``/``length``/``n_active``/``offset`` broadcast over leading dims; rows
    outside ``[offset, offset + n_active)`` are zero (the template is centred in the
    static capacity)."""
    dev = start.device
    n_active = torch.as_tensor(n_active, device=dev)
    offset = torch.as_tensor(offset, device=dev)
    bin_size = length / n_active
    if sampling_ratio > 0:
        ratio = torch.full_like(n_active, sampling_ratio, dtype=torch.int32)
        max_ratio = sampling_ratio
    else:
        ratio = torch.ceil(length / n_active).to(torch.int32).clamp(1, max_ratio)
    ratio_f = ratio.to(torch.float32)
    i = torch.arange(n_static, device=dev) - offset[..., None]  # (..., n_static)
    k = torch.arange(max_ratio, device=dev)
    pos = start[..., None, None] + bin_size[..., None, None] * (
        i[..., :, None].to(torch.float32)
        + (k.to(torch.float32) + 0.5) / ratio_f[..., None, None]
    )
    w = _bilinear_weight_rows(pos, feat_size)  # (..., n_static, max_ratio, F)
    kmask = (k < ratio[..., None]).to(w.dtype)  # (..., max_ratio)
    w = (w * kmask[..., None, :, None]).sum(dim=-2) / ratio_f[..., None, None]
    row_valid = (i >= 0) & (i < n_active[..., None])
    return w * row_valid[..., None].to(w.dtype)


def roi_align(features: torch.Tensor, boxes: torch.Tensor, output_size,
              spatial_scale: float = 1.0, sampling_ratio: int = -1,
              aligned: bool = True, max_ratio: int = 8) -> torch.Tensor:
    """RoIAlign over one image: features (C, H, W), boxes (N, 4) xyxy -> (N, C, oh, ow)."""
    oh, ow = output_size
    _, h, w = features.shape
    off = 0.5 if aligned else 0.0
    x1 = boxes[:, 0] * spatial_scale - off
    y1 = boxes[:, 1] * spatial_scale - off
    x2 = boxes[:, 2] * spatial_scale - off
    y2 = boxes[:, 3] * spatial_scale - off
    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:
        roi_w = roi_w.clamp_min(1.0)
        roi_h = roi_h.clamp_min(1.0)
    ay = sampling_matrix(y1, roi_h, oh, oh, h, 0, sampling_ratio, max_ratio)
    ax = sampling_matrix(x1, roi_w, ow, ow, w, 0, sampling_ratio, max_ratio)
    return torch.einsum("nyh,chw,nxw->ncyx", ay, features.float(), ax)
