"""Template extraction and cross-correlation (counterpart of ``tmr_tpu/ops/xcorr.py``).

- :func:`template_geometry` / :func:`extract_template`: RoIAlign the exemplar into an
  odd (ht, wt) template centred in a static (T, T) capacity (template_matching.py:55-76).
- :func:`cross_correlation`: depthwise SAME correlation with per-image templates,
  divided by ``ht * wt + 1e-14``, the ``(ht // 2, wt // 2)`` border band zeroed, an
  optional channel sum. Buckets up to :data:`FFT_CAPACITY_THRESHOLD` run the direct
  correlation (``ops/cuda_xcorr.py``); larger ones the correlation theorem with
  ``torch.fft``, whose cost does not grow with T. With ``quant="int8"`` the direct
  path takes the int8 arms of ``tmr_tpu/ops/xcorr.py`` (no gates): ``"dequant"``, a
  bf16 feature and the int8-grid template through the f32 kernel (products of bf16
  values are exact in f32); ``"int8"``, both operands quantized per (image, channel)
  through the int8 kernel. The FFT path is f32 whatever ``quant`` says, as in JAX.
"""

from __future__ import annotations

import torch

from tmr_tpu_torch.ops.cuda_xcorr import xcorr, xcorr_int8
from tmr_tpu_torch.ops.quant import quantize_int8, quantize_int8_template, quantize_template
from tmr_tpu_torch.ops.roi_align import sampling_matrix

FFT_CAPACITY_THRESHOLD = 65


def template_geometry(exemplars: torch.Tensor, feat_h: int, feat_w: int) -> dict:
    """(B, 4) normalized xyxy -> feature-space x1/y1/x2/y2 (f32) and odd ht/wt (int)."""
    ex = exemplars.float().clamp(0.0, 1.0)
    x1, x2 = ex[:, 0] * feat_w, ex[:, 2] * feat_w
    y1, y2 = ex[:, 1] * feat_h, ex[:, 3] * feat_h
    wt = torch.ceil(x2).to(torch.int32) - torch.floor(x1).to(torch.int32)
    ht = torch.ceil(y2).to(torch.int32) - torch.floor(y1).to(torch.int32)
    wt = (wt - (wt % 2 == 0).to(torch.int32)).clamp_min(1)
    ht = (ht - (ht % 2 == 0).to(torch.int32)).clamp_min(1)
    return {"x1": x1, "y1": y1, "x2": x2, "y2": y2, "ht": ht, "wt": wt}


def extract_template(feature: torch.Tensor, exemplars: torch.Tensor, capacity: int):
    """feature (B, C, H, W), exemplars (B, 4) -> (templates (B, C, T, T) f32,
    thw (B, 2) int32 true sizes, clamped to the capacity)."""
    _, _, h, w = feature.shape
    g = template_geometry(exemplars, h, w)
    ht = g["ht"].clamp_max(capacity)
    wt = g["wt"].clamp_max(capacity)
    ay = sampling_matrix(g["y1"] - 0.5, g["y2"] - g["y1"], ht, capacity, h,
                         offset=torch.div(capacity - ht, 2, rounding_mode="floor"),
                         sampling_ratio=-1, max_ratio=2)
    ax = sampling_matrix(g["x1"] - 0.5, g["x2"] - g["x1"], wt, capacity, w,
                         offset=torch.div(capacity - wt, 2, rounding_mode="floor"),
                         sampling_ratio=-1, max_ratio=2)
    template = torch.matmul(torch.matmul(ay[:, None], feature.float()),
                            ax[:, None].transpose(-1, -2))
    return template, torch.stack([ht, wt], dim=1)


def _fft_size(n: int) -> int:
    """Smallest 2^a * 3^b >= n."""
    best = 1 << (n - 1).bit_length()
    for b in (1, 3, 9):
        m = b
        while m < n:
            m *= 2
        if n <= m < best:
            best = m
    return best


def _xcorr_fft(feature: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """Exact linear SAME correlation via the correlation theorem (f32)."""
    _, _, h, w = feature.shape
    t = template.shape[-1]
    c = t // 2
    n = _fft_size(max(h, w) + t - 1)
    ff = torch.fft.rfft2(feature.float(), s=(n, n))
    ft = torch.fft.rfft2(template.float(), s=(n, n))
    corr = torch.fft.irfft2(ff * torch.conj(ft), s=(n, n))
    ys = (torch.arange(h, device=feature.device) - c) % n
    xs = (torch.arange(w, device=feature.device) - c) % n
    return corr[:, :, ys][:, :, :, xs]


def xcorr_int8dot(feature: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """Both operands on the int8 grid (``_xcorr_int8dot``): the feature quantized per
    (image, channel) over H*W, the template as :func:`quantize_int8_template`."""
    b, c, h, w = feature.shape
    fq, fs = quantize_int8(feature.float().reshape(b, c, h * w), -1)
    tq, ts = quantize_int8_template(template)
    return xcorr_int8(fq.reshape(b, c, h, w), tq, fs.reshape(b, c, 1, 1), ts)


def cross_correlation(feature: torch.Tensor, template: torch.Tensor,
                      template_hw: torch.Tensor, squeeze: bool = False,
                      quant: str = "off", kernel: str = "dequant") -> torch.Tensor:
    """feature (B, C, H, W) f32; template (B, C, T, T); template_hw (B, 2) int ->
    (B, C, H, W), or (B, 1, H, W) with ``squeeze``. ``quant``/``kernel``: the
    ``Config`` fields of the same names."""
    _, _, h, w = feature.shape
    t = template.shape[-1]
    if t > FFT_CAPACITY_THRESHOLD:
        out = _xcorr_fft(feature, template)
    elif quant == "int8" and kernel == "int8":
        out = xcorr_int8dot(feature, template)
    elif quant == "int8":
        out = xcorr(feature.to(torch.bfloat16).float(),
                    quantize_template(template, torch.bfloat16).float())
    else:
        out = xcorr(feature.float(), template.float())
    ht = template_hw[:, 0]
    wt = template_hw[:, 1]
    out = out / (ht * wt + 1e-14).to(out.dtype)[:, None, None, None]
    ph = torch.div(ht, 2, rounding_mode="floor")[:, None]
    pw = torch.div(wt, 2, rounding_mode="floor")[:, None]
    ys = torch.arange(h, device=feature.device)[None, :]
    xs = torch.arange(w, device=feature.device)[None, :]
    row_ok = (ys >= ph) & (ys < h - ph)
    col_ok = (xs >= pw) & (xs < w - pw)
    mask = row_ok[:, None, :, None] & col_ok[:, None, None, :]
    out = torch.where(mask, out, torch.zeros_like(out))
    if squeeze:
        out = out.sum(dim=1, keepdim=True)
    return out
