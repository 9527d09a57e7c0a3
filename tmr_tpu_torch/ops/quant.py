"""Symmetric int8 quantization (counterpart of ``tmr_tpu/ops/quant.py``).

One grid for every int8 operand of the port: ``scale = amax * float32(1/127)`` per
group (a multiply, not a division, as in the JAX package, so every caller gets the
same last bit), ``q = clip(round_half_even(w / scale), -127, 127)``, and all-zero
groups take scale 1. Decoder and head weights get one scale per (tap, output
channel); templates and the correlation's feature one per (image, channel).

Forward only: training scrubs the quant fields (as the JAX ``main.py`` does), so no
path differentiates through :func:`fake_quant`, and its straight-through gradient is
not ported (ROADMAP A2).

:func:`quantize_conv` is the storage half (the counterpart of ``quantize_tree``): an
OIHW conv kernel becomes an int8 ``(kh, kw, O, I)`` tensor, each tap an ``(N, K)``
K-contiguous matrix (the ``.col`` B operand of the int8 matmul kernel), with f32
scales ``(kh, kw, O)``.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

#: float32(1/127) as a Python float: a tensor times this scalar computes in f32 (and the
#: product of two f32 values is exact in f64 besides), so no device copy of a constant
#: is made and the scale is the JAX package's ``amax * float32(1/127)`` bit for bit
_INV_127 = float(np.float32(1.0 / 127.0))

Dims = Union[int, Tuple[int, ...]]


def quantize_int8(w: torch.Tensor, dim: Dims = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scales shared over the reduced ``dim`` and distinct over the kept ones.
    Returns (q int8 of ``w``'s shape, scale f32 with the reduced dims kept as 1)."""
    w = w.float()
    amax = torch.amax(w.abs(), dim=dim, keepdim=True)
    scale = torch.where(amax > 0, amax * _INV_127, torch.ones_like(amax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def fake_quant(w: torch.Tensor, dim: Dims = -1,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``dequantize(*quantize_int8(w, dim))``: the value an int8 program multiplies by."""
    q, s = quantize_int8(w, dim)
    return dequantize(q, s, dtype)


def quantize_template(template: torch.Tensor,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Round trip of a (B, C, T, T) template bank through the int8 grid, one scale per
    (image, channel)."""
    b, c, t, _ = template.shape
    return fake_quant(template.reshape(b, c, t * t), -1, dtype).reshape(b, c, t, t)


def quantize_int8_template(template: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 (B, C, T, T), scale f32 (B, C, 1, 1)) on the grid of
    :func:`quantize_template`."""
    b, c, t, _ = template.shape
    q, s = quantize_int8(template.reshape(b, c, t * t), -1)
    return q.reshape(b, c, t, t), s.reshape(b, c, 1, 1)


def quantize_conv(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW f32 kernel -> (q int8 (kh, kw, O, I) contiguous, scale f32 (kh, kw, O)),
    one scale per (tap, output channel): the JAX package's ``axis=2`` of an HWIO
    kernel, elementwise equal to the per-tap fake quantization of the fused tail."""
    q, s = quantize_int8(weight, dim=1)  # (O, I, kh, kw), (O, 1, kh, kw)
    return q.permute(2, 3, 0, 1).contiguous(), s[:, 0].permute(1, 2, 0).contiguous()
