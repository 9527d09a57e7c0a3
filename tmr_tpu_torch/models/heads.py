"""Decoder conv stacks and prediction heads (counterpart of ``tmr_tpu/models/heads.py``).

NCHW; ``padding = (k - 1) // 2``; LeakyReLU slope 0.01. These are ordinary
convolutions, computed by ``F.conv2d`` as the JAX package leaves them to XLA.
:class:`Int8Conv2d` holds one of their kernels on the int8 grid for the stored tail
(``Config.quant_storage="int8"``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tmr_tpu_torch.models.common import Conv2d
from tmr_tpu_torch.ops.quant import quantize_conv


class Decoder(nn.Module):
    """N x (conv k x k same -> LeakyReLU), channel-preserving."""

    def __init__(self, channels: int, num_layers: int = 1, kernel_size: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"conv_{i}", Conv2d(channels, channels, kernel_size,
                                                padding=(kernel_size - 1) // 2,
                                                dtype=dtype))
        self.num_layers = num_layers

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), negative_slope=0.01)
        return x


class ObjectnessHead(nn.Module):
    """1x1 conv -> 1 logit channel."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, 1, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class BboxesHead(nn.Module):
    """1x1 conv -> 4 ltrb regression channels."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(channels, 4, 1, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Int8Conv2d(nn.Module):
    """A :class:`Conv2d`'s kernel stored on the int8 grid (``ops/quant.quantize_conv``):
    ``qweight`` (kh, kw, O, I) int8, ``scale`` (kh, kw, O) f32, and the f32 ``bias``.
    No f32 copy of the kernel is kept. Read by the fused tail (``ops/fused_heads.py``);
    it has no forward of its own."""

    def __init__(self, conv: Conv2d):
        super().__init__()
        q, s = quantize_conv(conv.weight.detach())
        self.register_buffer("qweight", q)
        self.register_buffer("scale", s)
        self.bias = nn.Parameter(conv.bias.detach().float(), requires_grad=False)
