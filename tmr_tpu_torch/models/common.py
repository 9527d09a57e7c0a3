"""Shared layers (counterpart of ``tmr_tpu/models/common.py``).

Parameters are kept in f32, as in the JAX package; ``Linear`` and ``Conv2d`` compute in
their ``dtype`` (the input, weight and bias are cast, as a flax ``nn.Dense`` /
``nn.Conv`` with ``dtype=bfloat16`` does).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class Linear(nn.Linear):
    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Conv2d(nn.Conv2d):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 padding: int = 0, bias: bool = True,
                 dtype: torch.dtype = torch.float32, dilation: int = 1):
        super().__init__(in_ch, out_ch, kernel_size, stride=stride, padding=padding,
                         bias=bias, dilation=dilation)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding,
                        self.dilation)


class LayerNorm2d(nn.Module):
    """Layer norm over the channel axis of an NCHW map, biased variance, eps 1e-6,
    computed in f32 (SAM's LayerNorm2d)."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        u = x.mean(dim=1, keepdim=True)
        s = (x - u).pow(2).mean(dim=1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return x * self.weight[:, None, None] + self.bias[:, None, None]


class MLPBlock(nn.Module):
    """Linear -> exact (erf) GELU -> Linear."""

    def __init__(self, dim: int, mlp_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lin1 = Linear(dim, mlp_dim, dtype=dtype)
        self.lin2 = Linear(mlp_dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin2(F.gelu(self.lin1(x), approximate="none"))
