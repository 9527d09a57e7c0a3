"""SAM image-encoder ViT (counterpart of ``tmr_tpu/models/vit.py``).

Tokens keep their (H, W) grid, channels last, as in the JAX package; windowed blocks
partition into 14x14 windows (zero-padded: the pad tokens are real keys, as in SAM),
global blocks attend over the whole grid. The rel-pos tables are linearly resized for
non-native grids (the 1536 bucket) by ``interp_rel_pos``. Global blocks call
``ops.cuda_attn.global_attention`` with the compact ``(2g - 1, D)`` tables, whose
Toeplitz expansion the kernel makes itself; windowed blocks call
``ops.cuda_attn.window_attention`` with the ``(g, g, D)`` tables that
:func:`get_rel_pos` looks up. Both at every grid size, and at the head dims of both SAM
encoders the port builds: ViT-B (768 over 12 heads of 64) and ViT-H (1280 over 16 heads
of 80), each a kernel instantiation of its own on the card.
``Attention(use_rel_pos=False)`` (the JAX option; no preset, ``Block`` or ``SamViT``
passes it, as in the JAX package) has no tables, and both of its paths take
``global_attention`` without them: on the card the global kernel's no-bias
instantiation, over each window's tokens for windowed blocks. LayerNorms run in f32; the
linears and convs in the model's compute dtype. Both attention calls carry gradients
(``ops.cuda_attn``'s autograd Functions). With ``remat`` each block is recomputed on the
backward pass (``torch.utils.checkpoint``, the counterpart of ``nn.remat(Block)``):
activation memory for one more forward per block.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tmr_tpu_torch.models.common import Conv2d, LayerNorm2d, Linear, MLPBlock
from tmr_tpu_torch.ops.cuda_attn import (get_rel_pos, global_attention, interp_rel_pos,
                                         window_attention)


def window_partition(x: torch.Tensor, window: int):
    """(B, H, W, C) -> (B*nW, window, window, C), zero-padding to multiples."""
    b, h, w, c = x.shape
    pad_h = (window - h % window) % window
    pad_w = (window - w % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // window, window, wp // window, window, c)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)
    return windows, (hp, wp)


def window_unpartition(windows: torch.Tensor, window: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window // window)
    x = windows.view(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w, :]


class Attention(nn.Module):
    """Multi-head attention with the decomposed rel-pos bias, or none with
    ``use_rel_pos=False`` (the JAX ``Attention`` option: no ``rel_pos_h`` / ``rel_pos_w``
    parameters, and scores without the bias). Without the bias the attention does not
    depend on the token grid, so windowed blocks take :func:`global_attention` over each
    window's tokens: on the card the global kernel's no-bias instantiation."""

    def __init__(self, dim: int, num_heads: int, rel_pos_size: Tuple[int, int],
                 windowed: bool, dtype: torch.dtype = torch.float32,
                 use_rel_pos: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.windowed = windowed
        self.use_rel_pos = use_rel_pos
        head_dim = dim // num_heads
        self.qkv = Linear(dim, dim * 3, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * rel_pos_size[0] - 1, head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * rel_pos_size[1] - 1, head_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, dim = x.shape
        heads = self.num_heads
        hd = dim // heads
        qkv = self.qkv(x).reshape(b, h * w, 3, heads, hd).permute(2, 0, 3, 1, 4)
        # the kernels take dense rows: the copy comes before the reshape, where every batch
        # needs it (after it, b = 1 would leave a strided view, which a program traced
        # at another batch size would pass on as it is)
        q, k, v = (t.contiguous().reshape(b * heads, h * w, hd) for t in qkv)
        if not self.use_rel_pos:
            o = global_attention(q, k, v, None, None, (h, w), hd ** -0.5)
        elif self.windowed:
            o = window_attention(q, k, v, get_rel_pos(h, h, self.rel_pos_h),
                                 get_rel_pos(w, w, self.rel_pos_w), (h, w), hd ** -0.5)
        else:  # the compact tables: the kernel expands them itself
            o = global_attention(q, k, v, interp_rel_pos(self.rel_pos_h, 2 * h - 1),
                                 interp_rel_pos(self.rel_pos_w, 2 * w - 1), (h, w),
                                 hd ** -0.5)
        o = o.view(b, heads, h, w, hd).permute(0, 2, 3, 1, 4).reshape(b, h, w, dim)
        return self.proj(o)


class Block(nn.Module):
    """Transformer block with optional window attention."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, window_size: int,
                 rel_pos_size: Tuple[int, int], dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        attn_size = (window_size, window_size) if window_size > 0 else rel_pos_size
        self.attn = Attention(dim, num_heads, attn_size, window_size > 0, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        y = self.norm1(x.float())
        if self.window_size > 0:
            h, w = y.shape[1], y.shape[2]
            y, pad_hw = window_partition(y, self.window_size)
        y = self.attn(y)
        if self.window_size > 0:
            y = window_unpartition(y, self.window_size, pad_hw, (h, w))
        x = shortcut + y
        return x + self.mlp(self.norm2(x.float()))


class SamViT(nn.Module):
    """SAM image encoder: (B, S, S, 3) NHWC image -> (B, out_chans, S/16, S/16) f32."""

    def __init__(self, embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 global_attn_indexes: Sequence[int] = (2, 5, 8, 11),
                 patch_size: int = 16, window_size: int = 14, out_chans: int = 256,
                 mlp_ratio: float = 4.0, pretrain_img_size: int = 1024,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        grid = pretrain_img_size // patch_size
        self.remat = remat
        self.grid = grid
        self.patch_size = patch_size
        self.out_chans = out_chans
        self.global_attn_indexes = tuple(global_attn_indexes)
        self.patch_embed = Conv2d(3, embed_dim, patch_size, stride=patch_size,
                                  dtype=dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio,
                  0 if i in self.global_attn_indexes else window_size,
                  (grid, grid), dtype)
            for i in range(depth)
        )
        self.neck_0 = Conv2d(embed_dim, out_chans, 1, bias=False, dtype=dtype)
        self.neck_1 = LayerNorm2d(out_chans)
        self.neck_2 = Conv2d(out_chans, out_chans, 3, padding=1, bias=False,
                             dtype=dtype)
        self.neck_3 = LayerNorm2d(out_chans)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(image.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        h, w = x.shape[1], x.shape[2]
        pos = self.pos_embed
        if (h, w) != (self.grid, self.grid):
            pos = F.interpolate(pos.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                                align_corners=False).permute(0, 2, 3, 1)
        x = x + pos.to(x.dtype)
        for blk in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(blk, x, use_reentrant=False)
            else:
                x = blk(x)
        x = self.neck_1(self.neck_0(x.permute(0, 3, 1, 2)))
        return self.neck_3(self.neck_2(x))


VIT_CONFIGS = {
    "vit_b": dict(embed_dim=768, depth=12, num_heads=12,
                  global_attn_indexes=(2, 5, 8, 11)),
    "vit_h": dict(embed_dim=1280, depth=32, num_heads=16,
                  global_attn_indexes=(7, 15, 23, 31)),
}


def nhwc_features(encoder: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """The encoder's features as the JAX encoder gives them: f32 NHWC, contiguous. The
    copy is made whatever the layout, so that a ``torch.export`` program of this function
    writes the same layout as the eager call (the trace drops a ``contiguous()`` that it
    sees on a contiguous tensor)."""
    return encoder(images).float().permute(0, 2, 3, 1).clone(
        memory_format=torch.contiguous_format)


def build_sam_vit(model_type: str = "vit_h", dtype: torch.dtype = torch.float32,
                  remat: bool = False, **overrides) -> SamViT:
    return SamViT(dtype=dtype, remat=remat, **{**VIT_CONFIGS[model_type], **overrides})
