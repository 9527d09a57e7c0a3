"""SAM prompt encoder, two-way transformer and mask decoder (counterpart of
``tmr_tpu/models/sam_decoder.py``; reference utils/segment_anything/modeling/
{prompt_encoder,transformer,mask_decoder}.py).

The modules keep the flax names, so ``utils.weights.params_from_jax`` carries a JAX
``{"prompt_encoder", "mask_decoder"}`` tree across mechanically, and keep the JAX
package's NHWC interfaces: features (B, h, w, C), masks (N, 4h, 4w). Everything runs in
f32, as in the JAX package (its parameters are f32 and a bf16 feature is promoted), and
the attention is plain matmuls and a softmax, as the JAX einsums are: no kernel of the
port runs here. Prompts arrive as fixed-size padded tensors and the image and grid sizes
are call arguments, so one module serves every size bucket. The best-IoU mask selection
is the reference's patch of Meta's decoder (mask_decoder.py:100-103).

``UpConv2x`` holds the bridge's layout: ``params_from_jax`` turns the flax kernel
(2, 2, C_in, C_out) into ``weight`` (C_out, C_in, 2, 2), the conv rule it applies to every
4-D kernel; the module reads that layout (``utils.convert`` writes the same from a SAM
``ConvTranspose2d``).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tmr_tpu_torch.models.common import Conv2d, LayerNorm2d, Linear


def const_f32(ref: torch.Tensor, values: Sequence[float]) -> torch.Tensor:
    """An f32 vector of Python numbers on ``ref``'s device, made by fills on that device
    (a tensor copied from the host per call would stall it). A tensor divisor keeps
    the division exact on the card, where a division by a Python scalar is a
    reciprocal multiply."""
    if len(values) == 1:
        return ref.new_full((1,), float(values[0]), dtype=torch.float32)
    return torch.stack([ref.new_full((), float(v), dtype=torch.float32) for v in values])


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier positional encoding (prompt_encoder.py:171-214); the gaussian
    matrix is a parameter, so converted SAM checkpoints reproduce the encoding."""

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(torch.zeros(2, num_pos_feats))

    def forward(self, coords01: torch.Tensor) -> torch.Tensor:
        """coords01 (..., 2) in [0, 1] -> (..., 2 * num_pos_feats)."""
        c = (2.0 * coords01 - 1.0) @ self.positional_encoding_gaussian_matrix
        c = 2.0 * math.pi * c
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def grid_pe(self, size: Tuple[int, int]) -> torch.Tensor:
        """Dense PE of an (h, w) grid at half-pixel centres -> (h, w, C)
        (prompt_encoder.py:194-205)."""
        h, w = size
        dev = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / const_f32(
            self.positional_encoding_gaussian_matrix, [h])
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / const_f32(
            self.positional_encoding_gaussian_matrix, [w])
        grid = torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)  # (h, w, [x, y])
        return self(grid)


class PromptEncoder(nn.Module):
    """Sparse (points, boxes) and dense (mask) prompt embeddings
    (prompt_encoder.py:16-168), shape-static; the image size is a call argument."""

    def __init__(self, embed_dim: int = 256, mask_in_chans: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        # negative point, positive point, box corner 1, box corner 2
        self.point_embeddings = nn.Parameter(torch.zeros(4, embed_dim))
        self.not_a_point_embed = nn.Parameter(torch.zeros(1, embed_dim))
        self.no_mask_embed = nn.Parameter(torch.zeros(1, embed_dim))
        self.mask_down_0 = Conv2d(1, mask_in_chans // 4, 2, stride=2)
        self.mask_down_1 = LayerNorm2d(mask_in_chans // 4)
        self.mask_down_3 = Conv2d(mask_in_chans // 4, mask_in_chans, 2, stride=2)
        self.mask_down_4 = LayerNorm2d(mask_in_chans)
        self.mask_down_6 = Conv2d(mask_in_chans, embed_dim, 1)

    def _wh(self, ref: torch.Tensor, image_size: Tuple[int, int]) -> torch.Tensor:
        h, w = image_size
        return const_f32(ref, [w, h])

    def embed_boxes(self, boxes: torch.Tensor, image_size: Tuple[int, int]) -> torch.Tensor:
        """boxes (N, 4) xyxy in pixels -> (N, 2, embed_dim) (prompt_encoder.py:93-100)."""
        corners = (boxes.float() + 0.5).reshape(-1, 2, 2)
        corners = corners / self._wh(corners, image_size)
        return self.pe_layer(corners) + self.point_embeddings[2:4][None]

    def embed_points(self, points: torch.Tensor, labels: torch.Tensor,
                     image_size: Tuple[int, int]) -> torch.Tensor:
        """points (N, K, 2) px, labels (N, K) in {-1, 0, 1} -> (N, K, C)
        (prompt_encoder.py:73-91); label -1 is a padding slot."""
        pts = (points.float() + 0.5) / self._wh(points, image_size)
        emb = self.pe_layer(pts)
        lab = labels[..., None]
        emb = torch.where(lab == -1, self.not_a_point_embed[0], emb)
        emb = torch.where(lab == 0, emb + self.point_embeddings[0], emb)
        return torch.where(lab == 1, emb + self.point_embeddings[1], emb)

    def embed_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """masks (N, 4h, 4w, 1) -> (N, h, w, embed_dim)."""
        x = masks.float().permute(0, 3, 1, 2)
        x = F.gelu(self.mask_down_1(self.mask_down_0(x)), approximate="none")
        x = F.gelu(self.mask_down_4(self.mask_down_3(x)), approximate="none")
        return self.mask_down_6(x).permute(0, 2, 3, 1)

    def no_mask_dense(self, n: int, emb_size: Tuple[int, int]) -> torch.Tensor:
        """(n, h, w, embed_dim) broadcast of the no-mask embedding."""
        h, w = emb_size
        return self.no_mask_embed[0][None, None, None, :].expand(n, h, w, self.embed_dim)

    def dense_pe(self, emb_size: Tuple[int, int]) -> torch.Tensor:
        """(h, w, embed_dim) grid positional encoding."""
        return self.pe_layer.grid_pe(emb_size)

    def forward(self, boxes: torch.Tensor, image_size: Tuple[int, int],
                emb_size: Tuple[int, int]):
        """The box-prompt path (the refiner's): boxes (N, 4) px xyxy -> sparse
        (N, 2, C), dense (N, h, w, C)."""
        return self.embed_boxes(boxes, image_size), self.no_mask_dense(boxes.shape[0],
                                                                       emb_size)


class DownsampledAttention(nn.Module):
    """Attention with optional internal-dim downsampling (transformer.py:185-240)."""

    def __init__(self, embedding_dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        internal = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = Linear(embedding_dim, internal)
        self.k_proj = Linear(embedding_dim, internal)
        self.v_proj = Linear(embedding_dim, internal)
        self.out_proj = Linear(internal, embedding_dim)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    def forward(self, q, k, v):
        q = self._split(self.q_proj(q))
        k = self._split(self.k_proj(k))
        v = self._split(self.v_proj(v))
        head_dim = q.shape[-1]
        attn = (q @ k.transpose(-1, -2)) / const_f32(q, [math.sqrt(head_dim)])
        out = torch.softmax(attn, dim=-1) @ v
        b, h, n, c = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * c))


class TwoWayAttentionBlock(nn.Module):
    """Sparse <-> dense cross-attention block (transformer.py:109-182)."""

    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2, skip_first_layer_pe: bool = False):
        super().__init__()
        d = embedding_dim
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = DownsampledAttention(d, num_heads)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.cross_attn_token_to_image = DownsampledAttention(d, num_heads,
                                                              attention_downsample_rate)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)
        self.mlp_lin1 = Linear(d, mlp_dim)
        self.mlp_lin2 = Linear(mlp_dim, d)
        self.norm3 = nn.LayerNorm(d, eps=1e-5)
        self.cross_attn_image_to_token = DownsampledAttention(d, num_heads,
                                                              attention_downsample_rate)
        self.norm4 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))

        mlp = self.mlp_lin2(F.relu(self.mlp_lin1(queries)))
        queries = self.norm3(queries + mlp)

        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """Token <-> image two-way decoder transformer (transformer.py:16-106)."""

    def __init__(self, embedding_dim: int = 256, depth: int = 2, num_heads: int = 8,
                 mlp_dim: int = 2048, attention_downsample_rate: int = 2):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"layers_{i}", TwoWayAttentionBlock(
                embedding_dim, num_heads, mlp_dim, attention_downsample_rate,
                skip_first_layer_pe=i == 0))
        self.final_attn_token_to_image = DownsampledAttention(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(embedding_dim, eps=1e-5)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding / image_pe (B, h, w, C); point_embedding (B, N, C) ->
        (queries (B, N, C), keys (B, h*w, C))."""
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe.reshape(b, h * w, c)
        queries = point_embedding
        for i in range(self.depth):
            queries, keys = getattr(self, f"layers_{i}")(queries, keys, point_embedding,
                                                         key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class UpConv2x(nn.Module):
    """Non-overlapping 2x transposed conv (kernel 2, stride 2), the JAX einsum with the
    bridge's weight layout: out[b, 2i+u, 2j+v, o] = sum_c x[b, i, j, c] w[o, c, u, v] +
    bias[o], NHWC in and out."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, in_features, 2, 2))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        y = torch.einsum("bhwc,ocuv->bhuwvo", x, self.weight)
        return y.reshape(b, 2 * h, 2 * w, self.weight.shape[0]) + self.bias


class HyperMLP(nn.Module):
    """ReLU MLP head (mask_decoder.py:166-188)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            setattr(self, f"layers_{i}", Linear(dims[i], dims[i + 1]))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.num_layers - 1:
                x = F.relu(x)
        return x


class MaskDecoder(nn.Module):
    """SAM mask decoder with the best-IoU mask selection (mask_decoder.py:16-161 with
    the reference's argmax patch :100-103). NHWC in; masks at the 4x grid (4h, 4w)."""

    def __init__(self, transformer_dim: int = 256, num_multimask_outputs: int = 3,
                 iou_head_depth: int = 3, iou_head_hidden_dim: int = 256,
                 transformer_depth: int = 2, transformer_num_heads: int = 8,
                 transformer_mlp_dim: int = 2048):
        super().__init__()
        d = transformer_dim
        self.transformer_dim = d
        self.num_mask_tokens = num_multimask_outputs + 1
        self.iou_token = nn.Parameter(torch.zeros(1, d))
        self.mask_tokens = nn.Parameter(torch.zeros(self.num_mask_tokens, d))
        self.transformer = TwoWayTransformer(d, transformer_depth, transformer_num_heads,
                                             transformer_mlp_dim)
        self.upscale_0 = UpConv2x(d, d // 4)
        self.upscale_1 = LayerNorm2d(d // 4)
        self.upscale_3 = UpConv2x(d // 4, d // 8)
        for i in range(self.num_mask_tokens):
            setattr(self, f"hyper_mlps_{i}", HyperMLP(d, d, d // 8))
        self.iou_prediction_head = HyperMLP(d, iou_head_hidden_dim, self.num_mask_tokens,
                                            iou_head_depth)

    def forward(self, image_embeddings: torch.Tensor, image_pe: torch.Tensor,
                sparse_prompt_embeddings: torch.Tensor,
                dense_prompt_embeddings: torch.Tensor, return_all_masks: bool = False):
        """image_embeddings (1 or N, h, w, C), image_pe (h, w, C), sparse (N, P, C),
        dense (N, h, w, C) -> (masks (N, 4h, 4w), iou (N,)), the best mask per prompt;
        with ``return_all_masks`` every mask token's masks (N, T, 4h, 4w) and IoUs (N, T),
        the deploy surface's form (the JAX module's field of that name)."""
        d = self.transformer_dim
        n = sparse_prompt_embeddings.shape[0]
        output_tokens = torch.cat([self.iou_token, self.mask_tokens], dim=0)
        tokens = torch.cat([output_tokens[None].expand(n, -1, -1),
                            sparse_prompt_embeddings], dim=1)
        src = image_embeddings.float().expand(n, -1, -1, -1) + dense_prompt_embeddings
        pos_src = image_pe[None].expand(src.shape)
        hs, keys = self.transformer(src, pos_src, tokens)
        iou_token_out = hs[:, 0, :]
        mask_tokens_out = hs[:, 1:1 + self.num_mask_tokens, :]

        h, w = src.shape[1], src.shape[2]
        up = self.upscale_0(keys.reshape(n, h, w, d))
        up = self.upscale_1(up.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        up = F.gelu(self.upscale_3(F.gelu(up, approximate="none")), approximate="none")
        hyper = torch.stack([getattr(self, f"hyper_mlps_{i}")(mask_tokens_out[:, i, :])
                             for i in range(self.num_mask_tokens)], dim=1)  # (N, T, d/8)
        masks = torch.einsum("ntc,nhwc->nthw", hyper, up)
        iou_pred = self.iou_prediction_head(iou_token_out)  # (N, T)
        if return_all_masks:
            return masks, iou_pred
        best = torch.argmax(iou_pred, dim=1)
        rows = torch.arange(n, device=masks.device)
        return masks[rows, best], iou_pred[rows, best]


#: per (in_len, out_len, device): the source rows and fractions of an align_corners
#: resize, computed once on the host in the JAX package's f32 arithmetic
_ALIGN_TAPS: Dict[tuple, tuple] = {}


def _align_taps(in_len: int, out_len: int, device: torch.device):
    key = (in_len, out_len, str(device))
    if key not in _ALIGN_TAPS:
        pos = (np.arange(out_len, dtype=np.float32) * np.float32(in_len - 1)
               / np.float32(out_len - 1))
        lo = np.floor(pos).astype(np.int64)
        hi = np.minimum(lo + 1, in_len - 1)
        frac = (pos - lo.astype(np.float32)).astype(np.float32)
        _ALIGN_TAPS[key] = tuple(torch.from_numpy(a).to(device) for a in (lo, hi, frac))
    return _ALIGN_TAPS[key]


def resize_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with ``align_corners=True`` over the trailing two axes of
    (..., H, W), the JAX formula: rows, then columns, each ``a * (1 - frac) + b * frac``
    with ``frac`` in f32 (the reference's F.interpolate on mask logits,
    box_refine.py:103,158)."""

    def interp_axis(arr: torch.Tensor, axis: int, out_len: int) -> torch.Tensor:
        in_len = arr.shape[axis]
        if in_len == out_len:
            return arr
        if in_len == 1:
            return arr.repeat_interleave(out_len, dim=axis)
        lo, hi, frac = _align_taps(in_len, out_len, arr.device)
        a = arr.index_select(axis, lo)
        b = arr.index_select(axis, hi)
        shape = [1] * arr.dim()
        shape[axis] = out_len
        frac = frac.reshape(shape)
        return a * (1.0 - frac) + b * frac

    x = interp_axis(x, x.dim() - 2, out_hw[0])
    return interp_axis(x, x.dim() - 1, out_hw[1])


def masks_to_boxes(masks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tight pixel boxes of boolean masks (N, H, W) -> (boxes (N, 4) xyxy f32,
    nonempty (N,)); empty masks give zeros (box_refine.py:236-242)."""
    n, h, w = masks.shape
    any_x = masks.any(dim=1)  # (N, W)
    any_y = masks.any(dim=2)  # (N, H)
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)
    big = 1e9
    min_x = torch.where(any_x, xs, big).amin(dim=1)
    max_x = torch.where(any_x, xs, -big).amax(dim=1)
    min_y = torch.where(any_y, ys, big).amin(dim=1)
    max_y = torch.where(any_y, ys, -big).amax(dim=1)
    nonempty = any_x.any(dim=1)
    boxes = torch.stack([min_x, min_y, max_x, max_y], dim=1)
    return torch.where(nonempty[:, None], boxes, 0.0), nonempty
