"""The decoder tail as channel-tiled matmuls (counterpart of ``tmr_tpu/ops/fused_heads.py``).

A k x k SAME conv is k^2 matmuls of the zero-padded NHWC activation, one per tap,
contracted over the channels and summed in f32 in ``dy, dx`` order, then the f32 bias.
The two decoder stacks share their input, so their first layers run as one conv with
the output channels concatenated ``[objectness | bbox]``; both 1x1 heads run as one
block-diagonal ``(5, 2C)`` matmul over the combined activation. This is the path of
``Config.quant="int8"``; the unquantized model keeps its cuDNN convolutions
(``models/heads.py``).

Weights arrive in the port's layouts: an f32 OIHW kernel, or, under ``quant="stored"``,
the int8 ``(kh, kw, O, I)`` kernel with its ``(kh, kw, O)`` scales of
``ops/quant.quantize_conv``. :func:`fused_decoder_heads` views the f32 kernels in the
same per-tap layout, so every tap is an ``(N, K)`` matrix.

``quant``: ``False`` exact weights; ``True`` the int8 round trip of each tap's weight
next to its matmul (fake quantization); ``"stored"`` the int8 weights themselves.
``kernel_arm`` (stored only): ``"dequant"`` widens the int8 operand to ``dtype`` next to
an f32-accumulated product (bitwise the fake path); ``"int8"`` quantizes the activation
per image as well and contracts on the int8 grid through the hand-written kernels, the
scales applied in their f32 epilogue: each 3x3 layer is one ``ops/cuda_int8.int8_conv3x3``
launch (nine taps, bias and ``leaky_relu`` inside), the heads and any other conv go tap
by tap through ``ops/cuda_int8.int8_mm``. Rounding points are the JAX package's: layer
inputs are cast to ``dtype`` before an int8 arm quantizes them (the JAX package pads
first, which changes nothing: the padded zeros never set the amax); the heads quantize
the f32 activation after ``leaky_relu``.

The ``"dequant"`` and unquantized arms multiply f32 operands that hold ``dtype``'s
values: the products are exact in f32 and the sums f32, which is what JAX's
``preferred_element_type=f32`` product of bf16 operands computes. That product is plain
``torch.matmul``, as the JAX package left it to XLA; it is not the slice's path on the
card.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from tmr_tpu_torch.ops.cuda_int8 import int8_conv3x3, int8_mm
from tmr_tpu_torch.ops.quant import dequantize, fake_quant, quantize_int8

ParamPair = Tuple[torch.Tensor, ...]  # (weight, bias[, scale])


def _maybe_quant(w: torch.Tensor, dtype: torch.dtype, quant, scale=None) -> torch.Tensor:
    """The (N, K) weight operand of one matmul, in ``dtype``."""
    if quant == "stored":
        if w.dtype != torch.int8 or scale is None:
            raise TypeError("stored-quant matmul expects an int8 weight and its scale, "
                            f"got {w.dtype} (scale {'missing' if scale is None else 'ok'})")
        return dequantize(w, scale[:, None], dtype)
    if quant:
        return fake_quant(w, dim=1, dtype=dtype)
    return w.to(dtype)


def _quant_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image int8 quantization of an NHWC activation: (q int8, scale f32 (B,))."""
    b = x.shape[0]
    q, s = quantize_int8(x.float().reshape(b, -1), -1)
    return q.reshape(x.shape), s.reshape(b)


def _row_scales(xs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Per-image scales (B,) broadcast to the rows (B, h, w) of an int8 product."""
    return xs[:, None, None].expand(-1, h, w).contiguous()


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) x (N, K)^T with f32 operands holding the inputs' values: f32 result."""
    return torch.matmul(x.float(), w.float().t())


def conv_mm(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor,
            dtype: torch.dtype = torch.bfloat16, quant=False, scale=None,
            kernel_arm: str = "dequant", int8_matmul=int8_mm) -> torch.Tensor:
    """k x k conv with padding (k - 1) // 2 as k^2 tap matmuls; x (B, H, W, C_in),
    taps (k, k, C_out, C_in) (int8 with ``scale`` (k, k, C_out) when stored) ->
    (B, H', W', C_out) f32. ``int8_matmul`` is the int8 arm's product (the kernel, or
    ``cuda_int8.int8_mm_plain`` to hold the kernel against)."""
    stored = quant == "stored"
    k = taps.shape[0]
    p = (k - 1) // 2
    b, h, w, _ = x.shape
    oh, ow = h + 2 * p - k + 1, w + 2 * p - k + 1
    xp = F.pad(x.to(dtype), (0, 0, p, p, p, p)).contiguous()
    int8_act = stored and kernel_arm == "int8"
    if int8_act:
        xq, xs = _quant_act(xp)
        rows = _row_scales(xs, oh, ow)
    acc = None
    for dy in range(k):
        for dx in range(k):
            wt, st = taps[dy, dx], (scale[dy, dx] if stored else None)
            if int8_act:
                tap = int8_matmul(xq[:, dy:dy + oh, dx:dx + ow, :], wt, rows, st)
            else:
                tap = _mm_f32(xp[:, dy:dy + oh, dx:dx + ow, :],
                              _maybe_quant(wt, dtype, quant, st))
            acc = tap if acc is None else acc.add_(tap)
    return acc + bias.float()


def _conv_act(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor, dtype, quant,
              scale, kernel_arm: str, negative_slope: float, int8_matmul,
              int8_conv) -> torch.Tensor:
    """``leaky_relu(conv_mm(...))``. A 3x3 layer of the int8 arm is one ``int8_conv`` call
    on the unpadded activation quantized per image: zeros never set an amax (an all-zero
    image takes scale 1 either way), so its int8 values and scale are those of the padded
    activation that :func:`conv_mm` quantizes."""
    if quant == "stored" and kernel_arm == "int8" and tuple(taps.shape[:2]) == (3, 3):
        xq, xs = _quant_act(x.to(dtype))
        return int8_conv(xq, xs, taps, scale, bias.float(), negative_slope)
    return F.leaky_relu(conv_mm(x, taps, bias, dtype, quant, scale, kernel_arm, int8_matmul),
                        negative_slope)


def _entry(pair):
    """(weight, bias[, scale]) -> (per-tap (k, k, O, I) weight, bias, scale or None)."""
    if len(pair) > 2:
        return pair
    return pair[0].permute(2, 3, 0, 1), pair[1], None


def _head_matrix(w1: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    """The block-diagonal (5, 2C) head weight: row 0 reads the objectness half, rows 1-4
    the bbox half; assembled on the int8 grid when stored (zeros quantize to 0 and never
    carry a row's amax, so it equals the fake path's quantization of the f32 matrix)."""
    c = w1.numel()
    wh = torch.zeros(5, 2 * c, dtype=w1.dtype, device=w1.device)
    wh[:1, :c] = w1.reshape(1, c)
    wh[1:, c:] = w4.reshape(4, c)
    return wh


def fused_decoder_heads(f_cat: torch.Tensor, dec_o: Sequence[ParamPair],
                        dec_b: Sequence[ParamPair], head_o: ParamPair,
                        head_b: ParamPair, dtype: torch.dtype = torch.bfloat16,
                        negative_slope: float = 0.01, quant=False,
                        kernel_arm: str = "dequant", int8_matmul=int8_mm,
                        int8_conv=int8_conv3x3) -> Tuple[torch.Tensor, torch.Tensor]:
    """f_cat (B, H, W, C_in) NHWC; dec_o/dec_b: per-layer (weight, bias[, scale]) of the
    objectness/bbox stacks; head_o/head_b: the 1x1 heads; ``int8_matmul`` as in
    :func:`conv_mm`; ``int8_conv`` the int8 arm's 3x3 layer (the kernel, or
    ``cuda_int8.int8_conv3x3_plain``). Returns (objectness (B, H, W, 1), regressions
    (B, H, W, 4)), f32."""
    if len(dec_o) != len(dec_b):
        raise ValueError("fused_decoder_heads: the stacks must have equal depth")
    stored = quant == "stored"
    ko0, bo0, so0 = _entry(dec_o[0])
    kb0, bb0, sb0 = _entry(dec_b[0])
    c = ko0.shape[2]

    w0 = torch.cat([ko0, kb0], dim=2)
    b0 = torch.cat([bo0, bb0])
    s0 = torch.cat([so0, sb0], dim=2) if stored else None
    arm = (kernel_arm, negative_slope, int8_matmul, int8_conv)
    act = _conv_act(f_cat, w0, b0, dtype, quant, s0, *arm)

    for eo, eb in zip(dec_o[1:], dec_b[1:]):
        wo, bo, so = _entry(eo)
        wb, bb, sb = _entry(eb)
        ao = _conv_act(act[..., :c], wo, bo, dtype, quant, so, *arm)
        ab = _conv_act(act[..., c:], wb, bb, dtype, quant, sb, *arm)
        act = torch.cat([ao, ab], dim=-1)

    w1, b1, s1 = _entry(head_o)
    w4, b4, s4 = _entry(head_b)
    bh = torch.cat([b1, b4]).float()
    wh = _head_matrix(w1, w4)
    if stored:
        sh = torch.cat([s1.reshape(1), s4.reshape(4)])
        if kernel_arm == "int8":
            aq, as_ = _quant_act(act)
            out = int8_matmul(aq, wh, _row_scales(as_, act.shape[1], act.shape[2]), sh)
        else:
            out = _mm_f32(act.to(dtype), dequantize(wh, sh[:, None], dtype))
    else:
        out = _mm_f32(act.to(dtype), _maybe_quant(wh, dtype, quant))
    out = out + bh
    return out[..., :1], out[..., 1:]
