"""The int8 kernels of the decoder tail, each a hand-written CUDA kernel beside its plain
version: the int8 x int8 -> int32 matrix product with an f32 scale epilogue, and the
fused 3x3 layer.

Both replace ``tmr_tpu/ops/pallas_int8.py`` (``int8_matmul`` / ``_int8_mm_kernel``):
``out[m, n] = float(sum_k x[m, k] * w[n, k]) * (x_scale[m] * w_scale[n])``, the sum exact
in int32. The weight is taken as ``(N, K)``, K contiguous (the layout int8 storage keeps,
``ops/quant.quantize_conv``), where the JAX function takes ``(K, N)``.

:func:`int8_mm` is the general product. ``x_q`` may be a strided view of up to four dims
``(B, H, W, K)`` whose last dim is contiguous: a tap passes its shifted window of a padded
activation as it stands and the kernel addresses the rows through the strides.

:func:`int8_conv3x3` is a whole 3x3 SAME layer of the int8 arm in one launch: the nine
tap products summed in f32 in tap order, each through the product's epilogue, then the
bias and ``leaky_relu``, bit for bit what the per-tap composition computes. It takes the
unpadded activation: the kernel reads zeros outside the image.

Each kernel is a registered ``torch.library`` op, ``tmr::int8_mm`` and
``tmr::int8_conv3x3``, which ``torch.export`` records by name: its CPU kernel is the plain
version, its CUDA kernel launches ``csrc/int8_mm.cu`` (whose header says what bounds each
kernel on the card) or raises, and its fake implementation gives the plain version's
output shape and dtype. The kernels have no backward (training runs without quantization): on the card an input that
requires grad raises while grad mode is on (``_build.refuse_grad``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tmr_tpu_torch.ops import _build


def int8_mm_plain(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                  w_scale: torch.Tensor) -> torch.Tensor:
    """The exact integer product, then the kernel's epilogue. The product runs in float64
    (PyTorch has no CUDA integer matmul, and its CPU one does not use BLAS): every
    product and partial sum is an integer below 2^53, so it is exact in any order."""
    k = x_q.shape[-1]
    x2 = x_q.reshape(-1, k)
    acc = torch.matmul(x2.double(), w_q.double().t()).int()
    scale = x_scale.reshape(-1, 1).float() * w_scale.reshape(1, -1).float()
    return (acc.float() * scale).reshape(*x_q.shape[:-1], w_q.shape[0])


def _row_layout(x_q: torch.Tensor):
    """(nh, nw, sb, sh, sw): the kernel's row dims and byte strides of x_q's rows."""
    lead = list(x_q.shape[:-1])
    strides = list(x_q.stride()[:-1])
    if len(lead) > 3:
        raise ValueError(f"int8_mm: x_q has {x_q.dim()} dims, the kernel takes <= 4")
    while len(lead) < 3:
        lead.insert(0, 1)
        strides.insert(0, 0)
    return lead[1], lead[2], strides[0], strides[1], strides[2]


def int8_mm(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
            w_scale: torch.Tensor) -> torch.Tensor:
    """x_q (..., K) int8, w_q (N, K) int8, x_scale x_q.shape[:-1] f32, w_scale (N,) f32
    -> (..., N) f32."""
    k = x_q.shape[-1]
    n = w_q.shape[0]
    if w_q.shape != (n, k) or x_scale.shape != x_q.shape[:-1] or w_scale.shape != (n,):
        raise ValueError(
            f"int8_mm: x_q {tuple(x_q.shape)}, w_q {tuple(w_q.shape)}, x_scale "
            f"{tuple(x_scale.shape)}, w_scale {tuple(w_scale.shape)}")
    if x_q.device.type != "cpu":
        _build.refuse_grad("int8_mm", x_q, w_q, x_scale, w_scale)
    return torch.ops.tmr.int8_mm(x_q, w_q, x_scale, w_scale)


@torch.library.custom_op(
    "tmr::int8_mm", mutates_args=(), device_types="cpu",
    schema="(Tensor x_q, Tensor w_q, Tensor x_scale, Tensor w_scale) -> Tensor")
def _int8_mm_op(x_q, w_q, x_scale, w_scale):
    """The op of :func:`int8_mm`; this, its CPU kernel, is the plain version."""
    return int8_mm_plain(x_q, w_q, x_scale, w_scale)


@_int8_mm_op.register_fake
def _int8_mm_fake(x_q, w_q, x_scale, w_scale):
    return x_q.new_empty((*x_q.shape[:-1], w_q.shape[0]), dtype=torch.float32)


@_int8_mm_op.register_kernel("cuda")
def _int8_mm_cuda(x_q, w_q, x_scale, w_scale):
    """The op's CUDA kernel: one launch of ``tmr_int8_mm`` on x_q's rows as they are
    strided, or ``ValueError`` for operands the kernel does not take."""
    k = x_q.shape[-1]
    n = w_q.shape[0]
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError("int8_mm: the kernel takes int8 operands")
    if x_q.stride(-1) != 1:
        raise ValueError("int8_mm: x_q's last dim must be contiguous")
    nh, nw, sb, sh, sw = _row_layout(x_q)
    w_q = w_q.contiguous()
    x_scale = x_scale.float().contiguous()
    w_scale = w_scale.float().contiguous()
    m = x_scale.numel()
    out = torch.empty(*x_q.shape[:-1], n, dtype=torch.float32, device=x_q.device)
    _build.launch("int8_mm", "int8_mm", "tmr_int8_mm", x_q.data_ptr(), w_q.data_ptr(),
                  x_scale.data_ptr(), w_scale.data_ptr(), out.data_ptr(), m, n, k, nh, nw,
                  sb, sh, sw, _build.stream_of(x_q))
    return out


def _check_conv3x3(xq, sx, wq, sw, bias):
    """(B, H, W, C, N), or ValueError when the shapes do not make one 3x3 layer."""
    if xq.dim() != 4 or wq.dim() != 4:
        raise ValueError(f"int8_conv3x3: xq {tuple(xq.shape)} must be (B, H, W, C) and wq "
                         f"{tuple(wq.shape)} (3, 3, N, C)")
    b, h, w, c = xq.shape
    n = wq.shape[2]
    if (wq.shape != (3, 3, n, c) or sx.shape != (b,) or sw.shape != (3, 3, n)
            or bias.shape != (n,)):
        raise ValueError(
            f"int8_conv3x3: xq {tuple(xq.shape)}, sx {tuple(sx.shape)}, wq "
            f"{tuple(wq.shape)}, sw {tuple(sw.shape)}, bias {tuple(bias.shape)}")
    return b, h, w, c, n


def int8_conv3x3_plain(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                       sw: torch.Tensor, bias: torch.Tensor,
                       negative_slope: float = 0.01) -> torch.Tensor:
    """The per-tap composition: each tap's :func:`int8_mm_plain` on its window of the
    zero-padded activation, summed in f32 in ``dy, dx`` order, then the f32 bias and
    ``F.leaky_relu``."""
    b, h, w, _, _ = _check_conv3x3(xq, sx, wq, sw, bias)
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
    rows = sx.float()[:, None, None].expand(b, h, w)
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = int8_mm_plain(xp[:, dy:dy + h, dx:dx + w, :], wq[dy, dx], rows, sw[dy, dx])
            acc = tap if acc is None else acc.add_(tap)
    return F.leaky_relu(acc + bias.float(), negative_slope)


def int8_conv3x3(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                 bias: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    """xq (B, H, W, C) int8, the unpadded activation, with its per-image scales sx (B,)
    f32; wq (3, 3, N, C) int8 and sw (3, 3, N) f32, the stored taps; bias (N,) f32 ->
    leaky_relu(conv3x3 + bias) (B, H, W, N) f32. On the card C must be a multiple of 16
    (TMA's 16-byte strides)."""
    _check_conv3x3(xq, sx, wq, sw, bias)
    if xq.device.type != "cpu":
        _build.refuse_grad("int8_conv3x3", xq, sx, wq, sw, bias)
    return torch.ops.tmr.int8_conv3x3(xq, sx, wq, sw, bias, float(negative_slope))


@torch.library.custom_op(
    "tmr::int8_conv3x3", mutates_args=(), device_types="cpu",
    schema="(Tensor xq, Tensor sx, Tensor wq, Tensor sw, Tensor bias, "
           "float negative_slope) -> Tensor")
def _int8_conv3x3_op(xq, sx, wq, sw, bias, negative_slope):
    """The op of :func:`int8_conv3x3`; this, its CPU kernel, is the plain version."""
    return int8_conv3x3_plain(xq, sx, wq, sw, bias, negative_slope)


@_int8_conv3x3_op.register_fake
def _int8_conv3x3_fake(xq, sx, wq, sw, bias, negative_slope):
    return xq.new_empty((*xq.shape[:3], wq.shape[2]), dtype=torch.float32)


@_int8_conv3x3_op.register_kernel("cuda")
def _int8_conv3x3_cuda(xq, sx, wq, sw, bias, negative_slope):
    """The op's CUDA kernel: one launch of ``tmr_int8_conv3x3``, or ``ValueError`` for
    operands the kernel does not take."""
    b, h, w, c, n = _check_conv3x3(xq, sx, wq, sw, bias)
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError("int8_conv3x3: the kernel takes int8 operands")
    if c % 16:
        raise ValueError(f"int8_conv3x3: C = {c}, the kernel takes a multiple of 16")
    xq, wq = xq.contiguous(), wq.contiguous()
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("int8_conv3x3: xq and wq must be 16-byte aligned")
    sx, sw, bias = (t.float().contiguous() for t in (sx, sw, bias))
    out = torch.empty(b, h, w, n, dtype=torch.float32, device=xq.device)
    _build.launch("int8_conv", "int8_mm", "tmr_int8_conv3x3", xq.data_ptr(), sx.data_ptr(),
                  wq.data_ptr(), sw.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, w,
                  c, n, float(negative_slope), _build.stream_of(xq))
    return out
