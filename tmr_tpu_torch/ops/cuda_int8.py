"""int8 x int8 -> int32 matrix product with an f32 scale epilogue: a hand-written CUDA
kernel and its plain version.

Replaces ``tmr_tpu/ops/pallas_int8.py`` (``int8_matmul`` / ``_int8_mm_kernel``):
``out[m, n] = float(sum_k x[m, k] * w[n, k]) * (x_scale[m] * w_scale[n])``, the sum exact
in int32. The weight is taken as ``(N, K)``, K contiguous (the layout int8 storage keeps,
``ops/quant.quantize_conv``), where the JAX function takes ``(K, N)``.

``x_q`` may be a strided view of up to four dims ``(B, H, W, K)`` whose last dim is
contiguous: a 3x3 tap passes its shifted window of the padded activation as it stands and
the kernel addresses the rows through the strides, so no copy of the window is made.

The wrapper runs the plain version only for CPU tensors; a CUDA tensor launches
``csrc/int8_mm.cu`` (its header says what bounds it on the card) or raises.
"""

from __future__ import annotations

import torch

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
    if x_q.device.type == "cpu":
        return int8_mm_plain(x_q, w_q, x_scale, w_scale)
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
