"""Depthwise template cross-correlation: a hand-written CUDA kernel and its plain version.

Replaces ``tmr_tpu/ops/pallas_xcorr.py`` (``xcorr_pallas`` / ``_xcorr_kernel``): the
SAME-padded depthwise correlation of a ``(B, C, H, W)`` map with per-image templates
``(B, C, T, T)``, T odd, no kernel flip, zero padding ``T // 2`` before and
``T - 1 - T // 2`` after, f32 accumulation. The port's direct path serves every bucket
up to :data:`MAX_T` (65); larger buckets take the FFT path in ``ops/xcorr.py``.

:func:`xcorr_int8` is the int8 variant, the counterpart of the XLA integer grouped
convolution in ``tmr_tpu/ops/xcorr.py`` (``_xcorr_int8dot``): int8 feature and template,
the sum exact in int32, then ``float(acc) * (f_scale * t_scale)`` per (image, channel).
PyTorch has no int8 grouped convolution on CUDA, and an f32 run of int8 values is not
exact past 2^24, so it is a hand-written kernel of its own in the same source.

On the card, both run on the tensor cores, each template row as a Toeplitz band in
``mma.sync`` products: :func:`xcorr` in TF32, in three passes of the operands' tf32 splits
(3xTF32, f32 grade); :func:`xcorr_int8` in s8 (m16n8k32), one pass with one exact int32
sum (:func:`int8_geometry` mirrors its launch geometry).

The wrapper runs the plain version (the T^2 shifted multiply-adds of the Pallas kernel)
only for CPU tensors (both wrappers); a CUDA tensor launches ``csrc/xcorr.cu`` (its
header says what bounds it on the card and how each kernel is laid out) or raises. The
kernels have no backward: on the card an input that requires grad raises while grad mode
is on (``_build.refuse_grad``); the train forward correlates through the FFT path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tmr_tpu_torch.ops import _build

#: largest template the kernel takes (its staged tile grows with T)
MAX_T = 65

#: the int8 kernel's CTA tile (output rows, columns) and the zero bytes staged before each
#: template row (``csrc/xcorr.cu`` I8_BM, I8_BN, I8_TPAD)
INT8_BM, INT8_BN, INT8_TPAD = 64, 128, 12


def int8_geometry(t: int) -> dict:
    """The int8 kernel's geometry for template size ``t``, as ``csrc/xcorr.cu`` computes it
    (``i8_kb``, ``i8_k16``, ``i8_cols``, ``i8_pitch``, ``i8_smem_bytes``). The window starts at the
    16-aligned column ``x0 - c - e``, ``e = (-c) mod 16``; ``delta = e & ~3`` goes into the
    A-fragment index and ``rho = e & 3`` into the band. ``kb``: k-blocks per n8 column
    tile, 32 deep (``mma.sync`` m16n8k32) but for the last, which is 16 deep (m16n8k16)
    where ``k16``; ``depth``: the band's depth the products run over; ``cols``/``pitch``: the staged window's bytes per row and its row pitch;
    ``tpitch``: a staged template row; ``smem``: shared bytes of a CTA. Raises
    ``ValueError`` for a size the kernel does not take."""
    if not (1 <= t <= MAX_T and t % 2):
        raise ValueError(f"xcorr_int8: the kernel takes odd T <= {MAX_T}, got {t}")
    e = (-(t // 2)) % 16
    delta, rho = e & ~3, e & 3
    kb = -(-(t + 7 + rho) // 32)
    k16 = t + 7 + rho - 32 * (kb - 1) <= 16
    cols = -(-(delta + INT8_BN + 32 * kb - 8) // 16) * 16
    pitch = -(-(cols - 16) // 32) * 32 + 16
    tpitch = 32 * kb + 16
    return dict(kb=kb, k16=k16, depth=32 * kb - 16 * k16, delta=delta, rho=rho, cols=cols,
                pitch=pitch, tpitch=tpitch, smem=(INT8_BM + t - 1) * pitch + t * tpitch)


def xcorr_plain(feature: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """T^2 shifted products accumulated in f32, in the Pallas kernel's order."""
    _, _, h, w = feature.shape
    t = template.shape[-1]
    c = t // 2
    fpad = F.pad(feature.float(), (c, t - 1 - c, c, t - 1 - c))
    tmpl = template.float()
    acc = torch.zeros(feature.shape, dtype=torch.float32, device=feature.device)
    for i in range(t):
        for j in range(t):
            acc = acc + fpad[:, :, i:i + h, j:j + w] * tmpl[:, :, i, j, None, None]
    return acc


def xcorr(feature: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """SAME-padded depthwise correlation, f32 result (B, C, H, W)."""
    b, c, h, w = feature.shape
    t = template.shape[-1]
    if template.shape != (b, c, t, t) or t % 2 == 0:
        raise ValueError(
            f"xcorr: template {tuple(template.shape)} must be (B, C, T, T), T odd")
    if feature.device.type == "cpu":
        return xcorr_plain(feature, template)
    _build.refuse_grad("xcorr", feature, template)
    if feature.dtype != torch.float32 or template.dtype != torch.float32:
        raise ValueError("xcorr: the kernel takes f32 feature and template")
    if t > MAX_T:
        raise ValueError(f"xcorr: the kernel takes T <= {MAX_T}, got {t}")
    feature = feature.contiguous()
    template = template.contiguous()
    out = torch.empty_like(feature)
    _build.launch("xcorr", "xcorr", "tmr_xcorr", feature.data_ptr(),
                  template.data_ptr(), out.data_ptr(), b * c, h, w, t,
                  _build.stream_of(feature))
    return out


def xcorr_int8_plain(feature: torch.Tensor, template: torch.Tensor, f_scale: torch.Tensor,
                     t_scale: torch.Tensor) -> torch.Tensor:
    """T^2 shifted int8 products summed in int32, then the kernel's epilogue."""
    _, _, h, w = feature.shape
    t = template.shape[-1]
    c = t // 2
    fpad = F.pad(feature.int(), (c, t - 1 - c, c, t - 1 - c))
    tmpl = template.int()
    acc = torch.zeros(feature.shape, dtype=torch.int32, device=feature.device)
    for i in range(t):
        for j in range(t):
            acc += fpad[:, :, i:i + h, j:j + w] * tmpl[:, :, i, j, None, None]
    return acc.float() * (f_scale.float() * t_scale.float())


def xcorr_int8(feature: torch.Tensor, template: torch.Tensor, f_scale: torch.Tensor,
               t_scale: torch.Tensor) -> torch.Tensor:
    """feature (B, C, H, W) int8, template (B, C, T, T) int8, scales (B, C, 1, 1) f32 ->
    the SAME-padded correlation (B, C, H, W) f32."""
    b, c, h, w = feature.shape
    t = template.shape[-1]
    if (template.shape != (b, c, t, t) or t % 2 == 0
            or f_scale.shape != (b, c, 1, 1) or t_scale.shape != (b, c, 1, 1)):
        raise ValueError(
            f"xcorr_int8: feature {tuple(feature.shape)}, template "
            f"{tuple(template.shape)} (T odd), scales {tuple(f_scale.shape)} / "
            f"{tuple(t_scale.shape)} must be (B, C, 1, 1)")
    if feature.device.type == "cpu":
        return xcorr_int8_plain(feature, template, f_scale, t_scale)
    _build.refuse_grad("xcorr_int8", feature, template, f_scale, t_scale)
    if feature.dtype != torch.int8 or template.dtype != torch.int8:
        raise ValueError("xcorr_int8: the kernel takes int8 feature and template")
    int8_geometry(t)
    feature = feature.contiguous()
    template = template.contiguous()
    f_scale = f_scale.float().contiguous()
    t_scale = t_scale.float().contiguous()
    out = torch.empty(feature.shape, dtype=torch.float32, device=feature.device)
    _build.launch("xcorr_int8", "xcorr", "tmr_xcorr_int8", feature.data_ptr(),
                  template.data_ptr(), f_scale.data_ptr(), t_scale.data_ptr(),
                  out.data_ptr(), b * c, h, w, t, _build.stream_of(feature))
    return out
