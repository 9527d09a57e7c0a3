"""Rel-pos attention of the SAM ViT: hand-written CUDA kernels and their plain versions.

Replaces ``tmr_tpu/ops/pallas_attn.py``:

- :func:`global_attention` <- ``pallas_decomposed_attention`` (``_attn_kernel`` and
  ``_attn_kernel_nobias``) and ``pallas_fused_attention`` (``_fused_attn_kernel``),
  which compute one function;
- :func:`window_attention` <- ``pallas_windowed_attention`` (``_win_kernel``).

Both take q/k/v as ``(B*H, S, D)`` over a ``(gh, gw)`` token grid and add the decomposed
bias ``rel_h_q[q, ky] + rel_w_q[q, kx]`` to each score, with the f32 projections of the
JAX ``_bias_projections`` (:func:`bias_projections` computes them from the expanded
tables). The global kernel takes the compact tables ``rel_pos_h (2gh - 1, D)`` /
``rel_pos_w (2gw - 1, D)``, which :func:`get_rel_pos` expands into the Toeplitz
``(gh, gh, D)`` / ``(gw, gw, D)`` tables; the windowed kernel takes the expanded tables.
Each kernel computes the projections itself, in shared memory, so an attention block is
one launch that writes nothing to HBM but its output. Softmax statistics and
accumulators are f32; p is rounded to the input dtype before the p.v product, as in
``blockwise_decomposed_attention``.

A wrapper runs the plain version only for CPU tensors; a CUDA tensor launches the
kernel (``csrc/attn.cu``, whose header says what bounds it on the card and how the
design answers) or raises. What the kernels take: bf16, contiguous, head dim 64 (SAM
ViT-B) or 80 (ViT-H; any other raises, with no fallback to the plain version); the
global kernel takes any token count whose projections fit in shared memory
(:func:`global_geometry`: gh + gw up to ~290 at head dim 64, ~195 at 80); the windowed
kernel takes rows of up to 64 tokens and a window whose staging fits in 227 KB
(:func:`window_geometry`).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tmr_tpu_torch.ops import _build

#: dynamic shared memory a block may use on Hopper
_SMEM_LIMIT = 227 * 1024
#: head dims the kernels are instantiated for (SAM ViT-B, ViT-H)
HEAD_DIMS = (64, 80)


def interp_rel_pos(rel_pos: torch.Tensor, target_len: int) -> torch.Tensor:
    """Linear resize of an (L, C) table to (target_len, C), align_corners=False."""
    if rel_pos.shape[0] == target_len:
        return rel_pos
    return F.interpolate(rel_pos.t()[None], size=target_len, mode="linear",
                         align_corners=False)[0].t()


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(q_size, k_size, C) relative-position table lookup."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    rel = interp_rel_pos(rel_pos, max_rel_dist)
    # the index is built on the table's device: a host-made index would be a pageable
    # copy per block, each one stalling the host until the device catches up
    ar = functools.partial(torch.arange, dtype=torch.float64, device=rel_pos.device)
    q_coords = ar(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = ar(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel_coords = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel[rel_coords.long()]


def bias_projections(
    q: torch.Tensor, rh: torch.Tensor, rw: torch.Tensor, grid_hw: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, S, D) q and the expanded (gh, gh, D) / (gw, gw, D) tables -> the f32
    projections rel_h_q (BH, S, gh) and rel_w_q (BH, S, gw)."""
    bh, s, d = q.shape
    gh, gw = grid_hw
    qf = q.float().reshape(bh, gh, gw, d)
    rel_h = torch.einsum("nywd,ykd->nywk", qf, rh.float()).reshape(bh, s, gh)
    rel_w = torch.einsum("nywd,wkd->nywk", qf, rw.float()).reshape(bh, s, gw)
    return rel_h.contiguous(), rel_w.contiguous()


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_h_q: Optional[torch.Tensor],
    rel_w_q: Optional[torch.Tensor],
    grid_hw: Tuple[int, int],
    scale: float,
) -> torch.Tensor:
    """The plain version of both kernels: dense f32 scores, f32 softmax over the full
    key axis, p rounded to the input dtype, f32 p.v (the semantics of the JAX
    ``blockwise_decomposed_attention``)."""
    bh, s, _ = q.shape
    gh, gw = grid_hw
    scores = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if rel_h_q is not None:
        scores = scores.view(bh, s, gh, gw)
        scores = scores + rel_h_q[..., :, None] + rel_w_q[..., None, :]
        scores = scores.view(bh, s, s)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _check(q, k, v, what: str) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous bf16, got {t.dtype}"
                             + ("" if t.is_contiguous() else ", not contiguous"))
        if t.shape != q.shape:
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != q {tuple(q.shape)}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what}: the kernel takes head dim 64 or 80, got {q.shape[-1]}")


def _counter(kernel: str, d: int) -> str:
    """The launch count of a kernel's head dim 64 or 80 instantiation."""
    return kernel if d == 64 else f"{kernel}_d{d}"


def global_geometry(gh: int, gw: int, has_bias: bool = True, d: int = 64) -> int:
    """Shared bytes of the global kernel for a (gh, gw) grid at head dim ``d``, as
    ``csrc/attn.cu`` ``launch_global`` sets them up: alignment slack, the 128-row Q tile
    in ceil(d / 64) panels of 64 columns, a ring of K/V stages (d = 64: 3 of 128 keys with
    the bias on 64-token grid rows, else 4 of 64; d = 80: 3 of 64), their mbarriers and,
    with the bias, the (128, gh | 1) and (128, gw | 1) f32 projections. Raises
    ``ValueError`` over 227 KB."""
    if gh < 1 or gw < 1:
        raise ValueError(f"global_attention: empty {gh}x{gw} grid")
    panels = -(-d // 64)
    if panels == 1:
        stages, keys = (3, 128) if has_bias and gw == 64 else (4, 64)
    else:
        stages, keys = 3, 64
    smem = (1024 + panels * 128 * 128 + stages * 2 * panels * keys * 128
            + (1 + 2 * stages) * 8)
    if has_bias:
        smem += 128 * ((gh | 1) + (gw | 1)) * 4
    if smem > _SMEM_LIMIT:
        raise ValueError(f"global_attention: a {gh}x{gw} grid needs {smem} B of shared "
                         f"memory, over the {_SMEM_LIMIT} B a block may use")
    return smem


def global_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_pos_h: Optional[torch.Tensor],
    rel_pos_w: Optional[torch.Tensor],
    grid_hw: Tuple[int, int],
    scale: float,
) -> torch.Tensor:
    """Global attention over the whole (gh, gw) grid with the decomposed rel-pos bias:
    ``rel_pos_h (2gh - 1, D)`` / ``rel_pos_w (2gw - 1, D)`` are the compact tables
    (``interp_rel_pos`` of the parameters; None: no bias). On the card one kernel
    computes the bias projections too, from the compact tables."""
    gh, gw = grid_hw
    has_bias = rel_pos_h is not None
    if has_bias != (rel_pos_w is not None):
        raise ValueError("global_attention: give both rel-pos tables or neither")
    if q.device.type == "cpu":
        rel = (bias_projections(q, get_rel_pos(gh, gh, rel_pos_h),
                                get_rel_pos(gw, gw, rel_pos_w), grid_hw)
               if has_bias else (None, None))
        return attention_plain(q, k, v, *rel, grid_hw, scale)
    _check(q, k, v, "global_attention")
    bh, s, d = q.shape
    if s != gh * gw:
        raise ValueError(f"global_attention: S={s} is not the {gh}x{gw} grid's")
    global_geometry(gh, gw, has_bias, d)
    if has_bias:
        rel_pos_h, rel_pos_w = (t.to(q.device, torch.float32).contiguous()
                                for t in (rel_pos_h, rel_pos_w))
        if rel_pos_h.shape != (2 * gh - 1, d) or rel_pos_w.shape != (2 * gw - 1, d):
            raise ValueError(f"global_attention: tables {tuple(rel_pos_h.shape)} / "
                             f"{tuple(rel_pos_w.shape)} are not the compact tables of a "
                             f"{gh}x{gw} grid")
    out = torch.empty_like(q)
    _build.launch(
        _counter("global_attn", d), "attn", "tmr_global_attn",
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        rel_pos_h.data_ptr() if has_bias else None,
        rel_pos_w.data_ptr() if has_bias else None,
        out.data_ptr(), bh, s, gh, gw, d, float(scale), int(has_bias),
        _build.stream_of(q),
    )
    return out


def window_geometry(gh: int, gw: int, d: int = 64) -> Tuple[int, int, int]:
    """The windowed kernel's staging for a (gh, gw) window at head dim ``d``, as
    ``csrc/attn.cu`` ``launch_window`` sets it up: key slots in grid rows of ``gwp`` (8,
    16, 32 or 64 >= gw), ``ghp`` key rows (gh, or gh + 1 to make the 8-slot tiles even),
    query rows padded to ``sp`` (a multiple of 16), bf16 rows of 2d bytes. Returns (gwp,
    ghp, shared bytes); raises ``ValueError`` for a window the kernel does not take (rows
    over 64 tokens, or staging over 227 KB)."""
    if not 1 <= gw <= 64 or gh < 1:
        raise ValueError(f"window_attention: the kernel takes window rows of 1..64 tokens, "
                         f"got a {gh}x{gw} window")
    gwp = next(p for p in (8, 16, 32, 64) if gw <= p)
    ghp = gh + (gh * gwp // 8) % 2
    sp = -(-gh * gw // 16) * 16
    st_h = (gh + 1) | 1
    smem = (sp + 2 * ghp * gwp) * d * 2 + sp * (st_h + gwp) * 4
    if smem > _SMEM_LIMIT:
        raise ValueError(f"window_attention: a {gh}x{gw} window needs {smem} B of shared "
                         f"memory, over the {_SMEM_LIMIT} B a block may use")
    return gwp, ghp, smem


def window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rh: torch.Tensor,
    rw: torch.Tensor,
    grid_hw: Tuple[int, int],
    scale: float,
) -> torch.Tensor:
    """Whole-window attention with the rel-pos bias: q/k/v (windows*heads, gh*gw, D). On
    the card one kernel computes the bias projections too, from the tables."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, *bias_projections(q, rh, rw, grid_hw), grid_hw,
                               scale)
    _check(q, k, v, "window_attention")
    bh, s, d = q.shape
    gh, gw = grid_hw
    if s != gh * gw:
        raise ValueError(f"window_attention: S={s} is not the {gh}x{gw} window's")
    window_geometry(gh, gw, d)
    rh, rw = (t.to(q.device, torch.float32).contiguous() for t in (rh, rw))
    if rh.shape != (gh, gh, d) or rw.shape != (gw, gw, d):
        raise ValueError(f"window_attention: tables {tuple(rh.shape)} / {tuple(rw.shape)} "
                         f"do not fit a {gh}x{gw} window")
    out = torch.empty_like(q)
    _build.launch(
        _counter("window_attn", d), "attn", "tmr_window_attn",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(), rw.data_ptr(),
        out.data_ptr(), bh, s, gh, gw, d, float(scale), _build.stream_of(q),
    )
    return out
