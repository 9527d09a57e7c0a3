"""Rel-pos attention of the SAM ViT: hand-written CUDA kernels and their plain versions.

Replaces ``tmr_tpu/ops/pallas_attn.py``:

- :func:`global_attention` <- ``pallas_decomposed_attention`` (``_attn_kernel`` and
  ``_attn_kernel_nobias``) and ``pallas_fused_attention`` (``_fused_attn_kernel``),
  which compute one function;
- :func:`window_attention` <- ``pallas_windowed_attention`` (``_win_kernel``).

Both take q/k/v as ``(B*H, S, D)`` over an ``(gh, gw)`` token grid and the
``get_rel_pos`` tables ``rh (gh, gh, D)`` / ``rw (gw, gw, D)``, and add the decomposed
bias ``rel_h_q[q, ky] + rel_w_q[q, kx]`` to each score, with the f32 projections of the
JAX ``_bias_projections``. The global kernel takes the projections, computed here by
:func:`bias_projections` (two small ``torch.einsum`` products); its module-private entry
``_global_attention_kernel`` takes them given, so it can be called and timed alone. The
windowed kernel computes them itself from the tables, in shared memory, so a windowed
block is one launch and writes nothing to HBM but its output. Softmax statistics and
accumulators are f32; p is rounded to the input dtype before the p.v product, as in
``blockwise_decomposed_attention``.

A wrapper runs the plain version only for CPU tensors; a CUDA tensor launches the
kernel (``csrc/attn.cu``, whose header says what bounds it on the card and how the
design answers) or raises. What the kernels take: bf16, head dim 64, contiguous; the
global kernel needs ``S % 64 == 0``; the windowed kernel takes rows of up to 64 tokens
and a window whose staging fits in 227 KB of shared memory (:func:`window_geometry`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tmr_tpu_torch.ops import _build

#: dynamic shared memory a block may use on Hopper
_SMEM_LIMIT = 227 * 1024


def bias_projections(
    q: torch.Tensor, rh: torch.Tensor, rw: torch.Tensor, grid_hw: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, S, D) q and the (gh, gh, D) / (gw, gw, D) tables -> the f32 projections
    rel_h_q (BH, S, gh) and rel_w_q (BH, S, gw)."""
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
            raise ValueError(f"{what}: {name} must be contiguous bf16, got {t.dtype}")
        if t.shape != q.shape:
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)} != q {tuple(q.shape)}")
    if q.shape[-1] != 64:
        raise ValueError(f"{what}: the kernel takes head dim 64, got {q.shape[-1]}")


def _global_attention_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_h_q: Optional[torch.Tensor],
    rel_w_q: Optional[torch.Tensor],
    grid_hw: Tuple[int, int],
    scale: float,
) -> torch.Tensor:
    """The global kernel on given projections (``rel_h_q`` None: no bias)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, rel_h_q, rel_w_q, grid_hw, scale)
    _check(q, k, v, "global_attention")
    bh, s, _ = q.shape
    if s % 64:
        raise ValueError(f"global_attention: the kernel needs S % 64 == 0, got S={s}")
    gh, gw = grid_hw
    out = torch.empty_like(q)
    has_bias = rel_h_q is not None
    _build.launch(
        "global_attn", "attn", "tmr_global_attn",
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        rel_h_q.data_ptr() if has_bias else None,
        rel_w_q.data_ptr() if has_bias else None,
        out.data_ptr(), bh, s, gh, gw, float(scale), int(has_bias),
        _build.stream_of(q),
    )
    return out


def global_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rh: Optional[torch.Tensor],
    rw: Optional[torch.Tensor],
    grid_hw: Tuple[int, int],
    scale: float,
) -> torch.Tensor:
    """Global attention with the decomposed rel-pos bias (``rh`` None: no bias)."""
    rel = bias_projections(q, rh, rw, grid_hw) if rh is not None else (None, None)
    return _global_attention_kernel(q, k, v, *rel, grid_hw, scale)


def window_geometry(gh: int, gw: int) -> Tuple[int, int, int]:
    """The windowed kernel's staging for a (gh, gw) window, as ``csrc/attn.cu``
    ``launch_window`` sets it up: key slots in grid rows of ``gwp`` (8, 16, 32 or 64 >= gw),
    ``ghp`` key rows (gh, or gh + 1 to make the 8-slot tiles even), query rows padded to
    ``sp`` (a multiple of 16). Returns (gwp, ghp, shared bytes); raises ``ValueError`` for a
    window the kernel does not take (rows over 64 tokens, or staging over 227 KB)."""
    if not 1 <= gw <= 64 or gh < 1:
        raise ValueError(f"window_attention: the kernel takes window rows of 1..64 tokens, "
                         f"got a {gh}x{gw} window")
    gwp = next(p for p in (8, 16, 32, 64) if gw <= p)
    ghp = gh + (gh * gwp // 8) % 2
    sp = -(-gh * gw // 16) * 16
    st_h = (gh + 1) | 1
    smem = (sp + 2 * ghp * gwp) * 64 * 2 + sp * (st_h + gwp) * 4
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
    bh, s, _ = q.shape
    gh, gw = grid_hw
    if s != gh * gw:
        raise ValueError(f"window_attention: S={s} is not the {gh}x{gw} window's")
    window_geometry(gh, gw)
    rh, rw = (t.to(q.device, torch.float32).contiguous() for t in (rh, rw))
    if rh.shape != (gh, gh, 64) or rw.shape != (gw, gw, 64):
        raise ValueError(f"window_attention: tables {tuple(rh.shape)} / {tuple(rw.shape)} "
                         f"do not fit a {gh}x{gw} window")
    out = torch.empty_like(q)
    _build.launch(
        "window_attn", "attn", "tmr_window_attn",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(), rw.data_ptr(),
        out.data_ptr(), bh, s, gh, gw, float(scale), _build.stream_of(q),
    )
    return out
