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
design answers) or raises. Both wrappers are differentiable: each is a
``torch.autograd.Function`` (the counterpart of ``_pallas_attn_vjp`` /
``_pallas_win_vjp`` and their ``jax.custom_vjp`` rules) whose backward,
:func:`attention_backward`, recomputes the scores and the softmax from the saved q, k, v
and tables in query bands, as the JAX backward does through
``blockwise_decomposed_attention``. The backward is PyTorch on both devices (the JAX
package's is XLA, not Pallas); it launches no kernel.

What the kernels take: bf16, contiguous, head dim 64 (SAM ViT-B) or 80 (ViT-H; any
other raises, with no fallback to the plain version); the global kernel takes any token
count whose projections fit in shared memory
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


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The type sums are taken in: f32, or f64 for f64 inputs (``gradcheck``)."""
    return torch.promote_types(dtype, torch.float32)


def bias_projections(
    q: torch.Tensor, rh: torch.Tensor, rw: torch.Tensor, grid_hw: Tuple[int, int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(BH, S, D) q and the expanded (gh, gh, D) / (gw, gw, D) tables -> the f32
    projections rel_h_q (BH, S, gh) and rel_w_q (BH, S, gw)."""
    bh, s, d = q.shape
    gh, gw = grid_hw
    acc = _acc(q.dtype)
    qf = q.to(acc).reshape(bh, gh, gw, d)
    rel_h = torch.einsum("nywd,ykd->nywk", qf, rh.to(acc)).reshape(bh, s, gh)
    rel_w = torch.einsum("nywd,wkd->nywk", qf, rw.to(acc)).reshape(bh, s, gw)
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
    acc = _acc(q.dtype)
    scores = torch.matmul(q.to(acc), k.to(acc).transpose(1, 2)) * scale
    if rel_h_q is not None:
        scores = scores.view(bh, s, gh, gw)
        scores = scores + rel_h_q[..., :, None] + rel_w_q[..., None, :]
        scores = scores.view(bh, s, s)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(p.to(acc), v.to(acc)).to(q.dtype)


#: f32 bytes one (BH, band, S) score tile of :func:`attention_backward` may take; the
#: query bands are whole grid rows cut to fit (at S = 4096, BH 48: 8 rows of 64 tokens,
#: 402 MB a tile, where one dense score tensor would take 3.2 GB)
BACKWARD_TILE_BYTES = 512 * 2 ** 20


def band_rows(bh: int, gh: int, gw: int) -> int:
    """Grid rows per query band of the backward: the largest divisor of ``gh`` whose
    (BH, rows * gw, S) f32 tile fits :data:`BACKWARD_TILE_BYTES` (at least 1)."""
    per_row = bh * gw * gh * gw * 4
    return max([r for r in range(1, gh + 1)
                if gh % r == 0 and r * per_row <= BACKWARD_TILE_BYTES] or [1])


def attention_backward(q, k, v, rh, rw, grid_hw, scale, g):
    """The gradients of both kernels' function (the backward of
    ``blockwise_decomposed_attention``, which the JAX kernels' VJPs take).

    q/k/v/g (BH, S, D); rh (gh, gh, D) / rw (gw, gw, D) the expanded tables, or None for
    no bias. Query bands of :func:`band_rows` grid rows each recompute their scores and
    bias projections (f32) and the softmax over the whole key axis, so no (S, S) tensor
    is held. The forward rounds p to q's dtype before p.v, so dv takes that rounded p;
    the softmax backward takes the f32 p. Sums are f32 (f64 for f64 inputs). Returns
    dq, dk, dv in q's dtype and, with the bias, drh, drw in the tables' dtype."""
    bh, s, d = q.shape
    gh, gw = grid_hw
    acc = _acc(q.dtype)
    qf, kf, vf, gf = (t.to(acc) for t in (q, k, v, g))
    # the scale rides on k, not on the (BH, band, S) tiles
    ks = kf * scale
    kt, vt = ks.transpose(1, 2), vf.transpose(1, 2)
    dq = torch.empty_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    has_bias = rh is not None
    if has_bias:
        rhf, rwf = rh.to(acc), rw.to(acc)
        drh, drw = torch.zeros_like(rhf), torch.zeros_like(rwf)
    rows = band_rows(bh, gh, gw)
    n = rows * gw
    for r0 in range(0, gh, rows):
        band = slice(r0 * gw, r0 * gw + n)
        qc, gc = qf[:, band], gf[:, band]
        scores = torch.matmul(qc, kt)
        if has_bias:
            q4 = qc.reshape(bh, rows, gw, d)
            rel_h = torch.einsum("nywd,ykd->nywk", q4, rhf[r0:r0 + rows])
            rel_w = torch.einsum("nywd,wkd->nywk", q4, rwf)
            s5 = scores.view(bh, rows, gw, gh, gw)
            s5.add_(rel_h[..., :, None]).add_(rel_w[..., None, :])
        p = torch.softmax(scores, dim=-1)
        del scores
        dv.baddbmm_(p.to(q.dtype).to(acc).transpose(1, 2), gc)
        ds = torch.ops.aten._softmax_backward_data(torch.matmul(gc, vt), p, -1, acc)
        del p
        dqc = torch.matmul(ds, ks)
        dk.baddbmm_(ds.transpose(1, 2), qc, alpha=scale)
        if has_bias:
            ds5 = ds.view(bh, rows, gw, gh, gw)
            dsh, dsw = ds5.sum(-1), ds5.sum(-2)
            dqc.view(bh, rows, gw, d).add_(
                torch.einsum("nywk,ykd->nywd", dsh, rhf[r0:r0 + rows])).add_(
                torch.einsum("nywk,wkd->nywd", dsw, rwf))
            drh[r0:r0 + rows] += torch.einsum("nywk,nywd->ykd", dsh, q4)
            drw += torch.einsum("nywk,nywd->wkd", dsw, q4)
        dq[:, band] = dqc
        del ds, dqc
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if has_bias:
        grads += (drh.to(rh.dtype), drw.to(rw.dtype))
    return grads


def compact_table_grad(d_expanded: torch.Tensor, g: int) -> torch.Tensor:
    """The gradient of a compact ``(2g - 1, D)`` table from that of its ``get_rel_pos(g,
    g, .)`` expansion (g, g, D): entry [y, ky] reads row y - ky + g - 1, so each row sums
    its diagonal."""
    idx = (torch.arange(g, device=d_expanded.device)[:, None]
           - torch.arange(g, device=d_expanded.device)[None, :] + (g - 1)).reshape(-1)
    out = d_expanded.new_zeros((2 * g - 1, d_expanded.shape[-1]))
    return out.index_add_(0, idx, d_expanded.reshape(g * g, -1))


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
    computes the bias projections too, from the compact tables. Differentiable in q, k,
    v and both tables (:class:`GlobalAttention`)."""
    if (rel_pos_h is None) != (rel_pos_w is None):
        raise ValueError("global_attention: give both rel-pos tables or neither")
    return GlobalAttention.apply(q, k, v, rel_pos_h, rel_pos_w, tuple(grid_hw),
                                 float(scale))


class GlobalAttention(torch.autograd.Function):
    """:func:`global_attention` with its gradient: the forward is the kernel (the plain
    version on the CPU); the backward is :func:`attention_backward` on the tables'
    expansion, folded back onto the compact tables (:func:`compact_table_grad`)."""

    @staticmethod
    def forward(ctx, q, k, v, rel_pos_h, rel_pos_w, grid_hw, scale):
        ctx.save_for_backward(q, k, v, rel_pos_h, rel_pos_w)
        ctx.grid_hw, ctx.scale = grid_hw, scale
        return _global_forward(q, k, v, rel_pos_h, rel_pos_w, grid_hw, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, ch, cw = ctx.saved_tensors
        gh, gw = ctx.grid_hw
        if ch is None:
            return (*attention_backward(q, k, v, None, None, ctx.grid_hw, ctx.scale, g),
                    None, None, None, None)
        dq, dk, dv, drh, drw = attention_backward(
            q, k, v, get_rel_pos(gh, gh, ch), get_rel_pos(gw, gw, cw), ctx.grid_hw,
            ctx.scale, g)
        return (dq, dk, dv, compact_table_grad(drh, gh), compact_table_grad(drw, gw),
                None, None)


def _global_forward(q, k, v, rel_pos_h, rel_pos_w, grid_hw, scale):
    gh, gw = grid_hw
    has_bias = rel_pos_h is not None
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
    the card one kernel computes the bias projections too, from the tables.
    Differentiable in q, k, v and both tables (:class:`WindowAttention`)."""
    return WindowAttention.apply(q, k, v, rh, rw, tuple(grid_hw), float(scale))


class WindowAttention(torch.autograd.Function):
    """:func:`window_attention` with its gradient: the forward is the kernel (the plain
    version on the CPU), the backward :func:`attention_backward`."""

    @staticmethod
    def forward(ctx, q, k, v, rh, rw, grid_hw, scale):
        ctx.save_for_backward(q, k, v, rh, rw)
        ctx.grid_hw, ctx.scale = grid_hw, scale
        return _window_forward(q, k, v, rh, rw, grid_hw, scale)

    @staticmethod
    def backward(ctx, g):
        return (*attention_backward(*ctx.saved_tensors, ctx.grid_hw, ctx.scale, g),
                None, None)


def _window_forward(q, k, v, rh, rw, grid_hw, scale):
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
