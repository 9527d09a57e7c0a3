"""The f32 attention kernels (``csrc/attn_f32.cu``, ``compute_dtype="float32"``) on the
CPU: the wrappers' dtype dispatch and refusals, the shared-memory geometry against a
mirror of the C side's formula, and a numpy model of the kernels' arithmetic (64-row
query tiles, 32-key tiles, online softmax in exp2, 3xTF32 products, the projections
times log2 e, each key's (ky, kx) stepped as a lane steps them) against the JAX
package's attention in f32, alone and through the TINY Predictor in place of the
wrappers' plain version.

Tolerances: the model against the JAX function, per element 2e-5 x max|want| (chip_smoke's
f32 attention tier: 3xTF32 is about 2^-21 a product; the sums run in another order);
through the whole TINY slice, the maps within 1e-4 as ``tests/test_torch_predictor.py``
holds the plain version."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tmr_tpu.models.vit import blockwise_decomposed_attention  # noqa: E402
from tmr_tpu.models.vit import get_rel_pos as jax_get_rel_pos  # noqa: E402
from tmr_tpu.ops.pallas_attn import pallas_windowed_attention  # noqa: E402
from test_torch_predictor import EXEMPLARS, SIZE, TINY, TINY_H80, _make_pair  # noqa: E402
from tmr_tpu_torch.models import vit  # noqa: E402
from tmr_tpu_torch.ops import _build, cuda_attn  # noqa: E402

F32_TOL = 2e-5
LIMIT = 227 * 1024
BQ, BK = 64, 32  # csrc/attn_f32.cu: query rows of a CTA, keys of a tile
LOG2E = np.float32(1.4426950408889634)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------------ dispatch and refusals
def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtypes,ok", [
    ((torch.bfloat16,) * 3, True),
    ((torch.float32,) * 3, True),
    ((torch.float16,) * 3, False),
    ((torch.float32, torch.bfloat16, torch.float32), False),
    ((torch.bfloat16, torch.bfloat16, torch.float32), False),
    ((torch.float64,) * 3, False),
])
def test_check_takes_bf16_or_f32_of_one_dtype(dtypes, ok):
    q, k, v = (torch.zeros(2, 196, 64, dtype=dt) for dt in dtypes)
    if ok:
        cuda_attn._check(q, k, v, "test")
    else:
        with pytest.raises(ValueError, match="bf16 or f32|as q is"):
            cuda_attn._check(q, k, v, "test")


@pytest.mark.parametrize("d", [16, 72, 96])
def test_f32_kernels_refuse_other_head_dims(d):
    q = torch.zeros(2, 49, d)
    with pytest.raises(ValueError, match="head dim 64 or 80"):
        cuda_attn._check(q, q.clone(), q.clone(), "test")


def test_f32_kernels_refuse_unaligned_operands():
    base = torch.zeros(2 * 49 * 64 + 1)
    q = base[1:].view(2, 49, 64)  # 4 bytes past an aligned start
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_attn._check(q, q, q, "test")


@pytest.fixture
def launches(monkeypatch):
    """Stand-ins for the C launcher on meta tensors (a tensor that is not on the CPU takes
    the kernel route): each call recorded as (counter, library, function, args)."""
    calls = []
    monkeypatch.setattr(_build, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    return calls


@pytest.mark.parametrize("dtype,d,counter,lib,fn", [
    (torch.float32, 64, "global_attn_f32", "attn_f32", "tmr_global_attn_f32"),
    (torch.float32, 80, "global_attn_f32_d80", "attn_f32", "tmr_global_attn_f32"),
    (torch.bfloat16, 64, "global_attn", "attn", "tmr_global_attn"),
    (torch.bfloat16, 80, "global_attn_d80", "attn", "tmr_global_attn"),
])
def test_global_attention_dispatches_by_dtype(launches, dtype, d, counter, lib, fn):
    gh, gw = 6, 7
    q = _meta((3, gh * gw, d), dtype)
    out = cuda_attn.global_attention(q, q, q, _meta((2 * gh - 1, d), torch.float32),
                                     _meta((2 * gw - 1, d), torch.float32), (gh, gw), 0.125)
    assert out.dtype == dtype and out.shape == q.shape
    (call,) = launches
    assert call[:3] == (counter, lib, fn)
    assert counter in _build.LAUNCHES
    # bh, s, gh, gw, d, scale after the six pointers
    assert call[9:15] == (3, gh * gw, gh, gw, d, 0.125)


@pytest.mark.parametrize("dtype,d,counter,lib,fn", [
    (torch.float32, 64, "window_attn_f32", "attn_f32", "tmr_window_attn_f32"),
    (torch.float32, 80, "window_attn_f32_d80", "attn_f32", "tmr_window_attn_f32"),
    (torch.bfloat16, 64, "window_attn", "attn", "tmr_window_attn"),
    (torch.bfloat16, 80, "window_attn_d80", "attn", "tmr_window_attn"),
])
def test_window_attention_dispatches_by_dtype(launches, dtype, d, counter, lib, fn):
    q = _meta((5, 196, d), dtype)
    out = cuda_attn.window_attention(q, q, q, _meta((14, 14, d), torch.float32),
                                     _meta((14, 14, d), torch.float32), (14, 14), 0.125)
    assert out.dtype == dtype and out.shape == q.shape
    (call,) = launches
    assert call[:3] == (counter, lib, fn)
    assert call[9:15] == (5, 196, 14, 14, d, 0.125)


def test_kernel_routes_refuse_what_they_do_not_take(launches):
    """f16 and mixed dtypes raise on the kernel route; the f32 global kernel takes the
    bias only (SAM always has it; f32 without it is not ported): nothing launches and
    nothing falls back to the plain version."""
    t = _meta((2, 49, 64), torch.float32)
    with pytest.raises(ValueError, match="takes the rel-pos bias"):
        cuda_attn.global_attention(t, t, t, None, None, (7, 7), 0.125)
    h = _meta((2, 49, 64), torch.float16)
    tab = _meta((7, 7, 64), torch.float32)
    with pytest.raises(ValueError, match="bf16 or f32"):
        cuda_attn.window_attention(h, h, h, tab, tab, (7, 7), 0.125)
    b = _meta((2, 49, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="as q is"):
        cuda_attn.window_attention(t, b, t, tab, tab, (7, 7), 0.125)
    assert launches == []


def test_every_f32_instantiation_has_a_counter():
    assert {cuda_attn._counter(k, d, torch.float32) for k in ("global_attn", "window_attn")
            for d in (64, 80)} == {"global_attn_f32", "global_attn_f32_d80",
                                   "window_attn_f32", "window_attn_f32_d80"}
    assert set(_build.SIGNATURES["attn_f32"]) == {"tmr_global_attn_f32",
                                                  "tmr_window_attn_f32"}
    assert (_build.CSRC / "attn_f32.cu").is_file()


# ------------------------------------------------------------------------ geometry
def _f32_smem_mirror(gh, gw, d):
    """csrc/attn_f32.cu smem_bytes: the Q tile and two stages of K and V tiles in rows of
    d + 4 floats, and the (BQ, gh | 1) + (BQ, gw | 1) f32 projections."""
    return ((BQ + 4 * BK) * (d + 4) + BQ * ((gh | 1) + (gw | 1))) * 4


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("grid", [(64, 64), (96, 96), (24, 40), (5, 7), (14, 14), (7, 64)])
def test_f32_geometry_mirrors_the_c_side_and_fits(grid, d):
    smem = cuda_attn.geometry_f32(*grid, d)
    assert smem == _f32_smem_mirror(*grid, d) <= LIMIT


@pytest.mark.parametrize("d", [64, 80])
def test_f32_geometry_refuses_what_does_not_fit(d):
    with pytest.raises(ValueError, match="shared memory"):
        cuda_attn.geometry_f32(400, 400, d)
    with pytest.raises(ValueError, match="empty"):
        cuda_attn.geometry_f32(0, 5, d)


# ------------------------------------------------------- the kernels' arithmetic
def _tf32_rna(x):
    """cvt.rna.tf32.f32 for finite f32 values: half a tf32 ulp added, 13 bits cleared."""
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return (((b + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def _mm3(a, b):
    """3xTF32: lo*hi + hi*lo + hi*hi of the split operands, each product exact (tf32 x
    tf32 fits f32), the sums rounded to f32."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    f = lambda x: x.astype(np.float64)  # noqa: E731
    return (f(al) @ f(bh) + f(ah) @ f(bl) + f(ah) @ f(bh)).astype(np.float32)


def _stepped_keys(s, gw):
    """Each key's (ky, kx) as the kernel's lanes step them: lane t of a tile starts at key
    kt * BK + 2t by one divide, then steps 1 to its second column and 7 to the next n8
    tile, wrapping kx past gw."""
    ky_of, kx_of = np.zeros(s, np.int64), np.zeros(s, np.int64)
    for kt in range(-(-s // BK)):
        for t in range(4):
            j0 = kt * BK + 2 * t
            ky, kx = j0 // gw, j0 - (j0 // gw) * gw
            for nb in range(4):
                for e in range(2):
                    j = j0 + nb * 8 + e
                    if j < s:
                        ky_of[j], kx_of[j] = ky, kx
                    kx += 1 if e == 0 else 7
                    while kx >= gw:
                        kx -= gw
                        ky += 1
    return ky_of, kx_of


def _model(q, k, v, th, tw, grid, scale, compact):
    """The f32 kernels' arithmetic in numpy: q/k/v (BH, S, D) f32; th/tw the compact
    (2g - 1, D) tables (the global entry) or the expanded (g, g, D) ones (the windowed)."""
    gh, gw = grid
    bh, s, d = q.shape
    ky, kx = _stepped_keys(s, gw)
    ys, xs = np.arange(s) // gw, np.arange(s) % gw
    if compact:
        rh = th[ys[:, None] - np.arange(gh)[None] + gh - 1]   # (S, gh, D)
        rw = tw[xs[:, None] - np.arange(gw)[None] + gw - 1]   # (S, gw, D)
    else:
        rh, rw = th[ys], tw[xs]
    relh = (np.einsum("nsd,scd->nsc", q.astype(np.float64), rh).astype(np.float32)
            * LOG2E)
    relw = (np.einsum("nsd,scd->nsc", q.astype(np.float64), rw).astype(np.float32)
            * LOG2E)
    qs = q * np.float32(np.float32(scale) * LOG2E)
    m = np.full((bh, s), -np.inf, np.float32)
    l = np.zeros((bh, s), np.float32)
    o = np.zeros((bh, s, d), np.float32)
    nk = -(-s // BK) * BK
    kp = np.zeros((bh, nk, d), np.float32)
    vp = np.zeros((bh, nk, d), np.float32)
    kp[:, :s], vp[:, :s] = k, v
    for j0 in range(0, s, BK):
        cols = np.arange(j0, j0 + BK)
        live = cols < s
        sc = np.stack([_mm3(qs[n], kp[n, j0:j0 + BK].T) for n in range(bh)])
        jj = np.minimum(cols, s - 1)
        sc = sc + (relh[:, :, ky[jj]] + relw[:, :, kx[jj]])
        sc[:, :, ~live] = -np.inf
        mx = np.maximum(m, sc.max(-1))
        alpha = np.exp2(m - mx)
        p = np.exp2(sc - mx[..., None]).astype(np.float32)
        l = l * alpha + p.sum(-1)
        pv = np.stack([_mm3(p[n], vp[n, j0:j0 + BK]) for n in range(bh)])
        o = (o * alpha[..., None] + pv).astype(np.float32)
        m = mx
    return (o / l[..., None]).astype(np.float32)


@pytest.mark.parametrize("gw", [1, 5, 7, 8, 14, 40, 64])
def test_lanes_step_each_key_to_its_grid_cell(gw):
    s = 3 * gw + 17
    ky, kx = _stepped_keys(s, gw)
    np.testing.assert_array_equal(ky, np.arange(s) // gw)
    np.testing.assert_array_equal(kx, np.arange(s) % gw)


def _inputs(seed, bh, grid, d, compact):
    rng = np.random.default_rng(seed)
    s = grid[0] * grid[1]
    q, k, v = (rng.standard_normal((bh, s, d)).astype(np.float32) for _ in range(3))
    if compact:
        th, tw = ((rng.standard_normal((2 * g - 1, d)) * 0.2).astype(np.float32)
                  for g in grid)
    else:
        th, tw = ((rng.standard_normal((g, g, d)) * 0.2).astype(np.float32) for g in grid)
    return q, k, v, th, tw


def _assert_f32_tier(got, want):
    err = np.abs(got - want).max()
    assert err <= F32_TOL * np.abs(want).max(), (err, np.abs(want).max())


# the main path's 64-token rows (cut to 4 rows), rows that are not one key tile (6x40),
# one partial tile (5x7), one-token rows (9x1), at both head dims
@pytest.mark.parametrize("grid,d", [((4, 64), 64), ((6, 40), 64), ((5, 7), 64),
                                    ((9, 1), 64), ((4, 64), 80), ((5, 7), 80)])
def test_global_model_matches_jax(grid, d):
    q, k, v, th, tw = _inputs(11, 2, grid, d, True)
    scale = d ** -0.5
    got = _model(q, k, v, th, tw, grid, scale, True)
    rh, rw = (np.asarray(jax_get_rel_pos(g, g, jnp.asarray(t))) for g, t in zip(grid, (th, tw)))
    want = np.asarray(blockwise_decomposed_attention(
        *(jnp.asarray(a[None]) for a in (q, k, v)), jnp.asarray(rh), jnp.asarray(rw), grid,
        scale))[0]
    _assert_f32_tier(got, want)


# SAM's 14x14 windows, 7x7 (one tile row of keys), 16x16 (whole key tiles)
@pytest.mark.parametrize("window,d", [(14, 64), (7, 64), (16, 64), (14, 80)])
def test_window_model_matches_pallas(window, d):
    grid = (window, window)
    q, k, v, th, tw = _inputs(12, 2, grid, d, False)
    scale = d ** -0.5
    got = _model(q, k, v, th, tw, grid, scale, False)
    want = np.asarray(pallas_windowed_attention(
        *(jnp.asarray(a[None]) for a in (q, k, v)), jnp.asarray(th), jnp.asarray(tw), grid,
        scale))[0]
    _assert_f32_tier(got, want)


def test_model_equals_the_plain_version_within_the_tier():
    """The plain version the wrappers take on the CPU (and that chip_smoke holds the
    kernels to on the card) and the model agree within the same tier."""
    grid, d = (6, 40), 64
    q, k, v, th, tw = _inputs(13, 2, grid, d, True)
    plain = cuda_attn.global_attention(*(torch.from_numpy(a) for a in (q, k, v, th, tw)),
                                       grid, d ** -0.5).numpy()
    _assert_f32_tier(_model(q, k, v, th, tw, grid, d ** -0.5, True), plain)


# -------------------------------------------------- the slice through the model
@pytest.fixture
def model_attention(monkeypatch):
    """The ViT's blocks call the kernels' model in place of the wrappers."""
    def run(compact):
        def attn(q, k, v, th, tw, grid, scale):
            args = (a.detach().float().numpy() for a in (q, k, v, th, tw))
            return torch.from_numpy(_model(*args, grid, scale, compact)).to(q.dtype)
        return attn

    monkeypatch.setattr(vit, "global_attention", run(True))
    monkeypatch.setattr(vit, "window_attention", run(False))


@pytest.mark.parametrize("tiny", [TINY, TINY_H80], ids=["head_dim_16", "head_dim_80"])
def test_f32_predictor_through_the_kernels_model_matches_jax(model_attention, tiny):
    """``compute_dtype="float32"`` at the TINY geometry (and ViT-H's head dim 80): the
    port's Predictor with every attention block through the f32 kernels' arithmetic
    against the JAX Predictor's maps (Pallas in interpret mode)."""
    jpred, pred, images = _make_pair(tiny)
    assert pred.cfg.compute_dtype == "float32"
    cap = jpred.pick_capacity(EXEMPLARS, SIZE)
    want = jpred.model.clone(template_capacity=cap).apply({"params": jpred.params},
                                                          images, EXEMPLARS)
    got = pred.forward(images, EXEMPLARS)
    for name in ("objectness", "regressions"):
        assert got[name].dtype == torch.float32
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name][0]),
                                   rtol=1e-4, atol=1e-4)
