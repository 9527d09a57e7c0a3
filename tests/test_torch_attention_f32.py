"""The f32 attention kernels (``csrc/attn_f32.cu``, ``compute_dtype="float32"``) on the
CPU: the wrappers' dtype dispatch and refusals, the shared-memory geometry against a
mirror of the C side's formula, and a numpy model of the kernels' arithmetic (128-row
query tiles, 32-key tiles, online softmax in exp2, 3xTF32 products with hi rounded to
tf32 by integer ops and lo the f32 remainder read as a truncated tf32, p.v in the V^T
slot order, the projections times log2 e as 3xTF32 products, each key's (ky, kx) by a
reciprocal multiply or as whole-tile grid rows) against the JAX package's attention in
f32, with and without the bias, alone and through the TINY Predictor in place of the
wrappers' plain version; and ``Attention(use_rel_pos=False)`` against the JAX one.

Tolerances: the model against the JAX function, per element 2e-5 x max|want| (chip_smoke's
f32 attention tier: 3xTF32 is about 2^-21 a product; the sums run in another order);
through the whole TINY slice, the maps within 1e-4 as ``tests/test_torch_predictor.py``
holds the plain version."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import jax  # noqa: E402

from tmr_tpu.models import vit as jvit  # noqa: E402
from tmr_tpu.models.vit import blockwise_decomposed_attention  # noqa: E402
from tmr_tpu.models.vit import get_rel_pos as jax_get_rel_pos  # noqa: E402
from tmr_tpu.ops.pallas_attn import (pallas_decomposed_attention,  # noqa: E402
                                     pallas_windowed_attention)
from test_torch_predictor import EXEMPLARS, SIZE, TINY, TINY_H80, _make_pair  # noqa: E402
from tmr_tpu_torch.models import vit  # noqa: E402
from tmr_tpu_torch.ops import _build, cuda_attn  # noqa: E402
from tmr_tpu_torch.utils.weights import params_from_jax  # noqa: E402
from torch_card_route import CardRoute  # noqa: E402

F32_TOL = 2e-5
LIMIT = 227 * 1024
BQ, BK = 128, 32  # csrc/attn_f32.cu: query rows of a CTA, keys of a tile
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
    """Stand-ins for the C launcher on meta tensors, which take the kernel route (the
    ``tmr::`` ops' CUDA kernels, ``tests/torch_card_route.py``): each call recorded as
    (counter, library, function, args)."""
    calls = []
    monkeypatch.setattr(_build, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    with CardRoute():
        yield calls


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
    """The f32 global kernel takes the call without the bias (its no-bias
    instantiation: null tables, has_bias 0, counted under ``global_attn_f32``); f16 and
    mixed dtypes raise on the kernel route: nothing more launches and nothing falls back
    to the plain version."""
    t = _meta((2, 49, 64), torch.float32)
    out = cuda_attn.global_attention(t, t, t, None, None, (7, 7), 0.125)
    assert out.dtype == torch.float32 and out.shape == t.shape
    (call,) = launches
    assert call[:3] == ("global_attn_f32", "attn_f32", "tmr_global_attn_f32")
    assert call[6:8] == (None, None) and call[15] == 0  # no tables, has_bias 0
    h = _meta((2, 49, 64), torch.float16)
    tab = _meta((7, 7, 64), torch.float32)
    with pytest.raises(ValueError, match="bf16 or f32"):
        cuda_attn.window_attention(h, h, h, tab, tab, (7, 7), 0.125)
    b = _meta((2, 49, 64), torch.bfloat16)
    with pytest.raises(ValueError, match="as q is"):
        cuda_attn.window_attention(t, b, t, tab, tab, (7, 7), 0.125)
    with pytest.raises(ValueError, match="bf16 or f32"):
        cuda_attn.global_attention(h, h, h, None, None, (7, 7), 0.125)
    assert len(launches) == 1


def test_every_f32_instantiation_has_a_counter():
    assert {cuda_attn._counter(k, d, torch.float32) for k in ("global_attn", "window_attn")
            for d in (64, 80)} == {"global_attn_f32", "global_attn_f32_d80",
                                   "window_attn_f32", "window_attn_f32_d80"}
    assert set(_build.SIGNATURES["attn_f32"]) == {"tmr_global_attn_f32",
                                                  "tmr_window_attn_f32"}
    assert (_build.CSRC / "attn_f32.cu").is_file()


# ------------------------------------------------------------------------ geometry
def _f32_smem_mirror(gh, gw, d):
    """csrc/attn_f32.cu smem_bytes of the global entry with the bias: 1024 bytes of
    alignment slack, the deepest ring of 4, 3 or 2 stages that fits 227 KB (a stage: K, K
    lo and raw V in ceil(d / 32) panels of BK rows of 128 bytes, V^T hi and lo in d rows
    of 128 bytes), 96 bytes of mbarriers, and the (BQ, gh | 1) rel-h and (BQ, stw) rel-w
    f32 projections (stw = gw + 8 when BK divides gw, else gw | 1)."""
    stage = 3 * -(-d // 32) * BK * 128 + 2 * d * 128
    stw = gw + 8 if gw % BK == 0 else gw | 1
    fits = [1024 + ns * stage + 96 + BQ * ((gh | 1) + stw) * 4 for ns in (4, 3, 2)]
    return next(b for b in fits if b <= LIMIT)


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
    """hi = tf32(x), nearest with ties away, as the kernel takes it by integer ops: half a
    tf32 ulp added to the bits, the low 13 cleared."""
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return (((b + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


def _tf32_trunc(x):
    """An f32 word as the tensor cores read it in tf32: the low 13 bits dropped."""
    return (x.astype(np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    """The kernel's split of every operand: hi rounded to tf32, lo the f32 remainder x - hi,
    read as tf32 (truncated). A non-finite x leaves lo a NaN."""
    x = x.astype(np.float32)
    hi = _tf32_rna(x)
    with np.errstate(invalid="ignore"):
        lo = _tf32_trunc((x - hi).astype(np.float32))
    return hi, lo


def _mm3(a, b):
    """3xTF32: lo*hi + hi*lo + hi*hi of the split operands, each product exact (tf32 x
    tf32 fits f32), the sums rounded to f32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    f = lambda x: x.astype(np.float64)  # noqa: E731
    return (f(al) @ f(bh) + f(ah) @ f(bl) + f(ah) @ f(bh)).astype(np.float32)


def _slot(key):
    """The V^T slot of a tile's key: in each k-block of 8, key 2t sits in slot t and key
    2t + 1 in slot t + 4, so the q.k accumulator's registers are p.v's A fragment."""
    key = np.asarray(key)
    return (key & ~7) | ((key & 7) >> 1) | ((key & 1) << 2)


def _stepped_keys(s, gw, row_tile=None):
    """Each key's (ky, kx) as the kernel's lanes take them: on whole-tile grid rows (the
    global entry where BK divides gw) a tile is one grid row (ky = k0 / gw, kx = k0 - ky *
    gw + column); elsewhere by the reciprocal multiply floor((key + 0.5) * f32(1 / gw))."""
    keys = np.arange(s)
    if gw % BK == 0 if row_tile is None else row_tile:
        k0 = keys // BK * BK
        ky = k0 // gw
        kx = k0 - ky * gw + keys % BK
        return ky, kx
    inv = np.float32(1.0) / np.float32(gw)
    ky = np.floor((keys.astype(np.float32) + np.float32(0.5)) * inv).astype(np.int64)
    return ky, keys - ky * gw


def _projections(q, table, pos, n, compact):
    """(BH, S, n) f32 projections x log2 e as the kernel's warps make them: 3xTF32 products
    of q and the table rows (m16n8k8 mma.sync, a fresh accumulator a task)."""
    c = np.arange(n)
    rows = table[pos[:, None] - c[None] + n - 1] if compact else table[pos[:, None], c[None]]
    qh, ql = (x.astype(np.float64) for x in _split(q))
    th, tl = (x.astype(np.float64) for x in _split(rows))
    prod = (np.einsum("nsd,scd->nsc", ql, th) + np.einsum("nsd,scd->nsc", qh, tl)
            + np.einsum("nsd,scd->nsc", qh, th))
    return prod.astype(np.float32) * LOG2E


def _model(q, k, v, th, tw, grid, scale, compact):
    """The f32 kernels' arithmetic in numpy: q/k/v (BH, S, D) f32; th/tw the compact
    (2g - 1, D) tables (the global entry), the expanded (g, g, D) ones (the windowed), or
    None (no bias)."""
    gh, gw = grid
    bh, s, d = q.shape
    ys, xs = np.arange(s) // gw, np.arange(s) % gw
    has_bias = th is not None
    if has_bias:  # the windowed entry never takes whole-tile rows
        ky, kx = _stepped_keys(s, gw, compact and gw % BK == 0)
        relh = _projections(q, th, ys, gh, compact)
        relw = _projections(q, tw, xs, gw, compact)
    qs = q * np.float32(np.float32(scale) * LOG2E)
    m = np.full((bh, s), -np.inf, np.float32)
    l = np.zeros((bh, s), np.float32)
    o = np.zeros((bh, s, d), np.float32)
    nk = -(-s // BK) * BK
    kp = np.zeros((bh, nk, d), np.float32)
    vp = np.zeros((bh, nk, d), np.float32)
    kp[:, :s], vp[:, :s] = k, v
    order = np.argsort(_slot(np.arange(BK)))  # key in each V^T slot
    for j0 in range(0, s, BK):
        cols = np.arange(j0, j0 + BK)
        live = cols < s
        sc = np.stack([_mm3(qs[n], kp[n, j0:j0 + BK].T) for n in range(bh)])
        if has_bias:
            jj = np.minimum(cols, s - 1)
            sc = sc + (relh[:, :, ky[jj]] + relw[:, :, kx[jj]])
        sc[:, :, ~live] = -np.inf
        mx = np.maximum(m, sc.max(-1))
        alpha = np.exp2(m - mx)
        p = np.exp2(sc - mx[..., None]).astype(np.float32)
        l = l * alpha + p.sum(-1)
        pv = np.stack([_mm3(p[n][:, order], vp[n, j0:j0 + BK][order]) for n in range(bh)])
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


# ----------------------------------------------- the design's operand layout and split
def test_v_transpose_slots_make_the_accumulator_the_a_fragment():
    """Lane (g, t)'s q.k accumulator holds keys 8j + 2t and 8j + 2t + 1 of rows g and g + 8
    (registers 4j, 4j + 1, 4j + 2, 4j + 3); p.v's A fragment wants k-slots t (a0 row g, a1
    row g + 8) and t + 4 (a2, a3). The kernel passes (4j, 4j + 2, 4j + 1, 4j + 3) as
    (a0, a1, a2, a3), so V^T must hold key 8j + 2t in slot 8j + t and key 8j + 2t + 1 in
    slot 8j + t + 4: a permutation of each k-block."""
    for j in range(BK // 8):
        keys = np.arange(8 * j, 8 * j + 8)
        assert sorted(_slot(keys)) == list(keys)
        for t in range(4):
            assert _slot(8 * j + 2 * t) == 8 * j + t
            assert _slot(8 * j + 2 * t + 1) == 8 * j + t + 4


def test_split_keeps_non_finite_words_and_meets_the_tier():
    """hi + lo recovers x to 2^-21 of x (both read as tf32), and any non-finite x leaves lo
    a NaN, which survives every product it enters (the check phase 3 makes on the card)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(100000) * np.exp(rng.uniform(-20, 20, 100000))).astype(np.float32)
    hi, lo = _split(x)
    rel = np.abs(hi.astype(np.float64) + lo - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -21
    for bad in (np.nan, np.inf, -np.inf):
        assert np.isnan(_split(np.array([bad], np.float32))[1]).all()


def test_model_keeps_non_finite_inputs():
    """A NaN in q makes its row NaN; an infinity in k or v leaves NaNs wherever the plain
    softmax makes the output non-finite (no non-finite output is lost)."""
    grid, d = (5, 7), 64
    q, k, v, th, tw = _inputs(14, 3, grid, d, True)
    q[0, 4, 2], k[1, 30, 63], v[2, 17, 0] = np.nan, np.inf, -np.inf
    got = _model(q, k, v, th, tw, grid, d ** -0.5, True)
    want = cuda_attn.global_attention(*(torch.from_numpy(a) for a in (q, k, v, th, tw)),
                                      grid, d ** -0.5).numpy()
    assert not (~np.isfinite(want) & np.isfinite(got)).any()
    both = np.isfinite(got) & np.isfinite(want)
    _assert_f32_tier(got[both], want[both])


# the no-bias instantiation against the JAX package's Pallas kernel (``_attn_kernel_nobias``
# in interpret mode): sequence lengths with a power-of-two block >= 128, both head dims
@pytest.mark.parametrize("grid,d", [((2, 64), 64), ((4, 64), 64), ((16, 16), 80)])
def test_nobias_model_matches_pallas(grid, d):
    q, k, v, _, _ = _inputs(15, 2, grid, d, True)
    scale = d ** -0.5
    got = _model(q, k, v, None, None, grid, scale, True)
    want = np.asarray(pallas_decomposed_attention(
        *(jnp.asarray(a[None]) for a in (q, k, v)), None, None, grid, scale))[0]
    _assert_f32_tier(got, want)


# --------------------------------------------------- Attention(use_rel_pos=False)
#: the port's bf16 attention vs the JAX one, relative to the output's max: both round the
#: linears' operands and p to bf16, at other points of the sums (tests/test_torch_predictor
#: holds whole bf16 networks at the same order)
BF16_TOL = 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("windowed", [False, True], ids=["global", "windowed"])
def test_attention_without_rel_pos_matches_jax(monkeypatch, windowed, dtype):
    """``Attention(use_rel_pos=False)`` at tiny width (32 channels, 2 heads) through
    ``params_from_jax``: a global block on 32x32 tokens (the JAX module's global path,
    ``TMR_GLOBAL_ATTN=blockwise``) and windowed blocks on 4 windows of 7x7 (its dense
    path); the port has no rel-pos parameters and both of its paths take the global
    attention without tables. f32 within 1e-5 x max (the same ops, sums in another
    order), bf16 within BF16_TOL x max."""
    monkeypatch.setenv("TMR_GLOBAL_ATTN", "blockwise")
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    shape = (4, 7, 7, 32) if windowed else (1, 32, 32, 32)
    x = np.random.default_rng(16).standard_normal(shape).astype(np.float32)
    jattn = jvit.Attention(num_heads=2, use_rel_pos=False, dtype=jdt)
    params = jattn.init(jax.random.key(1), jnp.asarray(x))["params"]
    assert set(params) == {"qkv", "proj"}
    want = np.asarray(jattn.apply({"params": params}, jnp.asarray(x)).astype(jnp.float32))
    attn = vit.Attention(32, 2, shape[1:3], windowed, tdt, use_rel_pos=False)
    attn.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    assert not any("rel_pos" in name for name, _ in attn.named_parameters())
    with torch.no_grad():
        got = attn(torch.from_numpy(x)).float().numpy()
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("windowed", [False, True], ids=["global", "windowed"])
def test_attention_without_rel_pos_routes_to_the_nobias_kernel(launches, windowed):
    """On the card both paths of ``Attention(use_rel_pos=False)`` launch the global kernel
    without tables over the block's (or window's) tokens: f32 counted under
    ``global_attn_f32``, and no windowed kernel."""
    shape = (4, 14, 14, 64) if windowed else (1, 16, 16, 64)
    attn = vit.Attention(64, 1, shape[1:3], windowed, torch.float32, use_rel_pos=False)
    x = torch.zeros(shape, device="meta")
    attn.to("meta")(x)
    (call,) = launches
    assert call[:3] == ("global_attn_f32", "attn_f32", "tmr_global_attn_f32")
    assert call[9:13] == (shape[0], shape[1] * shape[2], shape[1], shape[2])
    assert call[6:8] == (None, None) and call[15] == 0
