"""Port attention (``tmr_tpu_torch/ops/cuda_attn.py``, plain versions on the CPU) vs the
JAX package's Pallas attention kernels run in interpret mode on the same numpy inputs, and
on token grids the Pallas global kernel refuses (S not a multiple of its block) vs
``blockwise_decomposed_attention``, the function the JAX ViT runs there. The global
attention takes the compact ``(2g - 1, D)`` tables: the same numpy table goes through the
JAX ``get_rel_pos`` into the JAX function, and as it is into the port.

Tolerances: f32 2e-5 (online vs full-row softmax reassociate the f32 sums); bf16 per
element, one bf16 ulp of the element plus 2^-9 of the largest output, and a mean error
of at most 2^-8 of the mean output (both sides round p and the output to bf16, at
different points of the softmax; the floor covers the noise of p's rounding on outputs
that cancel to near zero)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tmr_tpu.models.vit import blockwise_decomposed_attention  # noqa: E402
from tmr_tpu.models.vit import get_rel_pos as jax_get_rel_pos  # noqa: E402
from tmr_tpu.ops.pallas_attn import (  # noqa: E402
    pallas_decomposed_attention,
    pallas_fused_attention,
    pallas_windowed_attention,
)
from tmr_tpu_torch.ops import cuda_attn  # noqa: E402

F32_TOL = 2e-5
BF16_REL_TOL = 2.0 ** -7
BF16_ABS_TOL = 2.0 ** -9
BF16_MEAN_TOL = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inputs(seed, b, h, gh, gw, d):
    rng = np.random.default_rng(seed)
    s = gh * gw
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    rh = (rng.standard_normal((gh, gh, d)) * 0.2).astype(np.float32)
    rw = (rng.standard_normal((gw, gw, d)) * 0.2).astype(np.float32)
    return q, k, v, rh, rw


def _global_inputs(seed, b, h, gh, gw, d, table_len=None):
    """q, k, v and the compact tables (2gh - 1, d) / (2gw - 1, d), or tables of
    ``table_len`` rows (a parameter the ViT interpolates)."""
    rng = np.random.default_rng(seed)
    s = gh * gw
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    th, tw = (table_len or 2 * gh - 1), (table_len or 2 * gw - 1)
    rph = (rng.standard_normal((th, d)) * 0.2).astype(np.float32)
    rpw = (rng.standard_normal((tw, d)) * 0.2).astype(np.float32)
    return q, k, v, rph, rpw


def _expand(rph, rpw, grid):
    """The JAX package's get_rel_pos of the compact tables: (gh, gh, d), (gw, gw, d)."""
    return (np.asarray(jax_get_rel_pos(grid[0], grid[0], jnp.asarray(rph))),
            np.asarray(jax_get_rel_pos(grid[1], grid[1], jnp.asarray(rpw))))


def _port(fn, q, k, v, rh, rw, grid, scale, dtype=torch.float32):
    b, h, s, d = q.shape
    t = lambda a: torch.from_numpy(a.reshape(b * h, s, d)).to(dtype)  # noqa: E731
    rel = (None, None) if rh is None else (torch.from_numpy(rh), torch.from_numpy(rw))
    out = fn(t(q), t(k), t(v), *rel, grid, scale)
    assert out.dtype == dtype and out.shape == (b * h, s, d)
    return out.float().numpy().reshape(b, h, s, d)


def _assert_bf16_close(got, want):
    limit = BF16_REL_TOL * np.abs(want) + BF16_ABS_TOL * np.abs(want).max()
    err = np.abs(got - want)
    assert (err <= limit).all(), (err - limit).max()
    assert err.mean() <= BF16_MEAN_TOL * np.abs(want).mean()


def _jax(fn, q, k, v, rh, rw, grid, scale, dtype=jnp.float32):
    j = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    rel = (None, None) if rh is None else (jnp.asarray(rh), jnp.asarray(rw))
    return np.asarray(fn(j(q), j(k), j(v), *rel, grid, scale).astype(jnp.float32))


@pytest.mark.parametrize("jax_fn", [pallas_decomposed_attention, pallas_fused_attention])
@pytest.mark.parametrize("bias", [True, False])
def test_global_attention_matches_pallas_f32(jax_fn, bias):
    gh = gw = 16
    q, k, v, rph, rpw = _global_inputs(1, 1, 2, gh, gw, 64)
    rh, rw = _expand(rph, rpw, (gh, gw))
    if not bias:
        rph = rpw = rh = rw = None
    scale = 64 ** -0.5
    want = _jax(jax_fn, q, k, v, rh, rw, (gh, gw), scale)
    got = _port(cuda_attn.global_attention, q, k, v, rph, rpw, (gh, gw), scale)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_global_attention_matches_pallas_bf16():
    gh = gw = 16
    q, k, v, rph, rpw = _global_inputs(2, 1, 2, gh, gw, 64)
    rh, rw = _expand(rph, rpw, (gh, gw))
    scale = 64 ** -0.5
    want = _jax(pallas_decomposed_attention, q, k, v, rh, rw, (gh, gw), scale,
                jnp.bfloat16)
    got = _port(cuda_attn.global_attention, q, k, v, rph, rpw, (gh, gw), scale,
                torch.bfloat16)
    _assert_bf16_close(got, want)


# token counts that are not multiples of 64: one partial tile (5x7), the 320^2 input's
# grid (20x20), rows wider than the grid is tall (3x40)
@pytest.mark.parametrize("grid", [(5, 7), (20, 20), (3, 40)])
@pytest.mark.parametrize("bias", [True, False])
def test_global_attention_ragged_grids_match_blockwise(grid, bias):
    q, k, v, rph, rpw = _global_inputs(9, 1, 2, *grid, 64)
    rh, rw = _expand(rph, rpw, grid)
    if not bias:
        rph = rpw = rh = rw = None
    scale = 64 ** -0.5
    want = _jax(blockwise_decomposed_attention, q, k, v, rh, rw, grid, scale)
    got = _port(cuda_attn.global_attention, q, k, v, rph, rpw, grid, scale)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_global_attention_interpolated_table_matches_expanded_route():
    """A parameter of 27 rows on a 20x20 grid (the ViT's non-native grids): the port's
    compact route (``interp_rel_pos`` to 39 rows) equals the JAX blockwise attention on
    JAX ``get_rel_pos`` of the same parameter, and the port's own expanded route."""
    grid = (20, 20)
    q, k, v, rph, rpw = _global_inputs(10, 1, 2, *grid, 64, table_len=27)
    scale = 64 ** -0.5
    rh, rw = _expand(rph, rpw, grid)
    want = _jax(blockwise_decomposed_attention, q, k, v, rh, rw, grid, scale)
    tph, tpw = (cuda_attn.interp_rel_pos(torch.from_numpy(t), 39) for t in (rph, rpw))
    assert tph.shape == (39, 64)
    got = _port(cuda_attn.global_attention, q, k, v, tph.numpy(), tpw.numpy(), grid, scale)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    qt, kt, vt = (torch.from_numpy(a[0]) for a in (q, k, v))
    exp_h, exp_w = (cuda_attn.get_rel_pos(20, 20, torch.from_numpy(t)) for t in (rph, rpw))
    expanded = cuda_attn.attention_plain(
        qt, kt, vt, *cuda_attn.bias_projections(qt, exp_h, exp_w, grid), grid, scale)
    torch.testing.assert_close(torch.from_numpy(got[0]), expanded, rtol=0, atol=0)


# 14: SAM's window (208 query rows, 14 key rows of 16 slots); 4: no query padding; 13: 169
# tokens; 16: full 16-slot key rows, no pad slots; 3 at d = 16: the plain version alone
@pytest.mark.parametrize("window,d", [(14, 64), (3, 16), (4, 64), (13, 64), (16, 64)])
def test_window_attention_matches_pallas_f32(window, d):
    q, k, v, rh, rw = _inputs(3, 3, 2, window, window, d)
    scale = d ** -0.5
    want = _jax(pallas_windowed_attention, q, k, v, rh, rw, (window, window), scale)
    got = _port(cuda_attn.window_attention, q, k, v, rh, rw, (window, window), scale)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_window_attention_matches_pallas_bf16():
    q, k, v, rh, rw = _inputs(4, 2, 2, 14, 14, 64)
    scale = 64 ** -0.5
    want = _jax(pallas_windowed_attention, q, k, v, rh, rw, (14, 14), scale, jnp.bfloat16)
    got = _port(cuda_attn.window_attention, q, k, v, rh, rw, (14, 14), scale,
                torch.bfloat16)
    _assert_bf16_close(got, want)


@pytest.mark.parametrize("window", [4, 13, 16])
def test_window_attention_edges_match_pallas_bf16(window):
    q, k, v, rh, rw = _inputs(6, 1, 2, window, window, 64)
    scale = 64 ** -0.5
    grid = (window, window)
    want = _jax(pallas_windowed_attention, q, k, v, rh, rw, grid, scale, jnp.bfloat16)
    got = _port(cuda_attn.window_attention, q, k, v, rh, rw, grid, scale, torch.bfloat16)
    _assert_bf16_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_attention_strong_bias_matches_pallas(dtype):
    """Bias tables scaled x2 (|bias| ~ the scores), so the bias moves the softmax."""
    q, k, v, rh, rw = _inputs(7, 1, 2, 14, 14, 64)
    rh, rw = rh * 2, rw * 2
    scale = 64 ** -0.5
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    want = _jax(pallas_windowed_attention, q, k, v, rh, rw, (14, 14), scale, jd)
    got = _port(cuda_attn.window_attention, q, k, v, rh, rw, (14, 14), scale, td)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        _assert_bf16_close(got, want)


def test_window_geometry_fits_every_accepted_window():
    """Square windows up to 16 and rows up to 64 tokens stage within 227 KB; one past
    either raises."""
    for side in range(1, 17):
        gwp, ghp, smem = cuda_attn.window_geometry(side, side)
        assert smem <= 227 * 1024 and gwp >= side and (ghp * gwp // 8) % 2 == 0
    for gh, gw in ((17, 17), (1, 65)):
        with pytest.raises(ValueError):
            cuda_attn.window_geometry(gh, gw)
    assert cuda_attn.window_geometry(1, 64)[2] <= 227 * 1024
    assert cuda_attn.window_geometry(14, 14) == (16, 14, 109760)


def test_kernel_entries_equal_wrappers_on_projections():
    """Each public entry (one kernel on the card, projections inside) equals the plain
    version on bias_projections' output: the global entry from the compact tables through
    get_rel_pos, the windowed entry from the expanded tables."""
    for window, fn in ((8, "global"), (14, "window")):
        grid, scale = (window, window), 64 ** -0.5
        if fn == "global":
            q, k, v, rph, rpw = (torch.from_numpy(a)
                                 for a in _global_inputs(8, 1, 2, window, window, 64))
            q, k, v = q[0], k[0], v[0]
            rh, rw = (cuda_attn.get_rel_pos(window, window, t) for t in (rph, rpw))
            got = cuda_attn.global_attention(q, k, v, rph, rpw, grid, scale)
        else:
            q, k, v, rh, rw = (torch.from_numpy(a) for a in _inputs(8, 1, 2, window, window, 64))
            q, k, v = q[0], k[0], v[0]
            got = cuda_attn.window_attention(q, k, v, rh, rw, grid, scale)
        want = cuda_attn.attention_plain(q, k, v, *cuda_attn.bias_projections(q, rh, rw, grid),
                                         grid, scale)
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_global_geometry_fits_the_grids_the_port_runs():
    """The global kernel's shared memory fits 227 KB up to the 1536 bucket's 96x96 grid and
    past it (gh + gw up to ~290); a grid beyond raises; without the bias any grid fits."""
    assert cuda_attn.global_geometry(64, 64) == 182328
    for gh, gw in ((96, 96), (5, 7), (1, 1), (145, 145)):
        assert cuda_attn.global_geometry(gh, gw) <= 227 * 1024
    with pytest.raises(ValueError):
        cuda_attn.global_geometry(150, 150)
    assert cuda_attn.global_geometry(150, 150, has_bias=False) <= 227 * 1024


@pytest.mark.parametrize("missing", ["h", "w"])
def test_global_attention_refuses_one_table(missing):
    """One rel-pos table without the other is refused before either path runs."""
    q, k, v, rph, rpw = (torch.from_numpy(a) for a in _global_inputs(3, 1, 1, 4, 5, 64))
    tables = (None, rpw) if missing == "h" else (rph, None)
    with pytest.raises(ValueError, match="both rel-pos tables"):
        cuda_attn.global_attention(q[0], k[0], v[0], *tables, (4, 5), 64 ** -0.5)


def test_bias_projections_layout():
    """rel_h_q[n, (y, x), ky] = q[n, (y, x)] . rh[y, ky]; rel_w_q uses the column x."""
    q, _, _, rh, rw = _inputs(5, 1, 1, 4, 5, 8)
    qt = torch.from_numpy(q[0])
    rel_h, rel_w = cuda_attn.bias_projections(qt, torch.from_numpy(rh),
                                              torch.from_numpy(rw), (4, 5))
    tok = 2 * 5 + 3  # (y, x) = (2, 3)
    np.testing.assert_allclose(rel_h[0, tok].numpy(), rh[2] @ q[0, 0, tok], rtol=1e-5)
    np.testing.assert_allclose(rel_w[0, tok].numpy(), rw[3] @ q[0, 0, tok], rtol=1e-5)


# ------------------------------------------------ head dim 80 (SAM ViT-H: 1280 / 16 heads)


def _assert_close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        _assert_bf16_close(got, want)


_DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# a 64-token grid row (2x64: the main path's row tiles) against both Pallas global kernels
# in interpret mode, and a ragged grid (5x7: one partial tile) against the blockwise
# attention the JAX ViT runs where the Pallas kernels refuse the token count
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("grid,jax_fn", [
    ((2, 64), pallas_decomposed_attention), ((2, 64), pallas_fused_attention),
    ((5, 7), blockwise_decomposed_attention)], ids=["2x64-decomposed", "2x64-fused",
                                                    "5x7-blockwise"])
def test_global_attention_head_dim_80_matches_jax(grid, jax_fn, bias, dtype):
    d = 80
    q, k, v, rph, rpw = _global_inputs(11, 1, 2, *grid, d)
    rh, rw = _expand(rph, rpw, grid)
    if not bias:
        rph = rpw = rh = rw = None
    scale = d ** -0.5
    jd, td = _DTYPES[dtype]
    want = _jax(jax_fn, q, k, v, rh, rw, grid, scale, jd)
    got = _port(cuda_attn.global_attention, q, k, v, rph, rpw, grid, scale, td)
    _assert_close(got, want, dtype)


# SAM's 14x14 windows (208 query rows, 14 key rows of 16 slots) and 7x7 (8-slot key rows, a
# pad key row) at head dim 80
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [14, 7])
def test_window_attention_head_dim_80_matches_pallas(window, dtype):
    d = 80
    q, k, v, rh, rw = _inputs(12, 2, 2, window, window, d)
    scale = d ** -0.5
    grid = (window, window)
    jd, td = _DTYPES[dtype]
    want = _jax(pallas_windowed_attention, q, k, v, rh, rw, grid, scale, jd)
    got = _port(cuda_attn.window_attention, q, k, v, rh, rw, grid, scale, td)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("d,ok", [(64, True), (80, True), (72, False), (96, False),
                                  (128, False)])
def test_kernels_take_head_dims_64_and_80_only(d, ok):
    """The card's wrappers take head dim 64 (ViT-B) and 80 (ViT-H) and raise for any other
    (no fallback to the plain version)."""
    q = torch.zeros(2, 196, d, dtype=torch.bfloat16)
    if ok:
        cuda_attn._check(q, q.clone(), q.clone(), "test")
    else:
        with pytest.raises(ValueError, match="head dim 64 or 80"):
            cuda_attn._check(q, q.clone(), q.clone(), "test")


def _global_smem_mirror(gh, gw, has_bias, d):
    """csrc/attn.cu launch_global's shared bytes: 1024 alignment slack, the Q tile of 128
    rows in 64-column panels, the K/V ring of NS stages of BK keys (GStages, BK in
    launch_global), NS full + NS empty + 1 mbarriers, and the (128, gh | 1) + (128, gw | 1)
    f32 projections."""
    np_ = (d + 63) // 64
    bk = 128 if has_bias and gw == 64 and d == 64 else 64
    ns = (4 if bk == 64 else 3) if np_ == 1 else 3
    fixed = 1024 + np_ * 128 * 128 + ns * 2 * np_ * bk * 128 + (1 + 2 * ns) * 8
    return fixed + (128 * ((gh | 1) + (gw | 1)) * 4 if has_bias else 0)


def _window_smem_mirror(gh, gw, d):
    """csrc/attn.cu launch_window's shared bytes: Q (sp rows), K and V (ghp key rows of
    8 NTW slots) in bf16 rows of d, and the f32 projections (sp, st_h + gwp)."""
    ntw = next(n for n in (1, 2, 4, 8) if gw <= 8 * n)
    gwp, ghp, sp, st_h = 8 * ntw, gh + ((gh * ntw) & 1), (gh * gw + 15) // 16 * 16, (gh + 1) | 1
    return gwp, ghp, (sp + 2 * ghp * gwp) * d * 2 + sp * (st_h + gwp) * 4


@pytest.mark.parametrize("d", [64, 80])
def test_geometry_mirrors_the_c_side(d):
    """global_geometry and window_geometry equal the C side's formulas at both head dims, and
    ViT-H's shapes (a 64x64 grid, 14x14 windows) fit the 227 KB a block may use."""
    limit = 227 * 1024
    for gh, gw in ((64, 64), (24, 40), (5, 7), (7, 64), (96, 96), (1, 1)):
        for has_bias in (True, False):
            assert (cuda_attn.global_geometry(gh, gw, has_bias, d)
                    == _global_smem_mirror(gh, gw, has_bias, d))
    for gh, gw in ((14, 14), (7, 7), (16, 16), (1, 64), (13, 13)):
        assert cuda_attn.window_geometry(gh, gw, d) == _window_smem_mirror(gh, gw, d)
    assert cuda_attn.global_geometry(64, 64, True, d) <= limit
    assert cuda_attn.window_geometry(14, 14, d)[2] <= limit
    with pytest.raises(ValueError):
        cuda_attn.global_geometry(150, 150, True, d)
    with pytest.raises(ValueError):
        cuda_attn.window_geometry(17, 17, d)


def _window_swizzle(row, chunk, d):
    """csrc/attn.cu swz<D>: the element offset of 16-byte chunk ``chunk`` of bf16 row ``row``
    in a (rows, d) tile of the windowed kernel."""
    f = (row & 7) if d == 64 else ((row >> 2) & 1)
    return row * d + ((chunk ^ f) << 3)


@pytest.mark.parametrize("d", [64, 80])
def test_window_swizzle_is_a_bijection_and_free_of_bank_conflicts(d):
    """Each row's chunks land on its own chunks, once each; and for every chunk, the 8 rows
    an ldmatrix phase reads (8 consecutive rows from a multiple of 8) sit in 8 distinct
    bank groups of 16 bytes."""
    chunks = d // 8
    rows = np.arange(256)[:, None]
    off = _window_swizzle(rows, np.arange(chunks)[None, :], d)  # elements
    for r in range(256):
        np.testing.assert_array_equal(np.sort(off[r] - r * d) // 8, np.arange(chunks))
    group = (off * 2 // 16) % 8  # 16-byte bank group of each chunk's address
    for r0 in range(0, 256, 8):
        for c in range(chunks):
            assert len(set(group[r0:r0 + 8, c].tolist())) == 8, (r0, c)
