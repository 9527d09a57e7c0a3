"""The head-dim-80 windowed attention kernel (``csrc/attn.cu`` ``window_attn_kernel_wg``:
SAM ViT-H's windows on persistent warpgroups with TMA and ``wgmma``) as numpy models of its
index maths, read from the kernel's own source where it states them, and held against the
JAX package's Pallas windowed kernel run in interpret mode: where TMA's 4-D box puts each
key slot and column and where the ``wgmma`` descriptors read them, how the m64n<slots>
accumulator maps to (query row, key slot) and to the rel-w columns a lane keeps, the
one-pass softmax over padded slots with bf16 p, the shared-memory staging and routing that
``cuda_attn.window_geometry`` mirrors, and the persistent loop over window-heads.

Tolerance of the softmax model: the bf16 tier of ``tests/test_torch_attention.py`` (one
bf16 ulp of the element plus 2^-9 of the largest output, mean error at most 2^-8 of the
mean output): both sides round p and the output to bf16, at different points."""

import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tmr_tpu.ops.pallas_attn import pallas_windowed_attention  # noqa: E402
from tmr_tpu_torch.ops import _build, cuda_attn  # noqa: E402

D = 80
SRC = (_build.CSRC / "attn.cu").read_text()
#: the kernel's body, from its signature to the host side
KERNEL = SRC[SRC.index("window_attn_kernel_wg(const"):SRC.index("// ---- host side")]
SMS = 132  # H100 SXM
SMEM_LIMIT = 227 * 1024


def _flat(text):
    """``text`` with every run of whitespace made one space: the source's statements read
    whatever their line breaks and indentation."""
    return " ".join(text.split())


FLAT_SRC, FLAT_KERNEL = _flat(SRC), _flat(KERNEL)


def _constant(name):
    """The value of ``constexpr int name = <n>;`` in attn.cu."""
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _c_function(name, **env):
    """The return expression of attn.cu's ``name`` (an integer formula of its arguments),
    evaluated with ``env`` and the source's ``WQ`` and the other such functions."""
    body = FLAT_SRC[FLAT_SRC.index(f" {name}("):]
    expr = body[body.index("return") + 6:body.index(";")].replace("(size_t)", "")
    scope = {"WQ": _constant("WQ"),
             "window_wg_proj_bytes": lambda S, gh, gw: _c_function(
                 "window_wg_proj_bytes", S=S, gh=gh, gw=gw)}
    return eval(expr, scope, dict(env))  # noqa: S307 - integer arithmetic only


def _wg_dispatch():
    """window_entry<80>'s choice among the wgmma kernel's instantiations, read from the
    source: (rows up to which the first takes a window, its (slots, gwp), the other's)."""
    m = re.search(r"gh <= (\d+) \? launch_window_wg<(\d+), (\d+)> : "
                  r"launch_window_wg<(\d+), (\d+)>", FLAT_SRC)
    rows, *inst = map(int, m.groups())
    return rows, tuple(inst[:2]), tuple(inst[2:])


def wg_staging(gh, gw):
    """(gwp, ghp, shared bytes) of the wgmma windowed kernel for a (gh, gw) window, from
    the C side: the instantiation window_entry<80> launches and window_wg_smem's bytes."""
    rows, first, other = _wg_dispatch()
    slots, gwp = first if gh <= rows else other
    return gwp, slots // gwp, _c_function("window_wg_smem", slots=slots, S=gh * gw, gh=gh,
                                           gw=gw)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _swizzle(addr, span):
    """The hardware's 32B / 128B address swizzle (TMA writes and the wgmma descriptors'
    layout types 3 / 1 alike): the 16-byte chunk bits XOR the bits above the 128 bytes."""
    mask = {32: 1, 128: 7}[span]
    return addr ^ (((addr >> 7) & mask) << 4)


def _c_descriptor(name, addr):
    """csrc/attn.cu's ``name`` (sw128_desc or sw32_desc) evaluated at shared address
    ``addr``, from the C expression in the source."""
    body = SRC[SRC.index(f"uint64_t {name}(const void* p)"):]
    expr = body[body.index("return") + 6:body.index(";")]
    expr = " ".join(expr.replace("(uint64_t)", "").replace("smem_addr(p)", str(addr)).split())
    return eval(expr.replace("ull", ""))  # noqa: S307 - constants and shifts only


def _descriptor_reads(desc, rows, cols, mn_major):
    """Byte addresses a wgmma descriptor reads for a (rows x 16) K-major tile (row r, k
    column c: Q or K) or a (16 keys x cols) MN-major one (key r, column c: V through the
    transpose bit): the swizzled modes' canonical layouts, then the address swizzle."""
    start = (desc & 0x3FFF) << 4
    lead = ((desc >> 16) & 0x3FFF) << 4
    stride = ((desc >> 32) & 0x3FFF) << 4
    span = {1: 128, 3: 32}[desc >> 62]
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    lin = start + (r // 8) * stride + (r % 8) * span
    if mn_major:
        lin = lin + (c // (span // 2)) * lead + (c % (span // 2)) * 2
    else:
        lin = lin + c * 2
    return _swizzle(lin, span)


def _box_offsets(rows, base):
    """Where a TMA box of ``rows`` rows of 80 bf16 columns puts element (row, col): columns
    0-63 by the 128B-swizzled 64-column box (rows of 128 bytes from ``base``), columns 64-79
    by the 32B-swizzled 16-column box (rows of 32 bytes after the first panel)."""
    r, c = np.meshgrid(np.arange(rows), np.arange(D), indexing="ij")
    return np.where(c < 64, base + _swizzle(r * 128 + c * 2, 128),
                    base + rows * 128 + _swizzle(r * 32 + (c - 64) * 2, 32))


def _slot_tokens(gh, gw):
    """The key slots of the 4-D box (NSLOT / gwp key rows x gwp slots, row-major) and the
    window token each holds, -1 where TMA zero-fills (a column past gw, a row past gh)."""
    slots, gwp = cuda_attn._wg_shape(gh, gw, D)
    j = np.arange(slots)
    u, kx = j // gwp, j % gwp
    return np.where((u < gh) & (kx < gw), u * gw + kx, -1), gwp


WINDOWS = [(14, 14), (7, 7), (16, 16), (13, 13), (4, 4), (3, 11), (12, 8)]


@pytest.mark.parametrize("grid", WINDOWS, ids=[f"{h}x{w}" for h, w in WINDOWS])
def test_box_slot_order_and_panels_are_read_as_tma_wrote_them(grid):
    """Slot j holds token (j // gwp) gw + j % gwp when j % gwp < gw (and its row is in the
    window), zero otherwise; every (slot, column) of K is read once over q.k's five k-steps
    and every one of V once over p.v's, at the bytes TMA wrote it to; so too Q's strips
    (the q.k A descriptors)."""
    gh, gw = grid
    tokens, gwp = _slot_tokens(gh, gw)
    slots = len(tokens)
    assert slots % 16 == 0 and slots <= 256
    # the box order: the row-major (key row, slot) walk TMA makes over (gw, gh) coordinates
    for j in range(slots):
        ky, kx = divmod(j, gwp)
        assert tokens[j] == (ky * gw + kx if kx < gw and ky < gh else -1)
    assert sorted(t for t in tokens if t >= 0) == list(range(gh * gw))
    base = 1 << 15  # a 1024-aligned stage
    tma = _box_offsets(slots, base)
    assert np.array_equal(np.sort(tma.ravel()), base + 2 * np.arange(slots * D))
    seen = np.zeros((slots, D), int)
    for kk in range(5):  # q.k: B = K, K-major
        desc = (_c_descriptor("sw128_desc", base) + kk * 2 if kk < 4
                else _c_descriptor("sw32_desc", base + slots * 128))
        np.testing.assert_array_equal(_descriptor_reads(desc, slots, 16, False),
                                      tma[:, 16 * kk:16 * kk + 16])
        seen[:, 16 * kk:16 * kk + 16] += 1
    assert (seen == 1).all()
    seen[:] = 0
    for kk in range(slots // 16):  # p.v: B = V, MN-major, issue_pv's descriptors
        keys = slice(16 * kk, 16 * kk + 16)
        np.testing.assert_array_equal(
            _descriptor_reads(_c_descriptor("sw128_desc", base + kk * 16 * 128), 16, 64, True),
            tma[keys, :64])
        np.testing.assert_array_equal(
            _descriptor_reads(_c_descriptor("sw32_desc", base + slots * 128 + kk * 16 * 32),
                              16, 16, True), tma[keys, 64:])
        seen[keys] += 1
    assert (seen == 1).all()
    # Q: 256 rows by the 3-D box; strip w's A descriptors read rows 64w..64w+63
    wq = cuda_attn.WG_QUERY_ROWS
    qtma = _box_offsets(wq, base)
    for strip in range(4):
        rows = slice(64 * strip, 64 * strip + 64)
        for kk in range(5):
            desc = (_c_descriptor("sw128_desc", base + strip * 64 * 128) + kk * 2 if kk < 4
                    else _c_descriptor("sw32_desc", base + wq * 128 + strip * 64 * 32))
            np.testing.assert_array_equal(_descriptor_reads(desc, 64, 16, False),
                                          qtma[rows, 16 * kk:16 * kk + 16])


@pytest.mark.parametrize("grid", WINDOWS, ids=[f"{h}x{w}" for h, w in WINDOWS])
def test_projection_units_cover_each_entry_once(grid):
    """window_projections_ahead's work split: unit u < gh is grid row u's tokens u gw + i
    against rh[u], unit gh + x column x's tokens x + i gw against rw[x]; projection warp w
    of 3 takes units w, w + 3, ..., two a trip; a unit's fragment rows g and g + 8 read
    tokens clamped to its last one and its B columns 8h + g table rows clamped to the last,
    but only rows < nrows and columns < ncols are stored. Every (token, column) of both
    projections is written once, and the sums equal ``bias_projections``."""
    gh, gw = grid
    for stmt in ("const int nrows = is_h ? gw : gh, ncols = is_h ? gh : gw;",
                 "const int tok0 = is_h ? grp * gw : grp, tstep = is_h ? 1 : gw;",
                 "for (int u0 = pw; u0 < units; u0 += 2 * W_PROJ_WARPS) {",
                 "const int u = u0 + W_PROJ_WARPS * k;", "if (i >= nrows) continue;",
                 "row[c0 + j] = (c[k][h][1][2 * r + j] + c[k][h][0][2 * r + j]) * LOG2E;"):
        assert stmt in FLAT_SRC, stmt
    warps = _constant("W_PROJ_WARPS")
    assert warps == 3
    rng = np.random.default_rng(3)
    s = gh * gw
    q = rng.standard_normal((s, D)).astype(np.float32)
    rh = rng.standard_normal((gh, gh, D)).astype(np.float32)
    rw = rng.standard_normal((gw, gw, D)).astype(np.float32)
    got = {True: np.zeros((s, gh)), False: np.zeros((s, gw))}
    writes = {True: np.zeros((s, gh), int), False: np.zeros((s, gw), int)}
    units = gh + gw
    for pw in range(warps):
        for u0 in range(pw, units, 2 * warps):
            for u in (u0, u0 + warps):
                if u >= units:
                    break
                is_h = u < gh
                grp = u if is_h else u - gh
                nrows, ncols = (gw, gh) if is_h else (gh, gw)
                tok0, tstep = (grp * gw, 1) if is_h else (grp, gw)
                tab = (rh if is_h else rw)[grp]
                rows = [tok0 + min(i, nrows - 1) * tstep for i in range(16)]
                cols = [min(c, ncols - 1) for c in range(16)]
                prod = q[rows] @ tab[cols].T  # the unit's 16 x 16 tile
                for i in range(min(16, nrows)):
                    for c in range(min(16, ncols)):
                        got[is_h][tok0 + i * tstep, c] = prod[i, c]
                        writes[is_h][tok0 + i * tstep, c] += 1
    assert (writes[True] == 1).all() and (writes[False] == 1).all()
    want_h, want_w = cuda_attn.bias_projections(torch.from_numpy(q)[None], torch.from_numpy(rh),
                                                torch.from_numpy(rw), grid)
    np.testing.assert_allclose(got[True], want_h[0].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got[False], want_w[0].numpy(), rtol=1e-4, atol=1e-4)


def _pack_table():
    """window_softmax's packing, read from the source: p[kk][i] = (s[8 kk + a] * il_r,
    s[8 kk + b] * il_r), il_r the reciprocal row sum of row g (r = 0) or g + 8 (r = 1)."""
    body = SRC[SRC.index("void window_softmax("):SRC.index("void window_projections_ahead(")]
    got = re.findall(r"p\[kk\]\[(\d)\] = pack_bf16\(s\[8 \* kk(?: \+ (\d))?\] \* il(\d), "
                     r"s\[8 \* kk \+ (\d)\] \* il(\d)\)", body)
    assert all(r0 == r1 for _, _, r0, _, r1 in got)
    return {int(i): (int(a or 0), int(b), int(r)) for i, a, r, b, _ in got}


@pytest.mark.parametrize("slots,gwp", [(224, 16), (256, 16)])
def test_accumulator_fragment_maps_rows_slots_and_rel_w_columns(slots, gwp):
    """The m64n<slots> accumulator of a warpgroup: register 4j + e of lane (g, t) in warp
    w is (row 16w + g, slot 8j + 2t + e), 4j + 2 + e is row 16w + g + 8: each (row, slot)
    once. Slot 8j + 2t + e is key row j // JG, column 8 (j % JG) + 2t + e (JG = gwp / 8),
    the rel-w register [j % JG][e] the lane loads from column 8 jg + 2t + e. And p's packing
    gives the A fragment of p.v's k-step kk: a0 (row g, keys 16kk + 2t + {0, 1}), a1 (row
    g + 8, the same keys), a2 / a3 the same 8 keys on."""
    jg_n = gwp // 8
    seen = np.zeros((64, slots), int)
    for w in range(4):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for j in range(slots // 8):
                for e in range(2):
                    slot = 8 * j + 2 * t + e
                    seen[16 * w + g, slot] += 1
                    seen[16 * w + g + 8, slot] += 1
                    assert slot // gwp == j // jg_n
                    assert slot % gwp == 8 * (j % jg_n) + 2 * t + e
    assert (seen == 1).all()
    assert (slots, gwp) in _wg_dispatch()[1:]
    assert "const int col = 8 * jg + 2 * t + e;" in FLAT_KERNEL
    pack = _pack_table()
    assert len(pack) == 4

    def reg_slot(reg, t):  # (row half, slot) of accumulator register reg of lane t
        j, e = divmod(reg, 4)
        return e // 2, 8 * j + 2 * t + e % 2

    for kk in range(slots // 16):
        for t in range(4):
            want = {0: (0, 16 * kk + 2 * t), 1: (1, 16 * kk + 2 * t),
                    2: (0, 16 * kk + 8 + 2 * t), 3: (1, 16 * kk + 8 + 2 * t)}
            for i, (a, b, r) in pack.items():
                lo, hi = reg_slot(8 * kk + a, t), reg_slot(8 * kk + b, t)
                assert lo == want[i] and hi == (want[i][0], want[i][1] + 1)
                assert r == want[i][0]  # normalized by its own row's sum


def _softmax_model(q, k, v, rh, rw, grid, scale):
    """The kernel's numerics in f32 on bf16 inputs: K and V in the box's slot order (zero in
    pad slots), the projections x log2 e, each score s' = q.k scale log2 e + (rel-h of its
    key row, -inf past gh) + (rel-w of its column, -inf past gw), one pass over all slots:
    m = max s', p = 2^(s' - m) / sum, rounded to bf16 for p.v, the output rounded to
    bf16."""
    gh, gw = grid
    tokens, gwp = _slot_tokens(gh, gw)
    j = np.arange(len(tokens))
    pad = torch.from_numpy(tokens < 0)
    idx = torch.from_numpy(np.maximum(tokens, 0))
    ks = k[:, idx].masked_fill(pad[None, :, None], 0.0)
    vs = v[:, idx].masked_fill(pad[None, :, None], 0.0)
    rel_h, rel_w = cuda_attn.bias_projections(q, rh, rw, grid)
    log2e = 1.0 / math.log(2.0)
    u, kx = torch.from_numpy(j // gwp), torch.from_numpy(j % gwp)
    h = torch.where(u < gh, rel_h[..., u.clamp(max=gh - 1)] * log2e, -math.inf)
    w = torch.where(kx < gw, rel_w[..., kx.clamp(max=gw - 1)] * log2e, -math.inf)
    s = torch.matmul(q, ks.transpose(1, 2)) * (scale * log2e) + (h + w)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.matmul(p.to(torch.bfloat16).float(), vs).to(torch.bfloat16).float()


@pytest.mark.parametrize("window", [14, 7, 16])
def test_one_pass_softmax_model_matches_pallas_bf16(window):
    """The model of the kernel's one-pass softmax over padded slots with bf16 p, at 14x14,
    7x7 and 16x16 windows and head dim 80, against ``pallas_windowed_attention`` in
    interpret mode at bf16, within the bf16 tier."""
    grid = (window, window)
    rng = np.random.default_rng(29)
    s = window * window
    q, k, v = (rng.standard_normal((1, 2, s, D)).astype(np.float32) for _ in range(3))
    rh = (rng.standard_normal((window, window, D)) * 0.2).astype(np.float32)
    rw = (rng.standard_normal((window, window, D)) * 0.2).astype(np.float32)
    scale = D ** -0.5
    j = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    want = np.asarray(pallas_windowed_attention(j(q), j(k), j(v), jnp.asarray(rh),
                                                jnp.asarray(rw), grid, scale)
                      .astype(jnp.float32)).reshape(2, s, D)
    t = lambda a: torch.from_numpy(a.reshape(2, s, D)).to(torch.bfloat16).float()  # noqa: E731
    got = _softmax_model(t(q), t(k), t(v), torch.from_numpy(rh), torch.from_numpy(rw), grid,
                         scale).numpy()
    limit = 2.0 ** -7 * np.abs(want) + 2.0 ** -9 * np.abs(want).max()
    err = np.abs(got - want)
    assert (err <= limit).all(), (err - limit).max()
    assert err.mean() <= 2.0 ** -8 * np.abs(want).mean()


def test_window_geometry_mirrors_the_wgmma_kernel_and_routes_each_window():
    """Every head-dim-80 window up to 16x16 goes to ``window_attn_kernel_wg`` with the C
    side's staging, within 227 KB: 224 slots (14 key rows of 16) up to 14 rows, else 256;
    wider or taller windows keep ``window_attn_kernel<80, ntw>``, and head dim 64 its own
    kernel; the instantiations named are the ones the source launches."""
    rows, first, other = _wg_dispatch()
    assert (rows, first, other) == (14, (224, 16), (256, 16))
    assert re.search(r"if \(gh <= 16 && gw <= 16\) \{ auto launch = gh <= 14", FLAT_SRC)
    for gh in range(1, 17):
        for gw in range(1, 17):
            gwp, ghp, smem = cuda_attn.window_geometry(gh, gw, D)
            assert (gwp, ghp, smem) == wg_staging(gh, gw)
            assert smem <= SMEM_LIMIT and ghp * gwp <= 256 and gwp >= gw and ghp >= gh
            assert cuda_attn.window_kernel(gh, gw, D) == (
                f"window_attn_kernel_wg<{ghp * gwp}, {gwp}>")
            assert cuda_attn.window_kernel(gh, gw, 64).startswith("window_attn_kernel<64, ")
    # SAM's 14x14: Q 40,960 + one K + V stage 71,680 + 8 mbarriers + 2 x 196 x (15 + 14)
    # x 4 of projections
    assert cuda_attn.window_geometry(14, 14, D) == (
        16, 14, 1024 + 40960 + 71680 + 64 + 2 * 22736) == (16, 14, 159200)
    assert cuda_attn.window_geometry(16, 16, D) == (16, 16, 1024 + 40960 + 81920 + 64
                                                    + 2 * 256 * 33 * 4)
    # 7x7 on the 224-slot instantiation: 49 x (7 + 7) x 4 = 2,744 bytes of projections,
    # 2,752 rounded up to 16
    assert cuda_attn.window_geometry(7, 7, D) == (16, 14, 1024 + 40960 + 71680 + 64
                                                  + 2 * 2752)
    for grid, kernel in (((20, 12), "window_attn_kernel<80, 2>"),
                         ((17, 8), "window_attn_kernel<80, 1>"),
                         ((4, 32), "window_attn_kernel<80, 4>"),
                         ((1, 64), "window_attn_kernel<80, 8>"),
                         ((15, 3), "window_attn_kernel_wg<256, 16>"),
                         ((14, 14), "window_attn_kernel_wg<224, 16>")):
        assert cuda_attn.window_kernel(*grid, D) == kernel
        assert cuda_attn.window_geometry(*grid, D)[2] <= SMEM_LIMIT


@pytest.mark.parametrize("bh", [1, 7, 131, 132, 133, 1600, 3136])
def test_persistent_loop_visits_every_window_head_once(bh):
    """min(BH, SMs) CTAs, CTA b walking b, b + gridDim.x, ... < BH (the producer's, the
    projection warpgroup's and the consumers' loops alike): each window-head once; each
    CTA's i-th window-head waits on Q and the one K/V stage with parity i & 1 and on
    projection buffer i % 2 with parity (i / 2) & 1, and the producer refills Q and K/V
    after parity (i - 1) & 1 of their releases, so each barrier's phases alternate in
    order; and the two consumer warpgroups' strips c, c + 2, ... (the same count for
    both) cover each query strip once."""
    waits = {m.group(1): m.group(2) for m in re.finditer(
        r"mbar_wait\((qfull|kvfull|&pfull\[b\]|qempty|kvempty|&pempty\[b\]), ([^;]*)\);",
        FLAT_KERNEL)}
    assert waits == {"qfull": "i & 1", "kvfull": "i & 1", "&pfull[b]": "(i >> 1) & 1",
                     "qempty": "(i - 1) & 1", "kvempty": "(i - 1) & 1",
                     "&pempty[b]": "((i >> 1) - 1) & 1"}
    loop = "for (int bh = blockIdx.x; bh < BH; bh += gridDim.x, ++i) {"
    assert FLAT_KERNEL.count(loop) == 3  # producer, projections, strips
    assert re.search(r"kernel<<<BH < sms \? BH : sms, G_THREADS, smem, st>>>", FLAT_SRC)
    grid = min(bh, SMS)
    visits = np.zeros(bh, int)
    for b in range(grid):
        heads = list(range(b, bh, grid))
        visits[heads] += 1
        for ns in (1, 2):  # Q and K/V (one buffer each), the projections (two)
            phases = {}
            for i in range(len(heads)):
                phases.setdefault(i % ns, []).append((i // ns) & 1)
            for seq in phases.values():
                assert seq == [n & 1 for n in range(len(seq))]
    assert (visits == 1).all()
    assert "const int nk = (((S + 63) >> 6) + 1) >> 1;" in FLAT_KERNEL
    for s in range(1, 257):
        nstrip = -(-s // 64)
        nk = (nstrip + 1) >> 1
        strips = [c + 2 * k for c in (0, 1) for k in range(nk)]
        # each strip of the window once, and at most one strip past it (rows never stored,
        # still inside the 256 staged rows of Q)
        assert sorted(x for x in strips if x < nstrip) == list(range(nstrip))
        assert len(strips) - nstrip == nstrip % 2 and max(strips) < 4
