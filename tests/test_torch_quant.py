"""The int8 path of the port (``Config.quant``/``quant_storage``/``quant_kernel``) vs
``tmr_tpu`` on the same numpy inputs, on the CPU.

- The int8 grid (``ops/quant.py``): int8 values and scales equal to the JAX package's,
  bit for bit (the same f32 operations).
- ``int8_mm_plain`` equals ``tmr_tpu.ops.pallas_int8.int8_matmul`` in interpret mode bit
  for bit (exact int32 sums, the same epilogue); the int8 correlation equals
  ``_xcorr_int8dot`` bit for bit, and so does a numpy model of its card kernel's index
  maths (tiles, zero-filled window, the lanes' ``mma.sync`` fragments), whose int32 sums
  equal the JAX integer conv's on int8 values of full magnitude.
- The fused 3x3 layer (``int8_conv3x3``) equals the JAX int8dot arm's ``conv_mm`` then
  ``leaky_relu`` bit for bit, and the per-tap composition on the padded activation:
  quantizing the unpadded activation changes nothing. Under the int8 arm each 3x3 layer
  is one ``int8_conv`` call and the heads one ``int8_matmul`` call.
- ``fused_decoder_heads`` vs the JAX function for each arm, in f32 and bf16: the int8
  arm bit for bit (exact int32 sums, the same f32 epilogue and tap order); the others
  within 1e-5 of the map's max (f32 sums of exact products in another order; measured
  below 4e-7). Within the port, stored-dequant equals fake bit for bit and the int8 arm
  stays within the JAX package's output tier (5e-2) of the exact tail. At the production
  geometry, on inputs with the detector's own outliers, the int8 arm still equals the
  JAX function bit for bit, and the JAX function's error against its exact tail is
  pinned on both measures (both maps; the objectness map alone).
- The whole slice at the TINY geometry of ``tests/test_torch_predictor.py`` against a
  JAX ``Predictor`` with int8 storage and the int8dot arm: maps and kept scores within
  1e-3 of their max (measured 2e-7). The encoders agree to ~1e-6 (f32 sums in another
  order), so the tail's int8 inputs are the same except where a value lies within that
  of the midpoint between two int8 steps: it then rounds one step apart, which moves
  the outputs it feeds by one step of its scale (1/127 of the tensor's max) times a
  weight, one of the ~300 terms of each output here. The same detection slots are
  kept.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tmr_tpu.ops import fused_heads as jfh  # noqa: E402
from tmr_tpu.ops import quant as jq  # noqa: E402
from tmr_tpu.ops import xcorr as jxcorr  # noqa: E402
from tmr_tpu.ops.pallas_int8 import int8_matmul  # noqa: E402
from tmr_tpu_torch.config import Config, preset  # noqa: E402
from tmr_tpu_torch.ops import (_build, cuda_int8, cuda_xcorr, fused_heads, probe,  # noqa: E402
                                quant, xcorr)

OUTPUT_TIER_REL = 5e-2  # tmr_tpu/ops/quant.py:79


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _oihw(hwio):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(hwio).transpose(3, 2, 0, 1)))


# ------------------------------------------------------------------ the int8 grid


@pytest.mark.parametrize("shape", [(3, 3, 8, 6), (1, 1, 8, 1), (1, 1, 8, 4)])
def test_quantize_conv_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero output channel takes scale 1
    jq_, js = jq.quantize_int8(jnp.asarray(w), axis=2)
    q, s = quant.quantize_conv(_oihw(w))
    assert q.dtype == torch.int8 and q.is_contiguous()
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_).transpose(0, 1, 3, 2))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js)[:, :, 0, :])


def test_quantize_conv_matches_jax_quantize_tree():
    rng = np.random.default_rng(3)
    k = lambda *s: (rng.standard_normal(s) * 0.05).astype(np.float32)  # noqa: E731
    tree = {
        "decoder_o_0": {"conv_0": {"kernel": k(3, 3, 8, 8), "bias": np.zeros(8, np.float32)}},
        "decoder_b_0": {"conv_0": {"kernel": k(3, 3, 8, 8), "bias": np.zeros(8, np.float32)}},
        "objectness_head_0": {"conv": {"kernel": k(1, 1, 8, 1), "bias": np.zeros(1, np.float32)}},
        "ltrbs_head_0": {"conv": {"kernel": k(1, 1, 8, 4), "bias": np.zeros(4, np.float32)}},
    }
    qp = jq.quantize_tree(tree)
    for path in qp.paths:
        mod, *rest = path.split("/")
        sub = rest[:-1]
        want_q = qp.tree[mod]
        want_s = qp.scales[mod]
        w = tree[mod]
        for name in sub:
            want_q, want_s, w = want_q[name], want_s[name], w[name]
        q, s = quant.quantize_conv(_oihw(w["kernel"]))
        np.testing.assert_array_equal(q.numpy(),
                                      np.asarray(want_q["kernel"]).transpose(0, 1, 3, 2))
        np.testing.assert_array_equal(s.numpy(), np.asarray(want_s["kernel"])[:, :, 0, :])
    assert qp.weight_bytes == sum(np.asarray(qp.tree[p.split("/")[0]][p.split("/")[1]]
                                             ["kernel"]).size for p in qp.paths)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fake_quant_and_templates_match_jax(dtype):
    rng = np.random.default_rng(5)
    w = rng.standard_normal((6, 10)).astype(np.float32)  # (O, I)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = quant.fake_quant(torch.from_numpy(w), dim=1, dtype=tdt).float().numpy()
    want = np.asarray(jq.fake_quant(jnp.asarray(w.T), axis=0, dtype=jdt), np.float32).T
    np.testing.assert_array_equal(got, want)
    tm = rng.standard_normal((2, 3, 5, 5)).astype(np.float32)
    got_t = quant.quantize_template(torch.from_numpy(tm), tdt).float().numpy()
    want_t = np.asarray(jq.quantize_template(jnp.asarray(tm), dtype=jdt), np.float32)
    np.testing.assert_array_equal(got_t, want_t)
    q, s = quant.quantize_int8_template(torch.from_numpy(tm))
    jq_, js = jq.quantize_int8_template(jnp.asarray(tm))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


# ------------------------------------------------------------------ kernel 7: int8_mm


@pytest.mark.parametrize("m,k,n", [(200, 300, 70), (37, 64, 5), (130, 1000, 200)])
def test_int8_mm_plain_matches_pallas_interpret(m, k, n):
    rng = np.random.default_rng(m + k + n)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sx = (rng.random((m, 1)) * 0.01 + 1e-4).astype(np.float32)
    sw = (rng.random((1, n)) * 0.01 + 1e-4).astype(np.float32)
    want = np.asarray(int8_matmul(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sx),
                                  jnp.asarray(sw), interpret=True))
    before = dict(_build.LAUNCHES)
    got = cuda_int8.int8_mm(torch.from_numpy(xq), torch.from_numpy(np.ascontiguousarray(wq.T)),
                            torch.from_numpy(sx[:, 0]), torch.from_numpy(sw[0]))
    np.testing.assert_array_equal(got.numpy(), want)
    assert _build.LAUNCHES == before  # the plain version launches nothing


def test_int8_mm_reads_a_tap_window_through_its_strides():
    """A 3x3 tap's shifted window of the padded activation is passed as a view: the
    kernel's row dims and byte strides, and the plain result equals the copy's."""
    rng = np.random.default_rng(0)
    xp = torch.from_numpy(rng.integers(-127, 128, (2, 7, 9, 16)).astype(np.int8))
    view = xp[:, 1:6, 2:9, :]
    assert cuda_int8._row_layout(view) == (5, 7, 7 * 9 * 16, 9 * 16, 16)
    assert cuda_int8._row_layout(xp.reshape(-1, 16)) == (1, 2 * 7 * 9, 0, 0, 16)
    w = torch.from_numpy(rng.integers(-127, 128, (3, 16)).astype(np.int8))
    sx = torch.from_numpy(rng.random((2, 5, 7)).astype(np.float32))
    sw = torch.from_numpy(rng.random(3).astype(np.float32))
    got = cuda_int8.int8_mm(view, w, sx, sw)
    want = cuda_int8.int8_mm(view.contiguous(), w, sx, sw)
    assert got.shape == (2, 5, 7, 3)
    assert torch.equal(got, want)


# ------------------------------------------------------- kernel 7: the fused 3x3 layer


def _conv_inputs(b, h, w, c, n, zero_image=False, seed=0):
    """A bf16-valued activation (one image all zero if asked) and a 3x3 layer's HWIO
    weights and bias, from numpy."""
    rng = np.random.default_rng(seed + b + h + w + c + n)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    if zero_image:
        x[-1] = 0.0
    x = torch.from_numpy(x).bfloat16().float().numpy()
    wk = (rng.standard_normal((3, 3, c, n)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return x, wk, bias


def _port_conv_operands(x, wk, bias):
    xq, xs = fused_heads._quant_act(torch.from_numpy(x))
    wq, sw = quant.quantize_conv(_oihw(wk))
    return xq, xs, wq, sw, torch.from_numpy(bias)


#: (B, H, W, C_in, N, last image all zero)
CONV_SHAPES = {"2x8x8x16-8": (2, 8, 8, 16, 8, False),
               "ragged-1x5x7x32-12": (1, 5, 7, 32, 12, False),
               "zero-image-2x6x6x16-8": (2, 6, 6, 16, 8, True)}


@pytest.mark.parametrize("shape", list(CONV_SHAPES))
def test_int8_conv3x3_plain_matches_jax_int8dot(shape):
    """The fused layer's plain version equals the JAX int8dot arm's conv_mm followed by
    jax.nn.leaky_relu bit for bit (exact int32 sums, the same epilogue, tap order and
    bias add). An all-zero image quantizes with scale 1."""
    b, h, w, c, n, zero = CONV_SHAPES[shape]
    x, wk, bias = _conv_inputs(b, h, w, c, n, zero)
    jw, js = jq.quantize_int8(jnp.asarray(wk), axis=2)
    want = np.asarray(jax.nn.leaky_relu(jfh.conv_mm(
        jnp.asarray(x), jw, jnp.asarray(bias), dtype=jnp.float32, quant="stored", scale=js,
        kernel_arm="int8dot"), 0.01))
    xq, xs, wq, sw, tb = _port_conv_operands(x, wk, bias)
    if zero:
        assert xs[-1].item() == 1.0 and not xq[-1].any()
    before = dict(_build.LAUNCHES)
    got = cuda_int8.int8_conv3x3(xq, xs, wq, sw, tb, 0.01)
    assert _build.LAUNCHES == before  # the plain version launches nothing
    assert got.shape == (b, h, w, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(cuda_int8.int8_conv3x3_plain(xq, xs, wq, sw, tb).numpy(),
                                  want)


@pytest.mark.parametrize("shape", list(CONV_SHAPES))
def test_int8_conv3x3_equals_the_padded_tap_composition(shape):
    """Quantizing the unpadded activation changes nothing: the fused layer on it equals
    the per-tap composition that quantizes the zero-padded activation (conv_mm with the
    int8 product's plain version, then F.leaky_relu), bit for bit."""
    b, h, w, c, n, zero = CONV_SHAPES[shape]
    x, wk, bias = _conv_inputs(b, h, w, c, n, zero, seed=1)
    xq, xs, wq, sw, tb = _port_conv_operands(x, wk, bias)
    xt = torch.from_numpy(x)
    pq, ps = fused_heads._quant_act(torch.nn.functional.pad(xt, (0, 0, 1, 1, 1, 1)))
    assert torch.equal(ps, xs) and torch.equal(pq[:, 1:-1, 1:-1], xq)
    want = torch.nn.functional.leaky_relu(fused_heads.conv_mm(
        xt, wq, tb, torch.float32, "stored", sw, "int8",
        int8_matmul=cuda_int8.int8_mm_plain), 0.01)
    assert torch.equal(cuda_int8.int8_conv3x3(xq, xs, wq, sw, tb, 0.01), want)


@pytest.mark.parametrize("bad", ["xq_3d", "wq_channels", "wq_1x1", "sx", "sw", "bias"])
def test_int8_conv3x3_rejects_shapes(bad):
    xq, xs, wq, sw, tb = _port_conv_operands(*_conv_inputs(2, 4, 4, 16, 8))
    args = dict(xq=xq, sx=xs, wq=wq, sw=sw, bias=tb)
    args.update({"xq_3d": dict(xq=xq[0]), "wq_channels": dict(wq=wq[..., :8]),
                 "wq_1x1": dict(wq=wq[:1, :1]), "sx": dict(sx=xs[:1]),
                 "sw": dict(sw=sw[:, :, :4]), "bias": dict(bias=tb[:4])}[bad])
    with pytest.raises(ValueError, match="int8_conv3x3"):
        cuda_int8.int8_conv3x3(**args)
    with pytest.raises(ValueError, match="int8_conv3x3"):
        cuda_int8.int8_conv3x3_plain(**args)


@pytest.mark.parametrize("layers", [1, 2])
def test_int8_arm_calls_the_fused_layer_once_per_3x3_layer(layers):
    """Under the int8 arm every 3x3 layer is one int8_conv call (the combined first
    layer, then one per stack) and the heads one int8_matmul call; the dequant arm calls
    neither. The injected plain versions give the default wrappers' result."""
    calls = {"conv": 0, "mm": 0}

    def conv(*a):
        calls["conv"] += 1
        return cuda_int8.int8_conv3x3_plain(*a)

    def mm(*a):
        calls["mm"] += 1
        return cuda_int8.int8_mm_plain(*a)

    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, 6, 6, 16))
                         .astype(np.float32))
    entries = _port_entries(_tail_params(layers=layers, seed=3), stored=True)
    got = fused_heads.fused_decoder_heads(x, *entries, dtype=torch.float32, quant="stored",
                                          kernel_arm="int8", int8_matmul=mm, int8_conv=conv)
    assert calls == {"conv": 1 + 2 * (layers - 1), "mm": 1}
    want = fused_heads.fused_decoder_heads(x, *entries, dtype=torch.float32, quant="stored",
                                           kernel_arm="int8")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    fused_heads.fused_decoder_heads(x, *entries, dtype=torch.float32, quant="stored",
                                    kernel_arm="dequant", int8_matmul=mm, int8_conv=conv)
    assert calls == {"conv": 1 + 2 * (layers - 1), "mm": 1}


# ------------------------------------------------------------- the int8 correlation


@pytest.mark.parametrize("t", [3, 9, 17])
def test_xcorr_int8dot_matches_jax(t):
    rng = np.random.default_rng(t)
    f = rng.standard_normal((2, 3, 12, 14)).astype(np.float32)
    tm = rng.standard_normal((2, 3, t, t)).astype(np.float32)
    want = np.asarray(jxcorr._xcorr_int8dot(jnp.asarray(f), jnp.asarray(tm)))
    got = xcorr.xcorr_int8dot(torch.from_numpy(f), torch.from_numpy(tm)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel,jax_kernel", [("dequant", "dequant"), ("int8", "int8dot")])
def test_cross_correlation_quant_arms_match_jax(monkeypatch, kernel, jax_kernel):
    monkeypatch.setenv("TMR_QUANT", "int8")
    monkeypatch.setenv("TMR_QUANT_KERNEL", jax_kernel)
    rng = np.random.default_rng(11)
    f = rng.standard_normal((2, 4, 16, 16)).astype(np.float32)
    tm = rng.standard_normal((2, 4, 9, 9)).astype(np.float32)
    thw = np.array([[5, 7], [3, 1]], np.int32)
    want = np.asarray(jxcorr.cross_correlation(jnp.asarray(f), jnp.asarray(tm),
                                               jnp.asarray(thw)))
    got = xcorr.cross_correlation(torch.from_numpy(f), torch.from_numpy(tm),
                                  torch.from_numpy(thw), quant="int8", kernel=kernel).numpy()
    assert _rel_err(got, want) < 1e-5
    exact = xcorr.cross_correlation(torch.from_numpy(f), torch.from_numpy(tm),
                                    torch.from_numpy(thw)).numpy()
    assert 0 < _rel_err(got, exact) < OUTPUT_TIER_REL


# ------------------------------------------------------------------ the fused tail


def _tail_params(c_in=16, c=16, layers=1, seed=0):
    """JAX-layout (HWIO) decoder/head params, small non-zero biases."""
    rng = np.random.default_rng(seed)
    stack = lambda: [((rng.standard_normal((3, 3, c_in if i == 0 else c, c)) * 0.05)  # noqa: E731
                      .astype(np.float32), (rng.standard_normal(c) * 0.01).astype(np.float32))
                     for i in range(layers)]
    head = lambda n: ((rng.standard_normal((1, 1, c, n)) * 0.05).astype(np.float32),  # noqa: E731
                      (rng.standard_normal(n) * 0.01).astype(np.float32))
    return stack(), stack(), head(1), head(4)


def _jax_entries(params, stored):
    def one(w, b):
        if stored:
            q, s = jq.quantize_int8(jnp.asarray(w), axis=2)
            return (q, jnp.asarray(b), s)
        return (jnp.asarray(w), jnp.asarray(b))
    dec_o, dec_b, ho, hb = params
    return [one(*e) for e in dec_o], [one(*e) for e in dec_b], one(*ho), one(*hb)


def _port_entries(params, stored):
    def one(w, b):
        w = _oihw(w)
        if stored:
            q, s = quant.quantize_conv(w)
            return (q, torch.from_numpy(b), s)
        return (w, torch.from_numpy(b))
    dec_o, dec_b, ho, hb = params
    return [one(*e) for e in dec_o], [one(*e) for e in dec_b], one(*ho), one(*hb)


# (port quant, port arm, JAX quant, JAX arm)
ARMS = {
    "exact": (False, "dequant", False, "dequant"),
    "fake": (True, "dequant", True, "dequant"),
    "stored_dequant": ("stored", "dequant", "stored", "dequant"),
    "stored_int8": ("stored", "int8", "stored", "int8dot"),
}


def _run_port(x, params, dtype, arm):
    pq, parm, _, _ = ARMS[arm]
    tdt = getattr(torch, dtype)
    o, r = fused_heads.fused_decoder_heads(torch.from_numpy(x).to(tdt),
                                           *_port_entries(params, pq == "stored"),
                                           dtype=tdt, quant=pq, kernel_arm=parm)
    return o.numpy(), r.numpy()


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arm", list(ARMS))
def test_fused_decoder_heads_matches_jax(arm, dtype, layers):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    params = _tail_params(layers=layers)
    _, _, jquant, jarm = ARMS[arm]
    jdt = getattr(jnp, dtype)
    wo, wr = jfh.fused_decoder_heads(jnp.asarray(x, jdt),
                                     *_jax_entries(params, jquant == "stored"),
                                     dtype=jdt, quant=jquant, kernel_arm=jarm)
    o, r = _run_port(x, params, dtype, arm)
    assert o.shape == (2, 8, 8, 1) and r.shape == (2, 8, 8, 4)
    if arm == "stored_int8":
        np.testing.assert_array_equal(o, np.asarray(wo))
        np.testing.assert_array_equal(r, np.asarray(wr))
    assert _rel_err(o, wo) < 1e-5
    assert _rel_err(r, wr) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stored_dequant_equals_fake_bitwise(dtype):
    """The quant_storage_ok pin: same grid, same scales, the same operand."""
    x = np.random.default_rng(8).standard_normal((1, 8, 8, 16)).astype(np.float32)
    params = _tail_params(layers=2, seed=1)
    fo, fr = _run_port(x, params, dtype, "fake")
    so, sr = _run_port(x, params, dtype, "stored_dequant")
    np.testing.assert_array_equal(fo, so)
    np.testing.assert_array_equal(fr, sr)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_arm_within_output_tier(dtype):
    """The quant_int8dot_ok tier: the int8 arm within 5e-2 of the exact tail."""
    x = np.random.default_rng(9).standard_normal((1, 8, 8, 16)).astype(np.float32)
    params = _tail_params(seed=2)
    eo, er = _run_port(x, params, dtype, "exact")
    io, ir = _run_port(x, params, dtype, "stored_int8")
    scale = max(np.abs(eo).max(), np.abs(er).max())
    rel = max(np.abs(io - eo).max(), np.abs(ir - er).max()) / scale
    assert 0 < rel < OUTPUT_TIER_REL


def _fcat_like(rng, offsets: bool, h=128, c=1024):
    """A (1, h, h, c) decoder input. ``offsets``: the statistics of the detector's own
    ``f_cat`` (TMR_FSCD147, seeded weights, image 0 of ``chip_smoke.py``; measured on the
    card): per-channel offsets (rms ~1.1, the matcher half's centred on 0.67) over a
    spatial variation of std 0.3, and in the matcher half a few channels of std 3 whose
    extremes set the per-image int8 step (amax/std ~12 in that half, ~5 in the
    projection half; measured 9.8 and 4.1). Without: zero-mean channels of std 1.1 and
    the same outlier channels (the same amax/std in each half)."""
    half = c // 2
    if offsets:
        mu = np.concatenate([rng.normal(0.0, 1.06, half), rng.normal(0.67, 1.1, half)])
        sd = np.full(c, 0.3)
    else:
        mu, sd = np.zeros(c), np.full(c, 1.1)
    sd[half + rng.choice(half, 8, replace=False)] = 3.0
    return (mu + sd * rng.standard_normal((1, h, h, c))).astype(np.float32)


@pytest.mark.parametrize("offsets", [False, True])
def test_int8_arm_at_production_geometry_matches_jax(offsets):
    """The int8 arm at the production geometry (1 x 128^2 x 1024 -> 2 x 1024 channels,
    N(0, 0.01) weights, bf16), on inputs whose matcher half carries the outliers of the
    detector's ``f_cat``: the port equals the JAX function bit for bit, and the JAX
    function's own error against its exact tail is what the card shows. By the JAX
    tier's measure (max error over both maps / their max) it is inside 5e-2 either way
    (measured 0.034 and 0.046). The objectness map alone, relative to its own max, is
    inside it without the per-channel offsets (0.032) and outside with them (0.083):
    the step, amax/127, is set by offsets and outliers, while the map follows the
    channels' small spatial variation. ``chip_smoke.py`` prints both measures for the
    detector's own ``f_cat`` on the card (PERF.md)."""
    rng = np.random.default_rng(0)
    x = _fcat_like(rng, offsets)
    c = x.shape[-1]
    w = [(rng.standard_normal(s) * 0.01).astype(np.float32)
         for s in ((3, 3, c, c), (3, 3, c, c), (1, 1, c, 1), (1, 1, c, 4))]
    b = [np.zeros(n, np.float32) for n in (c, c, 1, 4)]
    params = [(w[0], b[0])], [(w[1], b[1])], (w[2], b[2]), (w[3], b[3])
    xj = jnp.asarray(x, jnp.bfloat16)
    eo, er = (np.asarray(a) for a in jfh.fused_decoder_heads(
        xj, *_jax_entries(params, False), dtype=jnp.bfloat16, quant=False))
    jo, jr = (np.asarray(a) for a in jfh.fused_decoder_heads(
        xj, *_jax_entries(params, True), dtype=jnp.bfloat16, quant="stored",
        kernel_arm="int8dot"))
    o, r = _run_port(x, params, "bfloat16", "stored_int8")
    np.testing.assert_array_equal(o, jo)
    np.testing.assert_array_equal(r, jr)
    both = max(np.abs(jo - eo).max(), np.abs(jr - er).max()) / max(np.abs(eo).max(),
                                                                   np.abs(er).max())
    assert 0 < both < OUTPUT_TIER_REL
    obj = _rel_err(jo, eo)
    assert (obj > OUTPUT_TIER_REL) if offsets else (0 < obj < OUTPUT_TIER_REL)


def test_stored_tail_refuses_an_f32_kernel():
    x = torch.zeros(1, 4, 4, 16)
    dec_o, dec_b, ho, hb = _port_entries(_tail_params(), stored=False)
    s = torch.ones(3, 3, 16)
    with pytest.raises(TypeError, match="int8"):
        fused_heads.fused_decoder_heads(x, [(*dec_o[0], s)], [(*dec_b[0], s)],
                                        (*ho, torch.ones(1, 1, 1)), (*hb, torch.ones(1, 1, 4)),
                                        dtype=torch.float32, quant="stored")


# ----------------------------------------------------------------- selection errors


@pytest.mark.parametrize("fields,match", [
    (dict(quant_storage="int8"), "needs quant='int8'"),
    (dict(quant_kernel="int8"), "needs quant='int8'"),
    (dict(quant="int8", ablation_no_box_regression=True), "needs box_reg"),
    (dict(quant="int8", quant_storage="int8", ablation_no_box_regression=True),
     "needs box_reg"),
    (dict(quant="fp8"), "expected off | int8"),
    (dict(quant="int8", quant_kernel="pallas"), "expected dequant | int8"),
    (dict(quant="int8", quant_storage="bf16"), "expected off | int8"),
])
def test_refused_combinations_raise(fields, match):
    with pytest.raises(ValueError, match=match):
        preset("TMR_FSCD147", **fields)
    with pytest.raises(ValueError, match=match):
        Config(**fields)


def test_admitted_combinations_build():
    for fields in (dict(), dict(quant="int8"), dict(quant="int8", quant_kernel="int8"),
                   dict(quant="int8", quant_storage="int8"),
                   dict(quant="int8", quant_storage="int8", quant_kernel="int8")):
        cfg = preset("TMR_FSCD147", **fields)
        assert (cfg.quant, cfg.quant_storage) == (fields.get("quant", "off"),
                                                  fields.get("quant_storage", "off"))


# The int8 card kernel (csrc/xcorr.cu xcorr_int8_kernel) emulated on the CPU with its own
# index maths: its CTA tiles, the window staged from the 16-aligned column x0 - c - e with
# zero fill, and per template row i the mma.sync fragments each lane (g, q) loads: A words
# at column delta + 8 u + 4 q (u = nb + 4 kb; a2 the word of u + 2) of rows g and g + 8, B
# words of the zero-padded template row joined by the byte shift (o & 3), o = 4 q - g -
# rho + I8_TPAD, and an m16n8k16 tail block where int8_geometry says k16.


def _int8_band_columns(geo, wn):
    """For the n8 column tiles and the band's k slots (k-blocks in order, 32 deep, the
    last 16 deep where k16): the window column each A slot reads, (wn, depth); and for
    each B slot (k, n) the byte of the padded template row it reads, (depth, 8)."""
    g, q = np.arange(8)[:, None, None], np.arange(4)[None, :, None]
    kk = np.arange(4)[None, None, :]
    o = 4 * q - g - geo["rho"] + cuda_xcorr.INT8_TPAD
    a_cols = np.zeros((wn, geo["depth"]), np.int64)
    b_bytes = np.zeros((geo["depth"], 8), np.int64)
    for kb in range(geo["kb"]):
        halves = 1 if geo["k16"] and kb == geo["kb"] - 1 else 2
        for h in range(halves):
            # slots 32 kb + 16 h + 4 q + kk of the band, as the lane registers hold them
            slot = (32 * kb + 16 * h + 4 * q + kk)[0]  # (4, 4)
            for nb in range(wn):
                word = geo["delta"] // 4 + q[0] + 2 * (nb + 4 * kb + 2 * h)  # (4, 1)
                a_cols[nb, slot] = 4 * word + kk[0]
            word = (o >> 2) + 8 * kb + 4 * h  # (8, 4, 1): the first of the two words
            byte = 4 * word + (o & 3) + kk  # __byte_perm(w, w + 1, 0x3210 + 0x1111 (o & 3))
            for gg in range(8):
                b_bytes[slot, gg] = byte[gg]
    return a_cols, b_bytes


def _band_xcorr_int8(f, tm):
    """f (P, H, W), tm (P, T, T) int8 values -> (P, H, W) int64: the kernel's sums."""
    p, h, w = f.shape
    t = tm.shape[-1]
    c = t // 2
    geo = cuda_xcorr.int8_geometry(t)
    bm, bn = cuda_xcorr.INT8_BM, cuda_xcorr.INT8_BN
    wn = bn // 8
    e = geo["delta"] + geo["rho"]
    a_cols, b_bytes = _int8_band_columns(geo, wn)
    padded = np.zeros((p, t, geo["tpitch"]), np.float64)
    padded[:, :, cuda_xcorr.INT8_TPAD:cuda_xcorr.INT8_TPAD + t] = tm
    band = padded[:, :, b_bytes]  # (P, T, depth, 8)
    out = np.zeros((p, h, w), np.int64)
    rows = bm + t - 1
    for y0 in range(0, h, bm):
        for x0 in range(0, w, bn):
            ys, xs = y0 - c + np.arange(rows), x0 - c - e + np.arange(geo["cols"])
            ok = ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None, :]
            win = np.where(ok, f[:, ys.clip(0, h - 1)][:, :, xs.clip(0, w - 1)], 0.0)
            acc = np.zeros((p, bm, wn, 8))  # f64: every partial sum is an exact integer
            for i in range(t):
                a = win[:, i:i + bm][:, :, a_cols]  # (P, BM, WN, depth)
                acc += np.einsum("pmbk,pkn->pmbn", a, band[:, i], optimize=True)
            tile = acc.reshape(p, bm, bn).astype(np.int64)
            out[:, y0:y0 + bm, x0:x0 + bn] = tile[:, :h - y0, :w - x0]
    return out


def _int8_epilogue(acc, fs, ts):
    """float(acc) * (fs * ts), each step rounded to f32, as the kernel does."""
    return acc.astype(np.float32) * (fs * ts).astype(np.float32)


INT8_XCORR_MAP = (2, 3, 40, 53)  # odd W: rows not 16-byte aligned; one tile at T <= 65


def test_int8_geometry_fits_every_template():
    """Every odd T <= 65 fits a CTA's shared memory; the k-blocks cover the band (an n8
    tile needs T + 7 + rho columns of it) with no 16-deep block to spare."""
    for t in range(1, cuda_xcorr.MAX_T + 1, 2):
        geo = cuda_xcorr.int8_geometry(t)
        need = t + 7 + geo["rho"]
        assert geo["kb"] == -(-need // 32) and geo["kb"] in (1, 2, 3)
        assert geo["depth"] >= need > geo["depth"] - 16
        assert geo["delta"] % 4 == 0 and (geo["delta"] + geo["rho"] + t // 2) % 16 == 0
        assert geo["pitch"] % 32 == 16 and geo["pitch"] >= geo["cols"]
        assert geo["smem"] <= 227 * 1024
    assert [cuda_xcorr.int8_geometry(t)["depth"] for t in (9, 17, 33, 65)] == [16, 32, 48, 80]
    for bad in (0, 2, 67):
        with pytest.raises(ValueError, match="odd T"):
            cuda_xcorr.int8_geometry(bad)


@pytest.mark.parametrize("t", [1, 3, 9, 17, 33, 65])
def test_int8_band_model_equals_plain_and_jax_sums(t):
    """The kernel's index maths on int8 values of full magnitude (-128, -127, 127 only,
    and odd W): the same int32 sums as the JAX int8dot arm's integer conv (the call
    ``_xcorr_int8dot`` makes) and the same f32 map as ``xcorr_int8_plain``."""
    rng = np.random.default_rng(t)
    b, c, h, w = INT8_XCORR_MAP
    f = rng.choice(np.array([-128, -127, 127], np.int8), (b, c, h, w))
    tm = rng.choice(np.array([-128, -127, 127], np.int8), (b, c, t, t))
    fs = rng.uniform(1e-4, 1e-2, (b, c, 1, 1)).astype(np.float32)
    ts = rng.uniform(1e-4, 1e-2, (b, c, 1, 1)).astype(np.float32)
    acc = _band_xcorr_int8(f.reshape(b * c, h, w), tm.reshape(b * c, t, t))
    jax_acc = jax.lax.conv_general_dilated(
        jnp.asarray(f).reshape(1, b * c, h, w), jnp.asarray(tm).reshape(b * c, 1, t, t),
        window_strides=(1, 1), padding=[(t // 2, t // 2), (t // 2, t // 2)],
        feature_group_count=b * c, dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc, np.asarray(jax_acc).reshape(b * c, h, w))
    want = cuda_xcorr.xcorr_int8_plain(*(torch.from_numpy(a) for a in (f, tm, fs, ts)))
    got = _int8_epilogue(acc.reshape(b, c, h, w), fs, ts)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("t", [1, 3, 9, 17, 33, 65])
def test_int8_band_model_equals_jax_int8dot(t):
    """The kernel's index maths on the port's quantized operands of f32 inputs, with its
    epilogue, equals the JAX ``_xcorr_int8dot`` map bit for bit."""
    rng = np.random.default_rng(100 + t)
    b, c, h, w = INT8_XCORR_MAP
    f = rng.standard_normal((b, c, h, w)).astype(np.float32)
    tm = rng.standard_normal((b, c, t, t)).astype(np.float32)
    fq, fs = quant.quantize_int8(torch.from_numpy(f).reshape(b, c, h * w), -1)
    tq, ts = quant.quantize_int8_template(torch.from_numpy(tm))
    acc = _band_xcorr_int8(fq.reshape(b * c, h, w).numpy(), tq.reshape(b * c, t, t).numpy())
    got = _int8_epilogue(acc.reshape(b, c, h, w), fs.reshape(b, c, 1, 1).numpy(),
                         ts.numpy())
    want = np.asarray(jxcorr._xcorr_int8dot(jnp.asarray(f), jnp.asarray(tm)))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------- kernel 8: add1


def test_add1_plain_on_the_cpu():
    x = torch.zeros(256, 256)
    before = _build.LAUNCHES["add1"]
    y = probe.add1(x)
    assert torch.equal(y, torch.ones(256, 256))
    assert _build.LAUNCHES["add1"] == before
    assert torch.equal(probe.add1_plain(torch.tensor([1.5, -1.0])), torch.tensor([2.5, 0.0]))


def test_every_kernel_has_a_source_and_a_counter():
    for lib_name in _build.SIGNATURES:
        assert (_build.CSRC / f"{lib_name}.cu").is_file()
    assert set(_build.LAUNCHES) == {"global_attn", "window_attn", "xcorr", "nms",
                                    "xcorr_int8", "int8_mm", "int8_conv", "add1",
                                    "global_attn_d80", "window_attn_d80"}


def test_launch_binds_each_c_function_once(monkeypatch):
    """A C function is looked up through lib() (its lock, the attribute lookup) on its
    first launch only; every launch is counted, and a CUDA error code raises uncounted."""
    looked_up = []

    class FakeLib:
        def __getattr__(self, fn):
            looked_up.append(fn)
            return lambda rc: rc  # the C function returns its argument as the error code

    monkeypatch.setattr(_build, "_FNS", {})
    monkeypatch.setattr(_build, "lib", lambda name: FakeLib())
    monkeypatch.setitem(_build.LAUNCHES, "add1", 0)
    for _ in range(3):
        _build.launch("add1", "probe", "tmr_add1", 0)
    assert looked_up == ["tmr_add1"] and _build.LAUNCHES["add1"] == 3
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        _build.launch("add1", "probe", "tmr_add1", 7)
    assert looked_up == ["tmr_add1"] and _build.LAUNCHES["add1"] == 3


# ------------------------------------------------------- the whole slice at TINY


TINY = dict(embed_dim=32, depth=4, num_heads=2, global_attn_indexes=(1, 3),
            patch_size=8, window_size=3, out_chans=16)
SIZE = 32
EXEMPLARS = np.array([[[0.2, 0.2, 0.4, 0.5]], [[0.5, 0.55, 0.7, 0.6]],
                      [[0.1, 0.6, 0.15, 0.7]]], np.float32)
QUANT = dict(quant="int8", quant_storage="int8", quant_kernel="int8")


@pytest.fixture(scope="module")
def slice_pair():
    """A JAX Predictor under TMR_DECODER_IMPL=fused, TMR_QUANT=int8,
    TMR_QUANT_STORAGE=int8, TMR_QUANT_KERNEL=int8dot and the port's Predictor with the
    same fields, on the weights of ``tests/test_torch_predictor.py``."""
    from tmr_tpu.config import preset as j_preset
    from tmr_tpu.inference import Predictor as JPredictor
    from tmr_tpu.models.matching_net import MatchingNet as JMatchingNet
    from tmr_tpu.models.vit import SamViT as JSamViT
    from tmr_tpu_torch.inference import Predictor
    from tmr_tpu_torch.models import build_model
    from tmr_tpu_torch.models.vit import SamViT

    mp = pytest.MonkeyPatch()
    for name, val in (("TMR_DECODER_IMPL", "fused"), ("TMR_QUANT", "int8"),
                      ("TMR_QUANT_STORAGE", "int8"), ("TMR_QUANT_KERNEL", "int8dot")):
        mp.setenv(name, val)
    overrides = dict(emb_dim=16, compute_dtype="float32", image_size=SIZE)
    jmodel = JMatchingNet(backbone=JSamViT(pretrain_img_size=SIZE, **TINY), emb_dim=16,
                          fusion=True, feature_upsample=True, template_capacity=9)
    jpred = JPredictor(j_preset("TMR_FSCD147", **overrides), model=jmodel)
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                    jpred.init_params(0))
    rng = np.random.default_rng(1)
    params["objectness_head_0"]["conv"]["kernel"] *= 300.0
    bb = params["backbone"]
    bb["pos_embed"] = (rng.standard_normal(bb["pos_embed"].shape) * 0.1).astype(np.float32)
    for i in range(TINY["depth"]):
        for name in ("rel_pos_h", "rel_pos_w"):
            shape = bb[f"blocks_{i}"]["attn"][name].shape
            bb[f"blocks_{i}"]["attn"][name] = (rng.standard_normal(shape) * 0.5).astype(
                np.float32)
    jpred.params = params
    assert jpred._storage_state() is not None, "the JAX package must admit storage here"
    cfg = preset("TMR_FSCD147", **overrides, **QUANT)
    pred = Predictor(cfg, device="cpu",
                     model=build_model(cfg, backbone=SamViT(pretrain_img_size=SIZE, **TINY),
                                       device="cpu"))
    pred.load_jax_params(params)
    images = rng.standard_normal((3, SIZE, SIZE, 3)).astype(np.float32)
    yield jpred, pred, images
    mp.undo()


def test_slice_maps_match_jax(slice_pair):
    jpred, pred, images = slice_pair
    cap = jpred.pick_capacity(EXEMPLARS, SIZE)
    st = jpred._storage_state()
    model = jpred._storage_model(jpred.model.clone(template_capacity=cap), st)
    want = model.apply(jpred._variables(st.tree, st.scales), images, EXEMPLARS)
    got = pred.forward(images, EXEMPLARS)
    for name in ("objectness", "regressions"):
        assert _rel_err(got[name].numpy(), np.asarray(want[name][0])) < 1e-3, name


def test_slice_detections_match_jax(slice_pair):
    jpred, pred, images = slice_pair
    want = jpred(images, EXEMPLARS)
    got = pred(images, EXEMPLARS)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["valid"].sum() > 0
    v = got["valid"].numpy()
    assert _rel_err(got["scores"].numpy()[v], np.asarray(want["scores"])[v]) < 1e-3


def test_slice_stores_int8_kernels_only(slice_pair):
    _, pred, _ = slice_pair
    sd = pred.model.state_dict()
    tail = [k for k in sd if k.startswith(("decoder_", "objectness_head_", "ltrbs_head_"))]
    assert not [k for k in tail if k.endswith(".weight")]  # no f32 kernel is kept
    q = sd["decoder_o_0.conv_0.qweight"]
    assert q.dtype == torch.int8 and q.shape == (3, 3, 32, 32) and q.is_contiguous()
    assert sd["decoder_o_0.conv_0.scale"].shape == (3, 3, 32)
    assert sd["decoder_o_0.conv_0.bias"].dtype == torch.float32
    stamp = pred.quant_stamp()
    want_bytes = 2 * 9 * 32 * 32 + 32 * 1 + 32 * 4
    assert stamp["weight_bytes"] == want_bytes and stamp["f32_weight_bytes"] == 4 * want_bytes
    assert stamp["quantized_leaves"] == 4
    with pytest.raises(RuntimeError, match="set once"):
        pred.init_params(0)
