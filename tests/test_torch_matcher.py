"""Port matcher (RoIAlign sampling matrices, template extraction, the correlation and
its plain version, the FFT path, TemplateMatcher) vs ``tmr_tpu`` on the same inputs.

f32 throughout. Tolerances: 1e-5 for sampling matrices and templates (the same f32
arithmetic), 1e-5 relative to the map's max for correlations (T^2-term f32 sums in
another order), 1e-4 for the FFT path (f32 FFT rounding)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import importlib  # noqa: E402

from tmr_tpu.models.matching_net import TemplateMatcher as JTemplateMatcher  # noqa: E402
from tmr_tpu.models.matching_net import select_capacity_bucket as j_select  # noqa: E402
from tmr_tpu.ops import xcorr as jxcorr  # noqa: E402
from tmr_tpu.ops.pallas_xcorr import xcorr_pallas  # noqa: E402
from tmr_tpu_torch.models.matching_net import TemplateMatcher, select_capacity_bucket  # noqa: E402
from tmr_tpu_torch.ops import cuda_xcorr, roi_align, xcorr  # noqa: E402

# tmr_tpu.ops re-exports a function under the module's name
jroi = importlib.import_module("tmr_tpu.ops.roi_align")

EXEMPLARS = np.array([[0.21, 0.33, 0.47, 0.52], [0.05, 0.61, 0.12, 0.66],
                      [0.0, 0.0, 1.0, 1.0], [0.5, 0.5, 0.5, 0.5]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _rel_err(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize("start,length,n_active,n_static,feat,offset", [
    (3.2, 5.7, 5, 9, 20, 2), (-0.7, 1.4, 1, 9, 12, 4), (10.1, 30.3, 31, 33, 40, 1),
    (17.5, 4.0, 3, 3, 20, 0),
])
def test_sampling_matrix_matches_jax(start, length, n_active, n_static, feat, offset):
    want = np.asarray(jroi.sampling_matrix(jnp.float32(start), jnp.float32(length),
                                           n_active, n_static, feat, offset=offset))
    got = roi_align.sampling_matrix(torch.tensor([start]), torch.tensor([length]),
                                    torch.tensor([n_active]), n_static, feat,
                                    offset=torch.tensor([offset]))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_roi_align_matches_jax():
    rng = np.random.default_rng(0)
    f = rng.standard_normal((3, 16, 18)).astype(np.float32)
    boxes = np.array([[1.3, 2.2, 9.7, 8.1], [0.0, 0.0, 17.0, 15.0]], np.float32)
    want = np.asarray(jroi.roi_align(jnp.asarray(f), jnp.asarray(boxes), (5, 4)))
    got = roi_align.roi_align(torch.from_numpy(f), torch.from_numpy(boxes), (5, 4)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("capacity", [9, 17])
def test_extract_template_matches_jax(capacity):
    rng = np.random.default_rng(capacity)
    f = rng.standard_normal((4, 5, 24, 20)).astype(np.float32)
    want_t, want_hw = jax.vmap(lambda a, e: jxcorr.extract_template(a, e, capacity))(
        jnp.asarray(f), jnp.asarray(EXEMPLARS))
    got_t, got_hw = xcorr.extract_template(torch.from_numpy(f),
                                           torch.from_numpy(EXEMPLARS), capacity)
    np.testing.assert_array_equal(got_hw.numpy(), np.asarray(want_hw))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [9, 17, 33])
def test_xcorr_plain_matches_pallas(t):
    rng = np.random.default_rng(t)
    f = rng.standard_normal((1, 8, 10, 10)).astype(np.float32)
    tm = rng.standard_normal((1, 8, t, t)).astype(np.float32)
    want = np.asarray(xcorr_pallas(jnp.asarray(f), jnp.asarray(tm), interpret=True))
    got = cuda_xcorr.xcorr(torch.from_numpy(f), torch.from_numpy(tm)).numpy()
    assert _rel_err(got, want) < 1e-5


@pytest.mark.parametrize("t", [65, 127])  # direct path at its top bucket, FFT above
def test_cross_correlation_matches_jax(t):
    rng = np.random.default_rng(t)
    f = rng.standard_normal((2, 3, 20, 22)).astype(np.float32)
    tm = rng.standard_normal((2, 3, t, t)).astype(np.float32)
    thw = np.array([[5, 7], [3, 1]], np.int32)
    want = np.asarray(jxcorr.cross_correlation(jnp.asarray(f), jnp.asarray(tm),
                                               jnp.asarray(thw)))
    got = xcorr.cross_correlation(torch.from_numpy(f), torch.from_numpy(tm),
                                  torch.from_numpy(thw)).numpy()
    assert _rel_err(got, want) < (1e-5 if t <= 65 else 1e-4)
    # the zeroed border band lands on the same pixels
    np.testing.assert_array_equal(got == 0, want == 0)


def test_fft_size_matches_jax():
    for n in range(1, 400, 7):
        assert xcorr._fft_size(n) == jxcorr._fft_size(n)


def test_select_capacity_bucket_matches_jax():
    rng = np.random.default_rng(9)
    buckets = (9, 17, 33, 65, 127, 191)
    for _ in range(200):
        x1, y1 = rng.uniform(0, 0.9, 2)
        ex = np.array([x1, y1, x1 + rng.uniform(0, 0.9), y1 + rng.uniform(0, 0.9)])
        assert select_capacity_bucket(ex, 128, 128, buckets) == j_select(ex, 128, 128,
                                                                         buckets)


@pytest.mark.parametrize("squeeze", [False, True])
def test_template_matcher_matches_jax(squeeze):
    rng = np.random.default_rng(int(squeeze))
    f = rng.standard_normal((4, 16, 16, 6)).astype(np.float32)  # NHWC, as flax takes it
    jm = JTemplateMatcher(squeeze=squeeze, capacity=9)
    params = {"scale": np.array([1.7], np.float32)}
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(f), jnp.asarray(EXEMPLARS)))
    m = TemplateMatcher(squeeze=squeeze)
    m.load_state_dict({"scale": torch.tensor([1.7])})
    with torch.no_grad():
        got = m(torch.from_numpy(f).permute(0, 3, 1, 2).contiguous(),
                torch.from_numpy(EXEMPLARS), 9).permute(0, 2, 3, 1).numpy()
    assert _rel_err(got, want) < 1e-5


# The f32 card kernel (csrc/xcorr.cu xcorr_tf32_kernel) emulated on the CPU: its CTA tile,
# its zero-filled staging window and, per template row i, the product of the window's
# rows i .. i + BM - 1 with the Toeplitz band B_i[k, n] = t[i, k - n] (0 outside [0, T)).
XCORR_BM = XCORR_BN = 64  # output rows and columns of a CTA


def _tf32_rna(x):
    """cvt.rna.tf32.f32: the f32 bit pattern rounded to 10 mantissa bits, nearest, ties
    away from zero (half an ulp added to the magnitude, then the low 13 bits cleared)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_tf32(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(np.asarray(x, np.float32) - hi)


def _band_xcorr(f, tm, three_tf32: bool):
    """f (P, H, W), tm (P, T, T) -> (P, H, W). ``three_tf32=False``: every product and sum
    in f64. ``three_tf32=True``: the kernel's arithmetic, lo*hi + hi*lo + hi*hi of the
    tf32 splits per template row (exact in f64, as the tensor cores' products are),
    the row's sum rounded to f32 and added to the f32 total."""
    p, h, w = f.shape
    t = tm.shape[-1]
    c = t // 2
    kb = (t + 14) // 8  # k-blocks of 8 per n8 column tile: ceil((T + 7) / 8)
    rows, cols = XCORR_BM + t - 1, XCORR_BN + 8 * (kb - 1)
    j = np.arange(cols)[:, None] - np.arange(XCORR_BN)[None, :]
    in_band = (j >= 0) & (j < t)
    out = np.zeros((p, h, w), np.float64 if not three_tf32 else np.float32)
    for y0 in range(0, h, XCORR_BM):
        for x0 in range(0, w, XCORR_BN):
            ys, xs = y0 - c + np.arange(rows), x0 - c + np.arange(cols)
            ok = (((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None, :]
                  & (np.arange(cols) < XCORR_BN + t - 1)[None, :])
            win = np.where(ok, f[:, ys.clip(0, h - 1)][:, :, xs.clip(0, w - 1)], 0.0)
            acc = np.zeros((p, XCORR_BM, XCORR_BN), out.dtype)
            for i in range(t):
                band = np.where(in_band, tm[:, i, j.clip(0, t - 1)], 0.0)  # (P, cols, BN)
                a = win[:, i:i + XCORR_BM]
                if not three_tf32:
                    acc += a @ band
                    continue
                (ah, al), (bh, bl) = _split_tf32(a), _split_tf32(band)
                ah, al, bh, bl = (v.astype(np.float64) for v in (ah, al, bh, bl))
                part = (al @ bh + ah @ bl + ah @ bh).astype(np.float32)
                acc = (acc + part).astype(np.float32)
            out[:, y0:y0 + XCORR_BM, x0:x0 + XCORR_BN] = acc[:, :h - y0, :w - x0]
    return out


#: ragged maps (planes, H, W): two row tiles and one column tile, one row tile and two
#: column tiles, and a map smaller than one tile
XCORR_RAGGED = ((3, 70, 45), (2, 37, 75), (2, 13, 11))


def test_tf32_rna_rounds_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # a tf32 ulp at 1
    x = np.array([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, 1 + 3 * ulp / 2, -(1 + ulp / 2),
                  1 + ulp / 4], np.float32)
    want = np.array([1 + ulp, 1, 1 + 2 * ulp, -(1 + ulp), one], np.float32)
    np.testing.assert_array_equal(_tf32_rna(x), want)
    hi, lo = _split_tf32(np.float32(1 + 2 ** -11 + 2 ** -22))
    assert hi == 1 + 2 ** -10 and lo == np.float32(-(2 ** -11) + 2 ** -22)


@pytest.mark.parametrize("shape", XCORR_RAGGED)
@pytest.mark.parametrize("t", [1, 3, 9, 33, 65])
def test_xcorr_band_index_maths_equals_plain(t, shape):
    """The band formulation over the kernel's tiles and zero-filled windows, in f64 on
    small integers (every sum exact in f64 and in f32), equals xcorr_plain exactly."""
    rng = np.random.default_rng(t * 100 + shape[1])
    p, h, w = shape
    f = rng.integers(-8, 9, (p, h, w)).astype(np.float64)
    tm = rng.integers(-8, 9, (p, t, t)).astype(np.float64)
    want = cuda_xcorr.xcorr_plain(torch.from_numpy(f[None]).float(),
                                  torch.from_numpy(tm[None]).float())[0].numpy()
    np.testing.assert_array_equal(_band_xcorr(f, tm, three_tf32=False), want)


@pytest.mark.parametrize("t", [1, 3, 9, 17, 33, 65])
def test_xcorr_3xtf32_within_tolerance(t):
    """The kernel's 3xTF32 arithmetic on normal f32 inputs stays within the card check's
    2e-5 x max of the Pallas kernel (interpret mode; it takes T <= 33) or, at 65, of
    xcorr_plain; one tf32 pass alone does not."""
    rng = np.random.default_rng(t)
    p, h, w = XCORR_RAGGED[0] if t <= 33 else XCORR_RAGGED[1]
    f = rng.standard_normal((p, h, w)).astype(np.float32)
    tm = rng.standard_normal((p, t, t)).astype(np.float32)
    if t <= 33:
        want = np.asarray(xcorr_pallas(jnp.asarray(f[None]), jnp.asarray(tm[None]),
                                       interpret=True))[0]
    else:
        want = cuda_xcorr.xcorr_plain(torch.from_numpy(f[None]),
                                      torch.from_numpy(tm[None]))[0].numpy()
    assert _rel_err(_band_xcorr(f, tm, three_tf32=True), want) < 2e-5
    one_pass = _band_xcorr(_tf32_rna(f), _tf32_rna(tm), three_tf32=False)
    if t > 1:
        assert _rel_err(one_pass, want) > 2e-5


def test_xcorr_3xtf32_bf16_feature():
    """A bf16 feature (the main path's fp.float()) is exact in tf32: its lo part is 0."""
    rng = np.random.default_rng(5)
    f = torch.from_numpy(rng.standard_normal((3, 70, 45)).astype(np.float32))
    f = f.bfloat16().float().numpy()
    tm = rng.standard_normal((3, 33, 33)).astype(np.float32)
    assert not _split_tf32(f)[1].any()
    want = cuda_xcorr.xcorr_plain(torch.from_numpy(f[None]), torch.from_numpy(tm[None]))[0]
    assert _rel_err(_band_xcorr(f, tm, three_tf32=True), want.numpy()) < 2e-5
