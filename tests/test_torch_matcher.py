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
