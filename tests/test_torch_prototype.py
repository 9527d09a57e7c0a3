"""Prototype templates and the gradient of the f32 correlation (kernel 5) in the port,
on the CPU, against the JAX package on numpy inputs: ``extract_prototype``, the
prototype matcher, ``xcorr_backward`` / ``cuda_xcorr.XCorr`` against ``jax.vjp`` of the
JAX ``cross_correlation`` at T = 1, 3 and 9 (and of the whole prototype matcher), the
calls of the kernel's wrapper a forward and a backward make, the prototype detector
through ``Predictor`` against the JAX ``Predictor``, and one prototype train step against
``make_train_step``.

Tolerances (f32 both sides, sums in another order): templates and correlations 1e-6 x
max; gradients 2e-5 x each gradient's max (the kernel check's tolerance on the card);
the detector's maps 1e-4 x max, its detections the same slots with scores and boxes
within 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_resnet import EXEMPLARS, SIZE, _default_pair, check_train_step  # noqa: E402
from tmr_tpu.ops.xcorr import cross_correlation as j_cross_correlation  # noqa: E402
from tmr_tpu.ops.xcorr import extract_prototype as j_extract_prototype  # noqa: E402
from tmr_tpu.ops.xcorr import match_templates as j_match_templates  # noqa: E402
from tmr_tpu_torch.models.matching_net import TemplateMatcher  # noqa: E402
from tmr_tpu_torch.ops import cuda_xcorr  # noqa: E402
from tmr_tpu_torch.ops.xcorr import cross_correlation, extract_prototype  # noqa: E402

VALUE_TOL = 1e-6
GRAD_TOL = 2e-5
MAP_TOL = 1e-4
#: normalized xyxy boxes: inside, on the border, a zero-area one, past [0, 1], the
#: whole map, a one-cell one
BOXES = np.array([[0.2, 0.3, 0.55, 0.7], [0.0, 0.0, 0.31, 0.12], [0.5, 0.5, 0.5, 0.5],
                  [-0.2, 0.8, 1.3, 1.1], [0.0, 0.0, 1.0, 1.0], [0.41, 0.41, 0.43, 0.44]],
                 np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _feature(seed, b=len(BOXES), c=6, h=13, w=17):
    return np.random.default_rng(seed).standard_normal((b, c, h, w)).astype(np.float32)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("capacity", [1, 3])
def test_extract_prototype_matches_jax(capacity):
    """The crop mean at the centre of a (T, T) kernel, thw ones, on every kind of box."""
    f = _feature(0)
    want_t, want_thw = jax.vmap(lambda fi, e: j_extract_prototype(fi, e, capacity))(
        jnp.asarray(f), jnp.asarray(BOXES))
    got_t, got_thw = extract_prototype(torch.from_numpy(f), torch.from_numpy(BOXES),
                                       capacity)
    assert got_t.shape == (len(BOXES), 6, capacity, capacity)
    _close(got_t.numpy(), want_t, VALUE_TOL)
    np.testing.assert_array_equal(got_thw.numpy(), np.asarray(want_thw))
    assert got_thw.dtype == torch.int32


@pytest.mark.parametrize("squeeze", [False, True])
def test_prototype_matcher_matches_match_templates(squeeze):
    """``cross_correlation`` of the prototype (T = 1) against the JAX
    ``match_templates(..., template_type="prototype")`` (its capacity argument is
    ignored for prototypes)."""
    f = _feature(1)
    want = j_match_templates(jnp.asarray(f), jnp.asarray(BOXES), 9,
                             template_type="prototype", squeeze=squeeze)
    ft = torch.from_numpy(f)
    got = cross_correlation(ft, *extract_prototype(ft, torch.from_numpy(BOXES), 1),
                            squeeze=squeeze)
    assert got.shape == want.shape
    _close(got.numpy(), want, VALUE_TOL)


def _corr_case(t, seed):
    rng = np.random.default_rng(seed)
    b, c, h, w = 3, 4, 11, 14
    f = rng.standard_normal((b, c, h, w)).astype(np.float32)
    tmpl = rng.standard_normal((b, c, t, t)).astype(np.float32)
    thw = np.stack([rng.integers(0, t // 2 + 1, b) * 2 + 1,
                    rng.integers(0, t // 2 + 1, b) * 2 + 1], 1).astype(np.int32)
    g = rng.standard_normal((b, c, h, w)).astype(np.float32)
    return f, tmpl, thw, g


@pytest.mark.parametrize("t", [1, 3, 9])
def test_correlation_gradient_matches_jax_vjp(t):
    """d/d(feature, template) of the port's ``cross_correlation`` (``XCorr``: the
    kernel's plain version here, its backward ``xcorr_backward``) against ``jax.vjp`` of
    the JAX ``cross_correlation`` on the same cotangent."""
    f, tmpl, thw, g = _corr_case(t, t)
    _, vjp = jax.vjp(lambda a, b: j_cross_correlation(a, b, jnp.asarray(thw)),
                     jnp.asarray(f), jnp.asarray(tmpl))
    want = vjp(jnp.asarray(g))
    ft = torch.from_numpy(f).requires_grad_()
    tt = torch.from_numpy(tmpl).requires_grad_()
    out = cross_correlation(ft, tt, torch.from_numpy(thw))
    got = torch.autograd.grad(out, (ft, tt), torch.from_numpy(g))
    for a, b in zip(got, want):
        _close(a.numpy(), b, GRAD_TOL)


@pytest.mark.parametrize("t", [1, 3, 9])
def test_xcorr_backward_is_the_plain_versions_autograd(t):
    """``xcorr_backward`` against ``torch.autograd`` through ``xcorr_plain`` (the T^2
    shifted products), the comparison the card makes at its shapes."""
    f, tmpl, _, g = _corr_case(t, 10 + t)
    ft = torch.from_numpy(f).requires_grad_()
    tt = torch.from_numpy(tmpl).requires_grad_()
    want = torch.autograd.grad(cuda_xcorr.xcorr_plain(ft, tt), (ft, tt), torch.from_numpy(g))
    got = cuda_xcorr.xcorr_backward(torch.from_numpy(f), torch.from_numpy(tmpl),
                                    torch.from_numpy(g))
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        _close(a.numpy(), b.numpy(), GRAD_TOL)


def test_prototype_matcher_gradient_matches_jax_vjp():
    """The gradient through the whole prototype matcher (the crop mean feeds the
    template, so the feature gets both paths) against ``jax.vjp`` of
    ``match_templates``."""
    f = _feature(2)
    g = np.random.default_rng(3).standard_normal(f.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a: j_match_templates(a, jnp.asarray(BOXES), 1,
                                                 template_type="prototype"),
                     jnp.asarray(f))
    (want,) = vjp(jnp.asarray(g))
    ft = torch.from_numpy(f).requires_grad_()
    out = cross_correlation(ft, *extract_prototype(ft, torch.from_numpy(BOXES), 1))
    (got,) = torch.autograd.grad(out, ft, torch.from_numpy(g))
    _close(got.numpy(), want, GRAD_TOL)


def test_forward_and_backward_call_the_kernel_once_each(monkeypatch):
    """Through ``XCorr`` a forward calls the kernel's wrapper once and its backward once
    more (d_feature: the correlation of the gradient with the flipped template), so a
    prototype train step launches kernel 5 twice on the card; d_template makes no call.
    The wrapper itself, without the Function, still refuses inputs that require grad on
    the card (``tests/test_torch_train.py``)."""
    calls = []
    orig = cuda_xcorr.xcorr

    def counted(feature, template):
        calls.append(tuple(template.shape))
        return orig(feature, template)

    monkeypatch.setattr(cuda_xcorr, "xcorr", counted)
    f, tmpl, thw, g = _corr_case(3, 5)
    ft = torch.from_numpy(f).requires_grad_()
    out = cross_correlation(ft, torch.from_numpy(tmpl).requires_grad_(),
                            torch.from_numpy(thw))
    assert calls == [(3, 4, 3, 3)]
    out.backward(torch.from_numpy(g))
    assert calls == [(3, 4, 3, 3)] * 2


@pytest.mark.parametrize("capacity", [9, 33, 191])
def test_prototype_correlates_at_t1_whatever_the_bucket(monkeypatch, capacity):
    """The prototype matcher hands the correlation a 1 x 1 template at every bucket, the
    FFT ones (> 65) included, as the JAX ``TemplateMatcher`` extracts at capacity 1."""
    seen = []
    orig = cuda_xcorr.XCorr.apply

    def record(feature, template):
        seen.append(template.shape[-1])
        return orig(feature, template)

    monkeypatch.setattr(cuda_xcorr.XCorr, "apply", record)
    f = torch.from_numpy(_feature(4))
    matcher = TemplateMatcher("prototype")
    out = matcher(f, torch.from_numpy(BOXES), capacity)
    assert seen == [1] and out.shape == f.shape
    with pytest.raises(ValueError, match="unknown template_type"):
        TemplateMatcher("mean")


@pytest.fixture(scope="module")
def prototype_pair():
    return _default_pair("prototype")


def test_prototype_detector_matches_jax(prototype_pair):
    """``Config(template_type="prototype")`` (the ResNet of one block a stage at full
    width, f32, 128 px): the maps within 1e-4 x max and the same detections after NMS
    as the JAX ``Predictor``."""
    jpred, pred, images = prototype_pair
    cap = jpred.pick_capacity(EXEMPLARS, SIZE)
    want = jpred.model.clone(template_capacity=cap).apply({"params": jpred.params},
                                                          images, EXEMPLARS)
    got = pred.forward(images, EXEMPLARS)
    for name in ("objectness", "regressions"):
        w = np.asarray(want[name][0])
        _close(got[name].numpy(), w, MAP_TOL)
    want, got = jpred(images, EXEMPLARS), pred(images, EXEMPLARS)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["valid"].sum() > 0
    for name in ("scores", "boxes", "refs"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-5,
                                   atol=1e-5)


def test_prototype_train_step_matches_make_train_step():
    """One prototype train step (T = 1 through ``XCorr`` and its backward; the backbone
    trains) against the JAX step: the losses, every parameter after it, the frozen
    batch norm statistics unmoved."""
    check_train_step("prototype")
