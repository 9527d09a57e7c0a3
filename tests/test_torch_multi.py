"""The multi-exemplar programs, the split programs and the device tail on the CPU: the
port's ``predict_multi_exemplar``, ``predict_multi_batch``, ``_get_backbone_fn`` /
``_get_heads_fn`` and ``decode_tail="device"`` against the JAX ``Predictor``'s at the
TINY geometry of ``tests/test_torch_predictor.py`` (f32), on the same
``params_from_jax`` weights, images and exemplars.

Tolerances: ``valid`` equal; scores, boxes and refs within 1e-5 (f32 sums in another
order through a 4-block encoder); the backbone's features within 1e-4, as the maps of
``tests/test_torch_predictor.py``; the heads program equal to the port's own fused call
bit for bit (the same ops on the same values)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_predictor import SIZE, TINY, _make_pair  # noqa: E402

from tmr_tpu.config import preset as j_preset  # noqa: E402
from tmr_tpu.inference import Predictor as JPredictor  # noqa: E402
from tmr_tpu_torch.config import preset  # noqa: E402
from tmr_tpu_torch.inference import Predictor, detections_to_numpy  # noqa: E402
from tmr_tpu_torch.models import build_model  # noqa: E402
from tmr_tpu_torch.models.vit import SamViT  # noqa: E402

#: five exemplars of one image, all in template bucket 9 of the 8 x 8 feature grid
EXEMPLAR_SET = np.array([[0.2, 0.2, 0.4, 0.5], [0.5, 0.55, 0.7, 0.6],
                         [0.1, 0.6, 0.15, 0.7], [0.6, 0.1, 0.9, 0.3],
                         [0.3, 0.7, 0.5, 0.9]], np.float32)
SINGLE = EXEMPLAR_SET[:3, None, :]  # (3, 1, 4): one exemplar for each of three images
QUANT = dict(quant="int8", quant_storage="int8", quant_kernel="int8")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def pair():
    return _make_pair(TINY)


def _assert_dets_match(got, want, tol=1e-5):
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["valid"].sum() > 0
    for name in ("scores", "boxes", "refs"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=tol, atol=tol)


def _assert_lists_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for name in ("boxes", "scores", "refs"):
            np.testing.assert_array_equal(x[name], y[name])


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_predict_multi_exemplar_matches_jax(pair, k):
    """k = 5 pads to bucket 6 with the last real row, which the mask drops."""
    jpred, pred, images = pair
    ex = EXEMPLAR_SET[:k]
    want = jpred.predict_multi_exemplar(images[:1], ex)
    got = pred.predict_multi_exemplar(images[:1], ex)
    bucket = pred.bucket_key(SIZE, ex, multi=True)[3]
    assert got["valid"].shape == (1, bucket * 64)
    _assert_dets_match(got, want)
    assert not got["valid"][0, k * 64:].any()  # padded rows keep nothing


def test_predict_multi_exemplar_with_pre_padded_rows_matches_jax(pair):
    jpred, pred, images = pair
    ex = np.concatenate([EXEMPLAR_SET[:2], EXEMPLAR_SET[4:], EXEMPLAR_SET[4:]])
    want = jpred.predict_multi_exemplar(images[1:2], ex, k_real=np.int64(2))
    got = pred.predict_multi_exemplar(images[1:2], ex, k_real=np.int64(2))
    _assert_dets_match(got, want)
    plain = pred.predict_multi_exemplar(images[1:2], EXEMPLAR_SET[:2])
    for name in ("valid", "scores", "boxes", "refs"):
        assert torch.equal(got[name], plain[name])


def test_predict_multi_batch_matches_jax_on_distinct_images(pair):
    """Three distinct images with k_real (3, 1, 2): an exemplar row paired with another
    image's feature (a tile where an image-major repeat belongs) changes every map. The
    padded rows are other exemplars, so only the row mask drops their detections."""
    jpred, pred, images = pair
    k_real = np.array([3, 1, 2], np.int32)
    ex = np.stack([EXEMPLAR_SET[[0, 1, 2]], EXEMPLAR_SET[[3, 0, 4]],
                   EXEMPLAR_SET[[4, 1, 2]]])
    want = jpred.predict_multi_batch(images, ex, k_real)
    got = pred.predict_multi_batch(images, ex, k_real)
    assert got["valid"].shape == (3, 3 * 64)
    _assert_dets_match(got, want)
    for b in range(3):
        assert got["valid"][b].sum() > 0
        assert not got["valid"][b, k_real[b] * 64:].any()
    # each image's union is the one predict_multi_exemplar gives for it alone
    for b in range(3):
        one = pred.predict_multi_exemplar(images[b:b + 1], ex[b], k_real=k_real[b])
        n = k_real[b] * 64
        for name in ("valid", "scores", "boxes"):
            np.testing.assert_allclose(got[name][b, :n].numpy().astype(np.float64),
                                       one[name][0, :n].numpy().astype(np.float64),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k_real", [None, 1, 2, 4])
def test_multi_bucket_key_matches_jax(pair, k_real):
    jpred, pred, _ = pair
    ex = EXEMPLAR_SET[:4]
    want = jpred.bucket_key(SIZE, ex, multi=True, k_real=k_real)
    assert pred.bucket_key(SIZE, ex, multi=True, k_real=k_real) == want
    assert Predictor.K_BUCKETS == JPredictor.K_BUCKETS


def test_split_programs_match_jax_and_the_fused_call(pair):
    """The backbone program's NHWC features within 1e-4 of JAX's; the heads program on
    them equal to the port's fused ``__call__`` bit for bit, and to JAX's heads program
    within 1e-5."""
    jpred, pred, images = pair
    jfeat = np.asarray(jpred._get_backbone_fn()(jpred.params, images))
    feat = pred._get_backbone_fn()(images)
    assert feat.shape == jfeat.shape == (3, SIZE // 8, SIZE // 8, TINY["out_chans"])
    np.testing.assert_allclose(feat.numpy(), jfeat, rtol=1e-4, atol=1e-4)
    cap = pred.pick_capacity(SINGLE, SIZE)
    got = pred._get_heads_fn(cap, SIZE)(feat, SINGLE)
    fused = pred(images, SINGLE)
    for name in ("valid", "scores", "boxes", "refs"):
        assert torch.equal(got[name], fused[name]), name
    want = jpred._get_heads_fn(cap, SIZE)(jpred.params, None, jfeat, SINGLE)
    _assert_dets_match(got, want)


def _device_tail_pair(pair, monkeypatch):
    jpred, pred, images = pair
    monkeypatch.setenv("TMR_DECODE_TAIL", "device")
    jdev = JPredictor(jpred.cfg, params=jpred.params, model=jpred.model)
    dev = Predictor(dataclasses.replace(pred.cfg, decode_tail="device"), device="cpu",
                    model=pred.model)
    return jdev, dev, pred, images


@pytest.mark.parametrize("program", ["single", "multi_batch"])
def test_device_tail_matches_jax_and_the_host_tail(pair, monkeypatch, program):
    jdev, dev, host, images = _device_tail_pair(pair, monkeypatch)
    if program == "single":
        args = (images, SINGLE)
        run = {p: p.__call__ for p in (jdev, dev, host)}
    else:
        args = (images, np.stack([EXEMPLAR_SET[:3]] * 3), np.array([3, 2, 1], np.int32))
        run = {p: p.predict_multi_batch for p in (jdev, dev, host)}
    want, got, host_dets = (run[p](*args) for p in (jdev, dev, host))
    assert "count" in got and "count" not in host_dets
    np.testing.assert_array_equal(got["count"].numpy(), np.asarray(want["count"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    n = int(got["count"].max())
    assert n > 0
    for name in ("scores", "boxes", "refs"):
        np.testing.assert_allclose(got[name][:, :n].numpy(), np.asarray(want[name])[:, :n],
                                   rtol=1e-5, atol=1e-5)
        assert not got[name][~got["valid"]].any()  # dead slots are zeroed
    _assert_lists_equal(detections_to_numpy(got), detections_to_numpy(host_dets))


@pytest.mark.parametrize("k_real", [0, 6, -1])
def test_k_real_out_of_range_raises(pair, k_real):
    _, pred, images = pair
    with pytest.raises(ValueError, match="out of range"):
        pred.predict_multi_exemplar(images[:1], EXEMPLAR_SET, k_real=k_real)


def test_bogus_decode_tail_raises():
    with pytest.raises(ValueError, match="decode_tail"):
        preset("TMR_FSCD147", decode_tail="bogus")
    assert preset("TMR_FSCD147").decode_tail == "host"


def test_refine_box_raises(pair):
    """``refine_box`` without a refiner no longer raises: it refines nothing, as the
    JAX Predictor refines only with both (the refiner itself:
    tests/test_torch_refine.py)."""
    _, pred, images = pair
    refining = Predictor(dataclasses.replace(pred.cfg, refine_box=True), device="cpu",
                         model=pred.model)
    got, want = refining(images, SINGLE), pred(images, SINGLE)
    for name in ("valid", "scores", "boxes", "refs"):
        assert torch.equal(got[name], want[name]), name


def test_union_tie_keeps_exemplar_0s_slot(pair):
    """The same exemplar twice gives two rows of equal scores and boxes: the union's
    stable sort puts row 0's slot first, so row 0's survivors stay and suppress row 1's
    twins (IoU 1), as ``jnp.argsort`` orders them."""
    jpred, pred, images = pair
    ex = EXEMPLAR_SET[[0, 0]]
    got = pred.predict_multi_exemplar(images[2:3], ex)
    _assert_dets_match(got, jpred.predict_multi_exemplar(images[2:3], ex))
    valid = got["valid"][0]
    assert valid[:64].sum() > 0 and not valid[64:].any()
    alone = pred.predict_multi_exemplar(images[2:3], ex[:1])
    assert torch.equal(valid[:64], alone["valid"][0])


def test_int8_predict_multi_exemplar_matches_jax(pair, monkeypatch):
    """k = 2 on the int8-storage path: each repeated row is its own image for the
    per-image activation scale, in both packages. The JAX package takes the path under
    its environment knobs, as ``tests/test_torch_quant.py`` sets them."""
    jpred, _, images = pair
    for name, val in (("TMR_DECODER_IMPL", "fused"), ("TMR_QUANT", "int8"),
                      ("TMR_QUANT_STORAGE", "int8"), ("TMR_QUANT_KERNEL", "int8dot")):
        monkeypatch.setenv(name, val)
    overrides = dict(emb_dim=16, compute_dtype="float32", image_size=SIZE)
    jq = JPredictor(j_preset("TMR_FSCD147", **overrides), params=jpred.params,
                    model=jpred.model)
    assert jq._storage_state() is not None, "the JAX package must admit storage here"
    cfg = preset("TMR_FSCD147", **overrides, **QUANT)
    q = Predictor(cfg, device="cpu", model=build_model(
        cfg, backbone=SamViT(pretrain_img_size=SIZE, **TINY), device="cpu"))
    q.load_jax_params(jpred.params)
    want = jq.predict_multi_exemplar(images[:1], EXEMPLAR_SET[:2])
    got = q.predict_multi_exemplar(images[:1], EXEMPLAR_SET[:2])
    _assert_dets_match(got, want)


def test_attention_gets_dense_rows_at_batch_1(pair, monkeypatch):
    """``predict_multi_exemplar`` runs the encoder on one image: the q/k/v handed to both
    attention functions must be contiguous there too, as the kernels require (at B = 1
    the heads' reshape is a strided view, which the card's wrappers refuse)."""
    from tmr_tpu_torch.models import vit

    _, pred, images = pair
    seen = []

    def dense(fn):
        def run(q, k, v, *rest):
            seen.append(all(t.is_contiguous() for t in (q, k, v)))
            return fn(q, k, v, *rest)
        return run

    for name in ("global_attention", "window_attention"):
        monkeypatch.setattr(vit, name, dense(getattr(vit, name)))
    pred.predict_multi_exemplar(images[:1], EXEMPLAR_SET[:2])
    assert len(seen) == TINY["depth"] and all(seen)
