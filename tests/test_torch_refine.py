"""SAM box refinement in the port (``tmr_tpu_torch/refine.py`` and the Predictor's
programs with a refiner) against the JAX package's on the CPU.

The refiner is the tiny one of ``tests/test_sam_refine.py`` (transformer dim 32, 4 heads,
MLP 64, chunk 4), its weights made by the torch oracle and carried into both packages
(``convert_sam_refiner`` -> ``params_from_jax``); features 8 x 8, images 64^2. The
Predictor pair is ``tests/test_torch_predictor.py``'s TINY MatchingNet with the encoder's
``out_chans`` 32, as ``tests/test_sam_refine.py:244`` builds it, on the same params.

Tolerances, those of ``chip_smoke.py`` phase 5d: boxes within 1e-6 (the boxes of
thresholded masks: equal masks give equal boxes), scores within 1e-5 of the largest
score (the IoU head's f32 sums in another order), invalid slots bit for bit, refs the box
centres; union mask pixels equal except where some slot's logit lies within 1e-4 of its
mask's largest |logit| (f32 rounding may flip the threshold there: at most 4 pixels);
after NMS the same slots kept, boxes and scores within 1e-5."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_sam_decoder import (DIM, HEADS, MLP, oracle_state_dict,  # noqa: E402
                                          refiner_sam_layout)
from tmr_tpu.config import preset as j_preset  # noqa: E402
from tmr_tpu.inference import Predictor as JPredictor  # noqa: E402
from tmr_tpu.models.matching_net import MatchingNet as JMatchingNet  # noqa: E402
from tmr_tpu.models.sam_decoder import MaskDecoder as JMaskDecoder  # noqa: E402
from tmr_tpu.models.sam_decoder import PromptEncoder as JPromptEncoder  # noqa: E402
from tmr_tpu.models.vit import SamViT as JSamViT  # noqa: E402
from tmr_tpu.refine import SamRefineModule as JSamRefineModule  # noqa: E402
from tmr_tpu.utils.convert import convert_sam_refiner  # noqa: E402
from tmr_tpu_torch.config import preset  # noqa: E402
from tmr_tpu_torch.inference import Predictor  # noqa: E402
from tmr_tpu_torch.models import build_model  # noqa: E402
from tmr_tpu_torch.models.sam_decoder import (MaskDecoder, PromptEncoder,  # noqa: E402
                                              resize_align_corners)
from tmr_tpu_torch.models.vit import SamViT  # noqa: E402
from tmr_tpu_torch.refine import SamRefineModule, build_refiner  # noqa: E402
from tmr_tpu_torch.utils.weights import params_from_jax  # noqa: E402

SIZE = 64
TINY = dict(embed_dim=32, depth=4, num_heads=2, global_attn_indexes=(1, 3),
            patch_size=8, window_size=3, out_chans=DIM)
EXEMPLARS = np.array([[[0.2, 0.2, 0.4, 0.5]], [[0.5, 0.55, 0.7, 0.6]],
                      [[0.1, 0.6, 0.15, 0.7]]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def tiny_refiners(chunk=4, seed=0):
    """(JAX refiner, its params, the port's refiner with the same weights)."""
    params = convert_sam_refiner(oracle_state_dict(seed)[0])
    jref = JSamRefineModule(chunk=chunk)
    jref.prompt_encoder = JPromptEncoder(embed_dim=DIM)
    jref.mask_decoder = JMaskDecoder(transformer_dim=DIM, transformer_num_heads=HEADS,
                                     transformer_mlp_dim=MLP)
    ref = SamRefineModule(chunk=chunk, prompt_encoder=PromptEncoder(DIM),
                          mask_decoder=MaskDecoder(DIM, transformer_num_heads=HEADS,
                                                   transformer_mlp_dim=MLP))
    ref.load_state_dict(params_from_jax(params))
    return jref, params, ref.eval()


@pytest.fixture(scope="module")
def refiners():
    return tiny_refiners()


def _dets(seed, b=2, n=12, valid_share=0.7):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.05, 0.6, (b, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.35, (b, n, 2))], -1)
    valid = rng.random((b, n)) < valid_share
    valid[0, 0] = True
    return {"boxes": boxes.astype(np.float32),
            "scores": rng.uniform(0.2, 1.0, (b, n)).astype(np.float32),
            "refs": rng.uniform(0, 1, (b, n, 2)).astype(np.float32), "valid": valid}


def _feats(seed, b=2):
    return np.random.default_rng(seed).standard_normal((b, 8, 8, DIM)).astype(np.float32)


def _near_zero(ref, feats, boxes, valid, rel=1e-4):
    """(B, H, W): pixels where some decoded slot's full-size logit lies within ``rel``
    of that mask's largest |logit|, where f32 rounding may flip the threshold at 0."""
    out = np.zeros((boxes.shape[0], SIZE, SIZE), bool)
    for b in range(boxes.shape[0]):
        keep = np.ones(boxes.shape[1], bool) if valid is None else valid[b]
        px = torch.from_numpy(boxes[b][keep] * SIZE)
        feat = torch.from_numpy(feats[b:b + 1])
        with torch.no_grad():
            logits, _ = ref._decode(feat, ref.prompt_encoder.dense_pe((8, 8)), px,
                                    (SIZE, SIZE))
            logits = resize_align_corners(logits, (SIZE, SIZE)).abs()
        top = logits.flatten(1).amax(1)[:, None, None]
        out[b] = (logits < rel * top).any(0).numpy()
    return out


def _port(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _check_refined(got, want, dets):
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0,
                               atol=1e-6)
    want_s = np.asarray(want["scores"])
    np.testing.assert_allclose(got["scores"].numpy(), want_s, rtol=0,
                               atol=1e-5 * np.abs(want_s).max())
    np.testing.assert_allclose(got["refs"].numpy(), np.asarray(want["refs"]), rtol=0,
                               atol=1e-6)
    inv = ~dets["valid"]
    assert np.array_equal(got["boxes"].numpy()[inv], dets["boxes"][inv])
    assert np.array_equal(got["scores"].numpy()[inv], dets["scores"][inv])
    assert torch.equal(got["valid"], torch.from_numpy(dets["valid"]))
    b = got["boxes"]
    assert torch.equal(got["refs"], torch.stack([(b[..., 0] + b[..., 2]) / 2,
                                                 (b[..., 1] + b[..., 3]) / 2], -1))


@pytest.mark.parametrize("n,mask_size", [(12, None), (9, None), (12, (16, 16))])
def test_refine_matches_jax(refiners, n, mask_size):
    """Valid slots decoded ``chunk`` at a time (the port gathers them, the JAX program
    decodes every slot in padded chunks): a full-size mask, a ragged last chunk, and
    the decoder's coarse grid as ``mask_size``."""
    jref, params, ref = refiners
    dets, feats = _dets(n, n=n), _feats(n)
    want = jax.jit(lambda p, f, d: jref.refine(p, f, d, (SIZE, SIZE), mask_size))(
        params, feats, dets)
    got = ref.refine(torch.from_numpy(feats), _port(dets), (SIZE, SIZE), mask_size)
    _check_refined(got, want, dets)
    moved = dets["valid"] & (got["boxes"].numpy() != dets["boxes"]).any(-1)
    assert moved.sum() >= dets["valid"].sum() // 2


def test_refine_keeps_the_box_of_an_empty_mask(refiners):
    """With the hypernetworks' last layers zeroed every mask is 0 (nothing above the
    threshold): valid slots keep their box, take ``iou * score``; both packages."""
    jref, params, ref = refiners
    params = jax.tree_util.tree_map(np.array, params)
    for i in range(4):
        for leaf in ("kernel", "bias"):
            params["mask_decoder"][f"hyper_mlps_{i}"]["layers_2"][leaf][...] = 0.0
    zeroed = SamRefineModule(chunk=4, prompt_encoder=ref.prompt_encoder,
                             mask_decoder=MaskDecoder(DIM, transformer_num_heads=HEADS,
                                                      transformer_mlp_dim=MLP))
    zeroed.load_state_dict(params_from_jax(params))
    dets, feats = _dets(3), _feats(3)
    want = jref.refine(params, jnp.asarray(feats), {k: jnp.asarray(v) for k, v in
                                                    dets.items()}, (SIZE, SIZE))
    got = zeroed.refine(torch.from_numpy(feats), _port(dets), (SIZE, SIZE))
    _check_refined(got, want, dets)
    assert np.array_equal(got["boxes"].numpy(), dets["boxes"])
    v = dets["valid"]
    assert not np.array_equal(got["scores"].numpy()[v], dets["scores"][v])


def test_refine_with_no_valid_slot_is_the_identity(refiners):
    _, _, ref = refiners
    dets = _dets(4)
    dets["valid"][:] = False
    got = ref.refine(torch.from_numpy(_feats(4)), _port(dets), (SIZE, SIZE))
    for name in ("boxes", "scores"):
        assert np.array_equal(got[name].numpy(), dets[name])


def test_refine_with_exemplar_scaling_matches_jax(refiners):
    jref, params, ref = refiners
    dets, feats = _dets(5), _feats(5)
    ex = np.array([[0.2, 0.2, 0.5, 0.5], [0.4, 0.1, 0.7, 0.45]], np.float32)
    want = jax.jit(lambda p, f, d, e: jref.refine_with_exemplar_scaling(
        p, f, d, e, (SIZE, SIZE)))(params, feats, dets, ex)
    got = ref.refine_with_exemplar_scaling(torch.from_numpy(feats), _port(dets),
                                           torch.from_numpy(ex), (SIZE, SIZE))
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0,
                               atol=1e-5)
    want_s = np.asarray(want["scores"])
    np.testing.assert_allclose(got["scores"].numpy(), want_s, rtol=0,
                               atol=1e-5 * np.abs(want_s).max())
    np.testing.assert_allclose(got["refs"].numpy(), np.asarray(want["refs"]), atol=1e-6)
    inv = ~dets["valid"]
    assert np.array_equal(got["boxes"].numpy()[inv], dets["boxes"][inv])


@pytest.mark.parametrize("with_valid", [True, False])
def test_decode_masks_matches_jax(refiners, with_valid):
    """The union of the valid slots' masks (every slot without ``valid``)."""
    jref, params, ref = refiners
    dets, feats = _dets(6, n=7), _feats(6)
    valid = dets["valid"] if with_valid else None
    want = np.asarray(jref.decode_masks(params, jnp.asarray(feats),
                                        jnp.asarray(dets["boxes"]), (SIZE, SIZE),
                                        None if valid is None else jnp.asarray(valid)))
    got = ref.decode_masks(torch.from_numpy(feats), torch.from_numpy(dets["boxes"]),
                           (SIZE, SIZE),
                           None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.bool and got.shape == (2, SIZE, SIZE)
    assert 0 < want.sum() < want.size
    differ = got.numpy() != want
    assert differ.sum() <= 4
    assert not (differ & ~_near_zero(ref, feats, dets["boxes"], valid)).any()
    empty = ref.decode_masks(torch.from_numpy(feats), torch.zeros(2, 0, 4), (SIZE, SIZE))
    assert empty.shape == (2, SIZE, SIZE) and not empty.any()


def test_save_masks_writes_the_jax_union(refiners, tmp_path):
    """PNGs written with PIL decode to the JAX package's union x 255 (its cv2 files)."""
    from PIL import Image

    jref, params, ref = refiners
    dets, feats = _dets(7, n=7), _feats(7)
    names = ["a", "b"]
    want = jref.save_masks(params, jnp.asarray(feats), {k: jnp.asarray(v) for k, v in
                                                        dets.items()},
                           (SIZE, SIZE), str(tmp_path / "jax"), names)
    got = ref.save_masks(torch.from_numpy(feats), _port(dets), (SIZE, SIZE),
                         str(tmp_path / "port"), names)
    assert [p.rsplit("/", 1)[-1] for p in got] == ["a.png", "b.png"]
    for g, w in zip(got, want):
        with Image.open(g) as a, Image.open(w) as b:
            pa, pb = np.asarray(a), np.asarray(b)
            assert a.mode == "L" and pa.dtype == np.uint8
            np.testing.assert_array_equal(pa, pb)
            assert set(np.unique(pa)) <= {0, 255}


def test_build_refiner_warns_and_seeds_without_a_checkpoint(capsys):
    cfg = preset("TMR_FSCD147", refine_box=True)
    a, b = (build_refiner(cfg, seed=3, device="cpu") for _ in range(2))
    assert "no refiner_checkpoint" in capsys.readouterr().err
    assert not a.training
    assert a.mask_decoder.transformer_dim == 256 and a.chunk == 50
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name


def test_build_refiner_reads_a_full_sam_checkpoint(tmp_path):
    """``refiner_checkpoint`` names a full SAM ``.pth`` (encoder keys too, as the
    reference's vit_h): its prompt encoder and mask decoder load into the refiner."""
    from tmr_tpu_torch.utils import convert

    gen = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=gen) for k, v in
          build_refiner(preset("TMR_FSCD147"), device="cpu").state_dict().items()}
    path = tmp_path / "sam_vit_h.pth"
    torch.save(dict(refiner_sam_layout(sd), **{"image_encoder.pos_embed":
                                                torch.zeros(1, 4, 4, 8)}), path)
    assert convert.checkpoint_kind(convert.load_torch_state_dict(str(path))) == "sam_vit"
    got = build_refiner(preset("TMR_FSCD147", refiner_checkpoint=str(path)),
                        device="cpu").state_dict()
    assert sorted(got) == sorted(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k]), k


# ------------------------------------------------------ the Predictor's programs
@pytest.fixture(scope="module")
def pred_pair(refiners):
    """The JAX Predictor with the tiny refiner and its port counterpart, both with
    ``refine_box``, on the same (tweaked, as in test_torch_predictor) params."""
    jref, rparams, ref = refiners
    overrides = dict(emb_dim=16, compute_dtype="float32", image_size=SIZE,
                     refine_box=True)
    jmodel = JMatchingNet(backbone=JSamViT(pretrain_img_size=SIZE, **TINY), emb_dim=16,
                          fusion=True, feature_upsample=True, template_capacity=9)
    jpred = JPredictor(j_preset("TMR_FSCD147", **overrides), model=jmodel, refiner=jref,
                       refiner_params=rparams)
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
    cfg = preset("TMR_FSCD147", **overrides)
    model = build_model(cfg, backbone=SamViT(pretrain_img_size=SIZE, **TINY), device="cpu")
    pred = Predictor(cfg, device="cpu", model=model, refiner=ref)
    pred.load_jax_params(params)
    images = rng.standard_normal((3, SIZE, SIZE, 3)).astype(np.float32)
    return jpred, pred, images


def _assert_dets_match(got, want, tol=1e-5):
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["valid"].sum() > 0
    for name in ("scores", "boxes", "refs"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=tol,
                                   atol=tol, err_msg=name)


def test_predictor_with_refiner_matches_jax(pred_pair):
    """``__call__``: forward -> decode -> refine on the encoder's pre-upsample feature ->
    NMS; the boxes differ from the unrefined program's."""
    jpred, pred, images = pred_pair
    got = pred(images, EXEMPLARS)
    _assert_dets_match(got, jpred(images, EXEMPLARS))
    plain = Predictor(dataclasses.replace(pred.cfg, refine_box=False), device="cpu",
                      model=pred.model, refiner=pred.refiner)(images, EXEMPLARS)
    assert not torch.equal(plain["boxes"], got["boxes"])


def test_multi_batch_with_refiner_matches_jax(pred_pair):
    """``predict_multi_batch`` refines each image's union of rows on that image's own
    feature (not the copies per exemplar row)."""
    jpred, pred, images = pred_pair
    ex = np.stack([EXEMPLARS[[0, 1, 2], 0], EXEMPLARS[[1, 2, 2], 0],
                   EXEMPLARS[[2, 0, 0], 0]])
    k_real = np.array([3, 2, 1], np.int32)
    seen = []
    orig = pred.refiner.refine

    def spy(feature, dets, image_hw, *a):
        seen.append((tuple(feature.shape), tuple(dets["boxes"].shape), image_hw))
        return orig(feature, dets, image_hw, *a)

    pred.refiner.refine = spy
    try:
        got = pred.predict_multi_batch(images, ex, k_real)
    finally:
        del pred.refiner.refine
    assert seen == [((3, 8, 8, DIM), (3, 3 * 256, 4), (SIZE, SIZE))]
    _assert_dets_match(got, jpred.predict_multi_batch(images, ex, k_real))


def test_multi_exemplar_with_refiner_matches_jax(pred_pair):
    jpred, pred, images = pred_pair
    ex = EXEMPLARS[:, 0]
    _assert_dets_match(pred.predict_multi_exemplar(images[1:2], ex, k_real=2),
                       jpred.predict_multi_exemplar(images[1:2], ex, k_real=2))


def test_heads_fn_with_refiner_matches_the_fused_call_and_jax(pred_pair):
    """``_get_heads_fn(cap, size)`` on ``_get_backbone_fn``'s features refines with the
    bucket's image size: bit for bit the fused call, and the JAX program."""
    jpred, pred, images = pred_pair
    cap = pred.pick_capacity(EXEMPLARS, SIZE)
    feats = pred._get_backbone_fn()(images)
    got = pred._get_heads_fn(cap, SIZE)(feats, EXEMPLARS)
    fused = pred(images, EXEMPLARS)
    for name in ("valid", "scores", "boxes", "refs"):
        assert torch.equal(got[name], fused[name]), name
    jfeat = np.asarray(jpred._get_backbone_fn()(jpred.params, images))
    want = jpred._get_heads_fn(cap, SIZE)(jpred.params, jpred.refiner_params, jfeat,
                                          EXEMPLARS)
    _assert_dets_match(got, want)


def test_device_tail_with_refiner_keeps_the_host_lists(pred_pair):
    from tmr_tpu_torch.inference import detections_to_numpy

    _, pred, images = pred_pair
    dev = Predictor(dataclasses.replace(pred.cfg, decode_tail="device"), device="cpu",
                    model=pred.model, refiner=pred.refiner)
    a, b = (detections_to_numpy(p(images, EXEMPLARS)) for p in (pred, dev))
    for x, y in zip(a, b):
        for name in ("boxes", "scores", "refs"):
            np.testing.assert_array_equal(x[name], y[name])
