"""The port's segment-anything surface (``tmr_tpu_torch/sam.py``: ``Sam``,
``SamPredictor``, ``SamAutomaticMaskGenerator``, ``SamDeployDecoder``) against the JAX
package's ``tmr_tpu/sam.py`` on the CPU, on a tiny ``Sam``: a SamViT of 32 x 2 blocks at
64^2 (4 x 4 tokens, windows of 2, 32 output channels, f32) and the tiny prompt encoder
and mask decoder of ``tests/test_torch_sam_decoder.py``; the JAX encoder's flax init and
the oracle's decoder weights go into the port through ``params_from_jax``.

Tolerances: features 1e-4 x max (f32 through 2 blocks, sums in another order); IoU 1e-5;
masks at the original resolution equal except where the logit lies within 1e-4 of the
largest |logit| (f32 rounding may flip the threshold there: at most a few pixels; the
JAX side resizes with cv2, the port with its numpy copy of cv2's float ``INTER_LINEAR``,
which equals cv2 bit for bit on the same logits); the mask generator's records: the same
count, boxes within a pixel, areas within a few pixels, IoU and stability within 1e-4;
the deploy decoder's resized masks 1e-4 x max."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import tmr_tpu.sam as jsam_mod  # noqa: E402
import tmr_tpu_torch.sam as sam_mod  # noqa: E402
from tmr_tpu_torch import sam_amg  # noqa: E402
from tests.test_torch_sam_decoder import (DIM, HEADS, MLP, oracle_state_dict,  # noqa: E402
                                          refiner_sam_layout)
from tmr_tpu.models.sam_decoder import MaskDecoder as JMaskDecoder  # noqa: E402
from tmr_tpu.models.sam_decoder import PromptEncoder as JPromptEncoder  # noqa: E402
from tmr_tpu.models.vit import SamViT as JSamViT  # noqa: E402
from tmr_tpu.utils.convert import convert_sam_refiner  # noqa: E402
from tmr_tpu_torch.data.transforms import resize_linear_f32  # noqa: E402
from tmr_tpu_torch.models.sam_decoder import MaskDecoder, PromptEncoder  # noqa: E402
from tmr_tpu_torch.models.vit import SamViT  # noqa: E402
from tmr_tpu_torch.sam import (Sam, SamAutomaticMaskGenerator,  # noqa: E402
                               SamDeployDecoder, SamPredictor, sam_model_registry)

SIZE = 64
ENC = dict(embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,), window_size=2,
           out_chans=DIM, pretrain_img_size=SIZE)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def sams():
    """(the JAX tiny Sam with its params, the port's with the same weights)."""
    jsam = jsam_mod.Sam("vit_b", image_size=SIZE)
    jsam.image_encoder = JSamViT(**ENC)
    jsam.prompt_encoder = JPromptEncoder(embed_dim=DIM)
    jsam.mask_decoder = JMaskDecoder(transformer_dim=DIM, transformer_num_heads=HEADS,
                                     transformer_mlp_dim=MLP)
    enc = jax.jit(jsam.image_encoder.init)(jax.random.key(0),
                                           np.zeros((1, SIZE, SIZE, 3), np.float32))
    enc = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), enc["params"])
    rng = np.random.default_rng(0)
    enc["pos_embed"] = (rng.standard_normal(enc["pos_embed"].shape) * 0.1).astype(
        np.float32)
    jsam.params = dict(convert_sam_refiner(oracle_state_dict(0)[0]), image_encoder=enc)
    sam = Sam("vit_b", image_size=SIZE, device="cpu", image_encoder=SamViT(**ENC),
              prompt_encoder=PromptEncoder(DIM),
              mask_decoder=MaskDecoder(DIM, transformer_num_heads=HEADS,
                                       transformer_mlp_dim=MLP))
    sam.load_jax_params(jsam.params)
    return jsam, sam


def _image(seed, h, w):
    return np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8)


def _logits_full(pred, prompt):
    """The port's logits at the original resolution for one prompt (before > 0)."""
    kw = {k: torch.from_numpy(np.asarray(v)) for k, v in prompt.items()}
    pts = kw.get("point_coords")
    masks, _ = pred._decode(
        None if pts is None else (pts.float()[None] * pred.scale),
        None if pts is None else kw["point_labels"].int()[None],
        None if "box" not in kw else kw["box"].float()[None] * pred.scale)
    h, w = pred.orig_hw
    sh, sw = int(h * pred.scale + 0.5), int(w * pred.scale + 0.5)
    return resize_linear_f32(masks[0].numpy()[:sh, :sw], h, w)


def _assert_masks_agree(got, want, logits, rel=1e-4, most=8):
    differ = got != want
    assert differ.sum() <= most
    assert not (differ & (np.abs(logits) >= rel * np.abs(logits).max())).any()


def test_registry_builds_the_published_encoders():
    assert sam_model_registry["vit_b"](device="meta").image_encoder.blocks[0].norm1 \
        .normalized_shape == (768,)
    default = sam_model_registry["default"](device="meta")
    assert len(default.image_encoder.blocks) == 32
    assert default.mask_decoder.transformer_dim == 256
    with pytest.raises(ValueError, match="no weights"):
        SamPredictor(default)


@pytest.mark.parametrize("prompt", [
    dict(point_coords=[[40.0, 24.0]], point_labels=[1]),
    dict(box=[10.0, 10.0, 60.0, 40.0]),
    dict(point_coords=[[30.0, 20.0]], point_labels=[1], box=[10.0, 10.0, 60.0, 40.0]),
    dict(point_coords=[[30.0, 20.0], [50.0, 30.0]], point_labels=[1, 0])],
    ids=["point", "box", "point_box", "two_points"])
def test_predictor_matches_jax(sams, prompt):
    """set_image on a 48 x 80 image (features compared), then one prompt: the mask at
    the original resolution and the predicted IoU."""
    jsam, sam = sams
    jpred, pred = jsam_mod.SamPredictor(jsam), SamPredictor(sam)
    img = _image(0, 48, 80)
    jpred.set_image(img)
    pred.set_image(img)
    want_f = np.asarray(jpred.features)
    assert pred.features.shape == want_f.shape == (1, 4, 4, DIM)
    np.testing.assert_allclose(pred.features.numpy(), want_f, rtol=0,
                               atol=1e-4 * np.abs(want_f).max())
    args = {k: np.asarray(v, np.float32 if k != "point_labels" else np.int32)
            for k, v in prompt.items()}
    want_m, want_i = jpred.predict(**args)
    got_m, got_i = pred.predict(**args)
    assert got_m.shape == (48, 80) and got_m.dtype == bool
    np.testing.assert_allclose(got_i, want_i, rtol=0, atol=1e-5)
    _assert_masks_agree(got_m, want_m, _logits_full(pred, args))


def test_predictor_requires_an_image_and_a_prompt(sams):
    pred = SamPredictor(sams[1])
    with pytest.raises(RuntimeError, match="set_image"):
        pred.predict(point_coords=np.array([[1.0, 1.0]]), point_labels=np.array([1]))
    pred.set_image(_image(1, 32, 32))
    with pytest.raises(ValueError, match="points and/or a box"):
        pred.predict()


@pytest.mark.parametrize("hw", [(85, 128), (48, 80), (70, 33)])
def test_to_original_matches_jax(sams, hw):
    """Unpad with the preprocess's half-up rounding (85 x 128 at 64 keeps 43 rows, not
    int(round(42.5)) = 42), then cv2's float resize: the same bool mask as the JAX
    package's cv2 call, from the same logits."""
    jsam, sam = sams
    jpred, pred = jsam_mod.SamPredictor(jsam), SamPredictor(sam)
    for p in (jpred, pred):
        p.orig_hw, p.scale = hw, SIZE / max(hw)
    logits = np.random.default_rng(2).standard_normal((SIZE, SIZE)).astype(np.float32)
    np.testing.assert_array_equal(pred._to_original(logits), jpred._to_original(logits))
    sh = int(hw[0] * pred.scale + 0.5)
    only_last = np.full((SIZE, SIZE), -5.0, np.float32)
    only_last[sh - 1, :] = 5.0
    assert pred._to_original(only_last).any()


def _records_agree(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["predicted_iou"], w["predicted_iou"], atol=1e-4)
        np.testing.assert_allclose(g["stability_score"], w["stability_score"], atol=1e-4)
        np.testing.assert_allclose(g["bbox"], w["bbox"], atol=1.0)
        np.testing.assert_allclose(g["point_coords"], w["point_coords"], atol=1e-4)
        assert g["crop_box"] == w["crop_box"]
        assert abs(g["area"] - w["area"]) <= 8
        seg_g, seg_w = g["segmentation"], w["segmentation"]
        if isinstance(seg_g, dict):
            seg_g, seg_w = (sam_amg.rle_to_mask(x) for x in (seg_g, seg_w))
        assert (seg_g != seg_w).sum() <= 8


@pytest.mark.parametrize("kw", [
    dict(points_per_side=4, points_per_batch=8, box_nms_thresh=0.9),
    dict(points_per_side=4, points_per_batch=8, box_nms_thresh=0.7, crop_n_layers=1,
         min_mask_region_area=20, output_mode="uncompressed_rle")],
    ids=["one_crop", "crops_and_cleanup"])
def test_mask_generator_matches_jax(sams, kw):
    """The point grid in batches, the quality filters (kept open: random weights), the
    crop-edge filter, NMS within and across crops, small-region cleanup: the same
    records, sorted by predicted IoU."""
    jsam, sam = sams
    kw = dict(kw, pred_iou_thresh=-1e9, stability_score_thresh=-1.0)
    img = _image(3, 48, 64)
    want = jsam_mod.SamAutomaticMaskGenerator(jsam, **kw).generate(img)
    got = SamAutomaticMaskGenerator(sam, **kw).generate(img)
    _records_agree(got, want)
    ious = [r["predicted_iou"] for r in got]
    assert ious == sorted(ious, reverse=True)
    if kw.get("output_mode") == "uncompressed_rle":
        assert set(got[0]["segmentation"]) == {"size", "counts"}
    else:
        assert got[0]["segmentation"].shape == (48, 64)


def test_mask_generator_strict_thresholds_and_arguments(sams):
    sam = sams[1]
    strict = SamAutomaticMaskGenerator(sam, points_per_side=2, points_per_batch=4,
                                       pred_iou_thresh=1e9)
    assert strict.generate(_image(4, 32, 32)) == []
    with pytest.raises(ValueError, match="exactly one"):
        SamAutomaticMaskGenerator(sam, points_per_side=None)
    with pytest.raises(ValueError, match="output_mode"):
        SamAutomaticMaskGenerator(sam, output_mode="png")
    grids = [np.array([[0.5, 0.5]])]
    assert len(SamAutomaticMaskGenerator(sam, points_per_side=None, point_grids=grids)
               .point_grids[0]) == 1


@pytest.mark.parametrize("kw", [dict(return_single_mask=True),
                                dict(return_single_mask=False, use_stability_score=True),
                                dict(return_single_mask=True, return_extra_metrics=True)],
                         ids=["single", "stability", "extra_metrics"])
def test_deploy_decoder_matches_jax(sams, kw):
    """The exporter's surface on cached embeddings: padded point prompts (label -1), a
    mask input for one prompt, resized to a 50 x 70 original."""
    jsam, sam = sams
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((1, 4, 4, DIM)).astype(np.float32)
    pts = rng.uniform(0, SIZE, (2, 3, 2)).astype(np.float32)
    labels = np.array([[1, 0, -1], [1, -1, -1]], np.int32)
    mask_in = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    has = np.array([1.0, 0.0], np.float32)
    want = jax.jit(lambda p, *a: jsam_mod.SamDeployDecoder(jsam, **kw)(p, *a, (50, 70)))(
        jsam.params, emb, pts, labels, mask_in, has)
    got = SamDeployDecoder(sam, **kw)(*(torch.from_numpy(a) for a in
                                        (emb, pts, labels, mask_in, has)), (50, 70))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g.numpy().astype(np.float64), w, rtol=0,
                                   atol=1e-4 * scale)


def test_sam_from_checkpoint_reads_a_full_sam_pth(tmp_path, monkeypatch):
    """A full SAM ``.pth`` (``image_encoder.*`` with the refiner's subtrees): the
    encoder through ``sam_vit_state_dict``, the decoder through the refiner's
    converter."""
    from tmr_tpu_torch.utils import convert

    monkeypatch.setattr(sam_mod, "build_sam_vit",
                        lambda kind, dtype: SamViT(**dict(ENC, out_chans=256)))
    ref = Sam("vit_b", image_size=SIZE, device="cpu").init_random(4)
    sd = refiner_sam_layout({k: v for k, v in ref.state_dict().items()
                             if not k.startswith("image_encoder.")})
    renames = {"patch_embed.": "patch_embed.proj.", "neck_0.": "neck.0.",
               "neck_1.": "neck.1.", "neck_2.": "neck.2.", "neck_3.": "neck.3."}
    for key, val in ref.image_encoder.state_dict().items():
        for mine, theirs in renames.items():
            if key.startswith(mine):
                key = theirs + key[len(mine):]
        sd["image_encoder." + key] = val
    torch.save(sd, tmp_path / "sam_vit_b.pth")
    assert convert.checkpoint_kind(sd) == "sam_vit"
    got = Sam.from_checkpoint(str(tmp_path / "sam_vit_b.pth"), device="cpu")
    assert got.weights_set and not got.training
    want = ref.state_dict()
    for k, v in got.state_dict().items():
        assert torch.equal(v, want[k]), k
