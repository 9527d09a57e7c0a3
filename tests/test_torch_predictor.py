"""The whole slice on the CPU: ``tmr_tpu.inference.Predictor`` at the TINY geometry of
``tests/test_vit_golden.py`` (f32) with ``init_params(0)`` -> ``params_from_jax`` -> the
port's ``Predictor(device="cpu")``, on the same images and exemplars; and the same pair
with ViT-H's head dim (80: embed 160 over 2 heads), so both attention functions run at
d = 80 through the whole slice.

The objectness head kernel is scaled up in both (the flax init of N(0, 0.01) leaves
near-flat maps whose local maxima would hinge on last-ulp ties), and the zero-initialised
rel-pos tables and position embedding get values, so every path does real work.
Objectness/regression maps: 1e-4 (f32 sums in another order across a 4-block encoder);
detections after NMS: the same slots kept, scores and boxes within 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tmr_tpu.config import preset as j_preset  # noqa: E402
from tmr_tpu.inference import Predictor as JPredictor  # noqa: E402
from tmr_tpu.models.matching_net import MatchingNet as JMatchingNet  # noqa: E402
from tmr_tpu.models.vit import SamViT as JSamViT  # noqa: E402
from tmr_tpu_torch.config import preset  # noqa: E402
from tmr_tpu_torch.inference import Predictor, detections_to_numpy  # noqa: E402
from tmr_tpu_torch.models import build_model  # noqa: E402
from tmr_tpu_torch.models.vit import SamViT  # noqa: E402

TINY = dict(embed_dim=32, depth=4, num_heads=2, global_attn_indexes=(1, 3),
            patch_size=8, window_size=3, out_chans=16)
#: the same with ViT-H's head dim (1280 / 16 = 80): embed 160 over 2 heads
TINY_H80 = dict(TINY, embed_dim=160)
SIZE = 32
EXEMPLARS = np.array([[[0.2, 0.2, 0.4, 0.5]], [[0.5, 0.55, 0.7, 0.6]],
                      [[0.1, 0.6, 0.15, 0.7]]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _make_pair(tiny):
    """The JAX Predictor with ``tiny``'s backbone, its params, and the port's Predictor
    loaded with them; and the images."""
    overrides = dict(emb_dim=16, compute_dtype="float32", image_size=SIZE)
    jmodel = JMatchingNet(backbone=JSamViT(pretrain_img_size=SIZE, **tiny), emb_dim=16,
                          fusion=True, feature_upsample=True, template_capacity=9)
    jpred = JPredictor(j_preset("TMR_FSCD147", **overrides), model=jmodel)
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                    jpred.init_params(0))
    rng = np.random.default_rng(1)
    params["objectness_head_0"]["conv"]["kernel"] *= 300.0
    bb = params["backbone"]
    bb["pos_embed"] = (rng.standard_normal(bb["pos_embed"].shape) * 0.1).astype(np.float32)
    for i in range(tiny["depth"]):
        for name in ("rel_pos_h", "rel_pos_w"):
            shape = bb[f"blocks_{i}"]["attn"][name].shape
            bb[f"blocks_{i}"]["attn"][name] = (rng.standard_normal(shape) * 0.5).astype(
                np.float32)
    jpred.params = params
    cfg = preset("TMR_FSCD147", **overrides)
    pred = Predictor(cfg, device="cpu",
                     model=build_model(cfg, backbone=SamViT(pretrain_img_size=SIZE,
                                                            **tiny), device="cpu"))
    pred.load_jax_params(params)
    images = rng.standard_normal((3, SIZE, SIZE, 3)).astype(np.float32)
    return jpred, pred, images


@pytest.fixture(scope="module")
def pair():
    return _make_pair(TINY)


@pytest.fixture(scope="module")
def pair_h80():
    return _make_pair(TINY_H80)


def _check_maps(pair):
    jpred, pred, images = pair
    cap = jpred.pick_capacity(EXEMPLARS, SIZE)
    assert cap == pred.pick_capacity(EXEMPLARS, SIZE)
    want = jpred.model.clone(template_capacity=cap).apply({"params": jpred.params},
                                                          images, EXEMPLARS)
    got = pred.forward(images, EXEMPLARS)
    for name in ("objectness", "regressions"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name][0]),
                                   rtol=1e-4, atol=1e-4)


def _check_detections(pair):
    jpred, pred, images = pair
    want = jpred(images, EXEMPLARS)
    got = pred(images, EXEMPLARS)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["valid"].sum() > 0
    for name in ("scores", "boxes", "refs"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-5, atol=1e-5)
    lists = detections_to_numpy(got)
    assert [len(d["boxes"]) for d in lists] == got["valid"].sum(1).tolist()


def test_maps_match_jax(pair):
    _check_maps(pair)


def test_detections_match_jax(pair):
    _check_detections(pair)


def test_maps_match_jax_head_dim_80(pair_h80):
    """The whole slice with ViT-H's head dim: both attention kernels' plain versions at
    d = 80 against the JAX package's (Pallas in interpret mode where it runs them)."""
    assert pair_h80[1].model.backbone.blocks[0].attn.rel_pos_h.shape[-1] == 80
    _check_maps(pair_h80)


def test_detections_match_jax_head_dim_80(pair_h80):
    _check_detections(pair_h80)


def test_bucket_key_matches_jax(pair):
    jpred, pred, _ = pair
    for ex in EXEMPLARS:
        assert pred.bucket_key(SIZE, ex) == jpred.bucket_key(SIZE, ex)
    assert pred.feature_hw(SIZE) == jpred.feature_hw(SIZE)


def test_full_width_geometry_picks_the_main_path_buckets():
    """At 1024 the feature grid is 128 (64 tokens, upsampled 2x): 56/120/240-pixel
    exemplars land in buckets 9/17/33, the ones the chip smoke run drives."""
    from tmr_tpu_torch.models.matching_net import select_capacity_bucket

    buckets = preset("TMR_FSCD147").template_buckets
    for side, want in ((56, 9), (120, 17), (240, 33)):
        ex = np.array([64, 128, 64 + side, 128 + side]) / 1024
        assert select_capacity_bucket(ex, 128, 128, buckets) == want
