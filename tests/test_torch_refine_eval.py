"""``--refine_box`` through the port's eval entry on the CPU: ``Trainer.test`` with a
refiner against the JAX ``Trainer.test`` with one, and ``python -m tmr_tpu_torch.main
--eval --refine_box --refiner_checkpoint X --device cpu`` against ``Trainer.test`` with
the refiner that checkpoint holds.

The detector is ``tests/test_torch_eval.py``'s TINY MatchingNet (f32) with the encoder's
``out_chans`` 32 on a synthetic FSCD-147 fixture of 3 test images (128^2, 16 x 16
features); the JAX comparison uses ``tests/test_torch_refine.py``'s tiny refiner, the
CLI the full-size refiner (256-d, 8 heads, MLP 2048) from a seeded SAM-layout ``.pth``.
Tolerances as ``tests/test_torch_eval.py``: the same detections per image, boxes and
scores within 1e-4, AP/AP50/AP75/MAE/RMSE within 1e-6, losses within 1e-4 relative; the
CLI equal to ``Trainer.test`` exactly (the same code on the same CPU)."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import tmr_tpu.train.loop as j_loop  # noqa: E402
import tmr_tpu_torch.models  # noqa: E402
import tmr_tpu_torch.train.loop as loop  # noqa: E402
from tests.test_torch_refine import tiny_refiners  # noqa: E402
from tests.test_torch_sam_decoder import DIM, refiner_sam_layout  # noqa: E402
from tmr_tpu.config import preset as j_preset  # noqa: E402
from tmr_tpu.data.synthetic import write_synthetic_fscd147  # noqa: E402
from tmr_tpu.inference import Predictor as JPredictor  # noqa: E402
from tmr_tpu.models.matching_net import MatchingNet as JMatchingNet  # noqa: E402
from tmr_tpu.models.vit import SamViT as JSamViT  # noqa: E402
from tmr_tpu_torch import main as port_main  # noqa: E402
from tmr_tpu_torch.config import preset  # noqa: E402
from tmr_tpu_torch.models import build_model  # noqa: E402
from tmr_tpu_torch.models.vit import SamViT  # noqa: E402
from tmr_tpu_torch.refine import SamRefineModule, build_refiner  # noqa: E402
from tmr_tpu_torch.utils import convert  # noqa: E402
from tmr_tpu_torch.utils.weights import init_params  # noqa: E402

TINY = dict(embed_dim=32, depth=4, num_heads=2, global_attn_indexes=(1, 3),
            patch_size=8, window_size=3, out_chans=DIM)
SIZE = 128
N_TEST = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """The synthetic split, the TINY JAX model and its params (tweaked as in
    test_torch_predictor so every path does real work)."""
    root = tmp_path_factory.mktemp("refine_eval")
    write_synthetic_fscd147(str(root / "fsc"), n_train=1, n_val=N_TEST, image_size=SIZE,
                            square=28, seed=0)
    jmodel = JMatchingNet(backbone=JSamViT(pretrain_img_size=SIZE, **TINY), emb_dim=16,
                          fusion=True, feature_upsample=True, template_capacity=9)
    overrides = dict(emb_dim=16, compute_dtype="float32", image_size=SIZE)
    params = jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32),
        JPredictor(j_preset("TMR_FSCD147", **overrides), model=jmodel).init_params(0))
    rng = np.random.default_rng(1)
    params["objectness_head_0"]["conv"]["kernel"] *= 300.0
    bb = params["backbone"]
    bb["pos_embed"] = (rng.standard_normal(bb["pos_embed"].shape) * 0.1).astype(np.float32)
    for i in range(TINY["depth"]):
        for name in ("rel_pos_h", "rel_pos_w"):
            shape = bb[f"blocks_{i}"]["attn"][name].shape
            bb[f"blocks_{i}"]["attn"][name] = (rng.standard_normal(shape) * 0.5).astype(
                np.float32)
    return root, jmodel, params


def _cfg_kw(root, tag, k, bs, **extra):
    return dict(emb_dim=16, compute_dtype="float32", image_size=SIZE,
                datapath=str(root / "fsc"), logpath=str(root / tag), eval=True,
                eval_batch_size=bs, num_exemplars=k, num_workers=1, refine_box=True,
                **extra)


def _tiny_model(cfg):
    return build_model(cfg, backbone=SamViT(pretrain_img_size=SIZE, **TINY), device="cpu")


def _recording(monkeypatch, module):
    """Record the (meta, detections) of every image the eval loop logs."""
    seen = {}
    orig = module.image_info_collector

    def record(log_path, stage, meta, dets):
        for mt, d in zip(meta, dets):
            seen[mt["img_id"]] = {k: np.asarray(v) for k, v in d.items()}
        return orig(log_path, stage, meta, dets)

    monkeypatch.setattr(module, "image_info_collector", record)
    return seen


@pytest.mark.parametrize("k,bs", [(1, 2), (3, 1)])
def test_trainer_test_with_refiner_matches_jax(fixture, monkeypatch, k, bs):
    """Both packages refine before NMS in the eval programs: single-exemplar batches
    of 2 (then a ragged 1), and num_exemplars 3 (one image a batch, its union)."""
    root, jmodel, params = fixture
    jref, rparams, ref = tiny_refiners(chunk=16)
    tag = f"k{k}bs{bs}"
    jcfg = j_preset("TMR_FSCD147", device="cpu", **_cfg_kw(root, "jax_" + tag, k, bs))
    # the JAX Trainer would build (and init) a full-size refiner; give it the tiny one
    jtr = j_loop.Trainer(dataclasses.replace(jcfg, refine_box=False))
    jtr.cfg = jcfg
    jtr.model = jmodel
    jtr.predictor = JPredictor(jcfg, model=jmodel, refiner=jref, refiner_params=rparams)
    want_dets = _recording(monkeypatch, j_loop)
    want = jtr.test(params=params)

    cfg = preset("TMR_FSCD147", **_cfg_kw(root, "port_" + tag, k, bs))
    got_dets = _recording(monkeypatch, loop)
    tr = loop.Trainer(cfg, device="cpu", model=_tiny_model(cfg), refiner=ref)
    assert tr.predictor.refiner is ref
    got = tr.test(params=params)

    assert set(got) == set(want)
    for name in ("AP", "AP50", "AP75", "MAE", "RMSE"):
        np.testing.assert_allclose(got[f"test/{name}"], want[f"test/{name}"], rtol=0,
                                   atol=1e-6, err_msg=name)
    for name in ("loss", "loss_ce", "loss_giou"):
        np.testing.assert_allclose(got[f"test/{name}"], want[f"test/{name}"], rtol=1e-4,
                                   err_msg=name)
    assert sorted(got_dets) == sorted(want_dets) == list(range(N_TEST))
    for i in want_dets:
        g, w = got_dets[i], want_dets[i]
        assert len(g["boxes"]) == len(w["boxes"]) > 0, i
        for name in ("boxes", "scores", "refs"):
            np.testing.assert_allclose(g[name], w[name], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{i} {name}")


def test_trainer_builds_the_seeded_refiner_once(fixture, capsys):
    """Without ``refiner_checkpoint`` the Trainer builds the full-size refiner from
    ``cfg.seed`` (with the loud warning) and hands it to its Predictor."""
    root = fixture[0]
    cfg = preset("TMR_FSCD147", **_cfg_kw(root, "seeded", 1, 2), seed=7)
    tr = loop.Trainer(cfg, device="cpu", model=_tiny_model(cfg))
    assert "no refiner_checkpoint" in capsys.readouterr().err
    ref = tr.predictor.refiner
    assert isinstance(ref, SamRefineModule) and not ref.training
    want = build_refiner(cfg, seed=7, device="cpu").state_dict()
    assert all(torch.equal(v, want[k]) for k, v in ref.state_dict().items())


def test_main_eval_refine_box_matches_trainer_test(fixture, monkeypatch, tmp_path,
                                                   capsys):
    """``main --eval --refine_box --refiner_checkpoint X --device cpu`` on the split:
    the Lightning checkpoint under ``--logpath``, the full-size refiner from a SAM
    ``.pth``; its metrics and every image's detections equal ``Trainer.test`` with
    ``build_refiner`` of the same checkpoint."""
    root = fixture[0]
    # the full-size refiner reads a 256-channel feature: TINY with SAM's out_chans
    tiny256 = dict(TINY, out_chans=256)

    def tiny_backbone(cfg=None, device=None):
        return SamViT(pretrain_img_size=SIZE, **tiny256)

    monkeypatch.setattr(tmr_tpu_torch.models, "build_backbone", tiny_backbone)
    model = build_model(preset("TMR_FSCD147", emb_dim=16, compute_dtype="float32"),
                        backbone=tiny_backbone(), device="cpu")
    init_params(model, 0)
    with torch.no_grad():
        model.objectness_head_0.conv.weight.mul_(300.0)
    params = model.state_dict()
    gen = torch.Generator().manual_seed(3)
    sd = {k: torch.randn(v.shape, generator=gen) * 0.5 for k, v in
          build_refiner(preset("TMR_FSCD147"), device="cpu").state_dict().items()}
    ckpt = tmp_path / "sam_vit_h.pth"
    torch.save(refiner_sam_layout(sd), ckpt)
    logpath = tmp_path / "log"
    logpath.mkdir()
    torch.save({"state_dict": convert.lightning_state_dict(params)},
               logpath / "best_model.ckpt")
    argv = ["--eval", "--refine_box", "--refiner_checkpoint", str(ckpt), "--device", "cpu",
            "--dataset", "FSCD147", "--datapath", str(root / "fsc"), "--logpath",
            str(logpath), "--image_size", str(SIZE), "--backbone", "sam_vit_b",
            "--emb_dim", "16", "--fusion", "--feature_upsample", "--compute_dtype",
            "float32", "--num_workers", "1", "--max_detections", "64"]
    got_dets = _recording(monkeypatch, loop)
    got = port_main.main(argv)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(printed) == sorted(got) and "test/AP" in got

    cfg = port_main.to_config(port_main.config_parser(argv))
    assert cfg.refine_box and cfg.refiner_checkpoint == str(ckpt)
    cfg = dataclasses.replace(cfg, logpath=str(tmp_path / "direct"))
    want_dets = _recording(monkeypatch, loop)
    want = loop.Trainer(cfg, device="cpu", model=build_model(cfg, tiny_backbone(), "cpu"),
                        refiner=build_refiner(cfg, device="cpu")).test(params=params)
    assert got == want
    assert sorted(got_dets) == sorted(want_dets) == list(range(N_TEST))
    assert min(len(d["boxes"]) for d in got_dets.values()) > 0
    for i in want_dets:
        for name in ("boxes", "scores", "refs"):
            np.testing.assert_array_equal(got_dets[i][name], want_dets[i][name])
    assert os.path.exists(logpath / "predictions_test.json")

