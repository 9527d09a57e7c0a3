"""The port's eval entry on the CPU against the JAX package's: target assignment and
``compute_losses``, ``Trainer.test`` end to end (loader, one forward per batch for
losses and detections, the per-image JSONs, COCO AP and MAE/RMSE) at the TINY geometry
of ``tests/test_torch_predictor.py`` (f32) on a synthetic FSCD-147 fixture, the
Lightning ``.ckpt`` / SAM ``.pth`` loader, best-checkpoint resolution and
``python -m tmr_tpu_torch.main``.

Tolerances: target maps equal; losses within 1e-5 relative on the same outputs (f32
sums in another order); ``Trainer.test``: the same detection counts per image, boxes
and scores within 1e-4, AP/AP50/AP75/MAE/RMSE within 1e-6, losses within 1e-4 relative
(the maps differ by f32 rounding through a 4-block encoder, ``tests/test_torch_
predictor.py``); the checkpoint loader equal to ``params_from_jax(convert_matching_net(
sd))`` bit for bit. The fixture's objects are 28 px on 128-px images at image_size 128,
so no image reaches the 1536 bucket here (its rule is held in
``tests/test_torch_data.py``)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import tmr_tpu.train.loop as j_loop  # noqa: E402
import tmr_tpu_torch.train.loop as loop  # noqa: E402
from tmr_tpu.config import preset as j_preset  # noqa: E402
from tmr_tpu.data.synthetic import write_synthetic_fscd147  # noqa: E402
from tmr_tpu.inference import Predictor as JPredictor  # noqa: E402
from tmr_tpu.models.matching_net import MatchingNet as JMatchingNet  # noqa: E402
from tmr_tpu.models.vit import SamViT as JSamViT  # noqa: E402
from tmr_tpu.train import state as j_state  # noqa: E402
from tmr_tpu.train import targets as j_targets  # noqa: E402
from tmr_tpu.utils.convert import convert_matching_net, convert_sam_vit  # noqa: E402
from tmr_tpu_torch.config import preset  # noqa: E402
from tmr_tpu_torch.models import build_model  # noqa: E402
from tmr_tpu_torch.models.vit import SamViT  # noqa: E402
from tmr_tpu_torch.train import state, targets  # noqa: E402
from tmr_tpu_torch.utils import checkpoint, convert  # noqa: E402
from tmr_tpu_torch.utils.weights import params_from_jax  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TINY = dict(embed_dim=32, depth=4, num_heads=2, global_attn_indexes=(1, 3),
            patch_size=8, window_size=3, out_chans=16)
SIZE = 128
N_TEST = 5  # batches of 2, 2 and a ragged 1 at eval_batch_size 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------------------ losses
def _loss_inputs(seed, b=2, h=16, w=12, m=6, no_reg=False):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.0, 0.8, (b, m, 2))
    gt = np.concatenate([xy, xy + rng.uniform(0.03, 0.25, (b, m, 2))], -1)
    valid = rng.random((b, m)) < 0.8
    valid[0, 0] = True
    if b > 1:
        valid[1] = False  # an image without GT: the zero-positive dummy
    ex = np.concatenate([gt[:, :1], rng.uniform(0.1, 0.9, (b, 2, 4))], 1)
    obj = rng.standard_normal((b, h, w)).astype(np.float32) * 3
    reg = None if no_reg else (rng.standard_normal((b, h, w, 4)) * 0.3).astype(np.float32)
    return (obj, reg, ex.astype(np.float32), gt.astype(np.float32), valid)


@pytest.mark.parametrize("thr", [(0.5, 0.5), (0.7, 0.3), (1.0, 1.0)])
@pytest.mark.parametrize("last", [True, False])
def test_assign_targets_matches_jax(thr, last):
    obj, _, ex, gt, valid = _loss_inputs(1, b=3, h=20, w=16, m=7)
    got = targets.assign_targets(torch.from_numpy(gt), torch.from_numpy(valid),
                                 torch.from_numpy(ex[:, 0]), 20, 16, *thr, last)
    want = j_targets.assign_targets(gt, valid, ex[:, 0], 20, 16, *thr, last)
    for k in ("positive", "negative", "box_target"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["positive"].any() and got["negative"].any()
    np.testing.assert_array_equal(targets.boundary_mask(torch.from_numpy(ex[:, 1]), 20, 16)
                                  .numpy()[0],
                                  np.asarray(j_targets.boundary_mask(ex[0, 1], 20, 16)))


@pytest.mark.parametrize("kw", [dict(), dict(use_focal_loss=True),
                                dict(scale_imgsize=True), dict(scale_wh_only=True),
                                dict(no_reg=True), dict(thr=(0.7, 0.7), b=1)])
def test_compute_losses_matches_jax(kw):
    thr = kw.pop("thr", (0.5, 0.5))
    obj, reg, ex, gt, valid = _loss_inputs(2, b=kw.pop("b", 2),
                                           no_reg=kw.pop("no_reg", False))
    batch = {"exemplars": ex, "gt_boxes": gt, "gt_valid": valid}
    got = state.compute_losses(
        {"objectness": torch.from_numpy(obj),
         "regressions": None if reg is None else torch.from_numpy(reg)},
        {k: torch.from_numpy(v) for k, v in batch.items()}, *thr, **kw)
    want = j_state.compute_losses({"objectness": [obj], "regressions": [reg]}, batch,
                                  *thr, **kw)
    assert set(got) == set(want) == {"loss_ce", "loss_giou", "loss"}
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)


def test_compute_losses_takes_jax_level_lists():
    obj, reg, ex, gt, valid = _loss_inputs(3)
    batch = {"exemplars": ex, "gt_boxes": gt, "gt_valid": valid}
    out = {"objectness": torch.from_numpy(obj), "regressions": torch.from_numpy(reg)}
    one = state.compute_losses(out, batch, 0.5, 0.5)
    two = state.compute_losses({k: [v, v] for k, v in out.items()}, batch, 0.5, 0.5)
    want = j_state.compute_losses({"objectness": [obj, obj], "regressions": [reg, reg]},
                                  batch, 0.5, 0.5)
    np.testing.assert_allclose(two["loss"].item(), float(want["loss"]), rtol=1e-5)
    assert two["loss_ce"].item() != one["loss_ce"].item()  # is_center on the last only


# --------------------------------------------------------- Trainer.test
@pytest.fixture(scope="module")
def eval_pair(tmp_path_factory):
    """The fixture, a TINY JAX model's params (tweaked as in test_torch_predictor so
    every path does real work) and the JAX model."""
    root = tmp_path_factory.mktemp("eval")
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


def _cfg_kw(root, tag, k, bs):
    return dict(emb_dim=16, compute_dtype="float32", image_size=SIZE,
                datapath=str(root / "fsc"), logpath=str(root / tag), eval=True,
                eval_batch_size=bs, num_exemplars=k, num_workers=1)


def _port_trainer(root, tag, k, bs):
    cfg = preset("TMR_FSCD147", **_cfg_kw(root, tag, k, bs))
    model = build_model(cfg, backbone=SamViT(pretrain_img_size=SIZE, **TINY), device="cpu")
    return loop.Trainer(cfg, device="cpu", model=model)


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


@pytest.mark.parametrize("k,bs", [(1, 2), (1, 3), (3, 2)])
def test_trainer_test_matches_jax(eval_pair, monkeypatch, k, bs):
    """``Trainer.test(params=...)`` of both packages on the same fixture and weights:
    eval_batch_size 2 (batches 2, 2, 1), 3 (3, then a ragged 2 split to 1 + 1), and
    num_exemplars 3 (forced to B = 1; the fixture has 2 exemplars an image, so k bucket
    2)."""
    root, jmodel, params = eval_pair
    tag = f"k{k}bs{bs}"
    jcfg = j_preset("TMR_FSCD147", device="cpu", **_cfg_kw(root, "jax_" + tag, k, bs))
    jtr = j_loop.Trainer(jcfg)
    jtr.model = jmodel
    jtr.predictor = JPredictor(jcfg, model=jmodel)
    want_dets = _recording(monkeypatch, j_loop)
    want = jtr.test(params=params)

    got_dets = _recording(monkeypatch, loop)
    got = _port_trainer(root, "port_" + tag, k, bs).test(params=params)

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
    # the per-image JSONs are merged and removed, the merged files stay
    assert os.path.exists(root / ("port_" + tag) / "predictions_test.json")
    assert not os.path.exists(root / ("port_" + tag) / "logged_datas" / "test")


def test_trainer_test_loads_the_best_lightning_checkpoint(eval_pair):
    """With no params, ``test()`` loads the highest-version ``best_model*.ckpt`` under
    the logpath: the same metrics as the same weights passed in; with none it raises."""
    root, _, params = eval_pair
    direct = _port_trainer(root, "ckpt_direct", 1, 2).test(params=params)
    tr = _port_trainer(root, "ckpt", 1, 2)
    with pytest.raises(FileNotFoundError, match="best_model"):
        tr.test()
    sd = convert.lightning_state_dict(params_from_jax(params))
    ckdir = root / "ckpt" / "checkpoints"
    ckdir.mkdir(parents=True)
    torch.save({"state_dict": sd, "epoch": 3}, ckdir / "best_model-v2.ckpt")
    bad = {k: torch.zeros_like(v) for k, v in sd.items()}
    torch.save({"state_dict": bad}, root / "ckpt" / "best_model.ckpt")
    torch.save({"state_dict": bad}, ckdir / "best_model-v1.ckpt")
    assert checkpoint.best_checkpoint(str(root / "ckpt")) == str(ckdir / "best_model-v2.ckpt")
    assert tr.test() == direct


def test_best_checkpoint_resolution(tmp_path):
    assert checkpoint.best_checkpoint(str(tmp_path / "missing")) is None
    (tmp_path / "best_model-v0").mkdir()  # an orbax directory of the JAX package
    (tmp_path / "last.ckpt").write_bytes(b"")
    assert checkpoint.best_checkpoint(str(tmp_path)) is None
    for name in ("best_model.ckpt", "best_model-v9.ckpt", "best_model-v10.ckpt"):
        (tmp_path / name).write_bytes(b"")
    assert checkpoint.best_checkpoint(str(tmp_path)) == str(tmp_path / "best_model-v10.ckpt")


@pytest.mark.parametrize("field", ["refine_box", "visualize"])
def test_trainer_refuses_unported_options(eval_pair, field):
    root = eval_pair[0]
    cfg = preset("TMR_FSCD147", **_cfg_kw(root, "refuse", 1, 1), **{field: True})
    with pytest.raises(NotImplementedError, match="ROADMAP A[46]"):
        loop.Trainer(cfg, device="cpu")


# ------------------------------------------------------- checkpoint layouts
def _tiny_port_model():
    """Two decoder layers: the reference keeps them at even indices (conv, ReLU)."""
    cfg = preset("TMR_FSCD147", emb_dim=16, compute_dtype="float32", decoder_num_layer=2)
    return build_model(cfg, backbone=SamViT(pretrain_img_size=32, **TINY), device="cpu")


def _lightning_sd(seed):
    """A Lightning-layout ``model.*`` state_dict in the reference's module paths with
    the TINY port model's shapes, random values, and keys the port does not read."""
    gen = torch.Generator().manual_seed(seed)
    sd = convert.lightning_state_dict(
        {k: torch.randn(v.shape, generator=gen) for k, v in
         _tiny_port_model().state_dict().items()})
    sd["model.encoder.backbone.backbone.unused_buffer"] = torch.ones(3)
    return sd


def test_lightning_ckpt_loads_like_convert_matching_net(tmp_path):
    sd = _lightning_sd(0)
    assert "model.decoder_o.layer.2.weight" in sd
    assert "model.decoder_b.layer.1.weight" not in sd
    assert "model.encoder.backbone.backbone.patch_embed.proj.weight" in sd
    assert "model.encoder.backbone.backbone.neck.3.bias" in sd
    path = tmp_path / "best_model.ckpt"
    torch.save({"state_dict": sd, "epoch": 7, "global_step": 70}, path)
    got = convert.load_matching_net(str(path))
    want = params_from_jax(convert_matching_net({k: v.numpy() for k, v in sd.items()}))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k
    model = _tiny_port_model()
    model.load_state_dict(got, strict=True)
    # and back: the port's state_dict in the Lightning layout round-trips
    relaid = convert.lightning_state_dict(model.state_dict())
    assert all(torch.equal(relaid[k], sd[k]) for k in relaid)
    assert set(sd) - set(relaid) == {"model.encoder.backbone.backbone.unused_buffer"}


def test_sam_pth_loads_like_convert_sam_vit(tmp_path):
    sd = {"image_encoder." + k[len("model.encoder.backbone.backbone."):]: v
          for k, v in _lightning_sd(1).items() if k.startswith("model.encoder.")}
    sd["prompt_encoder.not_a_point_embed.weight"] = torch.ones(1, 4)
    torch.save(sd, tmp_path / "sam.pth")
    loaded = convert.load_torch_state_dict(str(tmp_path / "sam.pth"))
    assert convert.checkpoint_kind(loaded) == "sam_vit"
    got = convert.sam_vit_state_dict(loaded)
    want = params_from_jax(convert_sam_vit({k: v.numpy() for k, v in sd.items()}))
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    SamViT(pretrain_img_size=32, **TINY).load_state_dict(got, strict=True)
    with pytest.raises(ValueError, match="sam_vit"):
        convert.load_matching_net(str(tmp_path / "sam.pth"))


@pytest.mark.parametrize("keys,match", [(("layer1.0.conv1.weight",), "A3"),
                                        (("model.encoder.backbone.backbone.layer1.0.w",
                                          "model.input_proj.0.weight"), "A3"),
                                        (("mask_decoder.iou_token.weight",), "A6")])
def test_unported_layouts_raise(keys, match):
    sd = {k: torch.zeros(1) for k in keys}
    with pytest.raises(NotImplementedError, match=match):
        if keys[0].startswith("model."):
            convert.matching_net_state_dict(sd)
        else:
            convert.checkpoint_kind(sd)


# ------------------------------------------------------------------ the CLI
def _main(args, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "tmr_tpu_torch.main", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300, env=env)


def test_main_refuses_the_cpu_unless_asked(eval_pair):
    root = eval_pair[0]
    common = ["--dataset", "FSCD147", "--datapath", str(root / "fsc"), "--image_size",
              str(SIZE), "--backbone", "sam_vit_b", "--emb_dim", "16", "--fusion",
              "--compute_dtype", "float32"]
    res = _main(["--eval", "--logpath", str(root / "cli_gpu"), *common])
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    # --device cpu reaches the eval itself: the loaders, then the checkpoint lookup
    res = _main(["--eval", "--device", "cpu", "--logpath", str(root / "cli_cpu"),
                 *common])
    assert res.returncode != 0 and "FileNotFoundError" in res.stderr
    assert "best_model" in res.stderr and "no CUDA device" not in res.stderr
    # without --eval it trains: on the GPU by default (refused here), and on the CPU when
    # asked, where it reaches the trainer (a logpath with checkpoints is refused)
    res = _main(["--logpath", str(root / "cli_train_gpu"), *common])
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    ckdir = root / "cli_train_cpu" / "checkpoints"
    ckdir.mkdir(parents=True)
    (ckdir / "ckpt_meta.json").write_text("{}")
    res = _main(["--device", "cpu", "--logpath", str(root / "cli_train_cpu"), *common])
    assert res.returncode != 0 and "FileExistsError" in res.stderr
    assert "resume" in res.stderr and "no CUDA device" not in res.stderr


def test_main_parser_keeps_main_py_names_and_defaults():
    import main as j_main

    from tmr_tpu_torch import main as port_main

    got, want = vars(port_main.config_parser([])), vars(j_main.config_parser([]))
    for name, value in got.items():
        if name != "device":
            assert name in want and want[name] == value, name
    assert got["device"] == "cuda"
    cfg = port_main.to_config(port_main.config_parser(["--eval", "--device", "cpu"]))
    assert cfg.eval and cfg.backbone == "resnet50" and cfg.max_gt_boxes == 800
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        port_main.main(["--eval", "--mesh_model", "2"])
