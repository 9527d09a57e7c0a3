"""The port's training loop on the CPU (``tmr_tpu_torch/train/loop.py`` ``Trainer.fit``,
``utils/checkpoint.CheckpointManager``, ``python -m tmr_tpu_torch.main`` without
``--eval``) on the synthetic FSCD-147 writer's data at a TINY geometry: the rows of
``metrics.csv`` under the JAX trainer's keys, resume against an uninterrupted run, the
fresh-run guard, the best model as a Lightning ``.ckpt`` that ``--eval`` reads, the JAX
``tests/test_csv_logger.py`` cases, the checkpoint metadata, wandb's absence and the
profiler trace.

Tolerances: a resumed run equals the uninterrupted one bit for bit (the same ops on the
same values on one CPU thread); checkpoints round-trip bit for bit."""

import csv
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tmr_tpu_torch.models as port_models  # noqa: E402
from tmr_tpu.config import Config as JConfig  # noqa: E402
from tmr_tpu.data.synthetic import write_synthetic_fscd147  # noqa: E402
from tmr_tpu.inference import Predictor as JPredictor  # noqa: E402
from tmr_tpu.models.matching_net import MatchingNet as JMatchingNet  # noqa: E402
from tmr_tpu.models.vit import SamViT as JSamViT  # noqa: E402
from tmr_tpu.train import loop as j_loop  # noqa: E402
from tmr_tpu_torch import main as port_main  # noqa: E402
from tmr_tpu_torch.config import preset  # noqa: E402
from tmr_tpu_torch.models import build_model  # noqa: E402
from tmr_tpu_torch.models.vit import SamViT  # noqa: E402
from tmr_tpu_torch.train import loop, state  # noqa: E402
from tmr_tpu_torch.utils import checkpoint, convert  # noqa: E402
from tmr_tpu_torch.utils.wandb_logger import WandbLogger  # noqa: E402

TINY = dict(embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,), patch_size=8,
            window_size=3, out_chans=16)
SIZE = 64
#: the fields both trainers are given (the JAX package's e2e fixture's)
FIELDS = dict(dataset="FSCD147", backbone="sam_vit_b", emb_dim=16, fusion=True,
              feature_upsample=False, image_size=SIZE, positive_threshold=0.5,
              negative_threshold=0.5, NMS_cls_threshold=0.3, NMS_iou_threshold=0.5,
              lr=2e-3, lr_backbone=0.0, max_epochs=2, AP_term=1, batch_size=2,
              num_workers=1, max_gt_boxes=8, compute_dtype="float32", max_detections=64,
              template_buckets=(9,))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_loop")
    write_synthetic_fscd147(str(root / "fsc"), n_train=4, n_val=2, image_size=SIZE,
                            square=10, seed=0)
    return root


def _trainer(root, tag, **kw):
    cfg = preset("TMR_FSCD147", **{**FIELDS, "datapath": str(root / "fsc"),
                                   "logpath": str(root / tag), **kw})
    model = build_model(cfg, backbone=SamViT(pretrain_img_size=SIZE, **TINY), device="cpu")
    return loop.Trainer(cfg, device="cpu", model=model)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


# ------------------------------------------------------------------ fit
def test_metrics_csv_keys_match_the_jax_trainer(data):
    """One epoch of each trainer on the same fixture: the same columns in metrics.csv
    (train losses, epoch, train/sec, the phase times, the val metrics)."""
    jcfg = JConfig(**{**FIELDS, "datapath": str(data / "fsc"),
                      "logpath": str(data / "jax_keys"), "max_epochs": 1})
    jtr = j_loop.Trainer(jcfg)
    jtr.model = JMatchingNet(backbone=JSamViT(pretrain_img_size=SIZE, **TINY),
                             emb_dim=16, fusion=True, template_capacity=9)
    jtr.predictor = JPredictor(jcfg, model=jtr.model)
    jtr.fit()
    _trainer(data, "port_keys", max_epochs=1).fit()
    want = _rows(data / "jax_keys" / "metrics.csv")
    got = _rows(data / "port_keys" / "metrics.csv")
    assert len(got) == len(want) == 1
    assert sorted(got[0]) == sorted(want[0])
    assert {"train/loss", "train/skipped_nonfinite", "time/step", "val/AP",
            "val/MAE"} <= set(got[0])


def test_fit_checkpoints_and_resume_equal_an_uninterrupted_run(data):
    """3 epochs in one run against 2 epochs, then a resumed run to 3: the same
    parameters, moments and counts bit for bit, one metrics.csv row per epoch, the best
    versions as Lightning checkpoints and ``last.ckpt`` holding the train state."""
    whole = _trainer(data, "whole", max_epochs=3)
    whole.fit()
    part = _trainer(data, "part", max_epochs=2)
    part.fit()
    assert part.ckpt.meta["last_epoch"] == 1
    resumed = _trainer(data, "part", max_epochs=3, resume=True)
    resumed.fit()
    assert resumed.ckpt.meta["last_epoch"] == 2
    assert [r["epoch"] for r in _rows(data / "part" / "metrics.csv")] == ["0", "1", "2"]
    want, got = whole.state.state_dict(), resumed.state.state_dict()
    assert got["count"] == want["count"] == 6 and got["step"] == want["step"] == 6
    for name, p in want["model"].items():
        assert torch.equal(got["model"][name], p), name
    for i, s in want["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got["optimizer"]["state"][i][key], s[key]), (i, key)
    head = [n for n, lab in whole.state.labels.items() if lab == "head"]
    assert len(want["optimizer"]["state"]) == len(head)  # the frozen backbone has none
    ckdir = data / "whole" / "checkpoints"
    assert (ckdir / "best_model.ckpt").is_file() and (ckdir / "last.ckpt").is_file()
    best = checkpoint.best_checkpoint(str(data / "whole"))
    assert best == whole.ckpt.best_path()
    meta = json.loads((ckdir / "ckpt_meta.json").read_text())
    assert meta["last_epoch"] == 2 and meta["best_version"] >= 0


def test_fresh_guard_refuses_a_logpath_with_checkpoints(data):
    tr = _trainer(data, "guard", max_epochs=1)
    tr.fit()
    with pytest.raises(FileExistsError, match="resume"):
        _trainer(data, "guard", max_epochs=1)
    _trainer(data, "guard", max_epochs=1, resume=True)
    _trainer(data, "guard", max_epochs=1, eval=True)


def test_best_checkpoint_is_the_lightning_layout_eval_reads(data, tmp_path):
    """``save_epoch`` writes the model under the reference's ``model.*`` keys;
    ``convert.load_matching_net`` reads it back bit for bit, and ``Trainer.test()`` with
    no params loads it."""
    tr = _trainer(data, "best_layout", max_epochs=1)
    tr.fit()
    sd = tr.model.state_dict()
    loaded = convert.load_matching_net(tr.ckpt.best_path())
    assert sorted(loaded) == sorted(sd)
    for name, t in sd.items():
        assert torch.equal(loaded[name], t), name
    raw = torch.load(tr.ckpt.best_path(), weights_only=True)
    assert raw["epoch"] == 0 and raw["global_step"] == 2
    assert all(k.startswith("model.") for k in raw["state_dict"])
    assert convert.matching_net_state_dict(convert.lightning_state_dict(sd)).keys() == sd.keys()
    assert tr.test() == tr.test(params=sd)


def test_checkpoint_versions_monitor_and_meta(tmp_path):
    """New bests become versions 0, 1, ... (``best_model.ckpt``, then ``-v1``); MAE is
    monitored (minimized) under best_model_count; off-cadence epochs save only ``last``;
    a corrupt ``ckpt_meta.json`` restarts from the defaults."""
    torch.manual_seed(0)
    model = torch.nn.Module()
    model.backbone = torch.nn.Linear(2, 2)
    model.head = torch.nn.Linear(2, 1)
    cfg = preset("TMR_FSCD147", lr_backbone=0.0)
    ts = state.TrainState(model, cfg, steps_per_epoch=1)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "c"), monitor="val/MAE", mode="min",
                                       every_n_epochs=2)
    assert not (tmp_path / "c").exists()  # nothing is written before the first save
    for epoch, mae in enumerate([5.0, 4.0, 4.5, 3.0, 2.0]):
        mgr.save_epoch(ts, epoch, {"val/MAE": mae, "val/AP": 1.0})
    # cadence: epoch 0 and every 2nd (1, 3): 5.0 -> v0, 4.0 -> v1, 3.0 -> v2; 2.0 is off
    assert mgr.meta == {"best_value": 3.0, "best_version": 2, "last_epoch": 4}
    names = sorted(os.listdir(tmp_path / "c"))
    assert names == ["best_model-v1.ckpt", "best_model-v2.ckpt", "best_model.ckpt",
                     "ckpt_meta.json", "last.ckpt"]
    assert checkpoint.best_checkpoint(str(tmp_path)) is None
    assert mgr.best_path() == str(tmp_path / "c" / "best_model-v2.ckpt")
    (tmp_path / "c" / "ckpt_meta.json").write_text("{not json")
    again = checkpoint.CheckpointManager(str(tmp_path / "c"))
    assert again.meta == {"best_value": None, "best_version": -1, "last_epoch": -1}
    assert again.last_path() == str(tmp_path / "c" / "last.ckpt")


def test_restore_returns_the_full_train_state(tmp_path):
    """``last.ckpt`` holds the parameters, the AdamW moments, the counts and the
    accumulation state: a restored state goes on exactly as the saved one."""
    def fresh():
        torch.manual_seed(1)
        m = torch.nn.Module()
        m.backbone = torch.nn.Linear(3, 2)
        m.head = torch.nn.Linear(2, 2)
        return m

    cfg = preset("TMR_FSCD147", lr_backbone=1e-3, grad_accum_steps=2)
    rng = np.random.default_rng(0)
    grads = [{n: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
              for n, p in fresh().named_parameters()} for _ in range(5)]
    a = state.TrainState(fresh(), cfg, steps_per_epoch=4)
    for g in grads[:3]:
        a.apply_gradients(g)
    assert a.mini_step == 1 and a.count == 1
    mgr = checkpoint.CheckpointManager(str(tmp_path))
    mgr.save_epoch(a, 0, {})
    b = mgr.restore(mgr.last_path(), state.TrainState(fresh(), cfg, steps_per_epoch=4))
    assert (b.count, b.step, b.mini_step) == (1, 3, 1)
    for g in grads[3:]:
        a.apply_gradients(g)
        b.apply_gradients(g)
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n


def test_fit_refuses_quantized_configs(data):
    tr = _trainer(data, "quant", max_epochs=1)
    tr.cfg = preset("TMR_FSCD147", **{**FIELDS, "quant": "int8"})
    with pytest.raises(ValueError, match="inference-only"):
        tr.fit()


def test_profile_dir_traces_the_first_epoch(data):
    tr = _trainer(data, "profiled", max_epochs=1, profile_dir=str(data / "prof"))
    tr.fit()
    assert "aten::" in (data / "prof" / "trace.json").read_text()


# ------------------------------------------------------------------ the CLI
def test_main_without_eval_trains_then_tests_its_best_checkpoint(data, monkeypatch,
                                                                 capsys):
    """``python -m tmr_tpu_torch.main`` without ``--eval`` (in process, the registry's
    encoder swapped for the TINY one): ``fit``, then ``test`` on the best ``.ckpt`` it
    wrote: the metrics a trainer of the same flags gets from that file. (``--eval`` reads
    the same file through ``Trainer.test``, ``tests/test_torch_eval.py``.)"""
    monkeypatch.setattr(port_models, "build_backbone", lambda cfg, device=None: SamViT(
        pretrain_img_size=SIZE, **TINY).to(device))
    args = ["--device", "cpu", "--dataset", "FSCD147", "--datapath", str(data / "fsc"),
            "--logpath", str(data / "cli"), "--backbone", "sam_vit_b", "--emb_dim", "16",
            "--fusion", "--image_size", str(SIZE), "--compute_dtype", "float32",
            "--batch_size", "2", "--num_workers", "1", "--max_epochs", "2", "--AP_term",
            "1", "--lr", "2e-3", "--lr_backbone", "0", "--lr_drop", "--nowandb",
            "--max_detections", "64", "--NMS_cls_threshold", "0.3"]
    trained = port_main.main(args)
    captured = capsys.readouterr()
    assert json.loads(captured.out.strip().splitlines()[-1]) == trained
    assert {"test/AP", "test/MAE", "test/loss"} <= set(trained)
    assert len(_rows(data / "cli" / "metrics.csv")) == 2
    best = checkpoint.best_checkpoint(str(data / "cli"))
    assert f"--eval: loading {best}" in captured.err
    cfg = port_main.to_config(port_main.config_parser(args + ["--resume"]))
    assert loop.Trainer(cfg, device="cpu").test() == trained


def test_scrub_training_config_forces_exact_weights():
    cfg = preset("TMR_FSCD147", quant="int8", quant_storage="int8", quant_kernel="int8")
    scrubbed, names = port_main.scrub_training_config(cfg)
    assert names == ["quant", "quant_storage", "quant_kernel"]
    assert (scrubbed.quant, scrubbed.quant_storage, scrubbed.quant_kernel) == (
        "off", "off", "dequant")
    assert port_main.scrub_training_config(scrubbed)[1] == []


# ------------------------------------------------------ loggers (ported)
def test_varying_keys_never_truncate(tmp_path):
    log = loop.CSVLogger(str(tmp_path))
    log.log({"epoch": 0, "train/loss": 1.0, "val/AP": 5.0})
    log.log({"epoch": 1, "train/loss": 0.9})  # no val keys this epoch
    log.log({"epoch": 2, "train/loss": 0.8, "val/AP": 7.0})
    rows = _rows(log.path)
    assert len(rows) == 3
    assert rows[0]["val/AP"] == "5.0"
    assert rows[1]["val/AP"] == ""  # missing keys blank, row preserved
    assert rows[2]["train/loss"] == "0.8"


def test_resume_appends_to_existing(tmp_path):
    log = loop.CSVLogger(str(tmp_path))
    log.log({"epoch": 0, "train/loss": 1.0})
    log2 = loop.CSVLogger(str(tmp_path))  # new process, same logpath
    log2.log({"epoch": 1, "train/loss": 0.5})
    assert [r["epoch"] for r in _rows(log2.path)] == ["0", "1"]


def test_wandb_sink_degrades_gracefully(monkeypatch, capsys):
    """Without the wandb package the sink warns and does nothing."""
    import builtins

    real_import = builtins.__import__

    def no_wandb(name, *args, **kwargs):
        if name == "wandb":
            raise ImportError("no wandb here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_wandb)
    logger = WandbLogger("proj", name="run", config={"a": 1})
    logger.log({"train/loss": 1.0, "epoch": 0}, step=0)
    logger.finish()
    assert not logger.enabled
    assert "not installed" in capsys.readouterr().err
