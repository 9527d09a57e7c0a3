"""The PyTorch port stands alone: no JAX, flax or tmr_tpu import anywhere in
``tmr_tpu_torch/`` or ``chip_smoke.py``, every module imports on a machine without a
GPU, and the entry points refuse to carry on on the CPU unless asked to."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tmr_tpu_torch"
FORBIDDEN = ("jax", "flax", "tmr_tpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_ast_scan_finds_no_jax_or_tmr_tpu_import():
    files = _port_files()
    assert len(files) >= 20
    bad = [(str(p.relative_to(REPO)), name) for p in files
           for name in _imported_roots(p) if _forbidden(name)]
    assert bad == []


def test_forbidden_rule_is_exact():
    # tmr_tpu_torch is the port itself and must not trip the tmr_tpu rule
    assert not _forbidden("tmr_tpu_torch.ops")
    assert _forbidden("tmr_tpu") and _forbidden("tmr_tpu.ops.xcorr")
    assert _forbidden("jax.numpy") and _forbidden("flax.linen")


def test_every_port_module_imports_without_jax():
    mods = sorted(
        "tmr_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT.rglob("*.py") if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'tmr_tpu',"
        " 'triton')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_predictor_refuses_the_cpu_unless_asked(monkeypatch):
    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.inference import Predictor, resolve_device
    from tmr_tpu_torch.models import build_backbone, build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = preset("TMR_FSCD147")
    for entry in (lambda: resolve_device(None), lambda: Predictor(cfg),
                  lambda: build_model(cfg), lambda: build_backbone(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("fields", [dict(quant="int8"),
                                    dict(quant="int8", quant_kernel="int8"),
                                    dict(quant="int8", quant_storage="int8",
                                         quant_kernel="int8")])
def test_quant_predictor_refuses_the_cpu_unless_asked(monkeypatch, fields):
    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.inference import Predictor
    from tmr_tpu_torch.models import build_model
    from tmr_tpu_torch.models.vit import SamViT

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = preset("TMR_FSCD147", emb_dim=16, compute_dtype="float32", **fields)
    for entry in (lambda: Predictor(cfg), lambda: build_model(cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    model = build_model(cfg, device="cpu", backbone=SamViT(
        pretrain_img_size=32, embed_dim=32, depth=2, num_heads=2,
        global_attn_indexes=(1,), patch_size=8, window_size=3, out_chans=16))
    pred = Predictor(cfg, device="cpu", model=model)
    pred.init_params(0)
    assert pred.model.quant == "int8"
    assert pred.model.stored == (cfg.quant_storage == "int8")


def test_build_model_builds_on_the_cpu_when_asked():
    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.models import build_model
    from tmr_tpu_torch.models.vit import SamViT

    cfg = preset("TMR_FSCD147", emb_dim=16, compute_dtype="float32")
    model = build_model(cfg, device="cpu", backbone=SamViT(
        pretrain_img_size=32, embed_dim=32, depth=2, num_heads=2,
        global_attn_indexes=(1,), patch_size=8, window_size=3, out_chans=16))
    assert {p.device.type for p in model.parameters()} == {"cpu"}


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_a_card_or_the_port(tmp_path, alone):
    script = REPO / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
