"""The PyTorch port stands alone: no JAX, flax, tmr_tpu or cv2 import anywhere in
``tmr_tpu_torch/`` or ``chip_smoke.py`` (PIL only inside the dataset readers' and the
map phase's decode steps), every module imports on a machine without a GPU, and the entry points refuse to
carry on on the CPU unless asked to."""

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
FORBIDDEN = ("jax", "flax", "tmr_tpu", "cv2")


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
    assert _forbidden("cv2") and not _forbidden("cv2x")


def test_scan_covers_the_eval_modules():
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    for mod in ("data/transforms.py", "data/datasets.py", "data/loader.py",
                "data/coco_index.py", "data/synthetic.py", "utils/metrics.py",
                "utils/coco_eval.py", "utils/convert.py", "utils/checkpoint.py",
                "train/targets.py", "train/criterion.py", "train/state.py",
                "train/loop.py", "main.py"):
        assert f"tmr_tpu_torch/{mod}" in names, mod


@pytest.mark.parametrize("mod", [
    "utils/profiling.py", "utils/atomicio.py", "utils/faults.py", "parallel/__init__.py",
    "parallel/journal.py", "parallel/mapreduce.py", "diagnostics.py",
    "data/native_io.py", "extract_feature.py"])
def test_scan_covers_the_map_phase_modules(mod):
    """The map phase's modules, including the copies of JAX-free JAX-package modules
    (faults, journal, atomicio): each is the port's own, scanned like the rest."""
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    assert f"tmr_tpu_torch/{mod}" in names
    roots = list(_imported_roots(PORT / mod))
    assert not [n for n in roots if _forbidden(n)]


@pytest.mark.parametrize("mod", ["models/sam_decoder.py", "refine.py", "sam.py",
                                 "sam_amg.py"])
def test_scan_covers_the_sam_modules(mod):
    """The refiner and the segment-anything surface: each the port's own module, with no
    import of JAX, ``tmr_tpu``, ``tests`` or cv2 (pycocotools only inside
    ``sam_amg.coco_encode_rle`` and the mask generator's ``coco_rle`` check)."""
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    assert f"tmr_tpu_torch/{mod}" in names
    roots = list(_imported_roots(PORT / mod))
    assert not [n for n in roots if _forbidden(n) or n.split(".")[0] == "tests"]


@pytest.mark.parametrize("mod", ["models/resnet.py", "models/__init__.py",
                                 "models/matching_net.py", "ops/xcorr.py",
                                 "ops/cuda_xcorr.py", "utils/weights.py"])
def test_scan_covers_the_resnet_and_prototype_modules(mod):
    """The ResNet backbones, prototype templates and the correlation's autograd
    Function: each the port's own module, with no import of JAX, ``tmr_tpu``, ``tests``
    or cv2."""
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    assert f"tmr_tpu_torch/{mod}" in names
    roots = list(_imported_roots(PORT / mod))
    assert not [n for n in roots if _forbidden(n) or n.split(".")[0] == "tests"]


@pytest.mark.parametrize("mod", ["utils/export.py", "export_encoder.py", "ops/probe.py",
                                 "ops/cuda_nms.py", "ops/cuda_int8.py", "ops/cuda_attn.py"])
def test_scan_covers_the_export_modules(mod):
    """The export module, its CLI and the modules that register the ``tmr::`` ops: each
    the port's own, with no import of JAX, ``tmr_tpu``, ``tests`` or cv2."""
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    assert f"tmr_tpu_torch/{mod}" in names
    roots = list(_imported_roots(PORT / mod))
    assert not [n for n in roots if _forbidden(n) or n.split(".")[0] == "tests"]


@pytest.mark.parametrize("mod", ["serve/gallery.py", "serve/gallery_index.py",
                                 "serve/fleet.py", "demo.py", "ops/nms.py", "inference.py"])
def test_scan_covers_the_gallery_and_demo_modules(mod):
    """The gallery tier, its sketch index, the wire helpers, the demo and the ops and
    programs they add: each the port's own module, with no import of JAX, ``tmr_tpu``,
    ``tests`` or cv2 (the demo draws cv2's rectangles in numpy)."""
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    assert f"tmr_tpu_torch/{mod}" in names
    roots = list(_imported_roots(PORT / mod))
    assert not [n for n in roots if _forbidden(n) or n.split(".")[0] == "tests"]


@pytest.mark.parametrize("mod", ["serve/streams.py", "serve/feature_tier.py",
                                 "serve/fleet.py", "serve/engine.py", "serve/gallery.py",
                                 "serve/__init__.py"])
def test_scan_covers_the_stream_and_feature_tier_modules(mod):
    """Stream sessions, the feature tier, the fleet pieces it imports and the engine's
    two hooks: each the port's own module, with no import of JAX, ``tmr_tpu``, ``tests``
    or cv2 (the wire stays the JAX protocol through the port's own copy of it)."""
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    assert f"tmr_tpu_torch/{mod}" in names
    roots = list(_imported_roots(PORT / mod))
    assert not [n for n in roots if _forbidden(n) or n.split(".")[0] == "tests"]


def test_demo_refuses_the_cpu_unless_asked(monkeypatch):
    from tmr_tpu_torch import demo
    from tmr_tpu_torch.config import Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.DemoEngine(Config(backbone="resnet50_layer1", emb_dim=16))


def test_sam_entry_points_refuse_the_cpu_unless_asked(monkeypatch):
    from tmr_tpu_torch.config import preset
    from tmr_tpu_torch.refine import build_refiner
    from tmr_tpu_torch.sam import Sam

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (lambda: build_refiner(preset("TMR_FSCD147", refine_box=True)),
                  lambda: Sam("vit_b")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
    assert next(build_refiner(preset("TMR_FSCD147"), device="cpu")
                .parameters()).device.type == "cpu"


def _pil_imports(node, where="<module>"):
    """The enclosing function's name (or ``<module>``) of each import of PIL under
    ``node``."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield from _pil_imports(child, child.name)
            continue
        names = ([a.name for a in child.names] if isinstance(child, ast.Import)
                 else [child.module or ""] if isinstance(child, ast.ImportFrom) else [])
        if any(n.split(".")[0] == "PIL" for n in names):
            yield where
        yield from _pil_imports(child, where)


def test_pil_is_imported_only_in_the_decode_step():
    """PIL may be missing where the port runs: only the decode steps import it, inside
    the function (the datasets' ``_Base.decode`` and the map phase's
    ``transforms.decode_image``), the refiner's PNG writer (``save_masks``) and
    ``--visualize``'s writers (``utils/visualize.py``: the caption, the PNG writer, the
    triptychs' default image reader), so every module imports without it."""
    where = [(str(p.relative_to(REPO)), fn) for p in _port_files()
             for fn in _pil_imports(ast.parse(p.read_text(), filename=str(p)))]
    assert sorted(where) == [("tmr_tpu_torch/data/datasets.py", "decode"),
                             ("tmr_tpu_torch/data/transforms.py", "decode_image"),
                             ("tmr_tpu_torch/refine.py", "save_masks"),
                             ("tmr_tpu_torch/utils/visualize.py", "_caption"),
                             ("tmr_tpu_torch/utils/visualize.py", "_write_png"),
                             ("tmr_tpu_torch/utils/visualize.py", "save_triptychs")]


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
        " 'triton', 'cv2', 'PIL')]\n"
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


def test_scan_covers_the_serve_and_obs_modules():
    """The serving layer and the telemetry it records into: each the port's own module
    (including the copies of the JAX package's JAX-free batcher, admission, degrade and
    obs modules), with no import of JAX, ``tmr_tpu``, ``tests`` or cv2."""
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    mods = [f"{pkg}/{m}.py" for pkg, ms in (
        ("serve", ("__init__", "admission", "batcher", "caches", "degrade", "engine",
                   "staging")),
        ("obs", ("__init__", "compile", "flight", "metrics", "tracing"))) for m in ms]
    for mod in mods:
        assert f"tmr_tpu_torch/{mod}" in names, mod
        roots = list(_imported_roots(PORT / mod))
        assert not [n for n in roots if _forbidden(n) or n.split(".")[0] == "tests"], mod


def test_serve_engine_runs_on_its_predictors_device():
    """The engine and its stager take the predictor's device: ``cuda`` for a predictor
    built without ``device="cpu"`` (no CPU in between), the CPU only for one built with
    it; a ``devices=`` list naming another device raises."""
    from tmr_tpu_torch.serve import ServeEngine

    class _Pred:
        weights_set = True

        def __init__(self, device):
            self.device = torch.device(device)

        def feature_stamp(self):
            return ("w", "b")

    for device in ("cuda", "cpu"):
        eng = ServeEngine(_Pred(device), batch=1)
        try:
            assert eng.device.type == device and eng._stager.device.type == device
            assert eng.stats()["devices"] == [device]
        finally:
            eng.close(timeout=10)
    with pytest.raises(ValueError, match="predictor's device"):
        ServeEngine(_Pred("cuda"), devices=["cpu"])


@pytest.mark.parametrize("mod", ["parallel/leases.py", "parallel/elastic.py",
                                 "elastic_map.py", "chaos_probe.py", "utils/package.py"])
def test_scan_covers_the_elastic_map_modules(mod):
    """The elastic map phase, its CLI, its gauntlet and the worker payload: each the
    port's own module (the lease service and most of the coordinator are copies of
    JAX-free JAX-package modules), with no import of JAX, ``tmr_tpu``, ``tests``, cv2 or
    PIL, and none of torch at module level in the lease service and the coordinator's
    module, so that a coordinator runs without a CUDA stack."""
    names = {str(p.relative_to(REPO)) for p in _port_files()}
    assert f"tmr_tpu_torch/{mod}" in names
    roots = list(_imported_roots(PORT / mod))
    assert not [n for n in roots
                if _forbidden(n) or n.split(".")[0] in ("tests", "PIL")], mod
    if mod in ("parallel/leases.py", "parallel/elastic.py"):
        tree = ast.parse((PORT / mod).read_text())
        top = [n for node in tree.body if isinstance(node, (ast.Import, ast.ImportFrom))
               for n in ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""])]
        assert not [n for n in top if n.split(".")[0] == "torch"], top
