"""The port's export (``tmr_tpu_torch/utils/export.py``, ``python -m
tmr_tpu_torch.export_encoder``): every kernel wrapper a registered ``tmr::`` op, and the
encoder, detector and SAM-decoder artifacts against the JAX package's functions and the
port's own eager programs, on the CPU.

Inputs are made from a seed with numpy; the JAX weights come across through
``params_from_jax``. Tolerances: the encoder artifact against the JAX ``SamViT.apply``
1e-4 (f32 through the whole encoder, sums in another order: the tier of
``test_torch_vit.py``); detections against the JAX ``Predictor`` equal valid masks, boxes
and scores within 1e-5 (the tier of ``test_torch_predictor.py``); the SAM decoder against
the JAX ``SamDeployDecoder`` 1e-4 x max (the tier of ``test_torch_sam.py``). Against the
port's eager programs every artifact is held bit for bit: it runs the same ATen ops and
the same ``tmr::`` ops on the same values."""

import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tmr_tpu.config import Config as JConfig  # noqa: E402
from tmr_tpu.inference import Predictor as JPredictor  # noqa: E402
from tmr_tpu.models.matching_net import MatchingNet as JMatchingNet  # noqa: E402
from tmr_tpu.models.vit import SamViT as JSamViT  # noqa: E402
from test_torch_mapreduce import _make_tar, _png  # noqa: E402
from tmr_tpu_torch.config import Config, preset  # noqa: E402
from tmr_tpu_torch.inference import Predictor, detections_to_numpy  # noqa: E402
from tmr_tpu_torch.models import build_model  # noqa: E402
from tmr_tpu_torch.models.vit import SamViT  # noqa: E402
from tmr_tpu_torch.ops import cuda_attn, cuda_int8, cuda_nms, cuda_xcorr, probe  # noqa: E402
from tmr_tpu_torch.parallel import mapreduce as mr  # noqa: E402
from tmr_tpu_torch.utils import export as ex  # noqa: E402
from tmr_tpu_torch.utils.weights import params_from_jax  # noqa: E402

#: the TINY encoder of ``tests/test_export_extract.py``
TINY = dict(embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,), window_size=2,
            out_chans=16, pretrain_img_size=64)
SIZE = 64
DET_SIZE = 32
#: the detector configs of ``tests/test_export_extract.py`` (both packages' Config)
DET_CFG = dict(backbone="sam_vit_b", emb_dim=16, fusion=True, feature_upsample=False,
               image_size=DET_SIZE, NMS_cls_threshold=0.3, NMS_iou_threshold=0.5,
               max_detections=16, template_buckets=(5,), compute_dtype="float32",
               positive_threshold=0.5, negative_threshold=0.5)
DETS = ("boxes", "scores", "valid")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _randomize(params, rng, objectness=None):
    """The flax init zeroes the rel-pos tables and the position embedding, and leaves a
    near-flat objectness map: give them values, so every path does real work."""
    def walk(node):
        for name, val in node.items():
            if isinstance(val, dict):
                walk(val)
            elif name in ("rel_pos_h", "rel_pos_w", "pos_embed"):
                node[name] = (rng.standard_normal(np.shape(val)) * 0.3).astype(np.float32)
    walk(params)
    if objectness is not None:
        params["objectness_head_0"]["conv"]["kernel"] *= objectness
    return params


@pytest.fixture(scope="module")
def encoders():
    """(the JAX TINY SamViT, its params, the port's with the same weights, eval)."""
    jmodel = JSamViT(**TINY)
    params = _randomize(_np_tree(jmodel.init(jax.random.key(0), jnp.zeros(
        (1, SIZE, SIZE, 3), jnp.float32))["params"]), np.random.default_rng(0))
    model = SamViT(**TINY)
    model.load_state_dict(params_from_jax(params))
    return jmodel, params, model.eval()


@pytest.fixture(scope="module")
def encoder_artifact(encoders, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("enc") / "enc.pt2")
    ex.save_exported(ex.export_encoder(encoders[2], image_size=SIZE), path)
    return path


def _eager_features(model, x):
    with torch.inference_mode():
        return model(x).float().permute(0, 2, 3, 1).contiguous()


def _targets(path):
    program = ex.load_program(path, "cpu")
    return {str(n.target) for n in program.graph.nodes if n.op == "call_function"}


def _assert_kernel_graph(path, want_ops):
    """The program calls the ``tmr::`` ops by name, and no library call stands in for a
    kernel: no SDPA, no grouped convolution in place of the correlation."""
    program = ex.load_program(path, "cpu")
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert {t for t in targets if t.startswith("tmr.")} == {f"tmr.{o}.default"
                                                          for o in want_ops}
    assert not [t for t in targets if "scaled_dot_product" in t]
    for n in program.graph.nodes:
        if n.op == "call_function" and "conv" in str(n.target):
            groups = n.args[6] if str(n.target) == "aten.conv2d.default" and len(
                n.args) > 6 else n.kwargs.get("groups", 1)
            assert groups == 1, n.format_node()


# ------------------------------------------------------------------ the encoder
def test_encoder_artifact_matches_jax_apply(encoders, encoder_artifact):
    jmodel, params, _ = encoders
    x = np.random.default_rng(1).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    got = ex.load_exported(encoder_artifact, "cpu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_encoder_artifact_equals_eager_at_every_batch(encoders, encoder_artifact):
    """One artifact, a symbolic batch: 1, 2 and 3 images, each bit for bit the eager
    encoder's features; the input spec reads ``("b", S, S, 3)`` float32."""
    model = encoders[2]
    assert ex.exported_input_spec(encoder_artifact) == (("b", SIZE, SIZE, 3),
                                                        torch.float32)
    call = ex.load_exported(encoder_artifact, "cpu")
    rng = np.random.default_rng(2)
    for b in (1, 2, 3):
        x = torch.from_numpy(rng.standard_normal((b, SIZE, SIZE, 3)).astype(np.float32))
        got = call(x)
        assert got.shape == (b, SIZE // 16, SIZE // 16, TINY["out_chans"])
        assert torch.equal(got, _eager_features(model, x)), b
    _assert_kernel_graph(encoder_artifact, ("global_attn", "window_attn"))


def test_encode_stats_from_artifact_equals_the_model(encoders, encoder_artifact):
    images = np.random.default_rng(3).integers(0, 256, (3, SIZE, SIZE, 3), np.uint8)
    got = mr.make_encode_stats_fn_from_artifact(encoder_artifact, "cpu")(images)
    want = mr.make_encode_stats_fn(encoders[2])(images)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_loading_refuses_the_cpu_unless_asked(encoder_artifact, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load in (lambda: ex.load_exported(encoder_artifact),
                 lambda: ex.load_exported(encoder_artifact, "cuda"),
                 lambda: mr.make_encode_stats_fn_from_artifact(encoder_artifact)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load()


def test_map_cli_with_artifact_equals_the_model_run(encoders, encoder_artifact, tmp_path,
                                                    monkeypatch, capsys):
    """``map --artifact`` builds no model and reads no checkpoint: its records and
    feature files equal the run with the model, byte for byte."""
    import tmr_tpu_torch.models

    rng = np.random.default_rng(4)
    shards = [_make_tar(tmp_path / f"{cat}_0.tar",
                        [(f"i{i}.png", _png(rng, 40 + i, 48)) for i in range(n)])
              for cat, n in (("Easy", 3), ("Hard", 2))]
    runs = {}
    for tag, extra in (("model", []), ("artifact", ["--artifact", encoder_artifact])):
        built = []
        monkeypatch.setattr(tmr_tpu_torch.models, "build_sam_encoder",
                            lambda *a, **k: built.append(a) or encoders[2])
        monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(shards) + "\n"))
        assert mr.main(["map", "--batch_size", "2", "--image_size", str(SIZE),
                        "--features_out", str(tmp_path / tag), "--device", "cpu",
                        *extra]) == 0
        runs[tag] = capsys.readouterr().out
        assert bool(built) == (tag == "model")
    assert runs["artifact"] == runs["model"] and runs["model"].count("\n") == 2
    files = {tag: sorted(p.relative_to(tmp_path / tag) for p in (tmp_path / tag).rglob(
        "*.npy")) for tag in runs}
    assert files["artifact"] == files["model"] and len(files["model"]) == 5
    for rel in files["model"]:
        assert (tmp_path / "model" / rel).read_bytes() == (
            tmp_path / "artifact" / rel).read_bytes()


def test_extract_feature_with_artifact_equals_the_model_run(encoders, encoder_artifact,
                                                            tmp_path, capsys):
    from tmr_tpu_torch import extract_feature as ext

    img = tmp_path / "img.png"
    img.write_bytes(_png(np.random.default_rng(5), 48, 80))
    want = ext.run_extraction_and_analyze(str(img), str(tmp_path / "model"),
                                          model=encoders[2], image_size=SIZE)
    got = ext.main([str(img), "--output_dir", str(tmp_path / "artifact"), "--artifact",
                    encoder_artifact, "--device", "cpu", "--image_size", str(SIZE)])
    assert "artifact" in capsys.readouterr().out
    assert np.array_equal(np.load(got["save_path"]), np.load(want["save_path"]))
    assert {k: got[k] for k in ("mean", "std", "max", "sparsity")} == {
        k: want[k] for k in ("mean", "std", "max", "sparsity")}


# ----------------------------------------------------------------- the detector
def _detector_pair(seed, port_cfg=None, **cfg_kw):
    """The JAX Predictor on the TINY detector of ``tests/test_export_extract.py`` and the
    port's with the same weights (and the port's own ``port_cfg`` fields besides)."""
    jmodel = JMatchingNet(backbone=JSamViT(**TINY), emb_dim=16, fusion=True,
                          template_capacity=5)
    jpred = JPredictor(JConfig(**DET_CFG, **cfg_kw), model=jmodel)
    image = jnp.zeros((1, DET_SIZE, DET_SIZE, 3), jnp.float32)
    exemplar = jnp.asarray([[[0.3, 0.3, 0.55, 0.6]]], jnp.float32)
    jpred.params = _randomize(_np_tree(jax.jit(jmodel.init)(jax.random.key(seed), image,
                                                           exemplar)["params"]),
                              np.random.default_rng(seed), objectness=30.0)
    cfg = Config(**DET_CFG, **cfg_kw, **(port_cfg or {}))
    pred = Predictor(cfg, device="cpu",
                     model=build_model(cfg, backbone=SamViT(**TINY), device="cpu"))
    pred.load_jax_params(jpred.params)
    return jpred, pred


@pytest.fixture(scope="module")
def detectors():
    return _detector_pair(0, num_exemplars=3)


def _images(seed, b):
    return np.random.default_rng(seed).standard_normal((b, DET_SIZE, DET_SIZE, 3)).astype(
        np.float32)


def _export_load(tmp_path, name, predictor, **kw):
    path = str(tmp_path / f"{name}.pt2")
    ex.save_exported(ex.export_detector(predictor, 5, image_size=DET_SIZE, **kw), path)
    return path, ex.load_exported_detector(path, "cpu")


def _assert_jax_dets(got, want):
    """Equal valid masks; boxes and scores within 1e-5."""
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want["valid"]))
    for g, name in zip(got[:2], ("boxes", "scores")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), rtol=0, atol=1e-5)


def test_single_detector_artifact_matches_jax_and_eager(detectors, tmp_path):
    jpred, pred = detectors
    path, call = _export_load(tmp_path, "single", pred, batch=2)
    image = _images(6, 2)
    ex_rows = np.array([[[0.3, 0.3, 0.55, 0.6]], [[0.1, 0.15, 0.4, 0.35]]], np.float32)
    got = call(torch.from_numpy(image), torch.from_numpy(ex_rows))
    assert got[2].dtype == torch.bool and int(got[2].sum()) > 0
    want = jpred._get_fn(5)(jpred.params, jpred.refiner_params, jnp.asarray(image),
                            jnp.asarray(ex_rows))
    _assert_jax_dets(got, want)
    eager = pred(image, ex_rows)
    for g, name in zip(got, DETS):
        assert torch.equal(g, eager[name]), name
    _assert_kernel_graph(path, ("global_attn", "window_attn", "xcorr", "nms"))


def test_multi_detector_artifact_matches_jax_and_eager(detectors, tmp_path):
    """``n_exemplars`` 2 at k_real 2 against the JAX and the port's
    ``predict_multi_exemplar`` (the bucket live inference picks for 2 rows); ``n_exemplars``
    3 at k_real 3 against ``predict_multi_exemplar`` and at k_real 2 (a padded row masked)
    against ``predict_multi_batch`` at the same bucket, slot for slot, and against
    ``predict_multi_exemplar``'s per-image lists."""
    jpred, pred = detectors
    image = _images(7, 1)
    rows = np.array([[0.3, 0.3, 0.55, 0.6], [0.1, 0.15, 0.4, 0.35],
                     [0.6, 0.5, 0.8, 0.75]], np.float32)
    path, call = _export_load(tmp_path, "multi2", pred, n_exemplars=2)
    got = call(torch.from_numpy(image), torch.from_numpy(rows[:2]),
               torch.tensor(2, dtype=torch.int32))
    assert int(got[2].sum()) > 0
    _assert_jax_dets(got, jpred.predict_multi_exemplar(jnp.asarray(image), rows[:2]))
    eager = pred.predict_multi_exemplar(image, rows[:2])
    for g, name in zip(got, DETS):
        assert torch.equal(g, eager[name]), name
    _assert_kernel_graph(path, ("global_attn", "window_attn", "xcorr", "nms"))

    _, call = _export_load(tmp_path, "multi3", pred, n_exemplars=3)
    for k in (3, 2):
        padded = np.concatenate([rows[:k], np.repeat(rows[k - 1:k], 3 - k, 0)])
        got = call(torch.from_numpy(image), torch.from_numpy(padded),
                   torch.tensor(k, dtype=torch.int32))
        live = pred.predict_multi_exemplar(image, padded, k_real=k)
        slot = live if k == 3 else pred.predict_multi_batch(image, padded[None], [k])
        for g, name in zip(got, DETS):
            assert torch.equal(g, slot[name]), (k, name)
        lists = detections_to_numpy({"boxes": got[0], "scores": got[1], "valid": got[2],
                                     "refs": slot["refs"]})
        for a, b in zip(lists, detections_to_numpy(live)):
            for name in ("boxes", "scores", "refs"):
                np.testing.assert_array_equal(a[name], b[name])


@pytest.mark.parametrize("fields", [dict(quant="int8", quant_storage="int8",
                                         quant_kernel="int8"),
                                    dict(decode_tail="device")],
                         ids=["int8", "device_tail"])
def test_detector_artifact_of_each_config_equals_eager(tmp_path, fields):
    """A TINY int8 detector (stored int8 weights, the int8 correlation and tail kernels)
    and the device tail export too, each bit for bit its eager call."""
    _, pred = _detector_pair(1, fields)
    path, call = _export_load(tmp_path, "det", pred, batch=2)
    image = _images(8, 2)
    ex_rows = np.array([[[0.3, 0.3, 0.55, 0.6]], [[0.5, 0.5, 0.7, 0.7]]], np.float32)
    got = call(torch.from_numpy(image), torch.from_numpy(ex_rows))
    eager = pred(image, ex_rows)
    assert int(eager["valid"].sum()) > 0
    for g, name in zip(got, DETS):
        assert torch.equal(g, eager[name]), name
    ops = (("global_attn", "window_attn", "xcorr_int8", "int8_mm", "int8_conv3x3", "nms")
           if "quant" in fields else ("global_attn", "window_attn", "xcorr", "nms"))
    _assert_kernel_graph(path, ops)


def test_refined_detector_export_raises_by_name():
    from tmr_tpu_torch.refine import build_refiner

    cfg = preset("TMR_FSCD147", emb_dim=16, compute_dtype="float32", image_size=DET_SIZE,
                 refine_box=True)
    pred = Predictor(cfg, device="cpu", model=build_model(
        cfg, backbone=SamViT(**TINY), device="cpu"), refiner=build_refiner(cfg, device="cpu"))
    with pytest.raises(NotImplementedError, match="refine_box.*torch.nonzero.*ROADMAP A7"):
        ex.export_detector(pred, 5, image_size=DET_SIZE)


# ---------------------------------------------------------------- the SAM decoder
def test_sam_decoder_artifact_matches_jax_and_eager(tmp_path):
    """The case of ``tests/test_sam_amg.py``'s round trip: a tiny decoder at 4 x 4
    embeddings, two points per prompt, a 24 x 30 original; one artifact, a symbolic
    prompt count (1, 3 and 5 prompts)."""
    from tmr_tpu.models.sam_decoder import MaskDecoder as JMaskDecoder
    from tmr_tpu.models.sam_decoder import PromptEncoder as JPromptEncoder
    from tmr_tpu.sam import Sam as JSam
    from tmr_tpu.sam import SamDeployDecoder as JDeploy
    from tmr_tpu_torch.models.sam_decoder import MaskDecoder, PromptEncoder
    from tmr_tpu_torch.sam import Sam, SamDeployDecoder

    enc = dict(embed_dim=32, depth=2, num_heads=2, global_attn_indexes=(1,), patch_size=8,
               window_size=3, out_chans=8, pretrain_img_size=32)
    jsam = JSam(model_type="vit_b")
    jsam.image_encoder = JSamViT(**enc)
    jsam.image_size = 32
    jsam.prompt_encoder = JPromptEncoder(embed_dim=8)
    jsam.mask_decoder = JMaskDecoder(transformer_dim=8, transformer_num_heads=2,
                                     transformer_mlp_dim=16)
    jsam.init_random(seed=0)
    sam = Sam("vit_b", image_size=32, device="cpu", image_encoder=SamViT(**enc),
              prompt_encoder=PromptEncoder(8),
              mask_decoder=MaskDecoder(8, transformer_num_heads=2, transformer_mlp_dim=16))
    sam.load_jax_params(_np_tree(jsam.params))
    jdeploy = JDeploy(jsam, return_single_mask=True)
    jdecode = jax.jit(lambda p, *a: jdeploy(p, *a, (24, 30)))
    deploy = SamDeployDecoder(sam, return_single_mask=True)
    path = str(tmp_path / "decoder.pt2")
    ex.save_exported(ex.export_sam_decoder(deploy, (4, 4), num_points=2,
                                           orig_im_size=(24, 30)), path)
    call = ex.load_exported_decoder(path, "cpu")
    rng = np.random.default_rng(9)
    emb = rng.standard_normal((1, 4, 4, 8)).astype(np.float32)
    for n in (1, 3, 5):
        pts = rng.uniform(0, 32, (n, 2, 2)).astype(np.float32)
        labs = np.concatenate([np.ones((n, 1), np.int32), -np.ones((n, 1), np.int32)], 1)
        mask_in = rng.standard_normal((n, 16, 16, 1)).astype(np.float32)
        has = (np.arange(n) % 2).astype(np.float32)
        args = (emb, pts, labs, mask_in, has)
        got = call(*(torch.from_numpy(a) for a in args))
        eager = deploy(*(torch.from_numpy(a) for a in args), (24, 30))
        want = jdecode(jsam.params, *(jnp.asarray(a) for a in args))
        assert len(got) == len(eager) == len(want) == 3
        for g, e, w in zip(got, eager, want):
            assert torch.equal(g, e)
            w = np.asarray(w)
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-4 * max(float(np.abs(w).max()), 1.0))
    assert not [t for t in _targets(path) if "scaled_dot_product" in t]


# ---------------------------------------------------------------------- the ops
def _op_samples():
    """One CPU sample per ``tmr::`` op, at a small shape its kernel takes."""
    rng = np.random.default_rng(10)

    def f32(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def i8(*shape):
        return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))

    q, k, v = f32(4, 35, 64), f32(4, 35, 64), f32(4, 35, 64)
    boxes = torch.sort(f32(2, 20, 4).abs(), dim=-1).values
    boxes = torch.cat([boxes[..., :2], boxes[..., :2] + boxes[..., 2:]], dim=-1)
    return {
        "global_attn": (q, k, v, f32(9, 64), f32(13, 64), 5, 7, 0.125),
        "window_attn": (f32(4, 49, 64), f32(4, 49, 64), f32(4, 49, 64), f32(7, 7, 64),
                        f32(7, 7, 64), 7, 7, 0.125),
        "xcorr": (f32(2, 3, 12, 10), f32(2, 3, 5, 5)),
        "xcorr_int8": (i8(2, 3, 12, 10), i8(2, 3, 5, 5), f32(2, 3, 1, 1).abs(),
                       f32(2, 3, 1, 1).abs()),
        "nms": (boxes, torch.from_numpy(rng.random((2, 20)) < 0.8), 0.5),
        "int8_mm": (i8(6, 32), i8(5, 32), f32(6).abs(), f32(5).abs()),
        "int8_conv3x3": (i8(1, 5, 4, 16), f32(1).abs(), i8(3, 3, 6, 16),
                         f32(3, 3, 6).abs(), f32(6), 0.01),
        "add1": (f32(8, 8),),
    }


@pytest.mark.parametrize("op", sorted(_op_samples()))
def test_each_op_passes_opcheck(op):
    """The registration, the fake implementation and the CPU kernel agree
    (``torch.library.opcheck``: schema, autograd registration, fake tensors, traced
    dispatch with a symbolic shape)."""
    torch.library.opcheck(getattr(torch.ops.tmr, op).default, _op_samples()[op])


def test_each_wrapper_calls_its_op():
    """The wrappers route through the ops on the CPU: the eager path and an exported
    program call one op."""
    from torch.utils._python_dispatch import TorchDispatchMode

    s = _op_samples()
    calls = [
        lambda: cuda_attn.global_attention(*s["global_attn"][:5], (5, 7), 0.125),
        lambda: cuda_attn.window_attention(*s["window_attn"][:5], (7, 7), 0.125),
        lambda: cuda_xcorr.xcorr(*s["xcorr"]),
        lambda: cuda_xcorr.xcorr_int8(*s["xcorr_int8"]),
        lambda: cuda_nms.greedy_keep_sorted(*s["nms"]),
        lambda: cuda_int8.int8_mm(*s["int8_mm"]),
        lambda: cuda_int8.int8_conv3x3(*s["int8_conv3x3"]),
        lambda: probe.add1(*s["add1"]),
    ]

    class Seen(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "tmr":
                self.ops.append(func.__name__.split(".")[0])
            return func(*args, **(kwargs or {}))

    with Seen() as seen:
        for call in calls:
            call()
    assert seen.ops == ["global_attn", "window_attn", "xcorr", "xcorr_int8", "nms",
                        "int8_mm", "int8_conv3x3", "add1"]


# ------------------------------------------------------------------------ the CLI
def test_export_encoder_cli(encoders, tmp_path, monkeypatch, capsys):
    """``--device cpu`` writes an artifact that loads and equals the encoder; without a
    GPU the CLI refuses unless ``--device cpu`` is given."""
    import tmr_tpu_torch.models
    from tmr_tpu_torch import export_encoder

    monkeypatch.setattr(tmr_tpu_torch.models, "build_sam_encoder",
                        lambda *a, device=None, **k: tmr_tpu_torch.models.resolve_device(
                            device) and encoders[2])
    out = str(tmp_path / "enc.pt2")
    assert export_encoder.main(["--device", "cpu", "--image_size", str(SIZE), "--output",
                                out]) == out
    assert "wrote" in capsys.readouterr().out and os.path.getsize(out) > 0
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, SIZE, SIZE, 3)).astype(np.float32))
    assert torch.equal(ex.load_exported(out, "cpu")(x), _eager_features(encoders[2], x))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--detector"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export_encoder.main(argv + ["--output", str(tmp_path / "x.pt2")])
    with pytest.raises(SystemExit):
        export_encoder.main(["--detector", "--checkpoint", "sam.pth"])
