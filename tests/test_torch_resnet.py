"""The ResNet-50 backbones of the port (``tmr_tpu_torch/models/resnet.py``) and what
carries them through the detector, on the CPU, against the JAX package on numpy inputs:
every variant's feature (DC5 and truncated geometry), full depth once, the weight bridge
and the torchvision / Lightning converters on state dicts written here, ``Config()``'s
default detector through ``Predictor`` against the JAX ``Predictor``, the train step's
groups and one step against ``make_train_step``, and ``--refine_box`` on a ResNet
feature as the JAX program runs it.

The JAX ResNet has no width option, so "small" is a shallow net (one block a stage,
``layers=(1, 1, 1, 1)``) at full width on 32-128 px images. Its weights are drawn here
with numpy on the shapes of ``jax.eval_shape`` of its init (no compile): kernels at
lecun scale, and batch norms with statistics away from 1/0 so that the frozen norm's
arithmetic is held. Tolerances (f32 both sides, sums in another order): features
2e-5 x max over one block a stage and 1e-4 x max over the 16 blocks of full depth; the
detector's maps 1e-4 x max, its detections the same slots with scores and boxes within
1e-5; gradients 1e-4 x each leaf's max; train-step parameters within 1e-2 x lr."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tmr_tpu.config import Config as JConfig  # noqa: E402
from tmr_tpu.inference import Predictor as JPredictor  # noqa: E402
from tmr_tpu.models.matching_net import MatchingNet as JMatchingNet  # noqa: E402
from tmr_tpu.models.resnet import ResNet50 as JResNet50  # noqa: E402
from tmr_tpu.models.resnet import build_resnet as j_build_resnet  # noqa: E402
from tmr_tpu.refine import SamRefineModule as JSamRefineModule  # noqa: E402
from tmr_tpu.train import state as j_state  # noqa: E402
from tmr_tpu.utils.convert import convert_matching_net, convert_resnet50  # noqa: E402
from tmr_tpu_torch.config import Config  # noqa: E402
from tmr_tpu_torch.inference import Predictor  # noqa: E402
from tmr_tpu_torch.models import build_backbone, build_model  # noqa: E402
from tmr_tpu_torch.models.resnet import (RESNET_VARIANTS, FrozenBatchNorm,  # noqa: E402
                                         ResNet50, build_resnet)
from tmr_tpu_torch.refine import build_refiner  # noqa: E402
from tmr_tpu_torch.train import state  # noqa: E402
from tmr_tpu_torch.utils import convert  # noqa: E402
from tmr_tpu_torch.utils.weights import init_params, params_from_jax  # noqa: E402

SHALLOW = (1, 1, 1, 1)
FEATURE_TOL = 2e-5
DEEP_TOL = 1e-4
MAP_TOL = 1e-4
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _draw(tree_shapes, seed: int):
    """numpy params on the shapes of a flax tree: conv kernels N(0, 1 / fan_in), batch
    norm weight U(0.5, 1.5), bias N(0, 0.1), mean N(0, 0.1), var U(0.5, 1.5); any other
    leaf N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("weight", "running_var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree_shapes)


def _port_shapes(tree_shapes) -> dict:
    """The port's state_dict shapes of a flax tree of ``ShapeDtypeStruct``s."""
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), tree_shapes)
    return {k: tuple(v.shape) for k, v in params_from_jax(zeros).items()}


def _jax_resnet_params(jnet, size: int, seed: int):
    img = jnp.zeros((1, size, size, 3), jnp.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), img)["params"]
    return _draw(shapes, seed)


def _compare_features(jnet, net, size, seed, tol, batch=2):
    params = _jax_resnet_params(jnet, size, seed)
    net.load_state_dict(params_from_jax(params), strict=True)
    img = np.random.default_rng(seed + 100).standard_normal(
        (batch, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jnet.apply)({"params": params}, img))
    with torch.no_grad():
        got = net(torch.from_numpy(img)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)
    return got


# ------------------------------------------------------------------ the module
@pytest.mark.parametrize("name", sorted(RESNET_VARIANTS))
def test_variant_feature_matches_jax(name):
    """Each variant, one block a stage at full width on a 64 px image (48 px without
    DC5 for the full net, an odd map at its end), against the JAX module."""
    dilation = name != "resnet50_layer2"  # truncations ignore it; one run each way
    jnet = j_build_resnet(name, dilation=dilation).clone(layers=SHALLOW)
    net = ResNet50(dilation=dilation, layers=SHALLOW, **RESNET_VARIANTS[name])
    assert (net.num_channels, net.feature_stride) == (jnet.num_channels,
                                                      jnet.feature_stride)
    _compare_features(jnet, net, 64, seed=len(name), tol=FEATURE_TOL)


def test_full_depth_resnet50_matches_jax():
    """The default backbone at full depth (3, 4, 6, 3), DC5, on a 32 px image."""
    jnet = j_build_resnet("resnet50")
    net = build_resnet("resnet50")
    assert sum(len(getattr(net, f"layer{s}")) for s in range(1, 5)) == 16
    _compare_features(jnet, net, 32, seed=7, tol=DEEP_TOL, batch=1)


@pytest.mark.parametrize("out_layer,dilation,size", [
    (1, True, 36), (2, True, 40), (3, True, 44), (4, True, 33), (4, False, 50)])
def test_truncated_and_dc5_geometry(out_layer, dilation, size):
    """Feature shape, channels and stride against the JAX module at sizes that are not
    multiples of the stride (the stem's and the max pool's padding), as ``eval_shape``
    gives them; DC5 keeps layer4's first block at dilation 1 and its later blocks at 2,
    each 3x3 padded by its dilation."""
    with torch.device("meta"):
        net = ResNet50(out_layer=out_layer, dilation=dilation)
        got = net(torch.zeros(1, size, size, 3)).shape
    jnet = JResNet50(out_layer=out_layer, dilation=dilation)
    img = jnp.zeros((1, size, size, 3), jnp.float32)
    shapes = jax.eval_shape(jnet.init, jax.random.key(0), img)
    want = jax.eval_shape(jnet.apply, shapes, img).shape
    assert (got[0], got[2], got[3], got[1]) == want
    assert (net.num_channels, net.feature_stride) == (jnet.num_channels,
                                                      jnet.feature_stride)
    assert _port_shapes(shapes["params"]) == {k: tuple(v.shape)
                                              for k, v in net.state_dict().items()}
    if out_layer == 4:
        convs = [blk.conv2 for blk in net.layer4]
        assert [c.dilation for c in convs] == ([(1, 1), (2, 2), (2, 2)] if dilation
                                               else [(1, 1)] * 3)
        assert all(c.padding == c.dilation for c in convs)
        assert convs[0].stride == ((1, 1) if dilation else (2, 2))


def test_frozen_batch_norm_is_the_jax_arithmetic():
    """``x * scale + (bias - mean * scale)``, scale = weight / sqrt(var + eps), on an
    NCHW map; its four leaves are parameters."""
    bn = FrozenBatchNorm(3)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p, v in zip(bn.parameters(), (rng.uniform(0.5, 1.5, 3), rng.normal(0, 1, 3),
                                          rng.normal(0, 1, 3), rng.uniform(0.5, 1.5, 3))):
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    x = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    w, b, m, v = (p.detach().numpy() for p in bn.parameters())
    scale = w / np.sqrt(v + 1e-5)
    want = x * scale[:, None, None] + (b - m * scale)[:, None, None]
    np.testing.assert_allclose(bn(torch.from_numpy(x)).detach().numpy(), want, rtol=1e-6,
                               atol=1e-6)
    assert [n for n, _ in bn.named_parameters()] == ["weight", "bias", "running_mean",
                                                     "running_var"]


def test_seeded_init_is_flax_like_and_finite():
    """``init_params`` seeds every conv (lecun scale) and sets the frozen norms to
    1/0/0/1, as flax inits them; the seeded full-depth feature is finite and of order
    one."""
    net = build_resnet("resnet50")
    init_params(net, 0)
    bns = [m for m in net.modules() if isinstance(m, FrozenBatchNorm)]
    assert len(bns) == 53
    for bn in bns:
        assert bool((bn.weight == 1).all() and (bn.bias == 0).all()
                    and (bn.running_mean == 0).all() and (bn.running_var == 1).all())
    std = net.layer4[0].conv2.weight.std().item()
    assert 0.85 < std * np.sqrt(512 * 9) < 1.15  # the port's lecun rule
    img = np.random.default_rng(0).normal(-1.0, 0.1, (1, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        f = net(torch.from_numpy(img))
    assert bool(torch.isfinite(f).all()) and 1e-2 <= f.std().item() <= 1e2


# --------------------------------------------------------------- the registry
def test_build_backbone_builds_every_variant():
    for name, kw in RESNET_VARIANTS.items():
        bb = build_backbone(Config(backbone=name, dilation=False), device="meta")
        assert isinstance(bb, ResNet50) and bb.out_layer == kw["out_layer"], name
        assert not bb.dilation
    with pytest.raises(ValueError, match="remat_backbone"):
        build_backbone(Config(remat_backbone=True), device="cpu")
    with pytest.raises(KeyError, match="unknown backbone"):
        build_backbone(Config(backbone="resnet101"), device="cpu")


def test_default_config_builds_the_jax_main_py_detector():
    """``Config()`` is resnet50 with DC5, 1024^2, emb_dim 512, no fusion, no upsample,
    roi_align, NMS 0.1 / 0.15: the port's model has the JAX model's parameter shapes
    (input_proj from 2048 channels, the heads at 512), and a 64^2 map at 1024."""
    cfg, jcfg = Config(), JConfig()
    for field in ("backbone", "dilation", "image_size", "emb_dim", "fusion",
                  "feature_upsample", "template_type", "NMS_cls_threshold",
                  "NMS_iou_threshold", "compute_dtype", "lr_backbone"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    model = build_model(cfg, device="meta")
    jpred = JPredictor(jcfg)
    img = jnp.zeros((1, 64, 64, 3), jnp.float32)
    ex = jnp.asarray([[[0.2, 0.2, 0.5, 0.5]]], jnp.float32)
    shapes = jax.eval_shape(jpred.model.init, jax.random.key(0), img, ex)["params"]
    assert _port_shapes(shapes) == {k: tuple(v.shape)
                                    for k, v in model.state_dict().items()}
    assert model.input_proj_0.weight.shape == (512, 2048, 1, 1)
    assert model.backbone.feature_stride == 16
    assert Predictor(cfg, device="meta", model=model).feature_hw(1024) == 64
    assert jpred.feature_hw(1024) == 64


@pytest.mark.parametrize("argv", [[], ["--backbone", "resnet50_layer2_FRZ"],
                                  ["--backbone", "resnet50_layer1", "--dilation", ""],
                                  ["--template_type", "prototype"]])
def test_main_flags_build_the_jax_main_py_model(argv):
    """``python -m tmr_tpu_torch.main`` without ``--backbone`` is ``main.py``'s default
    detector; the truncated and frozen variants, ``--dilation`` off (an empty value, as
    ``main.py`` reads it) and prototype templates give the config ``main.py`` gives and
    build (on the meta device: shapes only)."""
    import main as j_main

    from tmr_tpu_torch import main as port_main

    cfg = port_main.to_config(port_main.config_parser(argv))
    jcfg = j_main.to_config(j_main.config_parser(argv))
    for field in ("backbone", "dilation", "template_type", "lr_backbone", "emb_dim"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    model = build_model(cfg, device="meta")
    assert model.backbone.num_channels == JResNet50(
        out_layer=RESNET_VARIANTS[cfg.backbone]["out_layer"]).num_channels
    assert model.backbone.dilation == cfg.dilation
    assert model.matcher.template_type == cfg.template_type
    assert state.frozen_backbone(cfg) == cfg.backbone.endswith("_FRZ")


# ---------------------------------------------------------------- converters
def _torchvision_sd(net: ResNet50, seed: int, extras: bool = True) -> dict:
    """A torchvision-layout state dict of ``net``'s shapes with random values, plus the
    keys a torchvision checkpoint has that the port leaves out."""
    rng = np.random.default_rng(seed)
    sd = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape)).astype(np.float32))
          for k, v in net.state_dict().items()}
    if extras:
        sd["fc.weight"], sd["fc.bias"] = torch.zeros(1000, 2048), torch.zeros(1000)
        for k in [k for k in sd if k.endswith("running_var")]:
            sd[k] = sd[k].abs() + 0.5
            sd[k[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(7)
    return sd


@pytest.mark.parametrize("name", ["resnet50", "resnet50_layer2"])
def test_resnet50_state_dict_matches_convert_resnet50(name):
    """A full torchvision resnet50 state dict and a truncated one (layer1-2 only):
    ``resnet50_state_dict`` equals ``params_from_jax(convert_resnet50(...))`` key for key
    and bit for bit, and loads into the variant strictly."""
    net = build_resnet(name)
    with torch.no_grad():
        sd = _torchvision_sd(net, 3)
    assert convert.checkpoint_kind(sd) == "resnet50"
    got = convert.resnet50_state_dict(sd)
    want = params_from_jax(convert_resnet50({k: v.numpy() for k, v in sd.items()}))
    assert sorted(got) == sorted(want) == sorted(net.state_dict())
    assert all(torch.equal(got[k], want[k]) for k in want)
    net.load_state_dict(got, strict=True)


def test_resnet_lightning_checkpoint_loads_like_convert_matching_net(tmp_path):
    """A Lightning ``best_model.ckpt`` with a ResNet encoder (resnet50_layer3, as the
    reference's published FSCD-147 runs name it) through ``load_matching_net`` equals
    ``params_from_jax(convert_matching_net(..., backbone="resnet50"))``, loads into the
    port's model strictly and goes back to the same Lightning keys."""
    cfg = Config(backbone="resnet50_layer3", emb_dim=16)
    model = build_model(cfg, device="cpu")
    port_sd = _torchvision_sd(model, 5, extras=False)
    sd = convert.lightning_state_dict(port_sd)
    sd["model.encoder.backbone.backbone.bn1.num_batches_tracked"] = torch.tensor(1)
    path = tmp_path / "best_model.ckpt"
    torch.save({"state_dict": sd, "epoch": 3}, path)
    got = convert.load_matching_net(str(path))
    want = params_from_jax(convert_matching_net({k: v.numpy() for k, v in sd.items()},
                                                backbone="resnet50"))
    assert sorted(got) == sorted(want) == sorted(model.state_dict())
    assert all(torch.equal(got[k], want[k]) for k in want)
    model.load_state_dict(got, strict=True)
    relaid = convert.lightning_state_dict(model.state_dict())
    assert set(sd) - set(relaid) == {"model.encoder.backbone.backbone.bn1.num_batches_tracked"}
    assert all(torch.equal(relaid[k], sd[k]) for k in relaid)


def test_trainer_test_loads_a_resnet_lightning_checkpoint(tmp_path):
    """``Trainer.test()`` with no params reads a ResNet detector's ``best_model.ckpt``
    through ``load_matching_net``: the same metrics as the same weights passed in."""
    from tmr_tpu_torch.data.synthetic import write_synthetic_fscd147
    from tmr_tpu_torch.train.loop import Trainer

    write_synthetic_fscd147(str(tmp_path / "fsc"), n_train=1, n_val=2, image_size=64,
                            square=28, seed=0)
    kw = dict(dataset="FSCD147", datapath=str(tmp_path / "fsc"), eval=True, emb_dim=16,
              compute_dtype="float32", image_size=64, eval_batch_size=2, num_workers=1)

    def trainer(tag):
        cfg = Config(logpath=str(tmp_path / tag), **kw)
        return Trainer(cfg, device="cpu", model=build_model(
            cfg, backbone=ResNet50(layers=SHALLOW), device="cpu"))

    tr = trainer("direct")
    init_params(tr.model, 3)
    sd = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    direct = tr.test(params=sd)
    ckdir = tmp_path / "ckpt" / "checkpoints"
    ckdir.mkdir(parents=True)
    torch.save({"state_dict": convert.lightning_state_dict(sd)}, ckdir / "best_model.ckpt")
    assert trainer("ckpt").test() == direct
    assert np.isfinite(list(direct.values())).all()


# ------------------------------------------------------------ the whole slice
SIZE = 128
EXEMPLARS = np.array([[[0.2, 0.2, 0.4, 0.5]], [[0.5, 0.55, 0.7, 0.6]],
                      [[0.1, 0.6, 0.15, 0.7]]], np.float32)


def _default_pair(template_type="roi_align", **kw):
    """The JAX ``Predictor`` of ``Config()`` (f32, 128 px) with a ResNet50 of one block a
    stage at full width, on ``init_params(0)`` with the objectness head scaled up (flax's
    N(0, 0.01) leaves near-flat maps whose peaks hinge on last-ulp ties), and the port's
    Predictor on the same weights through ``params_from_jax``."""
    over = dict(compute_dtype="float32", image_size=SIZE, template_type=template_type,
                **kw)
    jcfg, cfg = JConfig(**over), Config(**over)
    jmodel = JMatchingNet(backbone=JResNet50(layers=SHALLOW), emb_dim=jcfg.emb_dim,
                          template_type=template_type,
                          template_capacity=max(jcfg.template_buckets))
    jpred = JPredictor(jcfg, model=jmodel)
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jpred.init_params(0))
    params["objectness_head_0"]["conv"]["kernel"] *= 300.0
    jpred.params = params
    pred = Predictor(cfg, device="cpu", model=build_model(
        cfg, backbone=ResNet50(layers=SHALLOW), device="cpu"))
    pred.load_jax_params(params)
    images = np.random.default_rng(1).standard_normal((3, SIZE, SIZE, 3)).astype(
        np.float32)
    return jpred, pred, images


@pytest.fixture(scope="module")
def default_pair():
    return _default_pair()


def test_default_detector_maps_match_jax(default_pair):
    jpred, pred, images = default_pair
    cap = jpred.pick_capacity(EXEMPLARS, SIZE)
    assert cap == pred.pick_capacity(EXEMPLARS, SIZE) == 9
    want = jpred.model.clone(template_capacity=cap).apply({"params": jpred.params},
                                                          images, EXEMPLARS)
    got = pred.forward(images, EXEMPLARS)
    for name in ("objectness", "regressions"):
        w = np.asarray(want[name][0])
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=MAP_TOL * np.abs(w).max())
    np.testing.assert_allclose(got["backbone_feature"].numpy(),
                               np.asarray(want["backbone_feature"]), rtol=0,
                               atol=MAP_TOL * np.abs(want["backbone_feature"]).max())


def test_default_detector_detections_match_jax(default_pair):
    """The same detections after NMS (0.15) from ``__call__``, and from the split
    programs on the ResNet's feature."""
    jpred, pred, images = default_pair
    want = jpred(images, EXEMPLARS)
    got = pred(images, EXEMPLARS)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["valid"].sum() > 0
    for name in ("scores", "boxes", "refs"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-5,
                                   atol=1e-5)
    feats = pred._get_backbone_fn()(images)
    assert feats.shape == (3, SIZE // 16, SIZE // 16, 2048)
    split = pred._get_heads_fn(pred.pick_capacity(EXEMPLARS, SIZE), SIZE)(feats, EXEMPLARS)
    for name in ("boxes", "scores", "refs", "valid"):
        assert torch.equal(split[name], got[name]), name


@pytest.mark.parametrize("name", ["resnet50_layer1", "resnet50"])
def test_refine_box_on_a_resnet_feature_does_what_jax_does(name):
    """``--refine_box`` hands the refiner the backbone's feature. The SAM mask decoder is
    256 wide: on resnet50_layer1's 256-channel feature both programs refine, to the
    same detections; on any other width the JAX program raises while it traces, and the
    port raises a ValueError that says why."""
    over = dict(compute_dtype="float32", image_size=64, refine_box=True, emb_dim=16,
                backbone=name, max_detections=16)
    jcfg, cfg = JConfig(**over), Config(**over)
    jnet = j_build_resnet(name).clone(layers=SHALLOW)
    jmodel = JMatchingNet(backbone=jnet, emb_dim=16, template_capacity=191)
    jref = JSamRefineModule()
    jpred = JPredictor(jcfg, model=jmodel, refiner=jref, refiner_params=jref.init_params(0))
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), jpred.init_params(0))
    params["objectness_head_0"]["conv"]["kernel"] *= 300.0
    jpred.params = params
    refiner = build_refiner(cfg, seed=0, device="cpu")
    refiner.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                   jpred.refiner_params)))
    pred = Predictor(cfg, device="cpu", refiner=refiner, model=build_model(
        cfg, backbone=ResNet50(layers=SHALLOW, **RESNET_VARIANTS[name]), device="cpu"))
    pred.load_jax_params(params)
    images = np.random.default_rng(2).standard_normal((1, 64, 64, 3)).astype(np.float32)
    ex = EXEMPLARS[:1]
    if name == "resnet50_layer1":
        want, got = jpred(images, ex), pred(images, ex)
        np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
        assert got["valid"].sum() > 0
        for field in ("scores", "boxes"):
            np.testing.assert_allclose(got[field].numpy(), np.asarray(want[field]),
                                       rtol=1e-4, atol=1e-4)
        return
    with pytest.raises(TypeError, match="incompatible shapes"):
        jpred(images, ex)
    with pytest.raises(ValueError, match="256"):
        pred(images, ex)


# ------------------------------------------------------------------ training
def test_param_labels_freeze_the_batch_norm_statistics():
    """The JAX ``param_labels`` on the same tree: running statistics ``"frozen"`` always,
    the rest of the backbone ``"backbone"`` (``"frozen"`` when the backbone is)."""
    model = build_model(Config(emb_dim=16), backbone=ResNet50(layers=SHALLOW),
                        device="cpu")
    jmodel = JMatchingNet(backbone=JResNet50(layers=SHALLOW), emb_dim=16)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1, 1, 4)))["params"]
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    # each leaf's index, through the weight bridge: the port's name of every JAX leaf
    index = params_from_jax(jax.tree_util.tree_unflatten(
        treedef, [np.full((1,) * len(s.shape), i, np.float32) for i, s in enumerate(leaves)]))
    for frozen in (False, True):
        labels = jax.tree_util.tree_leaves(j_state.param_labels(shapes, frozen))
        want = {name: labels[int(i.item())] for name, i in index.items()}
        got = state.param_labels(model, frozen)
        assert got == want
        assert {got[n] for n in got if n.endswith(("running_mean", "running_var"))} == {
            "frozen"}
    for name in ("resnet50_layer1_FRZ", "resnet50_layer3_FRZ"):
        assert state.frozen_backbone(Config(backbone=name))
    assert not state.frozen_backbone(Config())


def _train_batch(seed, size, b=2):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.05, 0.6, (b, 5, 2))
    gt = np.concatenate([xy, xy + rng.uniform(0.1, 0.3, (b, 5, 2))], -1).astype(np.float32)
    valid = np.ones((b, 5), bool)
    valid[:, 4] = False
    return {"image": rng.standard_normal((b, size, size, 3)).astype(np.float32),
            "exemplars": gt[:, :1].copy(), "gt_boxes": gt, "gt_valid": valid}


def train_step_pair(template_type: str, size: int = 64, seed: int = 4):
    """The JAX and port train steps of ``Config()`` at a TINY size (one block a stage at
    full width, emb_dim 16, f32, lr 1e-3, lr_backbone 1e-4: the backbone trains) on the
    same params; returns (jax step, jax state, port step, port state, model, cfg)."""
    kw = dict(emb_dim=16, compute_dtype="float32", image_size=size, lr=1e-3,
              lr_backbone=1e-4, max_epochs=10, template_type=template_type)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    jmodel = JMatchingNet(backbone=JResNet50(layers=SHALLOW), emb_dim=16,
                          template_type=template_type,
                          template_capacity=max(jcfg.template_buckets))
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, size, size, 3)), jnp.zeros((1, 1, 4)))["params"]
    params = _draw(shapes, seed)
    params["matcher"]["scale"] = np.ones(1, np.float32)
    tx = j_state.make_optimizer(jcfg, steps_per_epoch=2)
    jts = j_state.TrainState.create(apply_fn=jmodel.apply, params=params, tx=tx)
    jstep = jax.jit(j_state.make_train_step(jmodel, jcfg))
    model = build_model(cfg, backbone=ResNet50(layers=SHALLOW), device="cpu")
    model.load_state_dict(params_from_jax(params))
    ts = state.TrainState(model, cfg, steps_per_epoch=2)
    return jstep, jts, state.make_train_step(model, cfg), ts, model, cfg


def check_train_step(template_type: str, size: int = 64) -> None:
    """One step on both sides: the losses, then every parameter against the JAX step's
    (the running statistics unmoved on both)."""
    jstep, jts, step, ts, model, cfg = train_step_pair(template_type, size)
    stats0 = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.endswith(("running_mean", "running_var"))}
    conv0 = model.backbone.conv1.weight.detach().clone()
    batch = _train_batch(11, size)
    jts, want = jstep(jts, {k: jnp.asarray(v) for k, v in batch.items()})
    got = step(ts, batch)
    assert float(got["skipped_nonfinite"]) == float(want["skipped_nonfinite"]) == 0.0
    for name in ("loss", "loss_ce", "loss_giou"):
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5,
                                   err_msg=name)
    want_p = params_from_jax(jax.tree_util.tree_map(np.asarray, jts.params))
    lr = cfg.lr
    for name, p in model.named_parameters():
        diff = (p.detach() - want_p[name]).abs()
        assert (diff > 1e-2 * lr).sum().item() <= 3, name
        assert diff.max().item() <= 2.0 * lr, name
    params = dict(model.named_parameters())
    for name, p0 in stats0.items():
        assert torch.equal(params[name], p0), name
    assert not torch.equal(params["backbone.conv1.weight"], conv0)  # the backbone trains


def test_train_step_matches_make_train_step():
    """``Config()``'s train step (roi_align at capacity 191: the FFT correlation) with a
    training backbone against the JAX step."""
    check_train_step("roi_align")


def test_batch_norm_statistics_gradients_enter_the_clip():
    """The running statistics' gradients are taken (as JAX takes them) and count in the
    global norm the clip divides by."""
    _, _, step, ts, model, cfg = train_step_pair("prototype")
    batch = _train_batch(12, 64)
    seen = {}
    orig = ts.apply_gradients

    def record(grads, loss=None):
        seen.update(grads)
        return orig(grads, loss)

    ts.apply_gradients = record
    step(ts, batch)
    stats = [n for n in seen if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * sum(1 for m in model.modules()
                                 if isinstance(m, FrozenBatchNorm))
    assert sum(seen[n].abs().sum().item() for n in stats) > 0
