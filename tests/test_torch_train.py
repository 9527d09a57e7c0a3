"""Gradients, the optimizer and the train step of the port (``tmr_tpu_torch/ops/cuda_attn``'s
autograd Functions, ``tmr_tpu_torch/train/state.py``) on the CPU, against the JAX
package on the same numpy inputs: the attention backward against ``jax.vjp`` of the
Pallas kernels in interpret mode (and of ``blockwise_decomposed_attention`` on the TINY
global grid, which the Pallas global kernel refuses), ``torch.autograd.gradcheck`` in
f64, the whole TINY detector's gradients against ``jax.grad`` leaf by leaf, the
optimizer against the optax chain of ``make_optimizer`` on identical gradients, and three
train steps against ``make_train_step``.

Tolerances (all f32): attention gradients 2e-5 x the largest element of each gradient
(f32 sums in another order, an online against a banded softmax); whole-model gradients
1e-4 x each leaf's largest element, and 1e-5 relative on the global norm (f32 sums
through a 4-block encoder, the heads and the loss in another order); the optimizer on
identical gradients 1e-6 relative plus 1e-3 x lr absolute (Adam's algebra in another
order; optax takes the bias corrections 1 - b^t in f32, whose cancellation at small t
moves an update by up to ~1e-5 of itself, 12 updates in a run); the three train steps: losses 1e-5 relative, and the
parameters within 1e-2 x lr of the JAX step's (Adam's first updates are near +-lr for any
gradient above eps, so a gradient that differs in its last bits moves a parameter by
rounding only, except where a gradient within ~1e-6 of 0 has its sign flipped, which the
bound's count of such elements holds to a handful)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tmr_tpu.config import preset as j_preset  # noqa: E402
from tmr_tpu.models.matching_net import MatchingNet as JMatchingNet  # noqa: E402
from tmr_tpu.models.vit import SamViT as JSamViT  # noqa: E402
from tmr_tpu.models.vit import blockwise_decomposed_attention  # noqa: E402
from tmr_tpu.models.vit import get_rel_pos as jax_get_rel_pos  # noqa: E402
from tmr_tpu.ops.pallas_attn import (pallas_decomposed_attention,  # noqa: E402
                                     pallas_windowed_attention)
from tmr_tpu.train import state as j_state  # noqa: E402
from tmr_tpu_torch.config import preset  # noqa: E402
from tmr_tpu_torch.models import build_model  # noqa: E402
from tmr_tpu_torch.models.vit import SamViT  # noqa: E402
from tmr_tpu_torch.ops import _build, cuda_attn, cuda_int8, cuda_nms, cuda_xcorr  # noqa: E402
from tmr_tpu_torch.train import state  # noqa: E402
from tmr_tpu_torch.utils.weights import params_from_jax  # noqa: E402

TINY = dict(embed_dim=32, depth=4, num_heads=2, global_attn_indexes=(1, 3),
            patch_size=8, window_size=3, out_chans=16)
SIZE = 32
ATTN_TOL = 2e-5
GRAD_TOL = 1e-4
NORM_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------- attention backward
def _attn_case(seed, b, h, grid, d, compact):
    rng = np.random.default_rng(seed)
    s = grid[0] * grid[1]
    q, k, v, g = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(4))
    shape = ((2 * grid[0] - 1, d), (2 * grid[1] - 1, d)) if compact else (
        (grid[0], grid[0], d), (grid[1], grid[1], d))
    rh, rw = ((rng.standard_normal(sh) * 0.3).astype(np.float32) for sh in shape)
    return q, k, v, rh, rw, g


def _port_grads(fn, q, k, v, rh, rw, g, grid, scale):
    b, h, s, d = q.shape
    ts = [torch.from_numpy(a.reshape(b * h, s, d)).requires_grad_() for a in (q, k, v)]
    tabs = [] if rh is None else [torch.from_numpy(t).requires_grad_() for t in (rh, rw)]
    out = fn(*ts, *(tabs or (None, None)), grid, scale)
    grads = torch.autograd.grad(out, ts + tabs, torch.from_numpy(g.reshape(b * h, s, d)))
    return [x.numpy().reshape(a.shape) for x, a in zip(grads, (q, k, v, rh, rw))]


def _jax_grads(fn, q, k, v, rh, rw, g, grid, scale, expand):
    def f(q, k, v, *tabs):
        if expand and tabs:  # the port's global kernel takes the compact tables
            tabs = (jax_get_rel_pos(grid[0], grid[0], tabs[0]),
                    jax_get_rel_pos(grid[1], grid[1], tabs[1]))
        return fn(q, k, v, *(tabs or (None, None)), grid, scale)

    args = [jnp.asarray(a) for a in (q, k, v)] + (
        [] if rh is None else [jnp.asarray(rh), jnp.asarray(rw)])
    _, pull = jax.vjp(f, *args)
    return [np.asarray(x) for x in pull(jnp.asarray(g))]


def _assert_grads_close(got, want, tol, names=("dq", "dk", "dv", "drh", "drw")):
    assert len(got) == len(want)
    for name, a, b in zip(names, got, want):
        scale = np.abs(b).max()
        assert scale > 0, name
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("d", [16, 80])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("bands", [False, True])
def test_global_backward_matches_pallas_vjp(monkeypatch, d, bias, bands):
    """The global Function's gradients (q, k, v and the compact tables) against
    ``jax.vjp`` of ``pallas_decomposed_attention`` through ``get_rel_pos`` (the Pallas
    kernel takes S >= 128: a 16x16 grid); ``bands`` cuts the backward into 4-row query
    bands."""
    if bands:
        monkeypatch.setattr(cuda_attn, "BACKWARD_TILE_BYTES", 2 * 4 * 16 * 256 * 4)
        assert cuda_attn.band_rows(2, 16, 16) == 4
    grid = (16, 16)
    q, k, v, rh, rw, g = _attn_case(1, 1, 2, grid, d, compact=True)
    if not bias:
        rh = rw = None
    scale = d ** -0.5
    got = _port_grads(cuda_attn.global_attention, q, k, v, rh, rw, g, grid, scale)
    want = _jax_grads(pallas_decomposed_attention, q, k, v, rh, rw, g, grid, scale,
                      expand=True)
    _assert_grads_close(got, want, ATTN_TOL)


@pytest.mark.parametrize("bias", [True, False])
def test_global_backward_matches_blockwise_vjp_at_tiny_grid(bias):
    """The TINY ViT's 4x4 global grid, where the JAX ViT runs
    ``blockwise_decomposed_attention``."""
    grid = (4, 4)
    q, k, v, rh, rw, g = _attn_case(2, 2, 2, grid, 16, compact=True)
    if not bias:
        rh = rw = None
    got = _port_grads(cuda_attn.global_attention, q, k, v, rh, rw, g, grid, 0.25)
    want = _jax_grads(blockwise_decomposed_attention, q, k, v, rh, rw, g, grid, 0.25,
                      expand=True)
    _assert_grads_close(got, want, ATTN_TOL)


@pytest.mark.parametrize("window,d", [(3, 16), (3, 80), (14, 64)])
def test_window_backward_matches_pallas_vjp(window, d):
    grid = (window, window)
    q, k, v, rh, rw, g = _attn_case(3, 3, 2, grid, d, compact=False)
    scale = d ** -0.5
    got = _port_grads(cuda_attn.window_attention, q, k, v, rh, rw, g, grid, scale)
    want = _jax_grads(pallas_windowed_attention, q, k, v, rh, rw, g, grid, scale,
                      expand=False)
    _assert_grads_close(got, want, ATTN_TOL)


@pytest.mark.parametrize("kind", ["global", "global_nobias", "window", "global_bands"])
def test_attention_gradcheck_f64(monkeypatch, kind):
    """Both Functions against finite differences in f64 on a 3x4 grid, D 8 (bands: one
    grid row a band)."""
    if kind == "global_bands":
        monkeypatch.setattr(cuda_attn, "BACKWARD_TILE_BYTES", 1)
    gen = torch.Generator().manual_seed(5)
    gh, gw, d = 3, 4, 8
    qkv = [torch.randn(2, gh * gw, d, generator=gen, dtype=torch.float64,
                       requires_grad=True) for _ in range(3)]
    if kind == "window":
        tabs = [torch.randn(n, n, d, generator=gen, dtype=torch.float64) * 0.3
                for n in (gh, gw)]
        fn = cuda_attn.window_attention
    else:
        tabs = [torch.randn(2 * n - 1, d, generator=gen, dtype=torch.float64) * 0.3
                for n in (gh, gw)]
        fn = cuda_attn.global_attention
    tabs = [t.requires_grad_() for t in tabs]
    if kind == "global_nobias":
        assert torch.autograd.gradcheck(
            lambda q, k, v: fn(q, k, v, None, None, (gh, gw), 0.35), tuple(qkv))
    else:
        assert torch.autograd.gradcheck(
            lambda q, k, v, a, b: fn(q, k, v, a, b, (gh, gw), 0.35), (*qkv, *tabs))


def test_band_rows_bounds_the_score_tile():
    """SAM ViT-B's global blocks at batch 4 (BH 48, 64x64 tokens): 8 rows of 64 queries,
    402 MB a tile; the 14x14 windows at BH 1200: the whole window in one band."""
    assert cuda_attn.band_rows(48, 64, 64) == 8
    assert cuda_attn.band_rows(1200, 14, 14) == 14
    assert cuda_attn.band_rows(48, 96, 96) == 3
    assert cuda_attn.band_rows(10 ** 6, 7, 7) == 1


@pytest.mark.parametrize("call", ["xcorr", "xcorr_int8", "int8_mm", "int8_conv3x3",
                                  "nms"])
def test_kernels_without_backward_refuse_inputs_that_require_grad(call):
    """A device tensor that requires grad reaches ``_build.refuse_grad`` before any
    launch (``meta`` tensors stand for the card's here) and raises, naming ROADMAP;
    under ``no_grad`` the refusal stands aside."""
    m = dict(device="meta")
    f32 = lambda *s: torch.zeros(*s, **m, requires_grad=True)  # noqa: E731
    i8 = lambda *s: torch.zeros(*s, dtype=torch.int8, **m)  # noqa: E731
    calls = {
        "xcorr": lambda: cuda_xcorr.xcorr(f32(1, 2, 8, 8), f32(1, 2, 3, 3)),
        "xcorr_int8": lambda: cuda_xcorr.xcorr_int8(i8(1, 2, 8, 8), i8(1, 2, 3, 3),
                                                    f32(1, 2, 1, 1), f32(1, 2, 1, 1)),
        "int8_mm": lambda: cuda_int8.int8_mm(i8(4, 16), i8(5, 16), f32(4), f32(5)),
        "int8_conv3x3": lambda: cuda_int8.int8_conv3x3(i8(1, 4, 4, 16), f32(1),
                                                       i8(3, 3, 5, 16), f32(3, 3, 5), f32(5)),
        "nms": lambda: cuda_nms.greedy_keep_sorted(f32(1, 6, 4), torch.ones(
            1, 6, dtype=torch.bool, **m), 0.5),
    }
    with pytest.raises(RuntimeError, match="no backward.*ROADMAP A8"):
        calls[call]()
    with torch.no_grad():
        _build.refuse_grad(call, f32(2))  # no grad mode: nothing to cut


# ------------------------------------------------------ the whole detector
def _jax_tiny(capacity, seed=0):
    """The TINY JAX detector at ``capacity``, its params (the rel-pos tables and the
    position embedding get values, the objectness head a larger kernel, so every path
    does real work) and the port's model with the same weights."""
    jmodel = JMatchingNet(backbone=JSamViT(pretrain_img_size=SIZE, **TINY), emb_dim=16,
                          fusion=True, feature_upsample=True, template_capacity=capacity)
    img = jnp.zeros((1, SIZE, SIZE, 3), jnp.float32)
    ex = jnp.asarray([[[0.2, 0.2, 0.4, 0.4]]], jnp.float32)
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32),
                                    jmodel.init(jax.random.key(seed), img, ex)["params"])
    rng = np.random.default_rng(seed + 1)
    params["objectness_head_0"]["conv"]["kernel"] *= 30.0
    bb = params["backbone"]
    bb["pos_embed"] = (rng.standard_normal(bb["pos_embed"].shape) * 0.1).astype(np.float32)
    for i in range(TINY["depth"]):
        for name in ("rel_pos_h", "rel_pos_w"):
            shape = bb[f"blocks_{i}"]["attn"][name].shape
            bb[f"blocks_{i}"]["attn"][name] = (rng.standard_normal(shape) * 0.5).astype(
                np.float32)
    return jmodel, params


def _cfg_kw(capacity, **kw):
    return dict(emb_dim=16, compute_dtype="float32", image_size=SIZE,
                template_buckets=(capacity,), **kw)


def _port_model(params, capacity, **cfg_kw):
    cfg = preset("TMR_FSCD147", **_cfg_kw(capacity, **cfg_kw))
    model = build_model(cfg, backbone=SamViT(pretrain_img_size=SIZE,
                                             remat=cfg.remat_backbone, **TINY),
                        device="cpu")
    model.load_state_dict(params_from_jax(params))
    return cfg, model


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.05, 0.6, (b, 5, 2))
    gt = np.concatenate([xy, xy + rng.uniform(0.1, 0.3, (b, 5, 2))], -1).astype(np.float32)
    valid = np.ones((b, 5), bool)
    valid[:, 4] = False
    return {"image": rng.standard_normal((b, SIZE, SIZE, 3)).astype(np.float32),
            "exemplars": gt[:, :1].copy(), "gt_boxes": gt, "gt_valid": valid}


def _jax_loss_grads(jmodel, params, cfg, batch):
    def loss_fn(p):
        out = jmodel.apply({"params": p}, jnp.asarray(batch["image"]),
                           jnp.asarray(batch["exemplars"]))
        return j_state.compute_losses(out, {k: jnp.asarray(v) for k, v in batch.items()},
                                      cfg.positive_threshold, cfg.negative_threshold)["loss"]

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), params_from_jax(jax.tree_util.tree_map(np.asarray, grads))


def _port_loss_grads(model, cfg, batch, capacity):
    model.zero_grad(set_to_none=True)
    out = model(torch.from_numpy(batch["image"]), torch.from_numpy(batch["exemplars"]),
                capacity)
    loss = state.compute_losses(out, batch, cfg.positive_threshold,
                                cfg.negative_threshold)["loss"]
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("capacity", [9, 191])
def test_model_gradients_match_jax_grad(capacity):
    """``loss.backward()`` of the TINY port against ``jax.grad`` of the JAX loss on the
    same params and batch, every leaf (the backbone's included: the frozen backbone's
    gradients enter the clip's norm), and the global norm. 191: the train forward's
    capacity, the FFT correlation."""
    jmodel, params = _jax_tiny(capacity)
    cfg, model = _port_model(params, capacity)
    batch = _batch(3)
    want_loss, want = _jax_loss_grads(jmodel, params, cfg, batch)
    got_loss, got = _port_loss_grads(model, cfg, batch, capacity)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert sorted(got) == sorted(want)
    assert sum(k.startswith("backbone.") for k in got) > 40
    for name, w in want.items():
        g = got[name]
        assert g is not None and g.shape == w.shape, name
        scale = w.abs().max().item()
        assert scale > 0, name
        torch.testing.assert_close(g, w, rtol=0, atol=GRAD_TOL * scale, msg=name)
    norm = lambda gs: torch.linalg.vector_norm(torch.stack(  # noqa: E731
        [torch.linalg.vector_norm(x) for x in gs.values()])).item()
    np.testing.assert_allclose(norm(got), norm(want), rtol=NORM_TOL)


def test_remat_backbone_gives_the_same_gradients():
    """``remat_backbone`` recomputes each block on the backward pass: the same
    gradients, bit for bit (the same ops on the same values)."""
    _, params = _jax_tiny(9)
    batch = _batch(4)
    cfg, plain = _port_model(params, 9)
    rcfg, remat = _port_model(params, 9, remat_backbone=True)
    assert remat.backbone.remat and not plain.backbone.remat
    _, want = _port_loss_grads(plain, cfg, batch, 9)
    _, got = _port_loss_grads(remat, rcfg, batch, 9)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0, msg=name)


# ---------------------------------------------------------------- optimizer
class _Toy(torch.nn.Module):
    """A backbone and a head, as the detector's top-level modules."""

    def __init__(self):
        super().__init__()
        self.backbone = torch.nn.Linear(3, 4)
        self.head = torch.nn.Linear(4, 2)


def _toy_tree(model):
    return {"backbone": {"weight": model.backbone.weight.detach().numpy().copy(),
                         "bias": model.backbone.bias.detach().numpy().copy()},
            "head": {"weight": model.head.weight.detach().numpy().copy(),
                     "bias": model.head.bias.detach().numpy().copy()}}


def _flat(tree):
    return {f"{a}.{b}": np.asarray(v) for a, sub in tree.items() for b, v in sub.items()}


OPT_CASES = {
    "frozen": dict(lr_backbone=0.0),
    "trainable": dict(lr_backbone=3e-4),
    "frz_name": dict(lr_backbone=3e-4, backbone="sam_vit_b_FRZ"),
    "accum2": dict(lr_backbone=0.0, grad_accum_steps=2),
    "accum2_trainable": dict(lr_backbone=3e-4, grad_accum_steps=2),
    "no_clip": dict(lr_backbone=3e-4, clip_max_norm=1e6),
    "no_drop": dict(lr_backbone=3e-4, lr_drop=False),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
@pytest.mark.parametrize("nonfinite", [False, True])
def test_optimizer_matches_optax(case, nonfinite):
    """``TrainState.apply_gradients`` against the optax chain of ``make_optimizer`` on
    identical numpy gradients over 12 micro-steps of 2 a epoch at max_epochs 5 (the drop
    at update 6, or 3 under accumulation: the steps cross it), with the JAX train step's
    containment (``where(ok, new, old)``); ``nonfinite`` plants a NaN (step 3) and an
    infinite gradient (step 6, a first micro-step under accumulation) that must move
    nothing, the counts included."""
    kw = dict(backbone="sam_vit_b", lr=1e-3, lr_drop=True, max_epochs=5, clip_max_norm=0.1,
              weight_decay=1e-4, grad_accum_steps=1)
    kw.update(OPT_CASES[case])
    cfg = preset("TMR_FSCD147", **kw)
    jcfg = j_preset("TMR_FSCD147", **kw)
    torch.manual_seed(0)
    model = _Toy()
    ts = state.TrainState(model, cfg, steps_per_epoch=2)
    tx = j_state.make_optimizer(jcfg, steps_per_epoch=2)
    params = jax.tree_util.tree_map(jnp.asarray, _toy_tree(model))
    opt_state = tx.init(params)
    rng = np.random.default_rng(1)
    frozen = state.frozen_backbone(cfg)
    assert frozen == (case in ("frozen", "frz_name", "accum2"))
    counts = []
    for i in range(12):
        tree = {m: {p: (rng.standard_normal(v.shape) * (0.01 if i % 2 else 1.0)).astype(
            np.float32) for p, v in sub.items()} for m, sub in _toy_tree(model).items()}
        if nonfinite and i in (3, 6):
            tree["head" if i == 3 else "backbone"]["weight"][0, 0] = (
                np.nan if i == 3 else np.inf)
        ok = ts.apply_gradients({k: torch.from_numpy(v) for k, v in _flat(tree).items()})
        assert ok == (not (nonfinite and i in (3, 6)))
        if ok:
            updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, tree),
                                           opt_state, params)
            params = optax.apply_updates(params, updates)
        counts.append(ts.count)
        want = _flat(params)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-6,
                                       atol=1e-3 * cfg.lr, err_msg=f"step {i} {name}")
    k = cfg.grad_accum_steps
    updates_made = (12 - (2 if nonfinite else 0)) // k
    assert ts.count == updates_made and counts[-1] == updates_made
    assert ts.step == 12 - (2 if nonfinite else 0)
    if frozen:
        assert all(g["name"] == "head" for g in ts.optimizer.param_groups)


@pytest.mark.parametrize("max_epochs,steps,accum,drop", [
    (5, 2, 1, True), (200, 37, 1, True), (10, 7, 2, True), (7, 3, 4, True),
    (5, 2, 1, False)])
def test_lr_drop_lands_on_the_optax_boundary(max_epochs, steps, accum, drop):
    """The x0.1 drop is counted in optimizer updates and lands on the update optax's
    ``piecewise_constant_schedule`` lowers, not one before or after."""
    kw = dict(max_epochs=max_epochs, grad_accum_steps=accum, lr_drop=drop, lr=1e-4)
    cfg, jcfg = preset("TMR_FSCD147", **kw), j_preset("TMR_FSCD147", **kw)
    milestone = state.lr_milestone(cfg, steps)
    upe = max(steps // accum, 1)
    assert milestone == (int(max_epochs * 0.6) if drop else max_epochs + 1) * upe
    sched = optax.piecewise_constant_schedule(jcfg.lr, {milestone: 0.1})
    for count in (0, milestone - 1, milestone, milestone + 1):
        np.testing.assert_allclose(state.scheduled_lr(cfg.lr, count, milestone),
                                   float(sched(count)), rtol=1e-6)
    assert state.scheduled_lr(1.0, milestone - 1, milestone) == 1.0
    assert state.scheduled_lr(1.0, milestone, milestone) == pytest.approx(0.1)


def test_param_labels_follow_the_top_level_backbone():
    _, params = _jax_tiny(9)
    _, model = _port_model(params, 9)
    labels = state.param_labels(model, frozen=True)
    assert {v for k, v in labels.items() if k.startswith("backbone.")} == {"frozen"}
    assert {v for k, v in labels.items() if not k.startswith("backbone.")} == {"head"}
    assert set(state.param_labels(model, frozen=False).values()) == {"head", "backbone"}


# --------------------------------------------------------------- train step
def test_three_train_steps_match_make_train_step():
    """Three steps of ``make_train_step`` on the TINY detector (frozen backbone, lr 1e-3,
    clip 0.1) against the JAX step on the same params and batches: the losses, then the
    parameters after each step; the backbone bit for bit unmoved on both sides."""
    capacity = 9
    jmodel, params = _jax_tiny(capacity, seed=2)
    kw = _cfg_kw(capacity, lr=1e-3, max_epochs=10)
    cfg, model = _port_model(params, capacity, lr=1e-3, max_epochs=10)
    jcfg = j_preset("TMR_FSCD147", **kw)
    tx = j_state.make_optimizer(jcfg, steps_per_epoch=3)
    jts = j_state.TrainState.create(apply_fn=jmodel.apply, params=params, tx=tx)
    jstep = jax.jit(j_state.make_train_step(jmodel, jcfg))
    ts = state.TrainState(model, cfg, steps_per_epoch=3)
    step = state.make_train_step(model, cfg)
    backbone0 = {n: p.detach().clone() for n, p in model.named_parameters()
                 if n.startswith("backbone.")}
    lr = cfg.lr
    for i in range(3):
        batch = _batch(10 + i)
        jts, want = jstep(jts, {k: jnp.asarray(v) for k, v in batch.items()})
        got = step(ts, batch)
        assert float(got["skipped_nonfinite"]) == float(want["skipped_nonfinite"]) == 0.0
        for name in ("loss", "loss_ce", "loss_giou"):
            np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-5,
                                       err_msg=f"step {i} {name}")
        want_p = params_from_jax(jax.tree_util.tree_map(np.asarray, jts.params))
        for name, p in model.named_parameters():
            diff = (p.detach() - want_p[name]).abs()
            assert (diff > 1e-2 * lr).sum().item() <= 3, f"step {i} {name}"
            assert diff.max().item() <= 2.0 * lr, f"step {i} {name}"
    assert ts.count == ts.step == 3
    for name, p0 in backbone0.items():
        assert torch.equal(dict(model.named_parameters())[name], p0), name
    assert not torch.equal(model.objectness_head_0.conv.weight,
                           torch.from_numpy(params["objectness_head_0"]["conv"]["kernel"]
                                            .transpose(3, 2, 0, 1)))
