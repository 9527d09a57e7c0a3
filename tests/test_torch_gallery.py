"""The gallery tier in the port on the CPU: the ops it needs (``match_templates``, the
coarse prefilter and its sketch sign table, ``nms_topk``), ``Predictor.predict_gallery``
(fused and features arms), ``serve/gallery.GalleryBank`` and its gate, the engine's
``search_gallery`` and the ``tcp://`` feature sink, against the JAX package at the TINY
geometry of ``tests/test_torch_predictor.py`` (f32, 32 px), on the same
``params_from_jax`` weights, images and exemplars.

Tolerances: the sign table, ``nms_topk`` and the sink's bytes equal; the prefilter's
scores and ``match_templates`` within 1e-4 x max (f32 sums in another order, the
prefilter on the encoder's features); ``predict_gallery``'s valid masks equal, boxes and
scores within 1e-5 (as ``tests/test_torch_multi.py``); the port's fused arm against its
own N-loop: the same detections after NMS, scores within 1e-5 relative (the heads run at
N x k rows against k, and the CPU's convolutions may sum in another order); its fused and
features arms equal bit for bit (the same ops on the same values)."""

import dataclasses
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_predictor import SIZE, TINY, _make_pair  # noqa: E402
from test_torch_refine import EXEMPLARS as REX  # noqa: E402
from test_torch_refine import pred_pair, refiners  # noqa: E402,F401  (fixtures)

from tmr_tpu.config import preset as j_preset  # noqa: E402
from tmr_tpu.inference import Predictor as JPredictor  # noqa: E402
from tmr_tpu_torch.config import preset  # noqa: E402
from tmr_tpu_torch.inference import Predictor  # noqa: E402
from tmr_tpu_torch.models import build_model  # noqa: E402
from tmr_tpu_torch.models.vit import SamViT  # noqa: E402
from tmr_tpu_torch.ops import nms as pnms  # noqa: E402
from tmr_tpu_torch.ops import xcorr as pxcorr  # noqa: E402

FIELDS = ("boxes", "scores", "refs", "valid")
#: exemplars of the 32 px frame, all in template bucket 9 of the 8 x 8 map
EX = np.array([[0.2, 0.2, 0.4, 0.5], [0.5, 0.55, 0.7, 0.6], [0.1, 0.6, 0.15, 0.7],
               [0.6, 0.1, 0.9, 0.3], [0.3, 0.7, 0.5, 0.9]], np.float32)
#: a bank of 3 entries padded to k bucket 3, with k_real (3, 1, 2)
BANK = np.stack([EX[[0, 1, 2]], EX[[3, 0, 0]], EX[[4, 1, 1]]])
K_REAL = np.array([3, 1, 2], np.int32)
QUANT_ENV = (("TMR_DECODER_IMPL", "fused"), ("TMR_QUANT", "int8"),
             ("TMR_QUANT_STORAGE", "int8"), ("TMR_QUANT_KERNEL", "int8dot"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def pair():
    return _make_pair(TINY)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _assert_dets_match(got, want, tol=1e-5):
    np.testing.assert_array_equal(np.asarray(got["valid"]), np.asarray(want["valid"]))
    assert np.asarray(got["valid"]).sum() > 0
    for name in ("scores", "boxes", "refs"):
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(want[name]),
                                   rtol=tol, atol=tol, err_msg=name)


def _assert_same_detections(got, want, rel=1e-5):
    """The same detections after NMS (valid equal, boxes and refs within 1e-5), scores
    within ``rel`` of the largest."""
    g, w = ({k: np.asarray(d[k]) for k in FIELDS} for d in (got, want))
    np.testing.assert_array_equal(g["valid"], w["valid"])
    for name in ("boxes", "refs"):
        np.testing.assert_allclose(g[name], w[name], rtol=1e-5, atol=1e-5)
    scale = max(float(np.abs(w["scores"]).max()), 1e-30)
    assert float(np.abs(g["scores"] - w["scores"]).max()) <= rel * scale


def _assert_bitwise(a, b):
    for k in FIELDS:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


# --------------------------------------------------------------------- ops
@pytest.mark.parametrize("c", [16, 256, 1024, 2048])
def test_sketch_signs_match_jax_bernoulli(c):
    """The prefilter's sign table is ``jax.random.bernoulli(jax.random.key(20260804),
    0.5, (C, 32))`` bit for bit, drawn by the port's numpy Threefry."""
    want = jax.random.bernoulli(jax.random.key(pxcorr.SKETCH_SEED), 0.5, (c, 32))
    signs = np.where(np.asarray(want), 1.0, -1.0) / jnp.sqrt(32.0)
    got = pxcorr.sketch_signs(c, 32)
    assert got.dtype == np.float32
    assert np.array_equal(got > 0, np.asarray(want))
    assert got.tobytes() == np.asarray(signs, np.float32).tobytes()
    assert pxcorr.sketch_signs(c, 32) is got  # built once per (C, G)


def test_threefry_matches_the_published_vectors():
    """Threefry-2x32, 20 rounds: the known-answer vectors of the Random123 suite."""
    u32 = lambda *v: np.array(v, np.uint32)  # noqa: E731
    for key, ctr, want in (((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                           ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
                            (0x1CB996FC, 0xBB002BE7)),
                           ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                            (0xC4923A9C, 0x483DF7A0))):
        x0, x1 = pxcorr.threefry2x32(key, u32(ctr[0]), u32(ctr[1]))
        assert (int(x0[0]), int(x1[0])) == want


@pytest.mark.parametrize("side", [4, 16, 32])
def test_coarse_prefilter_scores_match_jax(side):
    """Random features of 24 channels; 5 entries with k_real (3, 1, 2, 1, 1) and 4 real.
    ``side`` 4 is below 8 x pool (the pool falls back to 1), 16 pools to 8^2 (T 7), 32 to
    16^2 (T 15)."""
    from tmr_tpu.ops.xcorr import coarse_prefilter_scores as jscores

    rng = np.random.default_rng(side)
    feat = rng.standard_normal((1, side, side, 24)).astype(np.float32)
    xy = rng.uniform(0, 0.7, (5, 3, 2))
    ex = np.concatenate([xy, xy + rng.uniform(0.05, 0.3, (5, 3, 2))], -1).astype(np.float32)
    kr = np.array([3, 1, 2, 1, 1], np.int32)
    want = np.asarray(jscores(jnp.asarray(feat), jnp.asarray(ex), jnp.asarray(kr),
                              jnp.asarray(4, jnp.int32)))
    got = pxcorr.coarse_prefilter_scores(_t(feat), _t(ex), _t(kr), 4).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin) and list(fin) == [True] * 4 + [False]
    assert np.all(got[~fin] == -np.inf)
    assert np.abs(got[fin] - want[fin]).max() <= 1e-4 * np.abs(want[fin]).max()
    assert list(np.argsort(-got[fin], kind="stable")) == list(
        np.argsort(-want[fin], kind="stable"))


def test_prefilter_program_matches_jax_on_the_encoder_features(pair):
    """The prefilter program on each package's encoder output for one frame: a zero frame
    with one textured region, entries over it, over the void and one padded (-inf)."""
    jpred, pred, _ = pair
    img = np.zeros((SIZE, SIZE, 3), np.float32)
    x1, y1, x2, y2 = (EX[0] * SIZE).astype(int)
    img[y1:y2, x1:x2] = np.random.default_rng(3).standard_normal(
        (y2 - y1, x2 - x1, 3)).astype(np.float32) * 3.0
    ex = np.stack([EX[:1], np.array([[0.7, 0.7, 0.82, 0.82]], np.float32), EX[3:4]])
    kr = np.ones(3, np.int32)
    jfeat = jpred._get_backbone_fn()(jpred.exec_params(), jnp.asarray(img[None]))
    want = np.asarray(jpred._get_gallery_prefilter_fn(3, 1)(
        jfeat, jnp.asarray(ex), jnp.asarray(kr), jnp.asarray(2, jnp.int32)))
    feats = pred._get_backbone_fn()(img[None])
    got = pred._get_gallery_prefilter_fn(3, 1)(feats, ex, kr, 2).numpy()
    assert got[2] == want[2] == -np.inf
    assert np.abs(got[:2] - want[:2]).max() <= 1e-4 * np.abs(want[:2]).max()
    assert (got[0] > got[1]) == (want[0] > want[1])


@pytest.mark.parametrize("template_type", ["roi_align", "prototype"])
@pytest.mark.parametrize("squeeze", [False, True])
def test_match_templates_matches_jax(template_type, squeeze):
    from tmr_tpu.ops.xcorr import match_templates as jmatch

    rng = np.random.default_rng(7)
    feat = rng.standard_normal((3, 8, 20, 24)).astype(np.float32)
    ex = np.array([[0.1, 0.2, 0.4, 0.5], [0.5, 0.5, 0.9, 0.7], [0.0, 0.0, 1.0, 1.0]],
                  np.float32)
    want = np.asarray(jmatch(jnp.asarray(feat), jnp.asarray(ex), 9, template_type,
                             squeeze))
    got = pxcorr.match_templates(_t(feat), _t(ex), 9, template_type, squeeze).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def _nms_case(case, b=2, n=160):
    rng = np.random.default_rng(11)
    xy = rng.uniform(0, 0.8, (b, n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.05, 0.3, (b, n, 2))], -1).astype(
        np.float32)
    scores = np.round(rng.uniform(size=(b, n)) * 8) / 8  # ties across slots
    valid = rng.uniform(size=(b, n)) > 0.2
    k = n // 2
    if case == "all_suppressed":
        boxes[:] = boxes[:, :1]
    elif case == "empty_valid":
        valid[:] = False
    elif case == "k_past_survivors":
        k = 2 * n
    elif case == "identical_ties":
        boxes[:, 40:80] = boxes[:, :40]
        scores[:, 40:80] = scores[:, :40]
    return boxes, scores.astype(np.float32), valid, k


@pytest.mark.parametrize("case", ["ties", "identical_ties", "all_suppressed",
                                  "empty_valid", "k_past_survivors"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_nms_topk_matches_jax(case, backend):
    """Count, index, boxes and scores equal to the JAX ``nms_topk`` (the XLA fixpoint, or
    the Pallas kernel in interpret mode): ties break toward the lower slot in both."""
    from tmr_tpu.ops.pallas_nms import nms_topk as jtopk

    boxes, scores, valid, k = _nms_case(case)
    kw = dict(interpret=True) if backend == "pallas" else {}
    want = jtopk(jnp.asarray(boxes), jnp.asarray(scores), 0.5, jnp.asarray(valid), k=k,
                 backend=backend, **kw)
    got = pnms.nms_topk(_t(boxes), _t(scores), 0.5, _t(valid), k=k)
    for f in ("count", "index", "boxes", "scores"):
        w = np.array(want[f])
        assert got[f].dtype == torch.from_numpy(w).dtype, f
        assert np.array_equal(got[f].numpy(), w), f


def test_nms_topk_takes_one_route():
    boxes, scores, valid, _ = _nms_case("ties")
    with pytest.raises(ValueError, match="one route"):
        pnms.nms_topk(_t(boxes), _t(scores), 0.5, _t(valid), backend="xla")
    got = pnms.nms_topk(_t(boxes), _t(scores), 0.5)  # valid None, k None: every slot
    assert got["index"].shape == (2, 160) and int(got["count"].min()) > 0


# ------------------------------------------------------------ predict_gallery
@pytest.mark.parametrize("arm", ["fused", "features"])
def test_predict_gallery_matches_jax(pair, arm):
    """3 real entries of mixed k_real pad to the rung of 4 (n_real < n_bucket): the
    padded entry keeps nothing."""
    jpred, pred, images = pair
    if arm == "fused":
        want = jpred.predict_gallery(images[:1], BANK, K_REAL)
        got = pred.predict_gallery(images[:1], BANK, K_REAL)
    else:
        jfeat = jpred._get_backbone_fn()(jpred.exec_params(), jnp.asarray(images[:1]))
        want = jpred.predict_gallery(None, BANK, K_REAL, features=jfeat, image_size=SIZE)
        feat = pred._get_backbone_fn()(images[:1])
        got = pred.predict_gallery(None, BANK, K_REAL, features=feat, image_size=SIZE)
    assert got["valid"].shape == (4, 3 * 64)
    _assert_dets_match({k: v.numpy() for k, v in got.items()}, want)
    assert not got["valid"][3].any()
    for i, k in enumerate(K_REAL):
        assert not got["valid"][i, k * 64:].any()


def test_predict_gallery_n_real_masks_entries(pair):
    """``n_real`` 2 of 3 carried entries: the rung is 2 and the third entry is cut."""
    jpred, pred, images = pair
    want = jpred.predict_gallery(images[1:2], BANK, K_REAL, n_real=2)
    got = pred.predict_gallery(images[1:2], BANK, K_REAL, n_real=2)
    assert got["valid"].shape == (2, 3 * 64)
    _assert_dets_match({k: v.numpy() for k, v in got.items()}, want)


def test_predict_gallery_arms_equal_bit_for_bit(pair):
    _, pred, images = pair
    fused = pred.predict_gallery(images[2:3], BANK, K_REAL)
    feat = pred._get_backbone_fn()(images[2:3])
    split = pred.predict_gallery(None, BANK, K_REAL, features=feat, image_size=SIZE)
    for k in FIELDS:
        assert torch.equal(fused[k], split[k]), k


def test_fused_arm_matches_its_n_loop(pair):
    """Each entry's slice against ``predict_multi_exemplar`` on its own rows."""
    _, pred, images = pair
    got = pred.predict_gallery(images[:1], BANK, K_REAL)
    for i, k in enumerate(K_REAL):
        one = pred.predict_multi_exemplar(images[:1], BANK[i], k_real=int(k))
        n = one["valid"].shape[1]
        _assert_same_detections({f: got[f][i:i + 1, :n] for f in FIELDS}, one)


def test_predict_gallery_refuses_bad_arguments(pair):
    _, pred, images = pair
    for args, kw, match in (((BANK[0], K_REAL), {}, "expected"),
                            ((BANK, K_REAL), dict(n_real=4), "n_real"),
                            ((BANK, K_REAL[:2]), {}, "one count"),
                            ((BANK, np.array([3, 4, 1])), {}, "k_real rows"),
                            ((BANK, K_REAL), dict(features=torch.zeros(1)), "image_size")):
        with pytest.raises(ValueError, match=match):
            pred.predict_gallery(images[:1], *args, **kw)
    bare = Predictor(pred.cfg, device="cpu", model=pred.model)
    with pytest.raises(RuntimeError, match="load weights"):
        bare.predict_gallery(images[:1], BANK, K_REAL)
    assert Predictor.N_BUCKETS == JPredictor.N_BUCKETS


def test_predict_gallery_with_refiner_matches_jax(pred_pair):
    """With a refiner and ``refine_box`` the feature is repeated per entry, as in JAX;
    the tiny refiner pair of ``tests/test_torch_refine.py``."""
    jpred, pred, images = pred_pair
    bank = np.stack([REX[[0, 1, 2], 0], REX[[1, 1, 1], 0]])
    kr = np.array([3, 1], np.int32)
    want = jpred.predict_gallery(images[:1], bank, kr)
    got = pred.predict_gallery(images[:1], bank, kr)
    _assert_dets_match({k: v.numpy() for k, v in got.items()}, want)
    plain = Predictor(dataclasses.replace(pred.cfg, refine_box=False), device="cpu",
                      model=pred.model, refiner=pred.refiner)
    plain.weights_set = True  # the model holds the weights already
    assert not torch.equal(plain.predict_gallery(images[:1], bank, kr)["boxes"],
                           got["boxes"])


def test_predict_gallery_int8_storage_matches_jax(pair, monkeypatch):
    jpred, _, images = pair
    for name, val in QUANT_ENV:
        monkeypatch.setenv(name, val)
    overrides = dict(emb_dim=16, compute_dtype="float32", image_size=SIZE)
    jq = JPredictor(j_preset("TMR_FSCD147", **overrides), params=jpred.params,
                    model=jpred.model)
    assert jq._storage_state() is not None
    cfg = preset("TMR_FSCD147", **overrides, quant="int8", quant_storage="int8",
                 quant_kernel="int8")
    q = Predictor(cfg, device="cpu", model=build_model(
        cfg, backbone=SamViT(pretrain_img_size=SIZE, **TINY), device="cpu"))
    q.load_jax_params(jpred.params)
    want = jq.predict_gallery(images[:1], BANK[:2], K_REAL[:2])
    got = q.predict_gallery(images[:1], BANK[:2], K_REAL[:2])
    _assert_dets_match({k: v.numpy() for k, v in got.items()}, want)


# --------------------------------------------------------------- the bank
def _bank(pred, **kw):
    from tmr_tpu_torch.serve import GalleryBank

    return GalleryBank(pred, **kw)


def test_register_evict_and_bucketing(pair):
    _, pred, _ = pair
    bank = _bank(pred, feature_cache=0, max_n_bucket=32)
    assert bank.register("a", EX[:1]) == {"name": "a", "capacity": 9, "k_bucket": 1,
                                          "k_real": 1}
    rec = bank.register("b", EX[:3])
    assert rec["k_bucket"] == 3 and rec["k_real"] == 3
    assert len(bank) == 2 and "a" in bank
    assert len(bank.stats()["groups"]) == 2  # k buckets 1 and 3 split
    assert bank.evict("a") is True and bank.evict("a") is False
    assert bank.names() == ["b"]
    with pytest.raises(ValueError):
        bank.register("bad", EX[:1], k_real=5)
    with pytest.raises(ValueError):
        bank.search(np.zeros((SIZE // 2, SIZE // 2, 3), np.float32))
    assert bank.search(np.zeros((1, SIZE, SIZE, 3), np.float32))["b"]["valid"].shape == \
        (1, 3 * 64)
    c = bank.counters
    assert (c["registered"], c["evicted"], c["searches"]) == (2, 1, 1)


def test_ladder_cap_chunks_groups(pair, monkeypatch):
    _, pred, _ = pair
    monkeypatch.setenv("TMR_GALLERY_NMAX", "3")
    bank = _bank(pred, feature_cache=0)
    assert bank.max_n_bucket == 2
    for i in range(5):
        bank.register(f"p{i}", EX[i:i + 1])
    assert [g["n_real"] for g in bank.stats()["groups"]] == [2, 2, 1]
    monkeypatch.delenv("TMR_GALLERY_NMAX")
    assert _bank(pred).max_n_bucket == 32  # nothing measured: the last rung


def test_fused_search_matches_the_n_loop_and_jax(pair):
    """A cold frame: the fused arm, one entry per pattern, the same detections as the
    N-loop of ``predict_multi_exemplar`` and as the JAX bank's fused search."""
    from tmr_tpu.serve.gallery import GalleryBank as JGalleryBank

    from tmr_tpu_torch.serve import gallery_fused_ok

    jpred, pred, images = pair
    assert gallery_fused_ok(pred, 9, 4, 1)
    bank = _bank(pred, feature_cache=4, max_n_bucket=32)
    jbank = JGalleryBank(jpred, feature_cache=4, max_n_bucket=32)
    for i in range(3):
        bank.register(f"p{i}", EX[i:i + 1])
        jbank.register(f"p{i}", EX[i:i + 1])
    img = images[0]
    res, jres = bank.search(img), jbank.search(img)
    assert bank.counters["fused_frames"] == 1
    assert bank.counters["full_match_entries"] == 3
    for i in range(3):
        r = res[f"p{i}"]
        assert r["valid"].shape == (1, 64)
        _assert_same_detections(r, pred.predict_multi_exemplar(img[None], EX[i:i + 1]))
        _assert_dets_match(r, jres[f"p{i}"])


def test_second_sighting_promotion_and_hit(pair):
    """Sighting 1 fused, 2 the encoder program and the tails (features stored), 3 a
    cache hit; all three equal bit for bit."""
    _, pred, images = pair
    bank = _bank(pred, feature_cache=4, max_n_bucket=32)
    for i in range(3):
        bank.register(f"p{i}", EX[i:i + 1])
    r1, r2, r3 = (bank.search(images[1]) for _ in range(3))
    c = bank.counters
    assert (c["fused_frames"], c["backbone_fills"], c["heads_frames"]) == (1, 1, 2)
    assert bank.feature_cache.stats()["hits"] == 1
    for name in r1:
        _assert_bitwise(r1[name], r2[name])
        _assert_bitwise(r1[name], r3[name])


def test_prefilter_skips_carry_degrade_step(pair):
    """Two textured regions and one featureless entry, the prefilter's top-2: the skipped
    entry says so, with its score, the others are matched in full, and the selection,
    scores and detections equal the JAX bank's."""
    from tmr_tpu.serve.gallery import GalleryBank as JGalleryBank

    jpred, pred, _ = pair
    img = np.zeros((SIZE, SIZE, 3), np.float32)
    rng = np.random.default_rng(5)
    for b in (EX[0], EX[3]):
        x1, y1, x2, y2 = (b * SIZE).astype(int)
        img[y1:y2, x1:x2] = rng.standard_normal((y2 - y1, x2 - x1, 3)) * 3.0
    banks = (_bank(pred, feature_cache=4), JGalleryBank(jpred, feature_cache=4))
    for bank in banks:
        bank.register("tex0", EX[:1])
        bank.register("empty", np.array([[0.7, 0.7, 0.82, 0.82]], np.float32))
        bank.register("tex3", EX[3:4])
    res, jres = (bank.search(img, prefilter_topk=2) for bank in banks)
    c = banks[0].counters
    assert (c["prefilter_runs"], c["prefilter_skipped"], c["full_match_entries"]) == \
        (1, 1, 2)
    skipped = [n for n, r in res.items() if r.get("degrade_steps")]
    assert skipped == [n for n, r in jres.items() if r.get("degrade_steps")]
    assert len(skipped) == 1
    r = res[skipped[0]]
    assert r["degrade_steps"] == ["prefilter"] and r["valid"].size == 0
    assert r["prefilter_score"] == pytest.approx(jres[skipped[0]]["prefilter_score"],
                                                 rel=1e-4, abs=1e-6)
    for name in set(res) - set(skipped):
        assert "degrade_steps" not in res[name]
        _assert_dets_match(res[name], jres[name])


def test_prefilter_topk_knob(pair, monkeypatch):
    _, pred, _ = pair
    bank = _bank(pred, feature_cache=0)
    for raw, want in (("", 0), ("off", 0), ("3", 3), ("-2", 0)):
        monkeypatch.setenv("TMR_GALLERY_PREFILTER_TOPK", raw)
        assert bank._resolve_topk(None) == want
    monkeypatch.setenv("TMR_GALLERY_PREFILTER_TOPK", "auto")
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        bank._resolve_topk(None)
    monkeypatch.setenv("TMR_GALLERY_PREFILTER_TOPK", "many")
    with pytest.raises(ValueError, match="off\\|auto\\|<int>"):
        bank._resolve_topk(None)


def test_gate_refuses_a_doubled_backbone_with_its_cause(pair):
    """A fused program that runs the encoder twice is refused with a ``gate_probe/v1``
    cause, and cold frames take the features arm (the encoder program once)."""
    from tmr_tpu_torch.diagnostics import drain_gate_refusals
    from tmr_tpu_torch.serve import gallery as gal

    _, pred, images = pair

    class Doubled(Predictor):
        def _gallery_tail(self, feat, exemplars, k_real, n_real, cap, image_hw):
            extra = self.model.backbone_features(
                torch.zeros((1, image_hw[0], image_hw[1], 3), device=self.device))
            return super()._gallery_tail(feat + 0.0 * extra.sum(), exemplars, k_real,
                                         n_real, cap, image_hw)

    doubled = Doubled(pred.cfg, device="cpu", model=pred.model)
    doubled.weights_set = True
    drain_gate_refusals()
    gal._GATE_CACHE.clear()
    try:
        assert gal.gallery_fused_ok(doubled, 9, 2, 1) is False
        rec = drain_gate_refusals()[-1]
        assert rec["schema"] == "gate_probe/v1" and rec["gate"] == "gallery_fused_ok"
        assert rec["cause"] == "forward-mismatch" and "2x" in rec["message"]
        assert rec["config"] == {"capacity": 9, "n_bucket": 2, "k_bucket": 1,
                                 "image_size": SIZE, "backbone": pred.cfg.backbone}
        bank = gal.GalleryBank(doubled, feature_cache=0)
        bank.register("a", EX[:1])
        bank.register("b", EX[1:2])
        res = bank.search(images[0])
        c = bank.counters
        assert (c["fused_frames"], c["backbone_fills"], c["heads_frames"]) == (0, 1, 1)
        assert res["a"]["valid"].any()
    finally:
        gal._GATE_CACHE.clear()


def test_nloop_fallback_is_counted(pair, monkeypatch):
    """A program that raises falls back to one ``predict_multi_exemplar`` per entry,
    counted, with the N-loop's results."""
    from tmr_tpu_torch.serve import gallery_fused_ok

    _, pred, images = pair
    bank = _bank(pred, feature_cache=0)
    bank.register("a", EX[:1])
    assert gallery_fused_ok(pred, 9, 1, 1)  # the gate's verdict, before the program breaks

    def broken(*a):
        raise RuntimeError("program failed")

    monkeypatch.setattr(pred, "_get_gallery_fn", broken)
    res = bank.search(images[2])
    assert bank.counters["nloop_fallback_frames"] == 1
    _assert_bitwise(res["a"], {k: v.numpy() for k, v in pred.predict_multi_exemplar(
        images[2][None], EX[:1]).items()})


def test_evict_racing_search_serves_snapshot(pair, monkeypatch):
    """An eviction while a search is in flight: the search serves its snapshot, every
    entry it started with and bit for bit; the next search leaves the entry out."""
    _, pred, images = pair
    bank = _bank(pred, feature_cache=0)
    bank.register("keep", EX[:1])
    bank.register("gone", EX[1:2])
    img = images[0]
    before = bank.search(img)
    orig = bank._groups_locked
    taken, evicted = threading.Event(), threading.Event()

    def paused():
        groups = orig()
        taken.set()
        assert evicted.wait(30)
        return groups

    monkeypatch.setattr(bank, "_groups_locked", paused)
    out = {}
    worker = threading.Thread(target=lambda: out.update(res=bank.search(img)),
                              daemon=True)
    worker.start()
    assert taken.wait(30)
    assert bank.evict("gone") is True
    evicted.set()
    worker.join(30)
    assert not worker.is_alive()
    assert set(out["res"]) == {"keep", "gone"}
    for name in ("keep", "gone"):
        _assert_bitwise(out["res"][name], before[name])
    monkeypatch.setattr(bank, "_groups_locked", orig)
    assert set(bank.search(img)) == {"keep"}


def test_engine_search_gallery_shares_its_feature_cache(pair):
    from tmr_tpu_torch.serve import ServeEngine

    _, pred, images = pair
    own = _bank(pred, feature_cache=4)
    with ServeEngine(pred, batch=1, max_wait_ms=5) as engine:
        with pytest.raises(RuntimeError, match="no gallery attached"):
            engine.search_gallery(images[0])
        shared = _bank(pred, feature_cache=engine.feature_cache)
        for bank in (own, shared):
            for i in range(3):
                bank.register(f"p{i}", EX[i:i + 1])
        engine.attach_gallery(shared)
        got = [engine.search_gallery(images[0]) for _ in range(2)]
        want = [own.search(images[0]) for _ in range(2)]
        assert engine.metrics.counter("serve.gallery.searches").value == 2
        assert len(engine.feature_cache) == 1  # the second sighting's fill, shared
        digest = own._feature_key("d", SIZE)
        assert engine._feature_key("d", SIZE) == digest  # the same stamped keys
    for g, w in zip(got, want):
        for name in w:
            _assert_bitwise(g[name], w[name])


def test_lru_cache_pop_keeps_the_byte_count():
    from tmr_tpu_torch.serve.caches import LRUCache

    c = LRUCache(4, max_bytes=100)
    c.put("a", np.zeros(10, np.float32))
    c.put("b", np.zeros(5, np.float32))
    assert c.pop("a") is not None and c.pop("a") is None
    s = c.stats()
    assert (s["bytes"], s["size"], s["evictions"]) == (20, 1, 0)


# ---------------------------------------------------------- the feature sink
def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


FEATS = [("shard_a.tar", "img_001.jpg", np.arange(12, dtype=np.float32).reshape(3, 4)),
         ("shard_a.tar", "img_002.png", np.ones((2, 2), np.float32)),
         ("shard_b.tar", "img_009.jpg", np.full((4, 4, 2), -1.5, np.float32))]


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port", "port_to_port"])
def test_feature_sink_wire_across_packages(direction):
    """``save`` pipelines, ``sync`` acks, ``cleanup`` evicts: a port worker's sinks into
    the JAX server, the JAX sinks into the port's, byte for byte."""
    from tmr_tpu.parallel.elastic import make_feature_sinks as jsinks
    from tmr_tpu.serve.gallery import FeatureSinkServer as JSink

    from tmr_tpu_torch.parallel.mapreduce import make_feature_sinks as psinks
    from tmr_tpu_torch.serve.gallery import FeatureSinkServer as PSink

    server = (JSink if direction == "port_to_jax" else PSink)(max_entries=64)
    make = jsinks if direction == "jax_to_port" else psinks
    host, port = server.start()
    try:
        save, cleanup, sync = make(f"tcp://{host}:{port}")
        for shard, name, arr in FEATS:
            save(shard, name, arr)
        sync("shard_a.tar")
        for shard, name, arr in FEATS:
            got = server.index.get((shard[:-4], name[:-4]))
            assert got.dtype == arr.dtype and got.tobytes() == arr.tobytes()
        c = server.counters()
        assert (c["features"], c["errors"], c["syncs"], c["connections"]) == (3, 0, 1, 1)
        assert c["bytes"] == sum(a.nbytes for _, _, a in FEATS)
        cleanup("shard_a.tar")
        assert server.index.get(("shard_a", "img_001")) is None
        assert server.index.get(("shard_b", "img_009")) is not None
        assert server.counters()["evicted_shards"] == 1
    finally:
        server.close()


def test_feature_sink_sync_fails_a_dirty_connection():
    """A feature the sink cannot index fails the shard's sync; the ack resets the window,
    so a clean retry on the same connection syncs ok."""
    from tmr_tpu_torch.parallel.leases import recv_line, send_line
    from tmr_tpu_torch.serve.fleet import pack_array
    from tmr_tpu_torch.serve.gallery import FeatureSinkServer

    sink = FeatureSinkServer(max_entries=8)
    host, port = sink.start()
    try:
        with socket.create_connection((host, port), timeout=5) as s:
            f = s.makefile("rb")
            send_line(s, {"op": "hello", "worker": "t"})
            assert recv_line(f)["ok"]
            send_line(s, {"op": "feature", "shard": "x", "name": "bad",
                          "array": {"b64": "!!!", "dtype": "float32", "shape": [1]}})
            send_line(s, {"op": "sync", "shard": "x"})
            reply = recv_line(f)
            assert reply["ok"] is False and reply["errors"] == 1
            send_line(s, {"op": "feature", "shard": "x", "name": "good",
                          "array": pack_array(np.ones((2,), np.float32))})
            send_line(s, {"op": "sync", "shard": "x"})
            retry = recv_line(f)
            assert retry["ok"] is True and retry["errors"] == 0 and retry["features"] == 1
            send_line(s, {"op": "nope"})
            assert recv_line(f) == {"ok": False, "error": "unknown op 'nope'"}
            send_line(s, {"op": "bye"})
            assert recv_line(f)["ok"] is True
    finally:
        sink.close()
    assert sink.counters()["errors"] == 1


def test_network_sink_sync_raises_on_a_dirty_ack():
    """The client half: a sink that fails a feature makes ``sync`` raise (the retry then
    dials afresh)."""
    from tmr_tpu_torch.parallel.mapreduce import make_feature_sinks
    from tmr_tpu_torch.serve.gallery import FeatureSinkServer

    def refuse(shard, name, arr):
        raise OSError("index full")

    sink = FeatureSinkServer(on_feature=refuse)
    host, port = sink.start()
    try:
        save, _, sync = make_feature_sinks(f"tcp://{host}:{port}")
        save("s.tar", "a.png", np.zeros(3, np.float32))
        with pytest.raises(ConnectionError, match="1 failed features"):
            sync("s.tar")
        save("s.tar", "a.png", np.zeros(3, np.float32))  # a fresh dial, then fine
        with pytest.raises(ConnectionError):
            sync("s.tar")
        assert sink.counters()["connections"] == 2
    finally:
        sink.close()


def test_feature_sink_truncated_frame_counts_a_link_error():
    from tmr_tpu_torch.parallel.leases import recv_line, send_line
    from tmr_tpu_torch.serve.gallery import FeatureSinkServer

    sink = FeatureSinkServer(max_entries=8)
    host, port = sink.start()
    try:
        dirty = socket.create_connection((host, port), timeout=5)
        dirty.sendall(b'{"op": "hello", "worker": "t"')  # no newline, then gone
        dirty.close()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and sink.counters()["link_errors"] < 1:
            time.sleep(0.02)
        assert sink.counters()["link_errors"] == 1
        with socket.create_connection((host, port), timeout=5) as s:
            f = s.makefile("rb")
            send_line(s, {"op": "hello", "worker": "t2"})
            assert recv_line(f)["ok"] is True
            send_line(s, {"op": "bye"})
            assert recv_line(f)["ok"] is True
    finally:
        sink.close()
    assert sink.counters()["link_errors"] == 1


def test_network_sink_on_a_dead_address_raises_for_retry():
    from tmr_tpu_torch.parallel.mapreduce import make_feature_sinks

    save, cleanup, sync = make_feature_sinks(f"tcp://127.0.0.1:{_free_port()}")
    for call in (lambda: save("shard.tar", "img.jpg", np.zeros(3, np.float32)),
                 lambda: sync("shard.tar"), lambda: cleanup("shard.tar")):
        with pytest.raises(ConnectionError, match="unreachable"):
            call()
    for bad in ("tcp://nope", "tcp://:80", "tcp://host:port"):
        with pytest.raises(ValueError, match="tcp://host:port"):
            make_feature_sinks(bad)


def test_wire_helpers_match_jax():
    from tmr_tpu.serve.fleet import pack_array as jpack
    from tmr_tpu.serve.fleet import unpack_array as junpack

    from tmr_tpu_torch.serve.fleet import pack_array, unpack_array

    for arr in (np.arange(6, dtype=np.int32).reshape(2, 3), np.ones((0, 4), np.float32),
                np.asfortranarray(np.random.default_rng(0).standard_normal((3, 5)))):
        assert pack_array(arr) == jpack(arr)
        back = unpack_array(jpack(arr))
        assert back.flags.writeable and np.array_equal(back, junpack(pack_array(arr)))
