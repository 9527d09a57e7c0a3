"""The demo in the port (``python -m tmr_tpu_torch.demo``) against the JAX package's
``demo.py`` on the CPU: ``draw_boxes`` (cv2's ``INTER_LINEAR`` resize and 2-pixel
rectangles, written in numpy) bit for bit on seeded boxes that cross the border, and
``DemoEngine.infer`` on ``tests/test_demo.py``'s small config (``resnet50_layer1``, emb 16,
64 px, f32) with the same count and boxes within 1e-4 (f32 sums in another order through
the ResNet); the headless CLI with ``--device cpu`` and its refusal of the CPU without
it, ``--ckpt`` on a ``CheckpointManager`` directory, and gradio missing."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402

import demo as jdemo  # noqa: E402
from tmr_tpu.config import Config as JConfig  # noqa: E402
from tmr_tpu_torch import demo  # noqa: E402
from tmr_tpu_torch.config import Config  # noqa: E402

SMALL = dict(backbone="resnet50_layer1", emb_dim=16, fusion=True, template_type="roi_align",
             feature_upsample=False, image_size=64, NMS_cls_threshold=0.3,
             NMS_iou_threshold=0.5, compute_dtype="float32", max_detections=64,
             template_buckets=(5, 9))
#: a 96 x 128 query and two exemplars, pixel xyxy
EXEMPLARS_PX = [[32, 24, 64, 48], [70, 40, 100, 70]]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def engines():
    """The JAX ``DemoEngine`` on ``init_params(0)`` with the objectness head scaled up
    (flax's near-flat maps leave their peaks to last-ulp ties), and the port's on the
    same weights."""
    je = jdemo.DemoEngine(JConfig(**SMALL))
    je.init_params(seed=0)
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), je.predictor.params)
    params["objectness_head_0"]["conv"]["kernel"] *= 300.0
    je.predictor.params = params
    return je, demo.DemoEngine(Config(**SMALL), params=params, device="cpu")


def _image(seed, hw=(96, 128)):
    img = np.random.default_rng(seed).integers(0, 60, hw + (3,), dtype=np.uint8)
    for x1, y1, x2, y2 in EXEMPLARS_PX:
        img[y1:y2, x1:x2] = 200
    img[10:34, 90:120] = 200
    return img


# ------------------------------------------------------------------ drawing
@pytest.mark.parametrize("seed", range(4))
def test_draw_rectangle_matches_cv2(seed):
    """cv2's thickness-2 rectangle: each edge 3 pixels wide about it, round caps of
    radius 1; corners in any order, degenerate boxes, boxes past every border."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        h, w = rng.integers(5, 60, 2)
        p1, p2 = ((int(rng.integers(-20, w + 20)), int(rng.integers(-20, h + 20)))
                  for _ in range(2))
        if rng.uniform() < 0.2:
            p2 = (p1[0] + int(rng.integers(0, 2)), p1[1] + int(rng.integers(0, 2)))
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        want = cv2.rectangle(img.copy(), p1, p2, (255, 0, 0), 2)
        got = demo.draw_rectangle(img.copy(), p1, p2, (255, 0, 0))
        assert np.array_equal(got, want), (h, w, p1, p2)


@pytest.mark.parametrize("max_width", [64, 200, 1024, 128])
def test_draw_boxes_matches_jax(max_width):
    """Against the JAX ``draw_boxes`` (cv2) on seeded boxes, some crossing the border,
    down-, up- and no resize (128 is the image's width)."""
    rng = np.random.default_rng(max_width)
    for _ in range(5):
        img = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
        xy = rng.uniform(-0.3, 1.1, (6, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(-0.05, 0.6, (6, 2))], 1).astype(
            np.float32)
        want = np.asarray(jdemo.draw_boxes(img, boxes, max_width=max_width))
        got = demo.draw_boxes(img, boxes, max_width=max_width)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want)


def test_draw_boxes_geometry():
    """The JAX case: resized by 200 / 100, red edges at the scaled coordinates."""
    arr = demo.draw_boxes(np.zeros((50, 100, 3), np.uint8),
                          np.array([[0.25, 0.2, 0.75, 0.8]]), max_width=200)
    assert arr.shape == (100, 200, 3)
    assert arr[20:80, 50, 0].max() == 255 and arr[40, 50:150, 0].max() == 255


# ------------------------------------------------------------------ engine
def test_engine_infer_matches_jax(engines):
    je, pe = engines
    img = _image(0)
    jpred, jboxes, jscores = je.infer(img, EXEMPLARS_PX)
    pred, boxes, scores = pe.infer(img, EXEMPLARS_PX)
    assert len(boxes) == len(jboxes) > 0
    np.testing.assert_allclose(boxes, jboxes, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(scores, jscores, rtol=1e-4, atol=1e-4)
    assert pred.shape == (768, 1024, 3)
    assert np.array_equal(pred, np.asarray(jdemo.draw_boxes(img, boxes)))


def test_engine_infer_is_predict_multi_exemplar(engines):
    from tmr_tpu_torch.data.transforms import resize_normalize

    _, pe = engines
    img = _image(1, (64, 64))
    _, boxes, scores = pe.infer(img, EXEMPLARS_PX[:1])
    ex = np.asarray(EXEMPLARS_PX[:1], np.float32) / 64
    dets = pe.predictor.predict_multi_exemplar(resize_normalize(img, 64)[None], ex)
    v = dets["valid"][0].numpy()
    assert np.array_equal(dets["boxes"][0].numpy()[v], boxes)
    assert np.array_equal(dets["scores"][0].numpy()[v], scores)


def test_engine_refine_path():
    """``attach_refiner`` (seeded random weights) wires the refiner in; ``refine=False``
    after it runs the unrefined program again."""
    pe = demo.DemoEngine(Config(**SMALL), device="cpu")
    pe.init_params(0)
    img = _image(5, (64, 64))
    _, plain, _ = pe.infer(img, EXEMPLARS_PX[:1])
    pe.attach_refiner(seed=0)
    _, refined, scores = pe.infer(img, EXEMPLARS_PX[:1], refine=True)
    assert pe.cfg.refine_box and len(scores) == len(refined)
    _, again, _ = pe.infer(img, EXEMPLARS_PX[:1], refine=False)
    assert not pe.cfg.refine_box and np.array_equal(again, plain)


def test_load_checkpoint_reads_a_checkpoint_manager_directory(tmp_path):
    """The best version named by ``ckpt_meta.json``; before any best, ``last.ckpt``'s
    model; a ``logpath`` of ``best_model*.ckpt``; and a Lightning file itself."""
    from tmr_tpu_torch.utils.checkpoint import CheckpointManager

    src = demo.DemoEngine(Config(**SMALL), device="cpu")
    src.init_params(3)
    want = src.predictor.model.state_dict()
    state = types.SimpleNamespace(model=src.predictor.model, step=0,
                                  state_dict=lambda: {"model": want})
    ckdir = tmp_path / "logs" / "checkpoints"
    mgr = CheckpointManager(str(ckdir))
    mgr.save_epoch(state, 0, {})  # no metric: last.ckpt only, best_version -1
    for path in (ckdir,):
        e = demo.DemoEngine(Config(**SMALL), device="cpu")
        e.load_checkpoint(str(path))
        got = e.predictor.model.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
    mgr.save_epoch(state, 0, {"val/AP": 0.5})
    for path in (ckdir, tmp_path / "logs", ckdir / "best_model.ckpt"):
        e = demo.DemoEngine(Config(**SMALL), device="cpu")
        e.load_checkpoint(str(path))
        got = e.predictor.model.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), path
    with pytest.raises(FileNotFoundError, match="orbax"):
        demo.DemoEngine(Config(**SMALL), device="cpu").load_checkpoint(str(tmp_path))


# --------------------------------------------------------------------- CLI
def _png(tmp_path, img):
    path = tmp_path / "q.png"
    demo.write_png(str(path), img)
    return path


def test_cli_headless_on_the_cpu(tmp_path, capsys):
    from tmr_tpu_torch.data.transforms import decode_image

    img = _image(2)
    q = _png(tmp_path, img)
    assert np.array_equal(decode_image(q.read_bytes()), img)
    argv = ["--image", str(q), "--out", str(tmp_path / "p.png"), "--device", "cpu",
            "--backbone", "resnet50_layer1", "--image_size", "64"]
    argv += [a for e in EXEMPLARS_PX for a in ("--exemplar", ",".join(map(str, e)))]
    demo.main(argv)
    out = capsys.readouterr().out
    assert "no --ckpt: running with random weights" in out
    n = int(out.strip().splitlines()[-1].split()[0])
    drawn = decode_image((tmp_path / "p.png").read_bytes())
    assert drawn.shape == (768, 1024, 3)
    e = demo.DemoEngine(demo.demo_config(types.SimpleNamespace(
        backbone="resnet50_layer1", image_size=64, NMS_cls_threshold=0.7,
        NMS_iou_threshold=0.5)), device="cpu")
    e.init_params()
    pic, boxes, _ = e.infer(img, EXEMPLARS_PX)
    assert len(boxes) == n and np.array_equal(pic, drawn)
    with pytest.raises(SystemExit, match="at least one --exemplar"):
        demo.main(argv[:8])


def test_cli_refuses_the_cpu_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--image", str(tmp_path / "q.png"), "--exemplar", "1,1,4,4"])


def test_gradio_missing_exits_with_the_headless_instructions(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_gradio(name, *a, **k):
        if name == "gradio":
            raise ImportError("No module named 'gradio'")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_gradio)
    with pytest.raises(SystemExit, match="python -m tmr_tpu_torch.demo --image"):
        demo.launch_gradio(object())
