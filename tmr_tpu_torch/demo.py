"""Interactive few-shot detection demo (counterpart of the JAX package's ``demo.py``;
reference demo.py).

Give 1-3 exemplar boxes on an image; the detector finds every other instance of the
pattern. :class:`DemoEngine` is the headless pipeline (resize and normalize, the
encoder once and a decode per exemplar through ``Predictor.predict_multi_exemplar``,
optional SAM box refinement, one union NMS, boxes drawn on a <= 1024-wide copy); the
gradio shell is optional around it, as in the JAX file.

As in the reference demo (demo.py:28-35), the defaults differ from the eval scripts:
NMS_cls_threshold 0.7, NMS_iou_threshold 0.5, pos/neg 0.5, fusion.

``--device`` defaults to the GPU and raises without one; ``--device cpu`` runs the plain
CPU versions. ``--ckpt`` reads what the port's ``main`` writes and reads: a
``CheckpointManager`` directory (resolved through its ``ckpt_meta.json`` to the best
version), a training ``logpath``, or a reference Lightning ``.ckpt``. The JAX package's
orbax directories are not read (ROADMAP A4). Nothing here needs cv2: the resize is
``data/transforms.resize_linear_u8`` (cv2's ``INTER_LINEAR``) and the rectangles are
cv2's 2-pixel ones drawn in numpy; the PNG is written with zlib.

Usage:
  python -m tmr_tpu_torch.demo --ckpt outputs/FSCD147/checkpoints [--backbone sam_vit_b]
      [--device cuda] [--share]
  # headless single shot:
  python -m tmr_tpu_torch.demo --image img.png --exemplar 100,120,180,200 --out pred.png
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

#: the drawn boxes' colour (RGB), as the JAX demo draws them
BOX_COLOR = (255, 0, 0)


def draw_rectangle(img: np.ndarray, pt1, pt2, color) -> np.ndarray:
    """``cv2.rectangle(img, pt1, pt2, color, thickness=2)`` in numpy: each edge 3 pixels
    wide, centred on it, with round caps of radius 1 (the outermost pixel of each corner
    stays unpainted), clipped to the image. Draws in place and returns ``img``."""
    h, w = img.shape[:2]
    x0, x1 = sorted((int(pt1[0]), int(pt2[0])))
    y0, y1 = sorted((int(pt1[1]), int(pt2[1])))
    ys = np.arange(max(y0 - 1, 0), min(y1 + 2, h))
    xs = np.arange(max(x0 - 1, 0), min(x1 + 2, w))
    if not ys.size or not xs.size:
        return img
    yy, xx = ys[:, None], xs[None, :]
    inner = (yy >= y0 + 2) & (yy <= y1 - 2) & (xx >= x0 + 2) & (xx <= x1 - 2)
    corner = (((yy == y0 - 1) | (yy == y1 + 1)) & ((xx == x0 - 1) | (xx == x1 + 1)))
    paint = ~(inner | corner)
    region = img[ys[0]:ys[-1] + 1, xs[0]:xs[-1] + 1]
    region[paint] = color
    return img


def draw_boxes(image_rgb: np.ndarray, boxes_norm: np.ndarray,
               max_width: int = 1024) -> np.ndarray:
    """The JAX ``draw_boxes`` (demo.py:137-150): the image resized to ``max_width``
    wide (cv2's ``INTER_LINEAR``), each normalized xyxy box of ``boxes_norm`` (N, 4)
    drawn as a 2-pixel red rectangle. Returns the (H', W', 3) uint8 pixels (the JAX
    function's PIL image as an array)."""
    from tmr_tpu_torch.data.transforms import resize_linear_u8

    img = np.asarray(image_rgb)[..., :3]
    h, w = img.shape[:2]
    r = max_width / w
    img = resize_linear_u8(np.ascontiguousarray(img), int(h * r), int(w * r))
    for x1, y1, x2, y2 in np.asarray(boxes_norm).reshape(-1, 4):
        draw_rectangle(img, (int(x1 * w * r), int(y1 * h * r)),
                       (int(x2 * w * r), int(y2 * h * r)), BOX_COLOR)
    return img


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit RGB PNG of ``img`` (zlib, no image library)."""
    from tmr_tpu_torch.chaos_probe import png_bytes

    with open(path, "wb") as f:
        f.write(png_bytes(np.ascontiguousarray(img, np.uint8)))


class DemoEngine:
    """The headless demo pipeline: an image and pixel exemplar boxes -> detections and
    their drawing (the reference ``Inference`` module, demo.py:53-150, without gradio).
    ``params``: a flax tree (through ``params_from_jax``) or the port's ``state_dict``;
    ``device``: None = the GPU, or ``"cpu"``."""

    def __init__(self, cfg, params=None, model=None, refiner=None, device=None):
        from tmr_tpu_torch.inference import Predictor

        self.cfg = cfg
        self.predictor = Predictor(cfg, device=device, model=model, refiner=refiner)
        if params is not None:
            if any(isinstance(v, dict) for v in params.values()):
                self.predictor.load_jax_params(params)
            else:
                self.predictor.load_state_dict(params)

    def attach_refiner(self, checkpoint: str = None, seed: int = 0):
        """Build the SAM box refiner once: with ``checkpoint`` its weights come from the
        SAM ``.pth``, else seeded random weights (a smoke run)."""
        from tmr_tpu_torch.refine import build_refiner

        cfg = dataclasses.replace(self.cfg, refiner_checkpoint=checkpoint)
        self.predictor.refiner = build_refiner(cfg, seed=seed,
                                               device=self.predictor.device)

    def init_params(self, seed: int = 0):
        self.predictor.init_params(seed)

    def load_checkpoint(self, path: str):
        """The model's weights from ``path``: a ``CheckpointManager`` directory (its
        ``ckpt_meta.json`` names the best version; ``last.ckpt``'s model when there is
        none yet), a ``logpath`` holding ``best_model*.ckpt`` (the highest version), or a
        Lightning ``.ckpt`` file. The optimizer state is not read."""
        import torch

        from tmr_tpu_torch.utils.checkpoint import best_checkpoint, best_name
        from tmr_tpu_torch.utils.convert import load_matching_net

        path = os.path.abspath(path)
        if os.path.isdir(path):
            meta_path = os.path.join(path, "ckpt_meta.json")
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    v = json.load(f).get("best_version", -1)
                if v < 0:
                    state = torch.load(os.path.join(path, "last.ckpt"), map_location="cpu",
                                       weights_only=True)
                    self.predictor.load_state_dict(state["model"])
                    return
                path = os.path.join(path, best_name(v))
            else:
                best = best_checkpoint(path)
                if best is None:
                    raise FileNotFoundError(
                        f"{path}: no ckpt_meta.json and no best_model*.ckpt (orbax "
                        "directories of the JAX package are not read)")
                path = best
        self.predictor.load_state_dict(load_matching_net(path))

    def infer(self, image_rgb: np.ndarray, exemplars_px, refine: bool = False):
        """image_rgb (H, W, 3) uint8; exemplars_px (K, 4) pixel xyxy. Returns (the
        drawing (H', W', 3) uint8, boxes_norm (N, 4), scores (N,)): a decode per exemplar
        and one union NMS (demo.py:111-130) through ``predict_multi_exemplar``."""
        from tmr_tpu_torch.data.transforms import resize_normalize

        h, w = np.asarray(image_rgb).shape[:2]
        scale = np.array([w, h, w, h], np.float32)
        ex_norm = np.asarray(exemplars_px, np.float32).reshape(-1, 4) / scale
        x = resize_normalize(image_rgb, self.cfg.image_size)[None]
        self.cfg.refine_box = bool(refine) and self.predictor.refiner is not None
        dets = self.predictor.predict_multi_exemplar(x, ex_norm)
        valid = dets["valid"][0].cpu().numpy()
        boxes = dets["boxes"][0].cpu().numpy()[valid]
        scores = dets["scores"][0].cpu().numpy()[valid]
        return draw_boxes(image_rgb, boxes), boxes, scores


def demo_config(args):
    from tmr_tpu_torch.config import Config

    return Config(
        backbone=args.backbone, emb_dim=512, fusion=True, template_type="roi_align",
        feature_upsample=True, positive_threshold=0.5, negative_threshold=0.5,
        NMS_cls_threshold=args.NMS_cls_threshold,
        NMS_iou_threshold=args.NMS_iou_threshold, image_size=args.image_size)


def launch_gradio(engine: "DemoEngine", share: bool = False):
    """The gradio Blocks shell (demo.py:152-195). gradio is optional: without it this
    raises ``SystemExit`` with the headless instructions."""
    try:
        import gradio as gr
    except ImportError as e:
        raise SystemExit(
            "gradio is not installed in this environment. Use the headless mode "
            "instead:\n  python -m tmr_tpu_torch.demo --image img.png "
            "--exemplar x1,y1,x2,y2 --out pred.png") from e

    def run(image, boxes_text, refine):
        if image is None:
            return None, "upload an image first"
        try:
            ex = [[float(v) for v in line.replace(",", " ").split()]
                  for line in boxes_text.strip().splitlines() if line.strip()]
            if not ex or any(len(b) != 4 for b in ex):
                return None, ("give 1-3 exemplar boxes as `x1,y1,x2,y2` pixel coords, "
                              "one per line")
        except ValueError:
            return None, "could not parse the exemplar boxes"
        pred, boxes, _ = engine.infer(np.asarray(image), ex, refine)
        return pred, f"{len(boxes)} detections"

    with gr.Blocks(title="TMR Few-Shot Pattern Detection") as app:
        gr.Markdown("# Few-Shot Pattern Detection\nUpload an image, give 1-3 exemplar "
                    "boxes (`x1,y1,x2,y2` pixels, one per line), run.")
        with gr.Row():
            inp = gr.Image(type="numpy", label="Query image")
            out = gr.Image(type="numpy", label="Prediction")
        boxes_text = gr.Textbox(label="Exemplar boxes (px)", placeholder="100,120,180,200")
        refine = gr.Checkbox(label="SAM box refinement", value=False)
        count = gr.Textbox(label="Count")
        gr.Button("Run").click(run, [inp, boxes_text, refine], [out, count])
    app.launch(share=share)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", default=None,
                   help="a CheckpointManager directory, a logpath or a Lightning .ckpt")
    p.add_argument("--backbone", default="sam_vit_b")
    p.add_argument("--image_size", default=1024, type=int)
    # demo defaults intentionally differ from eval scripts (demo.py:28-35)
    p.add_argument("--NMS_cls_threshold", default=0.7, type=float)
    p.add_argument("--NMS_iou_threshold", default=0.5, type=float)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a GPU) or cpu")
    p.add_argument("--share", action="store_true")
    p.add_argument("--refine_box", action="store_true",
                   help="enable SAM box refinement (builds the refiner; give "
                        "--refiner_checkpoint for real weights)")
    p.add_argument("--refiner_checkpoint", default=None)
    # headless mode
    p.add_argument("--image", default=None, help="run once on this image")
    p.add_argument("--exemplar", action="append", default=None,
                   help="x1,y1,x2,y2 pixel box (repeatable)")
    p.add_argument("--out", default="prediction.png")
    args = p.parse_args(argv)

    engine = DemoEngine(demo_config(args), device=args.device)
    if args.ckpt:
        engine.load_checkpoint(args.ckpt)
    else:
        print("no --ckpt: running with random weights (smoke mode)")
        engine.init_params()
    if args.refine_box:
        engine.attach_refiner(args.refiner_checkpoint)

    if args.image:
        from tmr_tpu_torch.data.transforms import decode_image

        ex = [[float(v) for v in e.split(",")] for e in (args.exemplar or [])]
        if not ex:
            raise SystemExit("--image needs at least one --exemplar")
        with open(args.image, "rb") as f:
            img = decode_image(f.read())
        pred, boxes, _ = engine.infer(img, ex, refine=args.refine_box)
        write_png(args.out, pred)
        print(f"{len(boxes)} detections -> {args.out}")
        return

    launch_gradio(engine, share=args.share)


if __name__ == "__main__":
    main()
