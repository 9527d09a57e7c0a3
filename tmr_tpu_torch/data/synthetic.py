"""Synthetic FSCD-147-layout fixture (counterpart of ``tmr_tpu/data/synthetic.py``): try
the eval path with no data.

Writes a dataset in the on-disk layout the FSCD-147 reader expects (reference
datamodules/datasets/FSCD147.py: ``images_384_VarV2/`` + ``annotation_FSC147_384.json``
+ ``Train_Test_Val_FSC_147.json`` + ``instances_{split}.json``): images with bright
square objects planted on a dark background, every object annotated as GT and as an
exemplar. The images are the JAX package's draws, written as PNG (lossless) by a small
encoder here, so no image library is needed to write the fixture.

CLI:  python -m tmr_tpu_torch.data.synthetic --out DIR [--n_train 16] [--n_val 4]
      [--image_size 128] [--square 28] [--seed 0]

With ``--eval`` the test split applies the reference's small-object escalation (objects
under 25 px run at the 1536 bucket, ``transforms.pick_image_size``); the CLI's 28-px
objects keep the fixture at its own resolution.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np


def png_bytes(arr: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 RGB array as a PNG file (8-bit truecolour, no filter)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w, _ = arr.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + chunk(b"IEND", b""))


def synthetic_images(n: int, image_size: int = 64, square: int = 10, seed: int = 0):
    """The fixture's images and boxes without files: a list of (uint8 (S, S, 3) image,
    [[x, y, w, h], ...]) with two objects at fixed fractional positions (the JAX
    fixture's draws, in its order)."""
    rng = np.random.default_rng(seed)
    s, h = image_size, square // 2
    centers = [(int(0.25 * s), int(0.25 * s)), (int(0.6875 * s), int(0.625 * s))]
    out = []
    for _ in range(n):
        arr = rng.uniform(0, 40, (s, s, 3)).astype(np.uint8)
        boxes = []
        for cx, cy in centers:
            arr[cy - h:cy + h, cx - h:cx + h] = 220
            boxes.append([cx - h, cy - h, square, square])
        out.append((arr, boxes))
    return out


def write_synthetic_fscd147(root: str, n_train: int = 4, n_val: int = 2,
                            image_size: int = 64, square: int = 10, seed: int = 0) -> list:
    """Write the fixture under ``root``; returns the image names."""
    os.makedirs(f"{root}/annotations", exist_ok=True)
    os.makedirs(f"{root}/images_384_VarV2", exist_ok=True)
    names = [f"im{i}.png" for i in range(n_train + n_val)]
    annos, instances = {}, []
    for i, (name, (arr, boxes)) in enumerate(zip(
            names, synthetic_images(len(names), image_size, square, seed))):
        with open(f"{root}/images_384_VarV2/{name}", "wb") as f:
            f.write(png_bytes(arr))
        annos[name] = {"box_examples_coordinates": [
            [[x, y], [x, y + bh], [x + bw, y + bh], [x + bw, y]] for x, y, bw, bh in boxes]}
        for b in boxes:
            instances.append({"id": len(instances) + 1, "image_id": i, "bbox": b})
    with open(f"{root}/annotations/annotation_FSC147_384.json", "w") as f:
        json.dump(annos, f)
    with open(f"{root}/annotations/Train_Test_Val_FSC_147.json", "w") as f:
        json.dump({"train": names[:n_train], "val": names[n_train:],
                   "test": names[n_train:]}, f)
    inst = {"images": [{"id": i, "file_name": n} for i, n in enumerate(names)],
            "annotations": instances}
    for split in ("train", "val", "test"):
        with open(f"{root}/annotations/instances_{split}.json", "w") as f:
            json.dump(inst, f)
    return names


def main(argv=None):
    import argparse
    import sys

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--n_train", type=int, default=16)
    p.add_argument("--n_val", type=int, default=4)
    p.add_argument("--image_size", type=int, default=128)
    p.add_argument("--square", type=int, default=28)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    names = write_synthetic_fscd147(a.out, a.n_train, a.n_val, a.image_size,
                                    square=a.square, seed=a.seed)
    print(f"wrote {len(names)} images to {a.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
