"""Debug visualizer for the pre-cropped training data (the reference ships
data/{coco,det,vid}/visual.py, ~200 LoC of cv2 overlay loops for eyeballing the
crop pipeline). Reads a crop511 directory + train.json (the tree that
``siammask_tpu_torch.data.prep`` writes) and writes (or shows) overlays: the
annotated bbox drawn on each 511x511 crop, the mask blended in red when a
`.m.png` exists.

Counterpart of ``tools/visualize.py``; cv2 is imported in the functions that
draw, read and write images. Usage:

    python -m siammask_tpu_torch.tools.visualize --root data/coco/crop511 \\
        --anno data/coco/train.json --out-dir /tmp/viz --num 20
"""
from __future__ import annotations

import argparse
import json
import random
from os import makedirs
from os.path import isdir, join

import numpy as np


def overlay(img: np.ndarray, bbox, mask: np.ndarray | None) -> np.ndarray:
    import cv2

    out = img.copy()
    if mask is not None:
        red = np.zeros_like(out)
        red[..., 2] = 255
        m = (mask > 0)[..., None]
        out = np.where(m, (0.5 * out + 0.5 * red).astype(np.uint8), out)
    x1, y1, x2, y2 = [int(round(v)) for v in bbox]
    cv2.rectangle(out, (x1, y1), (x2, y2), (0, 255, 0), 2)
    return out


def main(argv=None) -> int:
    """Returns the number of overlays drawn."""
    import cv2

    parser = argparse.ArgumentParser(description="Visualize cropped train data")
    parser.add_argument("--root", required=True, help="crop511 directory")
    parser.add_argument("--anno", required=True, help="train.json")
    parser.add_argument("--out-dir", default=None,
                        help="write overlays here (default: cv2.imshow)")
    parser.add_argument("--num", type=int, default=20)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    with open(args.anno) as f:
        anno = json.load(f)
    samples = [(video, track, frame, bbox)
               for video, tracks in anno.items()
               for track, frames in tracks.items()
               for frame, bbox in frames.items()]
    random.Random(args.seed).shuffle(samples)

    if args.out_dir and not isdir(args.out_dir):
        makedirs(args.out_dir)

    shown = 0
    for video, track, frame, bbox in samples:
        if shown >= args.num:
            break
        # frame keys may carry a leading number or be zero-padded ints
        fid = int(frame) if str(frame).isdigit() else frame
        stem = join(args.root, video, f"{fid:06d}.{int(track):02d}")
        img = cv2.imread(stem + ".x.jpg")
        if img is None:
            continue
        mask = cv2.imread(stem + ".m.png", cv2.IMREAD_GRAYSCALE)
        out = overlay(img, bbox, mask)
        shown += 1
        if args.out_dir:
            name = f"{video}_{track}_{frame}.jpg".replace("/", "_")
            cv2.imwrite(join(args.out_dir, name), out)
            print("wrote", name)
        else:  # pragma: no cover - interactive path
            cv2.imshow("crop", out)
            cv2.waitKey(0)
    return shown


if __name__ == "__main__":
    main()
