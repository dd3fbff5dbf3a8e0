"""Demo of the PyTorch port: track one object through a directory of frames.

Counterpart of ``tools/demo.py``: init from a box on the first frame, track
every later frame, and with ``--out-dir`` write each frame with the mask and
its rotated box (or, box only, the box) drawn on it::

    python -m siammask_tpu_torch.tools.demo --config experiments/siammask_sharp/config_davis.json \\
        --resume SiamMask_DAVIS.pth --base-path frames/ --box 300,110,165,250 --out-dir out/

The config's arch picks the path: SiamMask-sharp tracks with Refine,
SiamMask-base with its 63x63 masks, SiamRPN (or ``--box-only``) the box.
Weights and devices as ``tools/test.py``: ``--resume`` loads a reference
``.pth``, else seeded random weights; ``--device`` is ``cuda`` by default.
``main(argv)`` returns the frame count and the tracked frames/s.
"""
from __future__ import annotations

import argparse
import time
from glob import glob
from os import makedirs
from os.path import join

import numpy as np
import torch

from siammask_tpu_torch.config import Config
from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp
from siammask_tpu_torch.tools.test import load_model
from siammask_tpu_torch.tracker.runtime import TrackerRuntime


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="SiamMask demo (PyTorch port)")
    parser.add_argument("--config", required=True)
    parser.add_argument("--resume", default=None, help="a reference .pth checkpoint")
    parser.add_argument("--base-path", required=True, help="a directory of .jpg frames")
    parser.add_argument("--box", default="300,110,165,250", help="x,y,w,h init box (frame 0)")
    parser.add_argument("--out-dir", default=None, help="write the drawn frames here")
    parser.add_argument("--box-only", action="store_true", help="the box path, no mask")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    import cv2

    args = parse_args(argv)
    device = torch.device(args.device)
    cfg = Config.load(args.config)
    model = load_model(cfg.arch, cfg.anchors.anchor_num, args.resume, device)
    mask = not args.box_only and isinstance(model, (SiamMaskBase, SiamMaskSharp))
    runtime = TrackerRuntime(model, cfg.tracker_config(), device, mask=mask,
                             refine=isinstance(model, SiamMaskSharp))

    ims = [cv2.imread(f) for f in sorted(glob(join(args.base_path, "*.jp*")))]
    x, y, w, h = map(int, args.box.split(","))
    if args.out_dir:
        makedirs(args.out_dir, exist_ok=True)
    warm = toc = 0.0
    for f, im in enumerate(ims):
        tic = time.perf_counter()
        if f == 0:
            runtime.init(im, np.array([x + w / 2, y + h / 2]), np.array([w, h]))
        else:
            out = runtime.track(im, soft_mask=False)
        # the first init and step build the kernels and pick the conv
        # algorithms: timed apart, as the reference's per-video speed
        if f <= 1:
            warm += time.perf_counter() - tic
        else:
            toc += time.perf_counter() - tic
        if args.out_dir and f > 0:
            shown = im.copy()
            if mask:
                on = out["mask_bin"].astype(bool)
                shown[:, :, 2] = on * 255 + (1 - on) * shown[:, :, 2]
                poly = np.asarray(out["polygon"], np.float64)
                if np.all(np.isfinite(poly)):
                    cv2.polylines(shown, [np.intp(poly).reshape(-1, 1, 2)], True, (0, 255, 0), 3)
            else:
                x0, y0 = out["target_pos"] - out["target_sz"] / 2
                x1, y1 = out["target_pos"] + out["target_sz"] / 2
                cv2.rectangle(shown, (int(x0), int(y0)), (int(x1), int(y1)), (0, 255, 0), 3)
            cv2.imwrite(join(args.out_dir, f"{f:05d}.jpg"), shown)

    tracked = max(len(ims) - 2, 0)
    fps = tracked / max(toc, 1e-9)
    print(f"SiamMask demo: {len(ims)} frames, init and first step {warm:.1f}s, "
          f"tracked {tracked} frames in {toc:.2f}s ({fps:.1f} fps)")
    return {"frames": len(ims), "fps": fps}


if __name__ == "__main__":
    main()
