"""The metric-parity harness's weights and mask path, the card against the CPU.

Run on a machine with a CUDA card; everything runs in one process:

1. Seed 0's SiamMask-sharp is tempered (``metric_parity.temper``) from the
   same initial weights on the card and on the CPU. Printed: the largest
   relative difference of the two (max |card - cpu| / max |cpu| a tensor),
   the tensors it is largest in, and ``refine_model.post2.bias`` on each.
2. The VOS pseudo-gt pass of ``make_benchmark`` (no resets, the clip
   forward, masks over ``seg_thr``) for each weights file on each device:
   the mean mask area a frame, and the mean per-frame IoU of the masks
   between runs.
3. ``metric_parity --make-benchmark`` in mask-polygon mode with VOS on the
   card, then the same in float32 on the CPU with ``--benchmark`` on that
   directory (so the card's weights and pseudo-gt) and ``--compare`` to the
   card's tree: EAO/A/lost, J/F and the protocol decisions of both.

First it prints what the weights and the benchmark are made from, so that
two machines can be told apart: the library versions, an md5 of the clip's
JPEG files, of their decoded frames and of seed 0's initial weights.

Usage::

    python scripts/metric_parity_devices.py --frames 70 --work-dir build/mp_devices \\
        --json-out chiprun_out/mp_devices.json
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from os.path import dirname, exists, join, realpath
from pathlib import Path

REPO = dirname(dirname(realpath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from siammask_tpu_torch.tools import metric_parity as mp  # noqa: E402
from siammask_tpu_torch.tools.overfit import N_FRAMES, write_overfit_clip  # noqa: E402
from siammask_tpu_torch.tracker.runtime import TrackerRuntime  # noqa: E402
from siammask_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402


def fingerprint(clip: str, frames: int, width: int) -> dict:
    """Versions, and md5s of the clip's files, decoded frames and seed 0's
    initial weights: the inputs of the tempering and of the benchmark."""
    import cv2

    files = [Path(clip) / f"{i:05d}.jpg" for i in range(frames)]
    state = mp.SiamMaskSharp(width=width).init_weights(
        torch.Generator().manual_seed(mp.SEED)).state_dict()
    return {"torch": torch.__version__, "numpy": np.__version__, "cv2": cv2.__version__,
            "clip_files_md5": hashlib.md5(b"".join(f.read_bytes() for f in files)).hexdigest(),
            "clip_frames_md5": hashlib.md5(b"".join(
                im.tobytes() for im in mp.read_clip(clip, frames))).hexdigest(),
            "init_weights_md5": hashlib.md5(b"".join(
                state[k].numpy().tobytes() for k in sorted(state))).hexdigest()}


def weight_difference(a: dict, b: dict) -> dict:
    """max |a - b| / max |b| of each floating tensor: the largest, and the
    five tensors with the largest."""
    rel = {k: float((a[k].double() - b[k].double()).abs().max()
                    / b[k].double().abs().max().clamp_min(1e-30))
           for k in b if b[k].is_floating_point()}
    top = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    return {"max_rel": top[0][1], "top": dict(top)}


def vos_masks(weights: str, width: int, device: str, images) -> list[np.ndarray]:
    model = mp.load_model(weights, width, device)
    runtime = TrackerRuntime(model, mp.tracker_config(), device)
    return mp.noreset_run(runtime, images, *mp.init_box(0), want_masks=True)[1][1:]


def mask_iou(a: list[np.ndarray], b: list[np.ndarray]) -> float:
    return float(np.mean([(x & y).sum() / max((x | y).sum(), 1) for x, y in zip(a, b)]))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=N_FRAMES)
    parser.add_argument("--width", type=int, default=64)
    parser.add_argument("--work-dir", default="build/mp_devices")
    parser.add_argument("--json-out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("metric_parity_devices: needs a CUDA card")
    work, out = args.work_dir, {}
    os.makedirs(work, exist_ok=True)
    clip = join(work, "clip")
    if not exists(join(clip, f"{N_FRAMES - 1:05d}.jpg")):
        write_overfit_clip(Path(clip))
    images = mp.read_clip(clip, args.frames)
    out["fingerprint"] = fingerprint(clip, args.frames, args.width)
    print("fingerprint:", json.dumps(out["fingerprint"]), flush=True)
    anchor_cfg = mp.tracker_config().anchor_config().to_dict()

    weights, states = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = mp.tempered_model(images[0], args.width, device)
        states[device] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        weights[device] = join(work, f"tempered_{device}.pth")
        save_checkpoint(weights[device], states[device], arch="Custom", anchor_cfg=anchor_cfg)
        print(f"tempered on {device} in {time.perf_counter() - t0:.1f} s", flush=True)
    out["weights"] = weight_difference(states["cuda"], states["cpu"])
    out["post2_bias"] = {d: states[d]["refine_model.post2.bias"].tolist() for d in states}
    print("weights:", json.dumps(out["weights"]), "post2.bias:", out["post2_bias"], flush=True)

    masks, areas = {}, {}
    for w in ("cuda", "cpu"):
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            masks[w, device] = vos_masks(weights[w], args.width, device, images)
            areas[f"{w}_weights_on_{device}"] = float(np.mean([m.sum() for m in masks[w, device]]))
            print(f"VOS pseudo-gt pass, {w}'s weights on {device}: mean mask area "
                  f"{areas[f'{w}_weights_on_{device}']:.1f} px, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    out["mask_area"] = areas
    out["mask_iou"] = {
        "card_weights_card_vs_cpu": mask_iou(masks["cuda", "cuda"], masks["cuda", "cpu"]),
        "cpu_weights_card_vs_cpu": mask_iou(masks["cpu", "cuda"], masks["cpu", "cpu"]),
        "on_card_card_weights_vs_cpu_weights": mask_iou(masks["cuda", "cuda"],
                                                        masks["cpu", "cuda"]),
        "on_cpu_card_weights_vs_cpu_weights": mask_iou(masks["cuda", "cpu"],
                                                       masks["cpu", "cpu"])}
    print("mask IoU:", json.dumps(out["mask_iou"]), flush=True)

    mp_work = join(work, "tool")
    common = ["--work-dir", mp_work, "--frames", str(args.frames), "--width", str(args.width)]
    t0 = time.perf_counter()
    card = mp.run(mp.parse_args(["--make-benchmark", "--tracker-name", "card", *common]),
                  log=lambda *_: None)
    cpu = mp.run(mp.parse_args(["--benchmark", join(mp_work, "benchmark"), "--device", "cpu",
                                "--tracker-name", "cpu",
                                "--compare", join(mp_work, "results", "VOT2018", "card"),
                                *common]), log=lambda *_: None)
    out["mask_mode"] = {"card": card["scores"], "cpu": cpu["scores"],
                        "compare": cpu["compare"], "seconds": time.perf_counter() - t0}
    print("mask-polygon and VOS, the card's weights and benchmark, card against CPU:",
          json.dumps(out["mask_mode"]), flush=True)
    out["settings"] = {"frames": args.frames, "width": args.width,
                       "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                               "--format=csv,noheader"], capture_output=True,
                                              text=True).stdout.strip()}
    text = json.dumps(out, indent=1)
    if args.json_out:
        os.makedirs(dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            f.write(text)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
