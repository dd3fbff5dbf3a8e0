"""Benchmark test entry point (VOT, DAVIS, YouTube-VOS) of the PyTorch port.

Counterpart of ``tools/test.py``, with the same flags, less the JAX
package's ``--platform``, plus ``--device`` (``cuda`` by default; ``cpu``
runs on the CPU). It runs the reference's test matrix::

    python -m siammask_tpu_torch.tools.test --config experiments/siamrpn_resnet/config.json \\
        --dataset VOT2018 --data-dir data                      # SiamRPN, box only
    python -m siammask_tpu_torch.tools.test --config experiments/siammask_base/config.json \\
        --mask --dataset VOT2018 --data-dir data               # SiamMask-base
    python -m siammask_tpu_torch.tools.test --config experiments/siammask_sharp/config_vot.json \\
        --resume SiamMask_VOT.pth --mask --refine --dataset VOT2018 --data-dir data

``--resume`` loads a reference ``.pth`` (a bare state_dict or a training
checkpoint's ``state_dict``) through ``load_reference_state_dict``; without
it the weights are random, from seed 0. ``--dtype bfloat16`` builds the
model in bf16 compute over float32 parameters (``build_model(dtype=...)``);
``float32`` is the default, with TF32 off (the fp32 reference mode; the
float32 model switches it off as it is built). ``--arch`` is accepted and
ignored, as the JAX package's CLI does: the config's ``arch`` picks the
model. ``main(argv)`` returns the totals.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from siammask_tpu_torch.config import Config
from siammask_tpu_torch.eval.datasets import load_dataset
from siammask_tpu_torch.models.siammask import build_model
from siammask_tpu_torch.tracker.runtime import TrackerRuntime
from siammask_tpu_torch.tracker.vos import track_vos, track_vos_batched
from siammask_tpu_torch.tracker.vot import track_vot
from siammask_tpu_torch.utils.convert import load_reference_state_dict


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Test SiamMask (PyTorch port)")
    parser.add_argument("--config", required=True)
    parser.add_argument("--resume", default=None, help="a reference .pth checkpoint")
    parser.add_argument("--arch", default="Custom",
                        help="ignored, as in the JAX package's CLI: the config's arch "
                             "picks the model")
    parser.add_argument("--mask", action="store_true")
    parser.add_argument("--refine", action="store_true")
    parser.add_argument("--dataset", default="VOT2018")
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--video", default="", help="run one video only")
    parser.add_argument("--video-shard", default="",
                        help="'i/n': only the videos whose index %% n is i (result "
                             "directories of the shards merge)")
    parser.add_argument("--save_mask", action="store_true")
    parser.add_argument("--no-batch", action="store_true",
                        help="the sequential VOS driver, one pass per object")
    parser.add_argument("--scan-chunk", type=int, default=32,
                        help="frames per whole-video window of the batched VOS driver "
                             "(ragged tails step per frame)")
    parser.add_argument("--result-dir", default="test")
    parser.add_argument("--tracker-name", default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="model compute dtype (params stay fp32). float32 "
                             "is the metrics default; bfloat16 trades a "
                             "metric delta for the bench's headline "
                             "throughput: one observation of the port's, on "
                             "tempered random weights on an H100 by "
                             "chip_smoke.py [metric-parity], is in PERF.md §6 "
                             "and README.md")
    return parser.parse_args(argv)


def load_model(arch: str, anchor_num: int, resume: str | None, device: torch.device,
               dtype: torch.dtype = torch.float32):
    """The arch's model in eval mode on ``device``, computing in ``dtype``,
    with the checkpoint's weights or seeded random ones. A float32 model
    switches TF32 off as it is built (``build_model``)."""
    model = build_model(arch, anchor_num, dtype=dtype)
    if resume:
        ckpt = torch.load(resume, map_location="cpu", weights_only=True)
        load_reference_state_dict(model, ckpt.get("state_dict", ckpt))
    else:
        model.init_weights(torch.Generator().manual_seed(0))
    return model.to(device).eval()


def main(argv=None) -> dict:
    """Runs the benchmark; returns {"videos", "lost" (VOT) or "iou" (VOS),
    "fps" (the mean of the videos' speeds)}."""
    args = parse_args(argv)
    device = torch.device(args.device)
    cfg = Config.load(args.config)
    model = load_model(cfg.arch, cfg.anchors.anchor_num, args.resume, device,
                       getattr(torch, args.dtype))
    p = cfg.tracker_config()
    tracker_name = args.tracker_name or (
        cfg.arch + "_" + ("mask_" if args.mask else "") + ("refine_" if args.refine else "")
        + (args.resume.split("/")[-1].split(".")[0] if args.resume else "random"))

    dataset = load_dataset(args.dataset, args.data_dir)
    if args.video:
        dataset = {args.video: dataset[args.video]}
    if args.video_shard:
        i, n = map(int, args.video_shard.split("/"))
        dataset = {name: v for idx, (name, v) in enumerate(sorted(dataset.items()))
                   if idx % n == i}

    runtime = TrackerRuntime(model, p, device, mask=args.mask, refine=args.refine)
    vos_enable = args.dataset.startswith("DAVIS") or args.dataset == "ytb_vos"
    total_lost, ious, speeds = 0, [], []
    for video in dataset.values():
        if vos_enable:
            kw = {} if args.no_batch else {"scan_chunk": args.scan_chunk}
            vos_fn = track_vos if args.no_batch else track_vos_batched
            iou, fps = vos_fn(runtime, video, mot_enable=args.dataset in ("DAVIS2017", "ytb_vos"),
                              result_dir=args.result_dir, dataset=args.dataset,
                              tracker_name=tracker_name, save_mask=args.save_mask, **kw)
            if len(iou) > 0:
                ious.append(np.mean(iou))
        else:
            lost, fps = track_vot(runtime, video, dataset=args.dataset, mask_enable=args.mask,
                                  result_dir=args.result_dir, tracker_name=tracker_name)
            total_lost += lost
        speeds.append(fps)

    totals = {"videos": len(dataset), "fps": float(np.mean(speeds))}
    if vos_enable:
        totals["iou"] = float(np.mean(ious))
        print(f"Mean IoU: {totals['iou']:.4f}  Mean speed: {totals['fps']:.1f}fps")
    else:
        totals["lost"] = total_lost
        print(f"Total lost: {total_lost}  Mean speed: {totals['fps']:.1f}fps")
    return totals


if __name__ == "__main__":
    main()
