"""Training entry point of the PyTorch port: SiamRPN, SiamMask-base, and
SiamMask-sharp end to end or its stage-2 refine training.

Counterpart of ``tools/train.py`` (the reference's ``train_siammask.py``,
``train_siamrpn.py`` and ``train_siammask_refine.py``), with the same flags
less the JAX package's ``--xcorr``, ``--platform``, ``--num-devices``,
``--fused-allreduce``, ``--sync-bn``, ``--remat`` and ``--tb-dir``, plus
``--device`` (``cuda`` by default; ``cpu`` runs on the CPU). The
tensorboard scalars are in the log line. The two-stage recipe::

    python -m siammask_tpu_torch.tools.train --config experiments/siammask_base/config.json \\
        --task base --epochs 20 --batch 64 --save-dir snapshot_base
    python -m siammask_tpu_torch.tools.train --config experiments/siammask_sharp/config.json \\
        --task sharp_refine --epochs 20 --batch 64 --save-dir snapshot_sharp \\
        --pretrained snapshot_base/checkpoint_e20.pth

``--pretrained`` takes a ``.pth``, a checkpoint or a bare state_dict with
the reference names, with or without ``module.``, merged non-strictly (what
it lacks keeps its seeded init); ``--resume`` continues a checkpoint of this
CLI (weights, momentum, epoch). A checkpoint ``checkpoint_e{N}.pth`` is
written after each epoch. On the card TF32 is off (the fp32 reference
mode). ``main(argv)`` returns the last step's metrics.
"""
from __future__ import annotations

import argparse
import logging
import time
from os.path import join

import torch

from siammask_tpu_torch.config import Config
from siammask_tpu_torch.data.dataset import DataLoader, PairDataset, to_device
from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp, SiamRPN
from siammask_tpu_torch.train.checkpoint import (merge_state_dict, read_state_dict,
                                                 save_checkpoint)
from siammask_tpu_torch.train.lr import build_lr_spaces
from siammask_tpu_torch.train.trainer import OptimizerConfig, Trainer, TrainSettings

MODELS = {"siamrpn": SiamRPN, "base": SiamMaskBase, "sharp": SiamMaskSharp,
          "sharp_refine": SiamMaskSharp}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train SiamMask (PyTorch port)")
    parser.add_argument("--config", required=True)
    parser.add_argument("--task", default="base", choices=list(MODELS))
    parser.add_argument("--epochs", type=int, default=20)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--workers", type=int, default=16)
    parser.add_argument("--workers-mode", default="thread", choices=["thread", "process"],
                        help="loader item workers: threads (cv2 releases the GIL) or "
                             "forked processes (numpy and cv2 only)")
    parser.add_argument("--clip", type=float, default=10.0)
    parser.add_argument("--width", type=int, default=64,
                        help="backbone stem width (64 = the published model); smaller "
                             "widths keep the module tree, for smoke runs")
    parser.add_argument("--save-dir", default="snapshot")
    parser.add_argument("--pretrained", default=None, help="a .pth to warm-start from")
    parser.add_argument("--resume", default=None, help="a checkpoint of this CLI")
    parser.add_argument("--log-interval", type=int, default=10)
    parser.add_argument("--seed", type=int, default=None,
                        help="the data pipeline's seed (each item a function of seed, "
                             "epoch and index, whatever the workers) and the init's; "
                             "unseeded, the data draws a seed and the init takes 0")
    parser.add_argument("--unfreeze-at", type=float, default=0.5,
                        help="training-progress fraction at which backbone layer2/3 "
                             "unfreeze")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> dict[str, float]:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    log = logging.getLogger("train")
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    log.info(f"torch {torch.__version__} device {device}"
             + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    cfg = Config.load(args.config, clip=args.clip)
    model = MODELS[args.task](cfg.anchors.anchor_num, args.width)
    model.init_weights(torch.Generator().manual_seed(args.seed or 0))
    if args.pretrained:
        missing, unused = merge_state_dict(model, read_state_dict(args.pretrained))
        if missing:
            log.info(f"pretrained: {len(missing)} entries kept at init (e.g. {missing[0]})")
        if unused:
            log.info(f"pretrained: {len(unused)} checkpoint entries unused (e.g. {unused[0]})")
    model.to(device)

    train_cfg = cfg.train_datasets
    dataset = PairDataset(train_cfg, cfg.anchors, num_epoch=1, seed=args.seed)
    loader = DataLoader(dataset, args.batch, num_workers=args.workers,
                        workers_mode=args.workers_mode)
    settings = TrainSettings.for_search(args.task, cfg.loss_weight,
                                        train_cfg.get("search_size", 255))
    lr_spaces = build_lr_spaces(cfg.lr, args.epochs)
    opt_cfg = OptimizerConfig.from_lr_cfg(cfg.lr, clip=args.clip, clip_cfg=cfg.clip)
    trainer = Trainer(model, settings, opt_cfg, lr_spaces, epochs=args.epochs,
                      unfreeze_at=args.unfreeze_at)
    start_epoch = trainer.restore(args.resume) if args.resume else 0

    step = start_epoch * len(loader)
    metrics: dict[str, torch.Tensor] = {}
    t_last = time.time()
    for epoch in range(start_epoch, args.epochs):
        dataset.shuffle()
        lr = float(lr_spaces[min(epoch, len(lr_spaces) - 1)])
        for batch in to_device(iter(loader), device, size=2):
            metrics = trainer.step(batch, epoch)
            step += 1
            if step % args.log_interval == 0:
                logged = {k: v.item() for k, v in metrics.items()}
                dt = (time.time() - t_last) / args.log_interval
                t_last = time.time()
                # the per-group rates after the metrics: tools/curves.py reads
                # the \w+=value run that follows "lr L"
                groups = " ".join(f"lr/{g['name']}={lr * g['mult']:.6f}"
                                  for g in trainer.optimizer.param_groups)
                log.info(f"epoch {epoch} step {step} lr {lr:.5f} "
                         + " ".join(f"{k}={v:.4f}" for k, v in logged.items())
                         + f" {groups} ({dt:.2f}s/it)")
        path = join(args.save_dir, f"checkpoint_e{epoch + 1}.pth")
        save_checkpoint(path, model.state_dict(), trainer.optimizer.state_dict(), epoch + 1,
                        arch=cfg.arch, anchor_cfg=cfg.anchors.to_dict())
        log.info(f"saved {path}")
    return {k: v.item() for k, v in metrics.items()}


if __name__ == "__main__":
    main()
