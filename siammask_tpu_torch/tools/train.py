"""Training entry point of the PyTorch port: SiamRPN, SiamMask-base, and
SiamMask-sharp end to end or its stage-2 refine training.

Counterpart of ``tools/train.py`` (the reference's ``train_siammask.py``,
``train_siamrpn.py`` and ``train_siammask_refine.py``), with the same flags
less the JAX package's ``--xcorr``, ``--platform`` and ``--tb-dir``, plus
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
CLI (weights, momentum and epoch; the data's shuffle starts anew from its
first generation, as the JAX package's CLI does, so with ``--seed`` a
resumed run draws the pairs the JAX CLI's resumed run draws, which are not
the uninterrupted run's). A checkpoint ``checkpoint_e{N}.pth`` is written
after each epoch. TF32 is off (the fp32 reference mode: the float32 model
switches it off as it is built). ``main(argv)`` returns the last step's
metrics.

Data parallel: ``--batch`` is the global batch. ``--num-devices N`` spawns N
ranks, one card each over NCCL, or N gloo processes with ``--device cpu``;
fewer than N visible cards raise. Under torchrun (``WORLD_SIZE``) or SLURM
(``SLURM_NTASKS``, with ``MASTER_ADDR`` and ``MASTER_PORT`` set) with more
than one process, each process joins the group and nothing is spawned; one
process there runs as it would alone. ``--fused-allreduce``, ``--sync-bn`` and ``--remat``
are ``Trainer``'s modes. Each rank loads its rows of every batch from one
data seed (rank 0's, when ``--seed`` is not given); rank 0 writes the
checkpoints and logs, every rank restores ``--resume``, and ``main``
returns rank 0's metrics.
"""
from __future__ import annotations

import argparse
import logging
import random
import time
from os.path import join

import torch
import torch.distributed as dist

from siammask_tpu_torch.config import Config
from siammask_tpu_torch.data.dataset import DataLoader, PairDataset, to_device
from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp, SiamRPN
from siammask_tpu_torch.parallel.dist import init_distributed, spawn
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
    parser.add_argument("--num-devices", type=int, default=1,
                        help="data-parallel ranks to spawn: one card each, or gloo "
                             "processes with --device cpu; --batch stays the global batch")
    parser.add_argument("--fused-allreduce", action="store_true",
                        help="exchange the gradients as one flat bucket, averaged, with "
                             "local BN and loss normalizers (DDP's semantics) instead of "
                             "the exact global-batch step's per-tensor sums")
    parser.add_argument("--sync-bn", action="store_true",
                        help="with --fused-allreduce: sync the BN batch statistics over "
                             "the ranks (two small collectives per training-mode BN)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute the forward in the backward: about a third more "
                             "FLOPs for the activation memory of one forward")
    return parser.parse_args(argv)


def main(argv=None) -> dict[str, float]:
    args = parse_args(argv)
    rank, world, device = init_distributed(args.device)
    if world > 1:
        try:
            return train(rank, world, device, args)
        finally:
            dist.destroy_process_group()
    if args.num_devices > 1:
        if args.device == "cuda" and torch.cuda.device_count() < args.num_devices:
            raise RuntimeError(f"--num-devices {args.num_devices}: "
                               f"{torch.cuda.device_count()} cards are visible")
        return spawn(train, args.num_devices, args.device, args)[0]
    return train(0, 1, torch.device(args.device), args)


def train(rank: int, world: int, device: torch.device, args) -> dict[str, float]:
    """The training run of one rank of ``world`` (the whole run when 1)."""
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format="%(asctime)s %(levelname)s %(message)s")
    log = logging.getLogger("train")
    log.info(f"torch {torch.__version__} device {device}"
             + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
             + (f", {world} ranks over {dist.get_backend()}" if world > 1 else ""))

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

    seed = args.seed
    if world > 1 and seed is None:   # one data seed for every rank: rank 0's
        box = [random.SystemRandom().randrange(2 ** 31)]
        dist.broadcast_object_list(box, src=0)
        seed = box[0]
    train_cfg = cfg.train_datasets
    dataset = PairDataset(train_cfg, cfg.anchors, num_epoch=1, seed=seed)
    loader = DataLoader(dataset, args.batch, num_workers=args.workers,
                        workers_mode=args.workers_mode, rank=rank, world=world)
    settings = TrainSettings.for_search(args.task, cfg.loss_weight,
                                        train_cfg.get("search_size", 255))
    lr_spaces = build_lr_spaces(cfg.lr, args.epochs)
    opt_cfg = OptimizerConfig.from_lr_cfg(cfg.lr, clip=args.clip, clip_cfg=cfg.clip)
    trainer = Trainer(model, settings, opt_cfg, lr_spaces, epochs=args.epochs,
                      unfreeze_at=args.unfreeze_at, distributed=world > 1,
                      fused_allreduce=args.fused_allreduce, sync_bn=args.sync_bn,
                      remat=args.remat)
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
        if rank == 0:
            save_checkpoint(path, model.state_dict(), trainer.optimizer.state_dict(),
                            epoch + 1, arch=cfg.arch, anchor_cfg=cfg.anchors.to_dict())
            log.info(f"saved {path}")
        if world > 1:
            dist.barrier()
    return {k: v.item() for k, v in metrics.items()}


if __name__ == "__main__":
    main()
