#!/usr/bin/env python3
"""The exact data-parallel mode's gradient exchange on four cards, one tensor
at a time against one flat bucket, in one process:
``python3 scripts/ab_dp_exchange.py`` from the repo root, on a machine with
four NVIDIA cards.

Runs ``chip_smoke.dp_rank`` (SiamMask-base stage 1, width 64, the default
mode, global batch 64, 16 rows a card over NCCL, 10 timed unfrozen steps)
four times: per tensor, bucket, bucket, per tensor. The bucket is
``parallel.dist.all_reduce_tensors``; per tensor is the same sum issued as
one collective per gradient tensor. Prints each run's median, min and max
ms a step by the host clock and its collectives a step.
"""
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from siammask_tpu_torch.parallel import dist as pdist  # noqa: E402
from siammask_tpu_torch.parallel.dist import spawn  # noqa: E402


def per_tensor(tensors, op="sum"):
    for t in tensors:
        pdist._all_reduce(t)
        if op == "mean":
            t.div_(pdist.dist.get_world_size())


def rank_fn(rank, world, device, variant, *args):
    if variant == "per_tensor":
        import siammask_tpu_torch.train.trainer as trainer
        trainer.all_reduce_tensors = per_tensor
    return cs.dp_rank(rank, world, device, *args)


def main():
    smi = cs.phase_device()
    cs.phase_build()
    cfg = cs.Config.load(str(cs.TRAIN_CONFIG), clip=10.0)
    batch = cs.synthetic_train_batch(cfg, cs.TRAIN_BATCH, cs.DEV)
    init_state = {k: v.detach().cpu().clone()
                  for k, v in cs.build_train_model(batch, cs.DEV).state_dict().items()}
    cpu = {k: v.cpu() for k, v in batch.items()}
    for variant in ("per_tensor", "bucket", "bucket", "per_tensor"):
        runs = spawn(rank_fn, 4, "cuda", variant, init_state, cpu, cs.DP_MODES[:1], (), 10,
                     timeout=120)
        r = runs[0]["default"]
        print(f"[ab] {variant}, global 64 over 4 cards: median {statistics.median(r['ms']):.2f} "
              f"ms, min {min(r['ms']):.2f}, max {max(r['ms']):.2f} ({len(r['ms'])} unfrozen "
              f"steps); {r['steps'][1]['collectives']} collectives; digest "
              f"{r['steps'][1]['digest'][:12]}; ms {[round(x, 2) for x in r['ms']]} | {smi}",
              flush=True)


if __name__ == "__main__":
    main()
