#!/usr/bin/env python3
"""The SiamMask-base stage-1 train step of one checkout of the port, in fp32
and in bf16, on one NVIDIA card:
``python3 scripts/ab_train_step.py [--repo DIR] [--out FILE]``.

Imports ``siammask_tpu_torch`` and ``chip_smoke`` from ``--repo`` (this
checkout by default), builds ``chip_smoke``'s stage-1 batch and
BN-calibrated weights (batch 64, width 64, seeded) and times each dtype's
frozen and unfrozen step as ``chip_smoke.py``'s ``[train-timing]`` does
(10 warm steps by CUDA events after 3 untimed ones; median, min and max).
Prints a line each and appends one JSON line to ``--out``. To compare two
checkouts on one card, run this from each in its own process, in turns
(A, B, B, A): the bf16 step is short and leans on the host, whose load
moves it from run to run.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--out", default=None, help="append the result as a JSON line")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("ab_train_step: no CUDA device")
    smi = cs.phase_device()      # also switches TF32 off
    cfg = cs.Config.load(str(cs.TRAIN_CONFIG), clip=10.0)
    batch = cs.synthetic_train_batch(cfg, cs.TRAIN_BATCH, "cuda")
    init = {k: v.detach().cpu().clone()
            for k, v in cs.build_train_model(batch, "cuda").state_dict().items()}
    result = {"repo": args.repo, "nvidia_smi": smi}
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        trainer = cs.Trainer(cs.loaded_model(cs.SiamMaskBase, init, "cuda", dtype),
                             *cs.train_parts(cfg), epochs=cs.TRAIN_EPOCHS, unfreeze_at=0.5)
        for epoch, label in ((0, "frozen"), (1, "unfrozen")):
            for _ in range(3):
                trainer.step(batch, epoch)
            torch.cuda.synchronize()
            times = []
            for _ in range(10):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                trainer.step(batch, epoch)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            result[f"{name}_{label}_ms"] = [statistics.median(times), min(times), max(times)]
            print(f"[ab-train] {args.repo} {name} {label}: median {statistics.median(times):.2f} "
                  f"ms (min {min(times):.2f}, max {max(times):.2f}) | {smi}")
        del trainer
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(result) + "\n")


if __name__ == "__main__":
    main()
