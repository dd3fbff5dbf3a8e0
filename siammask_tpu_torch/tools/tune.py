"""Hyperparameter grid search over tracker inference params (VOT or VOS).

Counterpart of ``tools/tune.py``, with the same flags less the JAX package's
``--platform``, plus ``--device`` (``cuda`` by default; ``cpu`` runs on the
CPU; without a card ``cuda`` raises). It mirrors `tools/tune_vot.py` /
`tune_vos.py`: a randomized grid over penalty_k x window_influence x lr x
instance_size (+ seg_thr for VOS), with the reference's cooperative
file-claim protocol — write an 'Occ' placeholder, skip existing results,
honor a finish.flag poison pill — so N independent processes share one grid
idempotently::

    python -m siammask_tpu_torch.tools.tune --config experiments/siammask_sharp/config_vot.json \\
        --resume SiamMask_VOT.pth --dataset VOT2018 --data-dir data --out-dir tune

VOT cells are scored by EAO: each cell writes the per-video trajectory files
(the writer ``tools/test.py`` uses) under ``<out_dir>/results/<dataset>/<cell
tag>/`` and scores them with ``eval.benchmarks.EAOBenchmark``, so
``tools/eval.py`` over that tree ranks the cells by the same numbers. VOS
cells are scored by the mean over videos of each video's mean IoU, through
the batched VOS driver (``track_vos_batched``, the test CLI's default; it
gives ``track_vos``'s IoUs). The model is loaded once; each cell builds its
own ``TrackerRuntime``, dropped before the next. ``main(argv)`` returns the
cells this process scored.
"""
from __future__ import annotations

import argparse
import itertools
import random
import time
from os import makedirs
from os.path import exists, isdir, join

import numpy as np
import torch

from siammask_tpu_torch.config import Config
from siammask_tpu_torch.data.gen_json import create_vot_json
from siammask_tpu_torch.eval.benchmarks import EAOBenchmark
from siammask_tpu_torch.eval.datasets import VOTDataset, load_dataset
from siammask_tpu_torch.tools.test import load_model
from siammask_tpu_torch.tracker.runtime import TrackerRuntime
from siammask_tpu_torch.tracker.vos import track_vos_batched
from siammask_tpu_torch.tracker.vot import track_vot


def run_grid(grid, out_dir, tag_fn, score_fn, log=print):
    """The reference's cooperative grid protocol (tune_vot.py:77-89,214-241):
    claim a cell by writing an 'Occ' placeholder, skip cells another process
    already claimed/scored, stop when someone drops finish.flag. Returns the
    number of cells THIS process scored."""
    if not isdir(out_dir):
        makedirs(out_dir)
    finish_flag = join(out_dir, "finish.flag")
    done = 0
    for cell in grid:
        if exists(finish_flag):
            log("finish.flag present — stopping")
            break
        tag = tag_fn(cell)
        result_file = join(out_dir, tag + ".txt")
        if exists(result_file):  # claimed or done
            continue
        with open(result_file, "w") as f:
            f.write("Occ")  # cooperative claim
        score = score_fn(cell)
        with open(result_file, "w") as f:
            f.write(f"{tag} score {score}\n")
        log(f"{tag} score {score}")
        done += 1
    return done


def score_vot_cell(runtime, dataset, vot_ds, tag, out_dir, dataset_name,
                   eao_interval=None, log=print, speeds=None):
    """Score one VOT grid cell by EAO: run the reset-protocol tracker over
    every video writing trajectory files under <out_dir>/results, then
    EAO-score that result tree with the in-tree benchmark.

    vot_ds: eval.datasets.VOTDataset over the same sequences (provides gt
    trajectories, frame bounds and per-frame tags). eao_interval optionally
    overrides the dataset's (low, high) curve interval — the standard VOT2018
    window is frames 100..356, empty on short synthetic sequences. ``speeds``,
    a list, receives each video's frames/s on the driver's clock."""
    traj_root = join(out_dir, "results")
    for video in dataset.values():
        _, fps = track_vot(runtime, video, dataset=dataset_name, mask_enable=True,
                           result_dir=traj_root, tracker_name=tag, log=log)
        if speeds is not None:
            speeds.append(fps)
    vot_ds.set_tracker(join(traj_root, dataset_name), [tag])
    bench = EAOBenchmark(vot_ds)
    if eao_interval is not None:
        bench.low, bench.high = eao_interval
    return bench.eval(tag)[tag]["all"]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Tune SiamMask tracker hp (PyTorch port)")
    parser.add_argument("--config", required=True)
    parser.add_argument("--resume", default=None, help="a reference .pth checkpoint")
    parser.add_argument("--dataset", default="VOT2018")
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--out-dir", default="tune")
    parser.add_argument("--penalty-k", default="0.00,0.20,0.04")
    parser.add_argument("--window-influence", default="0.36,0.51,0.03")
    parser.add_argument("--lr", default="0.25,0.56,0.05")
    parser.add_argument("--search-region", default="255,256,16")
    parser.add_argument("--seg-thr", default="0.30,0.51,0.05",
                        help="used for VOS datasets")
    parser.add_argument("--eao-interval", default=None,
                        help="override the EAO curve interval as 'low,high' "
                             "(for short/synthetic sequences)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Runs this process's share of the grid. Returns {"scored": the number of
    cells scored, "cells": one record per scored cell (tag, score, wall
    seconds, frames/s on the drivers' clocks; on the card the peak memory
    during the cell and the memory still allocated after it)}."""
    args = parse_args(argv)
    device = torch.device(args.device)

    def parse_range(s):
        lo, hi, step = map(float, s.split(","))
        return np.arange(lo, hi, step).round(4).tolist()

    vos = args.dataset.startswith("DAVIS") or args.dataset == "ytb_vos"
    grid = list(itertools.product(
        parse_range(args.penalty_k),
        parse_range(args.window_influence),
        parse_range(args.lr),
        [int(x) for x in parse_range(args.search_region)],
        parse_range(args.seg_thr) if vos else [None]))
    random.shuffle(grid)

    cfg = Config.load(args.config)
    model = load_model(cfg.arch, cfg.anchors.anchor_num, args.resume, device)
    dataset = load_dataset(args.dataset, args.data_dir)

    vot_ds = None
    if not vos:
        # the EAO scorer reads the toolkit json metadata; build it from the
        # raw sequence layout if absent
        if not exists(join(args.data_dir, args.dataset + ".json")):
            create_vot_json(join(args.data_dir, args.dataset), args.dataset,
                            out_file=join(args.data_dir, args.dataset + ".json"))
        vot_ds = VOTDataset(args.dataset, args.data_dir)
    eao_interval = (tuple(int(x) for x in args.eao_interval.split(","))
                    if args.eao_interval else None)

    def tag_fn(cell):
        pk, wi, lr, instance, thr = cell
        return (f"pk{pk}_wi{wi}_lr{lr}_in{instance}"
                + (f"_thr{thr}" if vos else ""))

    def score(cell, speeds):
        pk, wi, lr, instance, thr = cell
        hp = dict(cfg.hp)
        hp.update(penalty_k=pk, window_influence=wi, lr=lr,
                  instance_size=instance)
        if thr is not None:
            hp["seg_thr"] = thr
        p = cfg.tracker_config()
        p.update(hp)
        runtime = TrackerRuntime(model, p, device, mask=True, refine=True)

        if vos:
            ious = []
            for video in dataset.values():
                iou, fps = track_vos_batched(runtime, video,
                                             mot_enable=args.dataset != "DAVIS2016",
                                             log=lambda *_: None)
                speeds.append(fps)
                if len(iou) > 0:
                    ious.append(np.mean(iou))
            return float(np.mean(ious))
        return score_vot_cell(runtime, dataset, vot_ds, tag_fn(cell),
                              args.out_dir, args.dataset,
                              eao_interval=eao_interval, log=lambda *_: None,
                              speeds=speeds)

    cells = []

    def score_fn(cell):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        speeds = []
        t0 = time.perf_counter()
        value = score(cell, speeds)     # the cell's runtime is dropped on return
        record = {"tag": tag_fn(cell), "score": value, "seconds": time.perf_counter() - t0,
                  "fps": float(np.mean(speeds))}
        if device.type == "cuda":
            record["peak_bytes"] = torch.cuda.max_memory_allocated(device)
            record["allocated_bytes"] = torch.cuda.memory_allocated(device)
            print(f"{record['tag']}: peak {record['peak_bytes'] / 2**20:.1f} MiB during the "
                  f"cell, {record['allocated_bytes'] / 2**20:.1f} MiB allocated after it")
        cells.append(record)
        return value

    scored = run_grid(grid, args.out_dir, tag_fn, score_fn)
    return {"scored": scored, "cells": cells}


if __name__ == "__main__":
    main()
