"""Metric-level parity of the PyTorch port against the JAX package, on the CPU.

The JAX package is the reference: the counterpart of ``tools/metric_parity.py``
with the JAX stack where that tool ran the PyTorch 0.4 reference, and the port
where it ran the JAX stack. Both get the same weights: a seeded SiamMask-sharp
of the port, tempered by ``siammask_tpu_torch.tools.metric_parity.temper``,
saved as a port checkpoint and carried into JAX variables by
``siammask_tpu.utils.torch_convert.convert_state_dict``.

1. The JAX tracker (``TrackerRuntime(SiamMaskSharp(xcorr_impl="pallas"), ...,
   latency_lowerings=False)``, the Pallas xcorr in interpret mode) makes the
   pseudo-benchmark with the port tool's ``make_benchmark``: its no-reset
   runs are the gt and the VOS pseudo-gt.
2. The JAX tracker runs ``siammask_tpu/tracker/vot.py`` ``track_vot`` and
   ``tracker/vos.py`` ``track_vos`` on it (tree ``jax``); the port runs its
   own drivers on the CPU on the same directory (tree ``port``,
   ``metric_parity.run_drivers``).
3. Both trees are scored with both eval toolkits. The tracker deltas (JAX
   against the port, the port's eval) and whether both made the same
   protocol decisions; the eval deltas (the JAX eval against the port's on
   one tree), which must be exactly 0.0.

Usage::

    python scripts/metric_parity_jax.py --width 64 --box-only --frames 70 \\
        --work-dir build/mp_jax --json-out build/mp_jax/out.json

``--frames`` is the clip frames used (each video has 3 * frames - 3; below
70 the failure windows scale with the video), ``--width 64`` the published
width. It does not import ``tools/metric_parity.py``, whose module reaches
for the PyTorch 0.4 checkout.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from os.path import dirname, exists, join, realpath
from pathlib import Path

REPO = dirname(dirname(realpath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

from siammask_tpu_torch.tools import metric_parity as mp  # noqa: E402
from siammask_tpu_torch.tools.overfit import write_overfit_clip  # noqa: E402
from siammask_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402

def jax_runtime(weights: str, width: int, mask: bool = True):
    """The JAX SiamMask-sharp tracker on a port checkpoint's weights: the
    Pallas xcorr (interpret mode off the TPU), the plain lowerings."""
    from siammask_tpu.config import TrackerConfig
    from siammask_tpu.models.siammask import SiamMaskSharp
    from siammask_tpu.tracker.runtime import TrackerRuntime as JaxTrackerRuntime
    from siammask_tpu.utils.torch_convert import load_torch_checkpoint

    p = TrackerConfig().update(mp.HP, mp.ANCHORS)
    return JaxTrackerRuntime(SiamMaskSharp(width=width, xcorr_impl="pallas"),
                             load_torch_checkpoint(weights), p, mask=mask, refine=mask,
                             latency_lowerings=False)


def prepare(work: str, frames: int, width: int, log=print) -> tuple[str, str]:
    """The clip, the tempered port weights and the benchmark the JAX tracker
    makes from them, under ``work``: (benchmark dir, weights file)."""
    clip = join(work, "clip")
    if not exists(join(clip, f"{frames - 1:05d}.jpg")):
        write_overfit_clip(Path(clip))
    model = mp.tempered_model(mp.read_clip(clip, 1)[0], width)
    weights = join(work, "tempered.pth")
    save_checkpoint(weights, model.state_dict(), arch="Custom",
                    anchor_cfg=mp.tracker_config().anchor_config().to_dict())
    bench = join(work, "benchmark")
    mp.make_benchmark(jax_runtime(weights, width), clip, bench, frames, weights, log=log)
    return bench, weights


def run_jax(bench: str, weights: str, width: int, results: str, vot_mask: bool = True,
            vos: bool = True, name: str = "jax", log=print) -> None:
    """The JAX drivers on the benchmark: VOT (the masks' rotated boxes, or
    with ``vot_mask`` False the boxes), and VOS with ``vos``."""
    from siammask_tpu.eval.datasets import load_dataset
    from siammask_tpu.tracker.vos import track_vos
    from siammask_tpu.tracker.vot import track_vot

    runtime = jax_runtime(weights, width, mask=vot_mask)
    for video in load_dataset(mp.VOT_NAME, bench).values():
        track_vot(runtime, video, mp.VOT_NAME, mask_enable=vot_mask, result_dir=results,
                  tracker_name=name, log=log)
    if vos:
        runtime = runtime if vot_mask else jax_runtime(weights, width)
        for video in load_dataset(mp.VOS_NAME, bench).values():
            track_vos(runtime, video, mot_enable=False, result_dir=results,
                      dataset=mp.VOS_NAME, tracker_name=name, save_mask=True, log=log)


def score_both(bench: str, results: str, vos: bool, names=("jax", "port")) -> dict:
    """Each tree through the port's eval and the JAX package's: {tree:
    {"port_eval", "jax_eval"}}, with VOS J/F with ``vos``."""
    from siammask_tpu.eval import benchmarks as jbench
    from siammask_tpu.eval.datasets import VOTDataset as JaxVOTDataset
    from siammask_tpu.eval.datasets import load_dataset as jax_load_dataset
    from siammask_tpu.eval.davis import DAVISBenchmark as JaxDAVISBenchmark

    out = {}
    for name in names:
        port_eval = mp.score_ar_eao(mp._vot_dataset(bench, results, name), name)
        jax_eval = mp.score_ar_eao(mp._vot_dataset(bench, results, name, JaxVOTDataset), name,
                                   jbench.AccuracyRobustnessBenchmark, jbench.EAOBenchmark)
        if vos:
            port_eval.update(mp.score_vos(bench, results, name))
            jax_eval.update(mp.score_vos(bench, results, name, JaxDAVISBenchmark,
                                         jax_load_dataset(mp.VOS_NAME, bench)))
        out[name] = {"port_eval": port_eval, "jax_eval": jax_eval}
    return out


def report(bench: str, results: str, scores: dict) -> dict:
    """Tracker deltas (the JAX tree against the port's, the port's eval),
    the protocol decisions of each, their agreement and region overlap, and
    the eval deltas (the JAX eval against the port's, each tree)."""
    ds_videos = mp.VOTDataset(mp.VOT_NAME, join(bench, mp.VOT_NAME)).videos
    return {
        "tracker_deltas": mp.deltas(scores["port"]["port_eval"], scores["jax"]["port_eval"]),
        "eval_deltas": {tree: {m: abs(s["port_eval"][m] - s["jax_eval"][m])
                               for m in s["port_eval"]} for tree, s in scores.items()},
        "decisions": {tree: {v: mp.decisions(lines) for v, lines in
                             mp.read_tree(results, tree, ds_videos).items()}
                      for tree in scores},
        "trees": mp.compare_trees(bench, (results, "jax"), (results, "port")),
        "scores": scores,
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=70)
    parser.add_argument("--width", type=int, default=64)
    parser.add_argument("--box-only", action="store_true",
                        help="report axis-aligned boxes; implies no VOS")
    parser.add_argument("--work-dir", default="build/metric_parity_jax")
    parser.add_argument("--json-out", default=None)
    args = parser.parse_args(argv)
    os.makedirs(args.work_dir, exist_ok=True)
    results = join(args.work_dir, "results")
    seconds = {}
    t0 = time.perf_counter()
    bench, weights = prepare(args.work_dir, args.frames, args.width)
    seconds["benchmark"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_jax(bench, weights, args.width, results, not args.box_only, not args.box_only)
    seconds["jax"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mp.run_drivers(weights, args.width, "cpu", bench, results, "port", not args.box_only,
                   not args.box_only)
    seconds["port"] = time.perf_counter() - t0
    out = report(bench, results, score_both(bench, results, not args.box_only))
    out["settings"] = {"frames": args.frames, "frames_per_video": 3 * args.frames - 3,
                       "width": args.width, "report": "box" if args.box_only else "mask-polygon",
                       "torch_threads": torch.get_num_threads()}
    out["seconds"] = seconds
    text = json.dumps(out, indent=1)
    print(text)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(text)
    return out


if __name__ == "__main__":
    main()
