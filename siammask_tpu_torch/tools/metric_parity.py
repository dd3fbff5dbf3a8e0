"""Metric-level parity harness of the port: EAO / Accuracy / Robustness, the
protocol decisions and VOS J/F of one closed-loop run, and their deltas
against another run on the same pseudo-benchmark and weights.

Counterpart of ``tools/metric_parity.py`` and of ``tools/parity_report.py``'s
tempering, with its own reference: the JAX package on the CPU
(``scripts/metric_parity_jax.py``) or another run of this tool (the card
against the CPU, bf16 against float32; ``chip_smoke.py`` ``[metric-parity]``).

- **The clip**: ``overfit.write_overfit_clip``'s 70 seeded frames, written
  to the work directory.
- **The pseudo-benchmark** (``make_benchmark``): two videos that reorder the
  clip (``orders``: fwd+rev+fwd and rev+fwd+rev, 207 frames each from 70),
  so that the EAO interval 100..356 has support. The gt is the no-reset
  closed-loop trajectory of the side that makes the benchmark, as
  axis-aligned polygons, displaced by ``DISPLACE`` px over two 5-frame
  windows a video (``fail_windows``) to force failures: each run goes
  through lost-marking, the 5-frame skip and the re-init from gt. The VOS
  video is the clip forward, its pseudo-gt masks that run's masks over
  ``seg_thr``. Written in the layout ``eval/datasets.load_dataset`` reads:
  ``VOT2018/`` (JPEG frames, ``groundtruth.txt``, ``list.txt``,
  ``VOT2018.json``) and ``DAVIS/`` (``JPEGImages``, ``Annotations``,
  ``ImageSets/2016/val.txt``), with the weights as ``weights.pth`` and the
  settings as ``benchmark.json``. Another run, of this tool or of the JAX
  package, reads the same directory (``--benchmark``).
- **The weights**: random weights of seed 0 tempered by ``temper`` (sequential
  LSUV over the convs in module order, then the refine logits centred on
  ``post2.bias``), or a port checkpoint (``--weights``).
- **The protocol**: ``tracker/vot.py`` ``track_vot`` (the mask's rotated box,
  or with ``--box-only`` the axis-aligned box; box-only implies no VOS) and
  ``tracker/vos.py`` ``track_vos`` through a ``TrackerRuntime`` in
  ``--dtype`` on ``--device``, writing the reference result trees.
- **Scoring** (``score_vot``, ``score_vos``): ``eval/benchmarks.py`` EAO and
  A/R and ``eval/davis.py`` J/F; ``compare`` gives the deltas to another
  tree, whether both made the same protocol decisions (the result files'
  marker lines) and the per-frame overlap of their regions.

Usage::

    python -m siammask_tpu_torch.tools.metric_parity --make-benchmark --box-only \\
        --work-dir build/mp --json-out build/mp/card.json          # the card
    python -m siammask_tpu_torch.tools.metric_parity --box-only --device cpu \\
        --benchmark build/mp/benchmark --work-dir build/mp \\
        --compare build/mp/results/VOT2018/port_cuda_float32          # the CPU

The tool runs on the card (``--device cuda``, the default) and refuses to
run without one unless ``--device cpu`` is given. cv2 is imported where an
image is read or written, not with the module.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
from os.path import basename, dirname, exists, isdir, join
from pathlib import Path

import numpy as np
import torch

from siammask_tpu_torch.config import TrackerConfig
from siammask_tpu_torch.eval.benchmarks import AccuracyRobustnessBenchmark, EAOBenchmark
from siammask_tpu_torch.eval.datasets import VOTDataset, load_dataset
from siammask_tpu_torch.eval.davis import DAVISBenchmark
from siammask_tpu_torch.eval.region import vot_overlap
from siammask_tpu_torch.models.siammask import SiamMaskSharp
from siammask_tpu_torch.tools.overfit import N_FRAMES, interpolate_boxes, write_overfit_clip
from siammask_tpu_torch.tracker.runtime import TrackerRuntime
from siammask_tpu_torch.tracker.vos import track_vos
from siammask_tpu_torch.tracker.vot import track_vot
from siammask_tpu_torch.train.checkpoint import read_state_dict, save_checkpoint

# tools/parity_report.py's tracker settings
HP = {"instance_size": 255, "out_size": 127, "base_size": 8, "seg_thr": 0.3,
      "penalty_k": 0.04, "window_influence": 0.4, "lr": 1.0}
ANCHORS = {"stride": 8, "ratios": [0.33, 0.5, 1, 2, 3], "scales": [8], "round_dight": 0}
FAIL_WINDOWS = (60, 140)    # forced-failure window starts in a 207-frame video
FAIL_LEN = 5                # frames a window
DISPLACE = 2000.0           # gt displacement that guarantees zero overlap
VOT_NAME, VOS_NAME, VOS_VIDEO = "VOT2018", "DAVIS2016", "clip"
WEIGHTS, SETTINGS = "weights.pth", "benchmark.json"
SEED = 0                    # the random weights'


def tracker_config() -> TrackerConfig:
    return TrackerConfig().update(HP, ANCHORS)


def orders(n: int) -> dict[str, list[int]]:
    """The two pseudo-videos' clip frame indices: fwd+rev+fwd and
    rev+fwd+rev, 3n-3 frames each."""
    fwd = list(range(n))
    rev = list(range(n - 2, 0, -1))
    return {"v0": fwd + rev + fwd[:n - 1],
            "v1": list(reversed(fwd)) + fwd[1:] + list(reversed(fwd))[1:n - 1]}


def fail_windows(length: int) -> tuple[int, ...]:
    """``FAIL_WINDOWS`` in a video of the full clip's length (207 frames) or
    longer; in a shorter one, scaled to its length."""
    full = 3 * N_FRAMES - 3
    if length >= full:
        return FAIL_WINDOWS
    return tuple(k * length // full for k in FAIL_WINDOWS)


def rect_poly(pos, sz) -> list[float]:
    """The axis-aligned box (cx, cy), (w, h) as a VOT polygon."""
    x1, y1 = pos[0] - sz[0] / 2, pos[1] - sz[1] / 2
    x2, y2 = pos[0] + sz[0] / 2, pos[1] + sz[1] / 2
    return [float(v) for v in (x1, y1, x1, y2, x2, y2, x2, y1)]


def displace_gt(gt, windows=FAIL_WINDOWS) -> list[list[float]]:
    """The gt moved by ``DISPLACE`` px in the ``FAIL_LEN`` frames from each
    window start."""
    gt = [list(g) for g in gt]
    for k in windows:
        for f in range(k, min(k + FAIL_LEN, len(gt))):
            gt[f] = [c + DISPLACE for c in gt[f]]
    return gt


def init_box(frame: int) -> tuple[np.ndarray, np.ndarray]:
    """(centre, size) of the clip's box at ``frame``."""
    x0, y0, x1, y1 = interpolate_boxes()[frame]
    return np.array([(x0 + x1) / 2, (y0 + y1) / 2]), np.array([x1 - x0, y1 - y0])


# ---------------------------------------------------------------- weights


class _Measured(Exception):
    """Raised by the measuring hook to skip the forward after its layer."""


def temper(model: SiamMaskSharp, frame: np.ndarray, iters: int = 2) -> SiamMaskSharp:
    """``tools/parity_report.py`` ``temper_reference_net`` on the port's
    entry points: scale each conv (module order, ``iters`` sweeps) so that
    its output std is 1 on the frame resized to 127 and 255, one layer a
    forward with everything upstream already scaled; then centre the refined
    mask logits at the cell (12, 12) on ``refine_model.post2.bias``. Random
    weights in eval mode have identity BNs, so without it activations grow
    layer by layer until the box deltas overflow the decode. Raises unless
    every parameter is finite and the logits' std is within (0.05, 20)."""
    import cv2

    device = next(model.parameters()).device
    convs = [m for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    stds: dict = {}

    def crop(size):
        im = cv2.resize(frame, (size, size)).astype(np.float32)
        return torch.from_numpy(im).permute(2, 0, 1)[None].contiguous().to(device)

    z, x = crop(127), crop(255)
    cell = torch.tensor([[12, 12]], device=device)

    def logits():
        zf = model.template(z)
        out = model.track_mask(zf, x)
        return model.track_refine(out.skips, out.corr, cell)

    def measure(target) -> bool:
        def hook(m, inp, out):
            stds[target] = float(out.detach().float().std())
            raise _Measured()

        handle = target.register_forward_hook(hook)
        try:
            logits()
        except _Measured:
            return True
        finally:
            handle.remove()
        return False

    with torch.no_grad():
        for _ in range(iters):
            for conv in convs:
                if not measure(conv):
                    continue
                s = stds[conv]
                if not np.isfinite(s) or s < 1e-8:
                    s = 1.0
                conv.weight /= s
                if conv.bias is not None:
                    conv.bias /= s
        model.refine_model.post2.bias -= logits().mean().to(model.refine_model.post2.bias.dtype)
        for name, p in model.named_parameters():
            if not bool(torch.isfinite(p).all()):
                raise AssertionError(f"temper: non-finite parameter {name}")
        lg = logits()
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError("temper: the mask logits are not finite")
        if not 0.05 < float(lg.std()) < 20.0:
            raise AssertionError(f"temper: mask logits degenerate (std {float(lg.std()):.2e})")
    return model


def tempered_model(frame: np.ndarray, width: int = 64,
                   device: str | torch.device = "cpu") -> SiamMaskSharp:
    """A float32 SiamMask-sharp of seeded random weights (an explicit
    ``torch.Generator``), in eval mode on ``device``, tempered on ``frame``."""
    model = SiamMaskSharp(width=width).init_weights(torch.Generator().manual_seed(SEED))
    return temper(model.to(device).eval(), frame)


def load_model(path: str, width: int, device, dtype: torch.dtype | None = None):
    """A SiamMask-sharp computing in ``dtype`` with a port checkpoint's
    weights, in eval mode on ``device``."""
    model = SiamMaskSharp(width=width, dtype=dtype)
    model.load_state_dict(read_state_dict(path))
    return model.to(device).eval()


# ---------------------------------------------------------------- benchmark


def read_clip(frames_dir: str, n: int) -> list[np.ndarray]:
    import cv2

    frames = [cv2.imread(join(frames_dir, f"{i:05d}.jpg")) for i in range(n)]
    if any(f is None for f in frames):
        raise FileNotFoundError(f"{frames_dir}: fewer than {n} frames {{f:05d}}.jpg")
    return frames


def noreset_run(runtime, images, pos0, sz0, want_masks: bool = False):
    """A closed-loop pass with no resets, the gt generator: (the trajectory
    as VOT polygons, the masks over ``seg_thr``, None at frame 0). Any
    runtime with the reference's ``init`` / ``track`` API."""
    gt, masks = [rect_poly(pos0, sz0)], [None]
    runtime.init(images[0], pos0, sz0)
    for im in images[1:]:
        out = runtime.track(im)
        gt.append(rect_poly(out["target_pos"], out["target_sz"]))
        if want_masks:
            masks.append(np.asarray(out["mask"]) > runtime.p.seg_thr)
    return gt, masks


def make_benchmark(runtime, frames_dir: str, root: str, frames: int, weights: str,
                   log=print) -> dict:
    """Write the pseudo-benchmark of the first ``frames`` clip frames under
    ``root`` (the module docstring), its gt from ``runtime``'s no-reset
    runs (a runtime with the mask and refine on). ``weights``, the file of
    the weights that made it, is copied in as ``weights.pth``. Returns the
    settings written to ``benchmark.json``."""
    import cv2

    images = read_clip(frames_dir, frames)
    h, w = images[0].shape[:2]
    vot_root, davis = join(root, VOT_NAME), join(root, "DAVIS")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(vot_root)
    meta, windows = {}, {}
    for name, order in orders(frames).items():
        pos0, sz0 = init_box(order[0])
        t0 = time.perf_counter()
        gt, _ = noreset_run(runtime, [images[i] for i in order], pos0, sz0)
        windows[name] = fail_windows(len(order))
        gt = np.round(np.array(displace_gt(gt, windows[name])), 4)
        log(f"gt of {name}: {len(order)} frames in {time.perf_counter() - t0:.1f} s, "
            f"failures forced from frames {list(windows[name])}")
        os.makedirs(join(vot_root, name))
        for i, f in enumerate(order):
            shutil.copyfile(join(frames_dir, f"{f:05d}.jpg"), join(vot_root, name, f"{i:08d}.jpg"))
        np.savetxt(join(vot_root, name, "groundtruth.txt"), gt, delimiter=",", fmt="%.4f")
        meta[name] = {"video_dir": name, "init_rect": [0, 0, 1, 1],
                      "img_names": [f"{name}/{i:08d}.jpg" for i in range(len(order))],
                      "gt_rect": gt.tolist(), "width": w, "height": h,
                      **{t: [0] * len(order) for t in
                         ("camera_motion", "illum_change", "motion_change", "size_change",
                          "occlusion")}}
    with open(join(vot_root, "list.txt"), "w") as f:
        f.write("\n".join(meta) + "\n")
    with open(join(vot_root, f"{VOT_NAME}.json"), "w") as f:
        json.dump(meta, f)

    # VOS: the clip forward, the pseudo-gt the no-reset run's masks
    pos0, sz0 = init_box(0)
    t0 = time.perf_counter()
    _, masks = noreset_run(runtime, images, pos0, sz0, want_masks=True)
    anno0 = np.zeros((h, w), np.uint8)
    x1, y1 = int(pos0[0] - sz0[0] / 2), int(pos0[1] - sz0[1] / 2)
    anno0[y1:y1 + int(sz0[1]), x1:x1 + int(sz0[0])] = 1
    jpeg_dir = join(davis, "JPEGImages", "480p", VOS_VIDEO)
    anno_dir = join(davis, "Annotations", "480p", VOS_VIDEO)
    sets = join(davis, "ImageSets", "2016")
    for d in (jpeg_dir, anno_dir, sets):
        os.makedirs(d)
    for i, mask in enumerate([anno0, *masks[1:]]):
        shutil.copyfile(join(frames_dir, f"{i:05d}.jpg"), join(jpeg_dir, f"{i:05d}.jpg"))
        cv2.imwrite(join(anno_dir, f"{i:05d}.png"), mask.astype(np.uint8))
    with open(join(sets, "val.txt"), "w") as f:
        f.write(VOS_VIDEO + "\n")
    log(f"VOS pseudo-gt: {frames} frames in {time.perf_counter() - t0:.1f} s, mean mask "
        f"area {np.mean([m.sum() for m in masks[1:]]):.0f} px")

    shutil.copyfile(weights, join(root, WEIGHTS))
    settings = {"frames": frames, "frame_hw": [h, w], "fail_windows": windows,
                "displace": DISPLACE, "hp": HP, "anchors": ANCHORS}
    with open(join(root, SETTINGS), "w") as f:
        json.dump(settings, f, indent=1)
    return settings


# ---------------------------------------------------------------- protocol


def run_vot(runtime, bench: str, result_root: str, name: str, mask_enable: bool,
            log=print) -> dict[str, int]:
    """``track_vot`` over the benchmark's VOT videos -> lost count a video."""
    return {vname: track_vot(runtime, video, VOT_NAME, mask_enable=mask_enable,
                             result_dir=result_root, tracker_name=name, log=log)[0]
            for vname, video in load_dataset(VOT_NAME, bench).items()}


def run_vos(runtime, bench: str, result_root: str, name: str, log=print) -> None:
    """``track_vos`` (single object) over the benchmark's VOS video, the
    fused masks saved."""
    for video in load_dataset(VOS_NAME, bench).values():
        track_vos(runtime, video, mot_enable=False, result_dir=result_root, dataset=VOS_NAME,
                  tracker_name=name, save_mask=True, log=log)


def run_drivers(weights: str, width: int, device, bench: str, result_root: str, name: str,
                vot_mask: bool = True, vos: bool = True, dtype: torch.dtype | None = None,
                log=print) -> dict[str, int]:
    """A port checkpoint's model in ``dtype`` on ``device`` through the VOT
    protocol (the masks' rotated boxes, or with ``vot_mask`` False the
    boxes) and, with ``vos``, VOS -> lost count a video."""
    model = load_model(weights, width, device, dtype)
    p = tracker_config()
    lost = run_vot(TrackerRuntime(model, p, device, mask=vot_mask, refine=vot_mask), bench,
                   result_root, name, vot_mask, log=log)
    if vos:
        run_vos(TrackerRuntime(model, p, device), bench, result_root, name, log=log)
    return lost


# ---------------------------------------------------------------- scoring


def read_tree(result_root: str, name: str, videos) -> dict[str, list[str]]:
    """The result files' lines a video."""
    out = {}
    for v in videos:
        with open(join(result_root, VOT_NAME, name, "baseline", v, f"{v}_001.txt")) as f:
            out[v] = f.read().splitlines()
    return out


def decisions(lines: list[str]) -> dict[str, list[int]]:
    """The frames of the lost (2) and the (re-)init (1) markers."""
    return {"lost_frames": [i for i, s in enumerate(lines) if s == "2"],
            "init_frames": [i for i, s in enumerate(lines) if s == "1"]}


def _vot_dataset(bench: str, result_root: str, name: str, dataset_cls=VOTDataset):
    ds = dataset_cls(VOT_NAME, join(bench, VOT_NAME))
    ds.set_tracker(join(result_root, VOT_NAME), [name])
    return ds


def score_ar_eao(ds, name: str, ar_cls=AccuracyRobustnessBenchmark,
                 eao_cls=EAOBenchmark) -> dict:
    """EAO (VOT2018's interval), accuracy, robustness and lost of one tree
    through one eval toolkit (the benchmark classes are arguments, so that
    the JAX package's score the same tree with its own ``summarize``)."""
    s = ar_cls.summarize(ar_cls(ds).eval(name))[name]
    return {"eao": float(eao_cls(ds).eval(name)[name]["all"]), "accuracy": s["accuracy"],
            "robustness": s["robustness"], "lost": s["lost_number"]}


def score_vot(bench: str, result_root: str, name: str) -> dict:
    """The port's eval of a VOT tree, with each video's protocol decisions."""
    ds = _vot_dataset(bench, result_root, name)
    out = score_ar_eao(ds, name)
    lines = read_tree(result_root, name, ds.videos)
    out["videos"] = {v: decisions(ls) for v, ls in lines.items()}
    return out


def score_vos(bench: str, result_root: str, name: str, benchmark_cls=DAVISBenchmark,
              dataset=None) -> dict:
    """J and F (means over the frames but the first and the last) of a VOS
    tree; ``benchmark_cls`` and ``dataset`` as another toolkit gives them."""
    dataset = dataset if dataset is not None else load_dataset(VOS_NAME, bench)
    s = benchmark_cls.summarize(benchmark_cls(dataset, VOS_NAME, result_root).eval(name))[name]
    return {"J": float(s["J_mean"]), "F": float(s["F_mean"])}


def _region(line: str) -> list[float]:
    v = [float(c) for c in line.split(",")]
    if len(v) == 4:             # x, y, w, h
        x, y, w, h = v
        v = [x, y, x + w, y, x + w, y + h, x, y + h]
    return v


def compare_trees(bench: str, a: tuple[str, str], b: tuple[str, str]) -> dict:
    """Two VOT trees (result root, name) on one benchmark: whether their
    marker lines (1, 2, 0) are the same, and the overlap of their regions
    at each frame where both report one (the region library's, clipped to
    the frame)."""
    ds = VOTDataset(VOT_NAME, join(bench, VOT_NAME))
    la, lb = read_tree(*a, ds.videos), read_tree(*b, ds.videos)
    same, ious = True, []
    for v, video in ds.videos.items():
        bounds = (video.width, video.height)
        for x, y in zip(la[v], lb[v]):
            marker_x, marker_y = x in ("0", "1", "2"), y in ("0", "1", "2")
            if marker_x or marker_y:
                same &= x == y
            else:
                ious.append(vot_overlap(_region(x), _region(y), bounds))
        same &= len(la[v]) == len(lb[v])
    ious = np.array(ious)
    return {"same_decisions": bool(same), "frames_compared": int(ious.size),
            "iou_mean": float(ious.mean()) if ious.size else float("nan"),
            "iou_min": float(ious.min()) if ious.size else float("nan")}


def deltas(ours: dict, theirs: dict) -> dict:
    """Absolute differences of the metrics both have."""
    return {k: abs(ours[k] - theirs[k]) for k in ("eao", "accuracy", "robustness", "lost", "J", "F")
            if k in ours and k in theirs}


# ---------------------------------------------------------------- the tool


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Metric-level parity harness (PyTorch port)")
    parser.add_argument("--work-dir", default="build/metric_parity",
                        help="the clip, the benchmark and the result trees go here")
    parser.add_argument("--frames", type=int, default=N_FRAMES,
                        help="clip frames used: each video has 3 * frames - 3")
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--make-benchmark", action="store_true",
                     help="make the benchmark under --work-dir from this run's no-reset "
                          "passes in float32, then run on it")
    src.add_argument("--benchmark", default=None,
                     help="a benchmark directory another run made; its weights.pth is the "
                          "default weights")
    parser.add_argument("--weights", default=None,
                        help="a port checkpoint instead of tempered random weights")
    parser.add_argument("--width", type=int, default=64, help="64 is the published width")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--box-only", action="store_true",
                        help="report axis-aligned boxes instead of the masks' rotated boxes; "
                             "implies no VOS")
    parser.add_argument("--tracker-name", default=None,
                        help="the result trees' name (default port_<device>_<dtype>)")
    parser.add_argument("--compare", default=None,
                        help="another VOT tree on this benchmark, <root>/VOT2018/<name>: "
                             "the deltas to it")
    parser.add_argument("--json-out", default=None)
    return parser.parse_args(argv)


def run(args, log=print) -> dict:
    """The tool on parsed arguments: the result JSON."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("metric_parity: no CUDA card; --device cpu runs on the CPU")
    dtype = getattr(torch, args.dtype)
    name = args.tracker_name or f"port_{device.type}_{args.dtype}"
    work = args.work_dir
    results = join(work, "results")
    os.makedirs(work, exist_ok=True)
    p = tracker_config()
    t0 = time.perf_counter()

    if not args.make_benchmark:
        bench = args.benchmark
        weights = args.weights or join(bench, WEIGHTS)
    else:
        bench = join(work, "benchmark")
        frames_dir = join(work, "clip")
        if not exists(join(frames_dir, f"{N_FRAMES - 1:05d}.jpg")):
            write_overfit_clip(Path(frames_dir))
        if args.weights:
            weights = args.weights
            model = load_model(weights, args.width, device)
        else:
            model = tempered_model(read_clip(frames_dir, 1)[0], args.width, device)
            weights = join(work, "tempered.pth")
            save_checkpoint(weights, model.state_dict(), arch="Custom",
                            anchor_cfg=p.anchor_config().to_dict())
        make_benchmark(TrackerRuntime(model, p, device), frames_dir, bench, args.frames,
                       weights, log=log)
        del model
    with open(join(bench, SETTINGS)) as f:
        settings = json.load(f)
    t_bench = time.perf_counter() - t0

    mask_on = not args.box_only
    t1 = time.perf_counter()
    lost = run_drivers(weights, args.width, device, bench, results, name, vot_mask=mask_on,
                       vos=mask_on, dtype=dtype, log=log)
    t_run = time.perf_counter() - t1
    scores = score_vot(bench, results, name)
    if mask_on:
        scores.update(score_vos(bench, results, name))
    out = {"settings": {"device": str(device), "dtype": args.dtype, "width": args.width,
                        "report": "box" if args.box_only else "mask-polygon",
                        "frames_per_video": 3 * settings["frames"] - 3, "weights": weights,
                        "benchmark": bench, "fail_windows": settings["fail_windows"]},
           "tree": {"root": results, "name": name}, "lost_by_video": lost,
           "scores": scores, "seconds": {"benchmark": t_bench, "protocol": t_run}}
    if args.compare:
        other_root, other = dirname(dirname(args.compare.rstrip("/"))), basename(
            args.compare.rstrip("/"))
        theirs = score_vot(bench, other_root, other)
        if mask_on and isdir(join(other_root, VOS_NAME, other)):
            theirs.update(score_vos(bench, other_root, other))
        out["compare"] = {"tree": {"root": other_root, "name": other}, "scores": theirs,
                          "deltas": deltas(scores, theirs),
                          **compare_trees(bench, (results, name), (other_root, other))}
    return out


def main(argv=None, log=print) -> dict:
    args = parse_args(argv)
    out = run(args, log=log)
    text = json.dumps(out, indent=1)
    if args.json_out:
        os.makedirs(dirname(args.json_out) or ".", exist_ok=True)
        with open(args.json_out, "w") as f:
            f.write(text)
    print(text)
    return out


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
