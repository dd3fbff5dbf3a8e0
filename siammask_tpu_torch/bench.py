"""Benchmark of the port on one NVIDIA card: ``python3 -m siammask_tpu_torch.bench``.

Counterpart of the root ``bench.py`` (the JAX package's measurement entry
point), with its rows, metric names, units and keys:

- default (``--scan T``): ``Tracker.track_video`` over T copies of one
  480x854 uint8 frame, SiamMask-sharp in bf16 (``--fp32``: float32, which
  switches TF32 off), ``siammask_sharp_scan_fps_T{T}``; ``--streams N``:
  ``track_video_multi`` over N streams, ``siammask_sharp_scan_aggregate_fps_
  {N}streams``. The names keep the word "scan" of the JAX package's
  ``lax.scan`` although the port replays a CUDA graph of the step a frame,
  so that the rows line up with ``BENCH_r0*.json`` and ``ROADMAP.md``.
- ``--per-step``: host-driven ``Tracker.step`` / ``step_batched``,
  ``siammask_sharp_track_step_fps_per_chip`` or
  ``siammask_sharp_track_aggregate_fps_{N}streams``.
- ``--train`` (``--unfrozen``, ``--remat``): the SiamMask-base stage-1 step
  at ``--batch`` (64), ``siammask_base_train_samples_per_s_b{B}``;
  ``--train-refine``: the stage-2 step (sharp, 143x143 search, 3x3 grid,
  loss weight (0, 0, 36)), ``siammask_refine_train_samples_per_s_b{B}``.
  Both through ``Trainer.step``, its host sync included.
- ``--summary`` (also with no arguments): the five rows of ``_SUMMARY_ROWS``,
  each in its own process; one final line with the headline row's fields
  and ``summary``. A row that fails or overruns ``ROW_TIMEOUT_S`` is
  ``{"error": ...}`` and the process exits 1. No row falls back to a cached
  number and nothing runs on the CPU: the CLI needs a card.
- ``--profile-dir DIR``: a ``torch.profiler`` Chrome trace of the timed
  windows, ``DIR/<metric>.json``, which ``tools/trace_report.py`` reads.

Timing: after a warm-up, windows of T frames (tracking) or of
``TRAIN_STEPS_PER_WINDOW`` steps (training) between CUDA events, at least
``MIN_WINDOWS`` of them (``--iters`` / T, ``--iters`` / 128), chained without
a sync between windows; ``value`` is from the median window, and
``device_step_us`` / ``device_step_ms`` carry the median with the
``_min`` / ``_max`` of the windows.

FLOPs: ``count_flops`` counts the dense conv and matmul FLOPs (2 MACs) of
one eager step with ``torch.utils.flop_counter``, per frame (a step of O
streams over O) or per training step: the numerator of the JAX package's
jaxpr walk (``_walk_matmul_flops``). The depthwise xcorr is not in it: its
kernels are not torch ops, and its plain versions on the CPU, the port's
only grouped convs, are left out, as JAX's shift and Pallas xcorrs emit no
conv or matmul. Window extraction is slices and gathers here. Where the
port's count differs from the walk's, the JAX program holds matmuls the
port does not run (``tests/test_torch_bench.py`` computes each from
shapes): Refine's nearest upsamples and the mask loss's 63->127 upsample
and ground-truth windows as interpolation and one-hot matmuls, the raw mask
head that JAX's sharp step traces and drops, and each conv's input gradient,
which the walk counts over the input's extent rather than the output's.
``mfu_pct`` / ``train_mfu_pct`` are those FLOPs at the measured rate over
``PEAK_FLOPS``, the bf16 peak for fp32 rows too, as the JAX bench does.

Every row carries ``device`` and the card's ``name`` and ``power_limit``
(``nvidia-smi``), and the xcorr launches of its timed windows by kernel,
from the wrappers' counters (a graph's captured launches times its replays):
each launch is the hand-written kernel's, the packed one in bf16.

The row functions take the width, batch, iterations and device, so the
tests run them at width 8 on the CPU, where the payload names its device
``cpu``, the xcorr takes its plain versions and no MFU is given.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from siammask_tpu_torch.config import TrackerConfig
from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp
from siammask_tpu_torch.ops.xcorr import (depthwise_xcorr, depthwise_xcorr_grad_input,
                                          depthwise_xcorr_grad_kernel)
from siammask_tpu_torch.tracker.tracker import Tracker
from siammask_tpu_torch.train.trainer import OptimizerConfig, Trainer, TrainSettings

BASELINE_FPS = 56.0  # reference SiamMask (mask+refine) on RTX 2080
# reference training: 600k pairs/epoch x 20 epochs in ~10 h on 4x V100
# (reference README.md:174, experiments/siammask_base/{config.json,run.sh})
BASELINE_TRAIN_SPS = 333.0
# NVIDIA H100 SXM, dense bf16 at 700 W (data sheet): the MFU denominator of
# every row, fp32 rows too
PEAK_FLOPS = 989e12

HP = {"instance_size": 255, "out_size": 127, "base_size": 8, "seg_thr": 0.35,
      "penalty_k": 0.04, "window_influence": 0.4, "lr": 1.0}
FRAME_HW = (480, 854)     # DAVIS frame geometry
INIT_POS, INIT_SZ = (427.0, 240.0), (120.0, 160.0)
MIN_WINDOWS = 5
TRAIN_STEPS_PER_WINDOW = 8
WARMUP = 2
ROW_TIMEOUT_S = 300.0
KERNELS = {"forward": depthwise_xcorr, "grad_input": depthwise_xcorr_grad_input,
           "grad_kernel": depthwise_xcorr_grad_kernel}
# xcorr launches a training step by kernel (forward, grad-input, grad-kernel)
TRAIN_LAUNCHES = {"base": (3, 3, 3), "sharp_refine": (3, 1, 1)}

# the five rows of the performance table; the first is the headline. Each
# carries an explicit flag: a bare invocation is the summary itself.
_SUMMARY_ROWS = (
    ("scan", ["--scan", "64"]),
    ("serving_16streams", ["--streams", "16"]),
    ("train_frozen", ["--train"]),
    ("train_unfrozen", ["--train", "--unfrozen"]),
    ("train_refine", ["--train-refine"]),
)
_T0 = time.monotonic()


def _phase(msg: str) -> None:
    """A breadcrumb on stderr with the process's elapsed time (stdout holds
    only the result line)."""
    print(f"bench: {msg} [{time.monotonic() - _T0:.0f}s]", file=sys.stderr, flush=True)


def card(device: torch.device) -> dict:
    """``device`` ("cuda" or "cpu") and the card's ``name`` and
    ``power_limit`` as ``nvidia-smi`` reads them; a CPU run has neither."""
    if device.type != "cuda":
        return {"device": "cpu", "name": None, "power_limit": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, check=True).stdout.strip()
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return {"device": "cuda", "name": name, "power_limit": limit}


@torch.no_grad()
def fast_init(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill ``model``'s parameters and buffers by the JAX bench's
    ``_fast_init`` rule: BN weight and running variance 1, BN bias, running
    mean and every bias 0, every other tensor ``0.02 * randn`` from
    ``np.random.RandomState(seed)``, each in its own dtype (a bf16 sharp
    model's deconv stays bf16). The values do not match JAX's element for
    element (the flax tree is walked in another order); the rows' cost does
    not depend on them."""
    rng = np.random.RandomState(seed)
    for module in model.modules():
        bn = isinstance(module, nn.BatchNorm2d)
        for name, t in [*module.named_parameters(recurse=False),
                        *module.named_buffers(recurse=False)]:
            if not t.is_floating_point():
                continue
            if bn and name in ("weight", "running_var"):
                t.fill_(1.0)
            elif name in ("bias", "running_mean"):
                t.zero_()
            else:
                t.copy_(torch.from_numpy(rng.randn(*t.shape) * 0.02))
    return model


def _dense_conv_flop(x_shape, w_shape, _bias, _stride, _padding, _dilation, transposed,
                     _output_padding, groups, *args, out_shape=None, **kwargs) -> int:
    from torch.utils.flop_counter import conv_flop_count
    if groups > 1:       # the xcorr's plain versions: no dense conv
        return 0
    return conv_flop_count(x_shape, w_shape, out_shape, transposed=transposed)


def _fused_conv_flop(x_shape, w_shape, *_args, out_shape=None, **_kwargs) -> int:
    """cuDNN's fused conv + bias (+ add) + ReLU of a folded conv -> BN pair
    (``ops/bn_fold.py``): its conv's FLOPs, as an unfolded pair's."""
    from torch.utils.flop_counter import conv_flop_count
    return conv_flop_count(x_shape, w_shape, out_shape, transposed=False)


def count_flops(fn):
    """(dense conv and matmul FLOPs of one call of ``fn``, its result), as
    ``torch.utils.flop_counter`` counts them with grouped convs left out."""
    from torch.utils.flop_counter import FlopCounterMode
    aten = torch.ops.aten
    mapping = {aten.convolution: _dense_conv_flop, aten._convolution: _dense_conv_flop,
               aten.cudnn_convolution_relu: _fused_conv_flop,
               aten.cudnn_convolution_add_relu: _fused_conv_flop}
    with FlopCounterMode(display=False, custom_mapping=mapping) as counter:
        result = fn()
    return counter.get_total_flops(), result


def _launches() -> dict:
    return {k: [f.launches, f.packed_launches] for k, f in KERNELS.items()}


def _launches_since(before: dict) -> dict:
    """Each kernel's launches and packed launches since ``_launches()``."""
    now = _launches()
    return {k: {"launches": now[k][0] - before[k][0], "packed": now[k][1] - before[k][1]}
            for k in KERNELS}


def check_launches(what: str, got: dict, expected: dict, bf16: bool) -> None:
    """On the card: every xcorr launch the one expected, by kernel; all of
    them the packed kernel in bf16, none in fp32."""
    for k, n in expected.items():
        want = (n, n if bf16 else 0)
        if (got[k]["launches"], got[k]["packed"]) != want:
            raise RuntimeError(f"{what}: {k} xcorr launches {got[k]}, expected launches and "
                               f"packed {want}")


def time_windows(run_window, n: int, device: torch.device, profile: str | None = None) -> list:
    """ms of each of ``n`` calls of ``run_window``: CUDA events between the
    calls, one sync at the end; on the CPU, the host clock. With ``profile``
    the calls run under ``torch.profiler``, whose Chrome trace goes there."""
    ctx = None
    if profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        ctx = torch.profiler.profile(activities=activities)
        ctx.__enter__()
    try:
        if device.type == "cuda":
            events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
            events[0].record()
            for i in range(n):
                run_window()
                events[i + 1].record()
            torch.cuda.synchronize(device)
            times = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        else:
            times = []
            for _ in range(n):
                t0 = time.perf_counter()
                run_window()
                times.append((time.perf_counter() - t0) * 1e3)
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)
    if ctx is not None:
        Path(profile).parent.mkdir(parents=True, exist_ok=True)
        ctx.export_chrome_trace(profile)
    return times


def _spread(times_ms: list, per: float, scale: float, key: str) -> dict:
    """The median and the extremes of the windows, each over ``per`` and
    times ``scale``, under ``key``, ``key_min`` and ``key_max``."""
    return {key: round(statistics.median(times_ms) / per * scale, 3),
            f"{key}_min": round(min(times_ms) / per * scale, 3),
            f"{key}_max": round(max(times_ms) / per * scale, 3), "windows": len(times_ms)}


def _tf32() -> bool:
    return torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32


def _profile_path(profile_dir: str | None, metric: str) -> str | None:
    return str(Path(profile_dir) / f"{metric}.json") if profile_dir else None


def train_batch(b: int, search: int, size: int, device, k: int = 5) -> dict:
    """The JAX bench's training batch (keys, distributions and draw order
    from ``RandomState(0)``) in the port's layout: NCHW images, int64 cls
    labels."""
    rng = np.random.RandomState(0)
    batch = {
        "template": rng.uniform(0, 255, (b, 127, 127, 3)).astype(np.float32),
        "search": rng.uniform(0, 255, (b, search, search, 3)).astype(np.float32),
        "label_cls": rng.choice([-1, 0, 1], size=(b, k, size, size), p=[0.8, 0.15, 0.05]),
        "label_loc": (rng.randn(b, 4, k, size, size) * 0.1).astype(np.float32),
        "label_loc_weight": (rng.rand(b, k, size, size) < 0.1).astype(np.float32),
        "label_mask": np.sign(rng.randn(b, search, search)).astype(np.float32),
        "label_mask_weight": (rng.rand(b, size, size) < 0.05).astype(np.float32),
    }
    for key in ("template", "search"):
        batch[key] = batch[key].transpose(0, 3, 1, 2)
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}
    out["label_cls"] = out["label_cls"].long()
    return out


def bench_train(width: int = 64, batch: int = 64, device="cuda", fp32: bool = False,
                refine: bool = False, unfrozen: bool = False, remat: bool = False,
                iters: int = 1024, profile_dir: str | None = None) -> dict:
    """Training-step throughput: the JAX bench's ``bench_train``.

    Stage 1 (``refine=False``): SiamMask-base, 127 templates / 255 searches,
    25x25 grid, loss weight (1, 1.2, 36), the mask windows padded by 32;
    ``unfrozen`` is the phase after the unfreeze (layer2/3 train). Stage 2
    (``refine=True``): SiamMask-sharp, 143 searches, 3x3 grid, loss weight
    (0, 0, 36), unpadded windows, only the mask corr and Refine train.
    ``OptimizerConfig()`` at lr 0.005. The first step is counted
    (``count_flops``), then ``WARMUP`` more before the timed windows."""
    device = torch.device(device)
    dtype = None if fp32 else torch.bfloat16
    if refine:
        model = SiamMaskSharp(width=width, dtype=dtype)
        search, size = 143, 3
        settings = TrainSettings(task="sharp_refine", loss_weight=(0.0, 0.0, 36.0), mask_pad=0)
    else:
        model = SiamMaskBase(width=width, dtype=dtype)
        search, size = 255, 25
        settings = TrainSettings(task="base", loss_weight=(1.0, 1.2, 36.0), mask_pad=32)
    fast_init(model).to(device)
    # two epochs, the unfreeze at the second (as the reference's 0.5 point)
    trainer = Trainer(model, settings, OptimizerConfig(), np.full(2, 0.005), epochs=2,
                      unfreeze_at=0.5, remat=remat)
    epoch = 1 if unfrozen else 0
    data = train_batch(batch, search, size, device)
    _phase("train inputs built")
    flops, metrics = count_flops(lambda: trainer.step(data, epoch))
    for _ in range(WARMUP):
        metrics = trainer.step(data, epoch)
    _phase("train step warm")

    windows = max(MIN_WINDOWS, iters // 128)
    losses = []

    def window():
        for _ in range(TRAIN_STEPS_PER_WINDOW):
            losses.append(trainer.step(data, epoch)["total_loss"])

    before = _launches()
    stage = "refine" if refine else "base"
    metric = f"siammask_{stage}_train_samples_per_s_b{batch}"
    times = time_windows(window, windows, device, _profile_path(profile_dir, metric))
    launched = _launches_since(before)
    final_loss = float(losses[-1])
    if not np.isfinite(final_loss) or not np.isfinite(float(metrics["total_loss"])):
        raise RuntimeError(f"{metric}: loss {final_loss} is not finite")
    steps = windows * TRAIN_STEPS_PER_WINDOW
    if device.type == "cuda":
        check_launches(metric, launched, dict(zip(KERNELS, (
            n * steps for n in TRAIN_LAUNCHES[settings.task]))), not fp32)
    spread = _spread(times, TRAIN_STEPS_PER_WINDOW, 1.0, "device_step_ms")
    sps = batch * TRAIN_STEPS_PER_WINDOW / (statistics.median(times) / 1e3)
    payload = {"metric": metric, "value": round(sps, 1), "unit": "samples/s",
               "vs_baseline": round(sps / BASELINE_TRAIN_SPS, 3), **spread,
               "batch": batch, "phase": "unfrozen" if unfrozen else "frozen",
               "train_gflops_per_step": round(flops / 1e9, 1), "train_mfu_pct": None,
               "loss": final_loss, "xcorr_launches": launched, "tf32": _tf32(),
               **card(device)}
    if device.type == "cuda":
        mfu = 100.0 * flops * sps / batch / PEAK_FLOPS
        payload["train_mfu_pct"] = round(mfu, 2)
        if mfu >= 100.0:     # the count or the clock is wrong: show it
            payload["mfu_suspect"] = True
    return payload


def _finite(out) -> bool:
    return all(torch.isfinite(v).all() for v in out if v.is_floating_point())


def bench_track(width: int = 64, device="cuda", fp32: bool = False, scan: int = 64,
                streams: int = 1, per_step: bool = False, iters: int = 1024,
                profile_dir: str | None = None) -> dict:
    """Tracking throughput of SiamMask-sharp (mask and Refine): the JAX
    bench's tracking rows. One 480x854 uint8 frame from ``RandomState(0)``;
    one stream at (427, 240) / (120, 160), or ``streams`` at centres
    U(100, 400) and sizes U(60, 200). A window is ``scan`` frames: one
    ``track_video`` / ``track_video_multi`` call on the frame broadcast,
    each call's state the next one's, or (``per_step``) that many
    host-driven ``step`` / ``step_batched`` calls."""
    device = torch.device(device)
    model = SiamMaskSharp(width=width, dtype=None if fp32 else torch.bfloat16)
    model = fast_init(model).to(device).eval()
    tracker = Tracker(model, TrackerConfig().update(HP), device)
    rng = np.random.RandomState(0)
    frame = torch.from_numpy(rng.uniform(0, 255, (*FRAME_HW, 3)).astype(np.uint8)).to(device)
    if streams > 1:
        pos = rng.uniform(100, 400, (streams, 2)).astype(np.float32)
        sz = rng.uniform(60, 200, (streams, 2)).astype(np.float32)
        state = tracker.init_batched(frame, pos, sz)
        step = tracker.step_batched
    else:
        state = tracker.init(frame, np.array(INIT_POS), np.array(INIT_SZ))
        step = tracker.step
    _phase("tracker state initialized")
    flops, _ = count_flops(lambda: step(state, frame))
    flops /= streams
    frames = frame.expand(scan, *frame.shape)
    st, last = [state], [None]

    if per_step:
        def window():
            for _ in range(scan):
                st[0], out = step(st[0], frame)
                last[0] = out
    else:
        run = tracker.track_video_multi if streams > 1 else tracker.track_video

        def window():
            st[0], last[0] = run(st[0], frames)

    for _ in range(WARMUP):
        window()
    st[0] = state
    _phase("tracker warm")
    windows = max(MIN_WINDOWS, iters // scan)
    if per_step:
        metric = ("siammask_sharp_track_step_fps_per_chip" if streams == 1 else
                  f"siammask_sharp_track_aggregate_fps_{streams}streams")
    else:
        metric = (f"siammask_sharp_scan_fps_T{scan}" if streams == 1 else
                  f"siammask_sharp_scan_aggregate_fps_{streams}streams")
    before = _launches()
    times = time_windows(window, windows, device, _profile_path(profile_dir, metric))
    launched = _launches_since(before)
    if not _finite(last[0]):
        raise RuntimeError(f"{metric}: non-finite outputs")
    steps = windows * scan
    if device.type == "cuda":
        if not per_step:    # graph replays: the launches captured, times the replays
            graph = tracker.graphs[(streams, *FRAME_HW, torch.uint8)]
            launched["forward"] = {"launches": graph.xcorr_launches * steps,
                                   "packed": graph.xcorr_packed_launches * steps}
        check_launches(metric, launched, {"forward": 3 * steps, "grad_input": 0,
                                          "grad_kernel": 0}, not fp32)
    spread = _spread(times, scan * streams, 1e3, "device_step_us")
    fps = scan * streams / (statistics.median(times) / 1e3)
    payload = {"metric": metric, "value": round(fps, 2), "unit": "fps",
               "vs_baseline": round(fps / BASELINE_FPS, 3), **spread, "streams": streams,
               "frames_per_window": scan, "xcorr_launches": launched, "tf32": _tf32(),
               **card(device)}
    if not per_step:
        payload["model_gflops_per_frame"] = round(flops / 1e9, 3)
        payload["mfu_pct"] = (round(100.0 * flops * fps / PEAK_FLOPS, 3)
                              if device.type == "cuda" else None)
    return payload


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python3 -m siammask_tpu_torch.bench")
    parser.add_argument("--summary", action="store_true",
                        help="every row of _SUMMARY_ROWS, each in its own process, then one "
                             "line: the scan row's fields and 'summary' (also with no "
                             "arguments)")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler Chrome trace of the timed windows here")
    parser.add_argument("--iters", type=int, default=1024,
                        help="frames (tracking) or 128 x windows (training) to time; at "
                             f"least {MIN_WINDOWS} windows")
    parser.add_argument("--fp32", action="store_true",
                        help="float32 compute, TF32 off (default bf16 over float32 weights)")
    parser.add_argument("--scan", type=int, default=64, help="frames a window")
    parser.add_argument("--per-step", action="store_true",
                        help="host-driven step calls instead of track_video")
    parser.add_argument("--streams", type=int, default=1,
                        help="independent streams on one frame; aggregate frames/s")
    parser.add_argument("--train", action="store_true",
                        help="the SiamMask-base stage-1 training step")
    parser.add_argument("--train-refine", action="store_true",
                        help="the stage-2 refine training step")
    parser.add_argument("--batch", type=int, default=64, help="training batch")
    parser.add_argument("--remat", action="store_true",
                        help="training: recompute the forward in the backward")
    parser.add_argument("--unfrozen", action="store_true",
                        help="training: the phase after the backbone's unfreeze")
    return parser


def _row_command(argv: list) -> list:
    return [sys.executable, "-m", "siammask_tpu_torch.bench", *argv]


def _run_row(name: str, argv: list, timeout: float) -> dict:
    """One row in its own process: its result line, or RuntimeError (a
    non-zero exit, no result line, or more than ``timeout`` s, after which
    the process is killed)."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(root), env.get("PYTHONPATH")) if p)
    try:
        proc = subprocess.run(_row_command(argv), capture_output=True, text=True, env=env,
                              cwd=root, timeout=timeout)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"exceeded {timeout:.0f} s") from None
    for line in proc.stderr.splitlines():
        if line.startswith("bench: "):
            print(f"  [{name}] {line[7:]}", file=sys.stderr, flush=True)
    payload = None
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            payload = json.loads(line)
            break
        except ValueError:
            continue
    if proc.returncode != 0 or not isinstance(payload, dict):
        raise RuntimeError(f"rc={proc.returncode}: {proc.stderr.strip()[-300:]}")
    return payload


def run_summary(extra: list = ()) -> int:
    """Every row of ``_SUMMARY_ROWS`` in turn, each with ``extra`` flags;
    prints one line, the headline row's metric, value, unit and vs_baseline
    with ``summary`` (every row's payload, or ``{"error": ...}``), and
    returns 1 if a row failed, else 0."""
    results, failed = {}, False
    t0 = time.monotonic()
    for name, argv in _SUMMARY_ROWS:
        try:
            results[name] = _run_row(name, [*argv, *extra], ROW_TIMEOUT_S)
        except RuntimeError as e:
            results[name] = {"error": str(e)[:300]}
            failed = True
        print(f"bench summary: {name} done [{time.monotonic() - t0:.0f}s]", file=sys.stderr,
              flush=True)
    headline = results[_SUMMARY_ROWS[0][0]]
    top = {k: headline[k] for k in ("metric", "value", "unit", "vs_baseline") if k in headline}
    print(json.dumps({**top, "summary": results}))
    return 1 if failed else 0


def main(argv: list | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = _build_parser().parse_args(argv)
    if args.summary or not argv:
        extra = ["--iters", str(args.iters)] + (["--fp32"] if args.fp32 else [])
        if args.profile_dir:
            extra += ["--profile-dir", args.profile_dir]
        return run_summary(extra)
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA card visible; the bench measures the card only")
    profile = ({"profile_dir": args.profile_dir} if args.profile_dir else {})
    if args.train or args.train_refine:
        payload = bench_train(batch=args.batch, fp32=args.fp32, refine=args.train_refine,
                              unfrozen=args.unfrozen, remat=args.remat, iters=args.iters,
                              **profile)
    else:
        payload = bench_track(fp32=args.fp32, scan=args.scan, streams=args.streams,
                              per_step=args.per_step, iters=args.iters, **profile)
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(main())
