#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: ``python3 chip_smoke.py``.

Drives the port's main paths at the published width (64; 127x127
template, 255x255 search, 25x25x5 anchors) in fp32 with TF32 off, on
synthetic uint8 frames made from a numpy seed, with seeded random weights:

- the SiamMask-sharp track step (``Tracker.init`` / ``Tracker.step``,
  127x127 masks) on 480x854 frames;
- whole videos: ``Tracker.track_video`` over 64 frames, a CUDA-graph replay
  per frame, and 16 streams on one frame (``init_batched`` /
  ``step_batched`` / ``track_video_multi`` over 32 frames);
- the VOS drivers (``track_vos_batched``, ``track_vos``) on a YouTube-VOS-
  style video of 41 frames and three objects written under ``build/``;
- the SiamMask-base stage-1 training step (``Trainer.step``, the
  ``experiments/siammask_base/config.json`` recipe) at batch 64, two steps
  with the backbone frozen and two after the unfreeze.

Phases, each of which raises on failure:

1. device: a CUDA card is required; its name and power limit are printed;
2. build: the hand-written kernels are compiled from ``siammask_tpu_torch/csrc``;
3. the forward xcorr kernel vs its plain version at the tracking shape, B=16,
   the training batch (B=64), a ragged shape and bf16; kernel and plain times
   at B=1 (fp32, bf16), B=16 and B=64 (fp32);
4. the two gradient kernels vs their plain versions at B=1, B=16, B=64, a
   ragged shape and bf16; two B=64 calls of each bit-identical; kernel and
   plain times at B=1, B=16 and B=64 beside each kernel's bound, and the
   eager autograd backward through the kernels vs through the plain forward;
5. the track slice: init + steps, with finite outputs in bounds, three xcorr
   kernel launches per step, and one step under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
6. the same track step on the card and on the CPU from the same state, open
   loop;
7. per-step track latency and frames/s on the card;
8. the video: ``track_video`` over 64 frames on the card against the eager
   ``step`` loop from the same state (the same ``best_id`` at every frame,
   every output bit-identical), one call under ``sync_debug_mode("error")``,
   3 xcorr kernels a frame, frames/s (median of 5 calls by CUDA events), and
   device ms a frame, idle share and host calls a frame from one profiled
   call; peak memory;
9. 16 streams: ``init_batched`` (centres U(100, 400), sizes U(60, 200)),
   ``step_batched`` with 3 xcorr launches at B=16 and each stream against
   the single-stream ``step`` from the same state, ``track_video_multi``
   over 32 frames against the eager ``step_batched`` loop (bit-identical),
   aggregate frames/s, the profile of one batched step (top 10 device ops,
   busy share) and of one graph call; peak memory;
10. ``step_batched`` at O=2 on the card and on the CPU from the same state,
    open loop; then the device time of each layer of the step (crop,
    backbone and heads, decode tail, skip windows, Refine, warp-back, the
    rest) at O=1 and O=16, on the step's own intermediates;
11. the VOS drivers: ``track_vos_batched`` (ragged stretches through
    ``step_batched``, one full window through the graph, a re-init at the
    late start; 3 xcorr launches a frame) against ``track_vos``, the late
    object absent before its start, object-frames/s; skipped, with a line
    that says so, where cv2 or PIL is not installed;
12. the training slice: per step finite losses, no skip, 3 + 3 + 3 kernel
    launches, the frozen stages bit-identical and the trainable ones moved;
    then the loss falling over 8 steps on the repeated batch; peak memory;
13. one training step on the card and on the CPU from the same weights and
    batch (B=2), open loop;
14. the profile of one frozen and one unfrozen step (no backbone backward
    while frozen), and train ms/step and samples/s.

The last line is ``{"ok": true, "device": {...}}``; the line before it lists
each kernel with its launches on the main paths, error, times, bound and
the time of the one library call (cuDNN's grouped conv) that computes the
same function. A kernel captured in a CUDA graph passes through its wrapper
(and its count) once, at capture; on the graph paths its launches are the
captured launches times the replays, which phases 8 and 9 confirm by kernel
name in a profiler trace.
"""
from __future__ import annotations

import contextlib
import json
import math
import shutil
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from siammask_tpu_torch.config import Config
from siammask_tpu_torch.data.anchor_target import AnchorTarget
from siammask_tpu_torch.eval.datasets import load_dataset
from siammask_tpu_torch.models.heads import slice_skip_windows
from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp
from siammask_tpu_torch.ops import _build
from siammask_tpu_torch.ops.sample import subwindow_crop, warp_back_mask
from siammask_tpu_torch.ops.xcorr import (_to_groups, depthwise_xcorr,
                                          depthwise_xcorr_grad_input,
                                          depthwise_xcorr_grad_input_reference,
                                          depthwise_xcorr_grad_kernel,
                                          depthwise_xcorr_grad_kernel_reference,
                                          depthwise_xcorr_reference)
from siammask_tpu_torch.tracker.anchors import Anchors
from siammask_tpu_torch.tracker.runtime import TrackerRuntime
from siammask_tpu_torch.tracker.tracker import StepOutput, Tracker, TrackState
from siammask_tpu_torch.tracker.vos import track_vos, track_vos_batched
from siammask_tpu_torch.train.lr import build_lr_spaces
from siammask_tpu_torch.train.trainer import OptimizerConfig, Trainer, TrainSettings

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "experiments" / "siammask_sharp" / "config_davis.json"
TRAIN_CONFIG = REPO / "experiments" / "siammask_base" / "config.json"
FRAME_HW = (480, 854)
TARGET_POS, TARGET_SZ = (300.0, 200.0), (120.0, 90.0)
SEED = 0
STEPS = 20
TIMED_STEPS = 50
VIDEO_T = 64              # bench.py's siammask_sharp_scan_fps_T64
STREAMS, STREAMS_T = 16, 32
# the VOS phase: a YouTube-VOS-style video, three objects, the third from
# frame VOS_LATE; frames 1-10 and 27-40 step through step_batched, 11-26 are
# one full window through the graph
VOS_FRAMES, VOS_CHUNK, VOS_LATE = 41, 16, 10
VOS_RAGGED, VOS_FULL = 24, 16
TIMED_CALLS = 5
TRAIN_BATCH = 64          # tools/train.py's default
TRAIN_EPOCHS = 2          # epoch 0 frozen, epoch 1 unfrozen (unfreeze_at 0.5)
TRAIN_FRAME_HW = (360, 480)
KERNELS = (depthwise_xcorr, depthwise_xcorr_grad_input, depthwise_xcorr_grad_kernel)
# an H100 SXM's published peaks at 700 W: HBM3 and fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def synthetic_frames(n: int, hw=FRAME_HW, seed: int = SEED) -> np.ndarray:
    """(n, H, W, 3) uint8: smoothed noise with a textured rectangle that starts
    at TARGET_POS/TARGET_SZ and drifts a few pixels a frame."""
    rng = np.random.RandomState(seed)
    h, w = hw
    coarse = rng.randint(0, 256, size=(h // 8 + 1, w // 8 + 1, 3)).astype(np.uint8)
    background = np.repeat(np.repeat(coarse, 8, axis=0), 8, axis=1)[:h, :w]
    tw, th = int(TARGET_SZ[0]), int(TARGET_SZ[1])
    patch = rng.randint(0, 256, size=(th, tw, 3)).astype(np.uint8)
    frames = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        frames[i] = background
        x0 = int(TARGET_POS[0] - tw / 2) + 3 * i
        y0 = int(TARGET_POS[1] - th / 2) + 2 * i
        frames[i, y0:y0 + th, x0:x0 + tw] = patch
    return frames


@contextlib.contextmanager
def bn_calibration(model: torch.nn.Module):
    """While open, every BatchNorm that runs first sets running_mean 0 and
    one running_var per layer, the mean square of its input."""
    def hook(bn, inputs):
        bn.running_mean.zero_()
        bn.running_var.fill_(inputs[0].pow(2).mean())

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.BatchNorm2d)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


@torch.inference_mode()
def calibrate_bn(model: SiamMaskSharp, z: torch.Tensor, x: torch.Tensor) -> None:
    """Scale every BatchNorm by the overall standard deviation of its input on
    one template/search pair (running_mean 0, one running_var per layer), so
    random-weight activations stay O(1) like a trained model's and the scores
    do not saturate. One scalar per layer, not per channel, so that nearly dead
    channels are not amplified."""
    with bn_calibration(model):
        zf = model.template(z)
        model.track_mask(zf, x)


def smi_line() -> str:
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_us(fn, *args, n: int = 100, reps: int = 5) -> float:
    """Device time of one call: ``n`` calls captured in a CUDA graph, replayed
    ``reps`` times; median of the replays over n, in microseconds."""
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / n)
    return statistics.median(times)


def eager_us(fn, *args, n: int = 100) -> float:
    """Median of ``n`` eager calls, each bracketed by CUDA events (launch
    overhead included), in microseconds."""
    for _ in range(10):
        fn(*args)
    times = []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def in_turns(kernel_fn, plain_fn, *args) -> tuple[list[float], list[float]]:
    """(device us, eager us) of the kernel and of the plain version, timed in
    turns (plain, kernel, kernel, plain); each side keeps its faster turn."""
    t = {}
    for name, fn in (("plain", plain_fn), ("kernel", kernel_fn), ("kernel2", kernel_fn),
                     ("plain2", plain_fn)):
        t[name] = (graph_us(fn, *args), eager_us(fn, *args))
    kernel = [min(t["kernel"][i], t["kernel2"][i]) for i in range(2)]
    plain = [min(t["plain"][i], t["plain2"][i]) for i in range(2)]
    return kernel, plain


def bound_us(x: torch.Tensor, k: torch.Tensor) -> tuple[float, str]:
    """The least time the card could take for the forward or either gradient
    at search x and template k, in microseconds, and what bounds it. Each of
    the three reads two of (x, k, out) and writes the third, and does
    B*Ho*Wo*Hk*Wk*C FMAs: the larger of those bytes at PEAK_BYTES_PER_S and
    those FLOPs (2 an FMA) at PEAK_FP32_FLOPS."""
    b, hx, wx, c = x.shape
    _, hk, wk, _ = k.shape
    ho, wo = hx - hk + 1, wx - wk + 1
    nbytes = (x.numel() + k.numel() + b * ho * wo * c) * x.element_size()
    fmas = b * ho * wo * hk * wk * c
    by_bytes, by_ops = nbytes / PEAK_BYTES_PER_S * 1e6, 2 * fmas / PEAK_FP32_FLOPS * 1e6
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def library_us(which: str, a: torch.Tensor, b: torch.Tensor) -> float:
    """Device time of the one PyTorch call that computes a kernel's function,
    cuDNN's grouped conv with groups=B*C, on its inputs already in the conv's
    layout (the plain versions also pay the NHWC copies): "forward"
    ``F.conv2d`` (a = x, b = k), "input" ``F.conv_transpose2d`` (a = g,
    b = k) or "kernel" ``F.conv2d`` with g as the filter (a = x, b = g)."""
    groups = a.shape[0] * a.shape[3]
    data, weight = _to_groups(a)[None], _to_groups(b)[:, None]
    conv = F.conv_transpose2d if which == "input" else F.conv2d
    return graph_us(lambda: conv(data, weight, groups=groups))


def time_kernel(tag: str, kernel_fn, plain_fn, args: tuple, which: str, lib_args: tuple,
                x: torch.Tensor, k: torch.Tensor) -> dict:
    """Times a kernel and its plain version in turns, then the library call
    (``library_us(which, *lib_args)``), at search x and template k; prints
    one line and returns the record's times and bound."""
    kernel, plain = in_turns(kernel_fn, plain_fn, *args)
    library = library_us(which, *lib_args)
    bound = bound_us(x, k)
    print(f"{tag}: kernel {kernel[0]:.2f} us device / {kernel[1]:.2f} us eager; plain "
          f"{plain[0]:.2f} us device / {plain[1]:.2f} us eager; library call {library:.2f} us "
          f"device; bound {bound[0]:.2f} us ({bound[1]}), {100 * bound[0] / kernel[0]:.0f}% of it")
    return {"ms": kernel[0] / 1e3, "plain_ms": plain[0] / 1e3, "library_ms": library / 1e3,
            "bound_ms": bound[0] / 1e3, "bound_by": bound[1]}


def check_close(what: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    """Kernel vs plain version: fp32 differs only in summation order (1e-4 of
    the largest entry); bf16 rounds its output once on each side (2e-2)."""
    scale = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    atol = (1e-4 if out.dtype == torch.float32 else 2e-2) * scale
    torch.testing.assert_close(out.float(), ref.float(), rtol=1e-5, atol=atol)
    print(f"[{what}] max_abs_err {err:.3e} (atol {atol:.3e}, max|ref| {scale:.3f})")
    return err


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}")
    print(f"[device] nvidia-smi: {smi}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    print(f"[build] {path.relative_to(REPO)} ready in {time.perf_counter() - t0:.2f} s")


def phase_kernels() -> dict:
    """Kernel vs plain version on the card; returns the record, timed at the
    tracking shape (B=1)."""
    g = torch.Generator().manual_seed(SEED)
    cases = [((1, 29, 29, 256), (1, 5, 5, 256), torch.float32),
             ((16, 29, 29, 256), (16, 5, 5, 256), torch.float32),
             ((TRAIN_BATCH, 29, 29, 256), (TRAIN_BATCH, 5, 5, 256), torch.float32),
             ((3, 17, 23, 200), (3, 4, 3, 200), torch.float32),
             ((1, 29, 29, 256), (1, 5, 5, 256), torch.bfloat16)]
    errors = {}
    for xs, ks, dtype in cases:
        x = torch.randn(xs, generator=g).to("cuda", dtype)
        k = torch.randn(ks, generator=g).to("cuda", dtype)
        out = depthwise_xcorr(x, k)
        torch.cuda.synchronize()
        ref = depthwise_xcorr_reference(x, k)
        torch.cuda.synchronize()
        errors[(xs, dtype)] = check_close(f"kernel {xs} * {ks} {str(dtype)[6:]}", out, ref)

    times = {}
    for b, dtype in ((1, torch.float32), (1, torch.bfloat16), (16, torch.float32),
                     (TRAIN_BATCH, torch.float32)):
        x = torch.randn((b, 29, 29, 256), generator=g).to("cuda", dtype)
        k = torch.randn((b, 5, 5, 256), generator=g).to("cuda", dtype)
        times[(b, dtype)] = time_kernel(
            f"[kernel] ({b},29,29,256)*({b},5,5,256) {str(dtype)[6:]}", depthwise_xcorr,
            depthwise_xcorr_reference, (x, k), "forward", (x, k), x, k)
    return {"name": "depthwise_xcorr", "route": "cuda",
            "source": "siammask_tpu_torch/csrc/xcorr.cu",
            "replaces": "siammask_tpu/ops/xcorr_pallas.py:67",
            "max_abs_err": errors[((1, 29, 29, 256), torch.float32)],
            **times[(1, torch.float32)]}


def phase_grad_kernels() -> list[dict]:
    """The two gradient kernels vs their plain versions on the card; returns
    their records, timed at the training shape (B=64)."""
    g = torch.Generator().manual_seed(SEED + 1)

    def inputs(xs, ks, dtype):
        go = (xs[0], xs[1] - ks[1] + 1, xs[2] - ks[2] + 1, xs[3])
        return tuple(torch.randn(s, generator=g).to("cuda", dtype) for s in (xs, ks, go))

    errors = {}
    for xs, ks, dtype in [((1, 29, 29, 256), (1, 5, 5, 256), torch.float32),
                          ((16, 29, 29, 256), (16, 5, 5, 256), torch.float32),
                          ((TRAIN_BATCH, 29, 29, 256), (TRAIN_BATCH, 5, 5, 256), torch.float32),
                          ((3, 17, 23, 200), (3, 4, 3, 200), torch.float32),
                          ((1, 29, 29, 256), (1, 5, 5, 256), torch.bfloat16)]:
        x, k, go = inputs(xs, ks, dtype)
        dx = depthwise_xcorr_grad_input(go, k, xs[1], xs[2])
        dk = depthwise_xcorr_grad_kernel(x, go)
        torch.cuda.synchronize()
        ref_dx = depthwise_xcorr_grad_input_reference(go, k, xs[1], xs[2])
        ref_dk = depthwise_xcorr_grad_kernel_reference(x, go)
        torch.cuda.synchronize()
        tag = f"{xs} * {ks} {str(dtype)[6:]}"
        errors[("input", xs, dtype)] = check_close(f"grad-input {tag}", dx, ref_dx)
        errors[("kernel", xs, dtype)] = check_close(f"grad-kernel {tag}", dk, ref_dk)
        if xs[0] == TRAIN_BATCH:
            # no atomics: a second call gives the same bits
            for which, first, again in (
                    ("input", dx, depthwise_xcorr_grad_input(go, k, xs[1], xs[2])),
                    ("kernel", dk, depthwise_xcorr_grad_kernel(x, go))):
                torch.cuda.synchronize()
                if not torch.equal(again, first):
                    raise AssertionError(f"grad-{which} {tag}: two calls differ")
                print(f"[grad] grad-{which} {tag}: two calls bit-identical")

    times = {}
    for b in (1, 16, TRAIN_BATCH):
        x, k, go = inputs((b, 29, 29, 256), (b, 5, 5, 256), torch.float32)
        times[("input", b)] = time_kernel(
            f"[grad] grad-input B={b} fp32", depthwise_xcorr_grad_input,
            depthwise_xcorr_grad_input_reference, (go, k, 29, 29), "input", (go, k), x, k)
        times[("kernel", b)] = time_kernel(
            f"[grad] grad-kernel B={b} fp32", depthwise_xcorr_grad_kernel,
            depthwise_xcorr_grad_kernel_reference, (x, go), "kernel", (x, go), x, k)
        # the whole backward through autograd, eager: the Function's two
        # kernels vs autograd of the plain forward (cuDNN's grouped conv)
        x.requires_grad_()
        k.requires_grad_()
        outs = {"kernel": depthwise_xcorr(x, k), "plain": depthwise_xcorr_reference(x, k)}
        bwd = {name: (lambda out=out: torch.autograd.grad(out, (x, k), go, retain_graph=True))
               for name, out in outs.items()}
        # in turns (plain, kernel, kernel, plain); each keeps its faster turn
        t = [eager_us(bwd[name]) for name in ("plain", "kernel", "kernel", "plain")]
        kernel, plain = min(t[1], t[2]), min(t[0], t[3])
        print(f"[grad] autograd backward (dx and dk) B={b} fp32, eager: kernels "
              f"{kernel:.2f} us; plain autograd {plain:.2f} us")

    # the custom_vjp backward of depthwise_xcorr_ad
    return [{"name": f"depthwise_xcorr_grad_{which}", "route": "cuda",
             "source": "siammask_tpu_torch/csrc/xcorr.cu",
             "replaces": "siammask_tpu/ops/xcorr_pallas.py:48",
             "max_abs_err": errors[(which, (TRAIN_BATCH, 29, 29, 256), torch.float32)],
             **times[(which, TRAIN_BATCH)]} for which in ("input", "kernel")]


def build_model(p) -> tuple[SiamMaskSharp, Tracker, np.ndarray]:
    model = SiamMaskSharp(width=64).init_weights(torch.Generator().manual_seed(SEED))
    model = model.to("cuda").eval()
    frames = synthetic_frames(STEPS + TIMED_STEPS + 12)
    f0 = torch.from_numpy(frames[0]).cuda()
    avg = f0.mean(dim=(0, 1), dtype=torch.float32)
    pos = torch.tensor([TARGET_POS], device="cuda")
    z = subwindow_crop(f0, pos, torch.tensor([180.0], device="cuda"), 127, avg[None])
    x = subwindow_crop(f0, pos, torch.tensor([360.0], device="cuda"), 255, avg[None])
    calibrate_bn(model, z.permute(0, 3, 1, 2).contiguous(), x.permute(0, 3, 1, 2).contiguous())
    return model, Tracker(model, p, "cuda"), frames


def check_output(out, hw) -> None:
    h, w = hw
    for name in out._fields:
        v = getattr(out, name)
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise AssertionError(f"non-finite {name}")
    sz, pos = out.target_sz.cpu(), out.target_pos.cpu()
    bounds = torch.tensor([w, h], dtype=torch.float32)
    if not (torch.all(sz >= 10.0) and torch.all(sz <= bounds)):
        raise AssertionError(f"target_sz {sz} outside [10, {bounds}]")
    if not (torch.all(pos >= 0.0) and torch.all(pos <= bounds)):
        raise AssertionError(f"target_pos {pos} outside [0, {bounds}]")
    if tuple(out.mask_in_frame.shape) != (h, w) or tuple(out.mask_logits.shape) != (127, 127):
        raise AssertionError(f"mask shapes {tuple(out.mask_in_frame.shape)}, "
                             f"{tuple(out.mask_logits.shape)}")


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def read_launches() -> list[int]:
    return [fn.launches for fn in KERNELS]


def phase_slice(tracker: Tracker, frames: np.ndarray):
    dev_frames = [torch.from_numpy(f).cuda() for f in frames[1:STEPS + 2]]
    torch.cuda.synchronize()
    reset_launches()
    state = tracker.init(frames[0], TARGET_POS, TARGET_SZ)
    outs = []
    for f in dev_frames[:STEPS]:
        state, out = tracker.step(state, f)
        outs.append(out)
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, out = tracker.step(state, dev_frames[STEPS])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    outs.append(out)
    torch.cuda.synchronize()
    launches = read_launches()
    steps = len(outs)
    if launches != [3 * steps, 0, 0]:
        raise AssertionError(f"{launches} forward/grad-input/grad-kernel launches in {steps} "
                             f"steps, expected {[3 * steps, 0, 0]}")
    for out in outs:
        check_output(out, FRAME_HW)
    last = outs[-1]
    print(f"[slice] init + {steps} steps at width 64: {launches[0]} xcorr launches; "
          f"step {steps} ran under sync_debug_mode=error; last pos "
          f"{last.target_pos.cpu().tolist()} sz {last.target_sz.cpu().tolist()} "
          f"score {last.score.item():.4f} best_id {last.best_id.item()}")
    return state, launches


def cpu_tracker_of(model: SiamMaskSharp, p) -> Tracker:
    """The same weights in a tracker on the CPU."""
    cpu_model = SiamMaskSharp(width=64)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    return Tracker(cpu_model.eval(), p, "cpu")


def check_step_close(what: str, out: StepOutput, ref: StepOutput) -> float:
    """A step's outputs against a reference step of other kernels (cuDNN's
    summation order against the CPU's, or another batch size): the same
    best_id, positions and sizes within 1e-2 px, the Refine mask within 1e-3
    of its largest magnitude. Returns the mask's max abs error."""
    ref = StepOutput(*(v.to(out.best_id.device) for v in ref))
    if not torch.equal(out.best_id, ref.best_id):
        raise AssertionError(f"{what}: best_id {out.best_id.tolist()} vs {ref.best_id.tolist()}")
    torch.testing.assert_close(out.target_pos, ref.target_pos, rtol=0, atol=1e-2)
    torch.testing.assert_close(out.target_sz, ref.target_sz, rtol=0, atol=1e-2)
    scale = ref.mask_logits.abs().max().item()
    torch.testing.assert_close(out.mask_logits, ref.mask_logits, rtol=0, atol=1e-3 * scale)
    return (out.mask_logits - ref.mask_logits).abs().max().item()


def phase_cpu_parity(model, tracker, cpu_tracker, state: TrackState, frame: np.ndarray) -> None:
    """The same step on the card and on the CPU, from the same state, open
    loop. Tolerances cover cuDNN's summation order against the CPU's over a
    ResNet-50 of random weights."""
    cpu_model = cpu_tracker.model
    cpu_state = TrackState(*(t.cpu() for t in state))

    with torch.inference_mode():
        x = subwindow_crop(torch.from_numpy(frame), cpu_state.target_pos[None],
                           torch.tensor([400.0]), 255, cpu_state.avg_chans[None])
        x = x.permute(0, 3, 1, 2).contiguous()
        ref = cpu_model.track_mask(cpu_state.zf, x)
        ours = model.track_mask(state.zf, x.cuda())
        cell = torch.tensor([[12, 12]])
        ref_m = cpu_model.track_refine(ref.skips, ref.corr, cell)
        ours_m = model.track_refine(ours.skips, ours.corr, cell.cuda())
    # maps: relative floor, 1e-3 of the largest magnitude (fp32, TF32 off)
    for name, a, b in (("score", ours.score, ref.score), ("loc", ours.loc, ref.loc),
                       ("refine logits", ours_m, ref_m)):
        scale = b.abs().max().item()
        err = (a.cpu() - b).abs().max().item()
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-3 * scale)
        print(f"[parity] {name}: max_abs_err {err:.3e} (atol {1e-3 * scale:.3e})")

    _, out = tracker.step(state, torch.from_numpy(frame).cuda())
    _, ref_out = cpu_tracker.step(cpu_state, frame)
    err = check_step_close("step, card vs CPU", out, ref_out)
    print(f"[parity] step: best_id {out.best_id.item()} on both; pos "
          f"{out.target_pos.cpu().tolist()} vs {ref_out.target_pos.tolist()}; "
          f"mask max_abs_err {err:.3e}")


def phase_timing(tracker: Tracker, state: TrackState, frames: np.ndarray, smi: str) -> None:
    dev_frames = [torch.from_numpy(f).cuda() for f in frames]
    for f in dev_frames[:10]:
        state, _ = tracker.step(state, f)
    torch.cuda.synchronize()
    event_ms, wall_ms = [], []
    for f in dev_frames[10:10 + TIMED_STEPS]:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        state, _ = tracker.step(state, f)
        end.record()
        end.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
    med = statistics.median(event_ms)
    # p80: the highest percentile with ten of the fifty samples beyond it
    p80 = statistics.quantiles(event_ms, n=5)[-1]
    print(f"[timing] fp32 step, width 64, TF32 off, frame on the card, host-driven: "
          f"median {med:.3f} ms, p80 {p80:.3f} ms (CUDA events), "
          f"{statistics.median(wall_ms):.3f} ms median (host clock to sync) over "
          f"{TIMED_STEPS} steps; {1e3 / med:.1f} frames/s | {smi}")


def stacked(outs: list) -> StepOutput:
    return StepOutput(*(torch.stack(v) for v in zip(*outs)))


def check_bit_identical(what: str, outs: StepOutput, ref: StepOutput, final: TrackState,
                        ref_final: TrackState) -> None:
    """A graph replay against the eager loop: the same kernels in the same
    order, so the same best_id at every frame and the same bits."""
    if not torch.equal(outs.best_id, ref.best_id):
        bad = (outs.best_id != ref.best_id).nonzero()[:, 0].tolist()
        raise AssertionError(f"{what}: best_id differs at frames {bad}")
    for name, a, b in (*zip(StepOutput._fields, outs, ref),
                       *zip(("final " + f for f in TrackState._fields), final, ref_final)):
        if not torch.equal(a, b):
            err = (a.float() - b.float()).abs().max().item()
            raise AssertionError(f"{what}: {name} is not bit-identical (max abs diff {err:.3e})")


def time_calls(fn) -> tuple[list[float], list[float]]:
    """(CUDA-event ms, host ms to the end of the work) of TIMED_CALLS calls;
    the caller has run ``fn`` before (a graph's capture and first replays)."""
    torch.cuda.synchronize()
    event_ms, wall_ms = [], []
    for _ in range(TIMED_CALLS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
    return event_ms, wall_ms


def profile_call(fn) -> tuple[list, float, float]:
    """One call under torch.profiler: (the averaged events, the device-busy
    ms summed over kernels and copies, the call's ms by CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return events, busy, start.elapsed_time(end)


def check_graph_profile(what: str, events, busy: float, call_ms: float, frames: int,
                        streams: int) -> None:
    """Confirms 3 xcorr kernels a frame by kernel name in the trace of a
    graph call and prints device ms a frame, the idle share and the host's
    CUDA calls a frame."""
    xcorr = sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                and "depthwise_xcorr" in e.key)
    if xcorr != 3 * frames:
        raise AssertionError(f"{what}: {xcorr} xcorr kernels in the trace of {frames} frames")
    host = {k: sum(e.count for e in events if e.key == k)
            for k in ("cudaGraphLaunch", "cudaMemcpyAsync", "cudaLaunchKernel")}
    print(f"[{what}] profiled call: {xcorr} xcorr kernels by name ({xcorr // frames} a frame); "
          f"device busy {busy:.3f} ms of {call_ms:.3f} ms, {busy / frames:.3f} ms a frame "
          f"({busy / (frames * streams):.3f} ms a stream-frame), idle share "
          f"{100 * (1 - busy / call_ms):.1f}%; host calls a frame: "
          + ", ".join(f"{k} {v / frames:.1f}" for k, v in host.items()))


def phase_video(tracker: Tracker, frames: np.ndarray, smi: str) -> tuple[int, TrackState]:
    """track_video over VIDEO_T frames on the card: a CUDA-graph replay per
    frame, against the eager step loop; returns the xcorr launches of the
    graph path (captured launches times replays) and the final state."""
    t = VIDEO_T
    dev = torch.from_numpy(frames[:t + 1]).cuda()
    state = tracker.init(dev[0], TARGET_POS, TARGET_SZ)
    st, eager = state, []
    for f in dev[1:]:
        st, out = tracker.step(st, f)
        eager.append(out)
    eager = stacked(eager)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    final, outs = tracker.track_video(state, dev[1:])    # captures, then T replays
    torch.cuda.synchronize()
    counted = read_launches()
    graph = tracker.graphs[(1, *FRAME_HW, torch.uint8)]
    if counted[0] == 0 or counted[1:] != [0, 0] or graph.xcorr_launches != 3:
        raise AssertionError(f"video: {counted} launches through the wrappers, "
                             f"{graph.xcorr_launches} xcorr kernels captured (expected 3)")
    peak = torch.cuda.max_memory_allocated()
    check_bit_identical("video", outs, eager, final, st)
    for i in range(t):
        check_output(StepOutput(*(v[i] for v in outs)), FRAME_HW)
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = tracker.track_video(state, dev[1:])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check_bit_identical("video, second call", again[1], eager, again[0], st)
    print(f"[video] track_video, T={t}, width 64, 480x854 uint8: a CUDA graph of the step "
          f"({graph.xcorr_launches} xcorr kernels captured; {counted[0]} xcorr launches "
          f"through the wrapper, warm-up and capture), {graph.xcorr_launches * t} xcorr "
          f"launches by replay; best_id and every output bit-identical to the eager step "
          f"loop; the second call ran under sync_debug_mode=error; peak memory "
          f"{peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held before the call)")
    event_ms, wall_ms = time_calls(lambda: tracker.track_video(state, dev[1:]))
    med = statistics.median(event_ms)
    print(f"[video] {TIMED_CALLS} calls of T={t}: median {med:.3f} ms (CUDA events; min "
          f"{min(event_ms):.3f}, max {max(event_ms):.3f}), {med / t:.3f} ms a frame, "
          f"{t * 1e3 / med:.1f} frames/s; host clock to the end "
          f"{statistics.median(wall_ms):.3f} ms | {smi}")
    check_graph_profile("video", *profile_call(lambda: tracker.track_video(state, dev[1:])),
                        t, 1)
    return graph.xcorr_launches * t, final


def stream_state(states: TrackState, i: int) -> TrackState:
    return TrackState(states.target_pos[i], states.target_sz[i], states.zf[i:i + 1],
                      states.avg_chans[i], states.score[i])


def phase_streams(tracker: Tracker, frames: np.ndarray, smi: str) -> tuple[int, TrackState]:
    """STREAMS objects on one video: init_batched, step_batched against the
    single-stream step of each stream, track_video_multi against the eager
    step_batched loop; returns the xcorr launches of the 16-stream paths and
    the states after one step."""
    o, t = STREAMS, STREAMS_T
    rng = np.random.RandomState(SEED)
    pos = rng.uniform(100, 400, (o, 2)).astype(np.float32)
    sz = rng.uniform(60, 200, (o, 2)).astype(np.float32)
    dev = torch.from_numpy(frames[:t + 1]).cuda()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    states = tracker.init_batched(dev[0], pos, sz)
    reset_launches()
    stepped, out = tracker.step_batched(states, dev[1])
    torch.cuda.synchronize()
    step_launches = read_launches()
    if step_launches != [3, 0, 0]:
        raise AssertionError(f"step_batched: {step_launches} launches, expected [3, 0, 0]")
    errs = []
    for i in range(o):
        _, single = tracker.step(stream_state(states, i), dev[1])
        errs.append(check_step_close(f"stream {i}", StepOutput(*(v[i] for v in out)), single))
        check_output(single, FRAME_HW)
    print(f"[streams] init_batched + step_batched at O={o}: 3 xcorr launches at B={o}; each "
          f"stream against the single-stream step: best_id equal, pos/sz within 1e-2 px, "
          f"largest mask error {max(errs):.3e}; best_id {out.best_id.tolist()}")
    events, busy, call_ms = profile_call(lambda: tracker.step_batched(states, dev[1]))
    kernels = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    print(f"[streams] profiled eager step_batched at O={o}: device busy {busy:.3f} ms of "
          f"{call_ms:.3f} ms ({100 * busy / call_ms:.1f}% busy), {len(kernels)} kernel names; "
          "top 10 by self device time: " + "; ".join(
              f"{e.key[:70]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
              for e in kernels[:10]))

    st, eager = states, []
    for f in dev[1:]:
        st, step_out = tracker.step_batched(st, f)
        eager.append(step_out)
    eager = stacked(eager)
    reset_launches()
    final, outs = tracker.track_video_multi(states, dev[1:])
    torch.cuda.synchronize()
    counted = read_launches()
    graph = tracker.graphs[(o, *FRAME_HW, torch.uint8)]
    if counted[0] == 0 or counted[1:] != [0, 0] or graph.xcorr_launches != 3:
        raise AssertionError(f"streams: {counted} launches through the wrappers, "
                             f"{graph.xcorr_launches} xcorr kernels captured (expected 3)")
    check_bit_identical("streams", outs, eager, final, st)
    if outs.mask_in_frame.shape != (t, o, *FRAME_HW) or not torch.isfinite(outs.mask_in_frame).all():
        raise AssertionError(f"streams: masks {tuple(outs.mask_in_frame.shape)}")
    peak = torch.cuda.max_memory_allocated()
    print(f"[streams] track_video_multi, O={o}, T={t}: {graph.xcorr_launches * t} xcorr "
          f"launches by replay at B={o}; best_id and every output bit-identical to the eager "
          f"step_batched loop; peak memory {peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB "
          "held before the phase)")
    event_ms, wall_ms = time_calls(lambda: tracker.track_video_multi(states, dev[1:]))
    med = statistics.median(event_ms)
    print(f"[streams] {TIMED_CALLS} calls of O={o}, T={t}: median {med:.3f} ms (CUDA events; "
          f"min {min(event_ms):.3f}, max {max(event_ms):.3f}), {med / t:.3f} ms a frame, "
          f"{o * t * 1e3 / med:.1f} aggregate frames/s; host clock to the end "
          f"{statistics.median(wall_ms):.3f} ms | {smi}")
    check_graph_profile("streams", *profile_call(
        lambda: tracker.track_video_multi(states, dev[1:])), t, o)
    return step_launches[0] + graph.xcorr_launches * t, stepped


@torch.inference_mode()
def phase_layers(tracker: Tracker, frame: torch.Tensor, *batches: TrackState) -> None:
    """Device time of each layer of the step for each batched state (one
    stream's tracked state, O=1, and the 16 streams' after a step), each a
    CUDA graph of repeated calls on the step's own intermediates: the crop at
    the step's crop sizes, the backbone and heads (``track_mask``), the
    decode tail (decode, penalty, argmax, state update, clamp), the
    skip-window gather and Refine at the step's best cells, the warp-back of
    the step's masks with its back-boxes, and the whole step. The rest is the
    step less the timed layers: the NCHW copy of the crop, the sigmoid, the
    geometry."""
    p = tracker.p
    h, w = frame.shape[:2]
    for st in batches:
        o = st.target_pos.shape[0]
        s_x_full, scale_x = tracker._search_window(st)

        def crop():
            return subwindow_crop(frame, st.target_pos, s_x_full, p.instance_size, st.avg_chans)

        x = crop().permute(0, 3, 1, 2).contiguous()
        out = tracker.model.track_mask(st.zf, x)
        best = tracker._decode(st, out.score, out.loc, scale_x, h, w)[0]
        cells = tracker._cells(best)
        masks = torch.sigmoid(tracker.model.track_refine(out.skips, out.corr, cells))
        masks = masks.reshape(o, p.out_size, p.out_size)
        boxes = tracker._back_box(st.target_pos, s_x_full, cells, h, w)
        _, step_out = tracker._step_body(st, frame)
        if not (torch.equal(step_out.best_id, best) and torch.equal(step_out.mask_logits, masks)):
            raise AssertionError(f"layers, O={o}: the intermediates are not the step's")
        us = {"crop": graph_us(crop, n=20),
              "track_mask": graph_us(tracker.model.track_mask, st.zf, x, n=5),
              "decode tail": graph_us(tracker._decode, st, out.score, out.loc, scale_x, h, w,
                                      n=20),
              "skip windows": graph_us(slice_skip_windows, *out.skips, cells, n=20),
              "Refine": graph_us(tracker.model.track_refine, out.skips, out.corr, cells, n=10),
              "warp-back": graph_us(warp_back_mask, masks, boxes, (h, w), n=20),
              "step": graph_us(tracker._step_body, st, frame, n=5)}
        rest = us["step"] - sum(v for k, v in us.items() if k not in ("step", "skip windows"))
        print(f"[layers] O={o}, device us a step on the step's own intermediates (CUDA graphs "
              "of repeated calls; Refine includes the skip windows): "
              + ", ".join(f"{k} {v:.1f}" for k, v in us.items())
              + f"; the rest of the step {rest:.1f}")


def phase_streams_cpu_parity(tracker: Tracker, cpu_tracker: Tracker, states: TrackState,
                             frame: np.ndarray) -> None:
    """step_batched for two streams on the card and on the CPU, from the same
    state, open loop, at phase 6's tolerances."""
    two = TrackState(*(v[:2] for v in states))
    _, out = tracker.step_batched(two, torch.from_numpy(frame).cuda())
    _, ref = cpu_tracker.step_batched(TrackState(*(v.cpu() for v in two)), frame)
    err = check_step_close("step_batched, card vs CPU", out, ref)
    print(f"[streams-parity] step_batched at O=2, card vs CPU: best_id {out.best_id.tolist()} "
          f"on both; mask max_abs_err {err:.3e}")


def write_vos_video(root: Path) -> None:
    """A YouTube-VOS valid-split video ``vid`` of VOS_FRAMES 480x854 frames
    under ``root`` (JPEG frames, a label PNG for every frame, ``meta.json``):
    three textured rectangles drifting over blocky noise, the third from
    frame VOS_LATE on."""
    import cv2

    rng = np.random.RandomState(SEED + 1)
    h, w = FRAME_HW
    valid = root / "ytb_vos" / "valid"
    for sub in ("JPEGImages", "Annotations"):
        (valid / sub / "vid").mkdir(parents=True)
    coarse = rng.randint(0, 256, size=(h // 8 + 1, w // 8 + 1, 3)).astype(np.uint8)
    background = np.repeat(np.repeat(coarse, 8, axis=0), 8, axis=1)[:h, :w]
    # (top-left x, y, width, height, x drift a frame, first frame); they never overlap
    objects = ((145, 105, 110, 90, 3, 0), (515, 235, 90, 130, -3, 0),
               (380, 85, 80, 70, 3, VOS_LATE))
    patches = [rng.randint(0, 256, size=(oh, ow, 3)).astype(np.uint8)
               for _, _, ow, oh, _, _ in objects]
    names = [f"{5 * i:05d}" for i in range(VOS_FRAMES)]
    for i, name in enumerate(names):
        im, anno = background.copy(), np.zeros((h, w), np.uint8)
        for k, ((x0, y0, ow, oh, vx, first), patch) in enumerate(zip(objects, patches)):
            if i >= first:
                x, y = x0 + vx * (i - first), y0 + 2 * (i - first)
                im[y:y + oh, x:x + ow] = patch
                anno[y:y + oh, x:x + ow] = k + 1
        cv2.imwrite(str(valid / "JPEGImages" / "vid" / f"{name}.jpg"), im)
        cv2.imwrite(str(valid / "Annotations" / "vid" / f"{name}.png"), anno)
    meta = {"videos": {"vid": {"objects": {
        str(k + 1): {"category": "synthetic", "frames": names[first:]}
        for k, (*_, first) in enumerate(objects)}}}}
    (valid / "meta.json").write_text(json.dumps(meta))


def phase_vos(model: SiamMaskSharp, p, smi: str) -> int:
    """The VOS drivers on the card, through ``load_dataset`` as a user calls
    them: ``track_vos_batched`` (scan_chunk VOS_CHUNK: ragged stretches
    through ``step_batched``, a full window through the CUDA graph, a re-init
    of the late object) against the sequential ``track_vos``; the batched
    driver's object-frames/s. Returns its xcorr launches (through the wrapper
    and by replay). Needs cv2 and PIL, the drivers' image I/O."""
    try:
        import cv2  # noqa: F401
        import PIL  # noqa: F401
    except ImportError as e:
        print(f"[vos] skipped: the VOS drivers' image I/O is not installed ({e})")
        return 0
    root = REPO / "build" / "vos_smoke"
    shutil.rmtree(root, ignore_errors=True)
    write_vos_video(root)
    video = load_dataset("ytb_vos", str(root))["vid"]
    if video["start_frame"] != {"1": 0, "2": 0, "3": VOS_LATE}:
        raise AssertionError(f"vos: start frames {video['start_frame']}")
    runtime = TrackerRuntime(model, p, "cuda")
    track_vos_batched(runtime, video, scan_chunk=VOS_CHUNK, log=lambda *_: None)  # captures
    torch.cuda.synchronize()
    reset_launches()
    lines = []
    t0 = time.perf_counter()
    iou_b, fps_b = track_vos_batched(runtime, video, scan_chunk=VOS_CHUNK,
                                     result_dir=str(root / "results"), dataset="ytb_vos",
                                     save_mask=True, log=lines.append)
    wall_b = time.perf_counter() - t0
    launches = read_launches()
    graph = runtime.tracker.graphs[(3, *FRAME_HW, torch.uint8)]
    if launches != [3 * VOS_RAGGED, 0, 0] or graph.xcorr_launches != 3:
        raise AssertionError(f"vos: {launches} launches through the wrappers (expected "
                             f"{[3 * VOS_RAGGED, 0, 0]}), {graph.xcorr_launches} captured")
    iou_b = np.asarray(iou_b)
    if iou_b.shape != (3, 4) or not np.all((iou_b >= 0) & (iou_b <= 1)):
        raise AssertionError(f"vos: IoU {iou_b}")
    fused = [cv2.imread(str(f), cv2.IMREAD_UNCHANGED) for f in
             sorted((root / "results" / "ytb_vos" / "SiamMask" / "vid").glob("*.png"))]
    gt3 = cv2.imread(video["anno_init_files"][2], cv2.IMREAD_UNCHANGED) == 3
    if (len(fused) != VOS_FRAMES or any((m == 3).any() for m in fused[:VOS_LATE])
            or not (fused[VOS_LATE][gt3] == 3).all()):
        raise AssertionError("vos: object 3 is not absent before its start frame and its "
                             "annotation at it")
    t0 = time.perf_counter()
    iou_s, fps_s = track_vos(runtime, video, log=lambda *_: None)
    wall_s = time.perf_counter() - t0
    # the batched and the sequential steps run other conv batch sizes, so the
    # masks differ in cuDNN's summation order: a pixel may cross a threshold
    diff = np.abs(iou_b - np.asarray(iou_s)).max()
    if diff > 1e-2:
        raise AssertionError(f"vos: batched IoU {iou_b.tolist()} vs sequential "
                             f"{np.asarray(iou_s).tolist()}")
    print(f"[vos] track_vos_batched, ytb_vos layout, {VOS_FRAMES} frames 480x854, 3 objects "
          f"(one from frame {VOS_LATE}), scan_chunk {VOS_CHUNK}: {3 * VOS_RAGGED} xcorr "
          f"launches through step_batched, {graph.xcorr_launches * VOS_FULL} by replay; "
          f"IoU at 0.3 {iou_b[:, 0].round(4).tolist()}, within {diff:.2e} of track_vos; object "
          "3 absent before its start and its annotation at it")
    print(f"[vos] {fps_b:.1f} object-frames/s batched (driver's clock, file reads excluded; "
          f"{wall_b:.3f} s for the call), {fps_s:.1f} sequential ({wall_s:.3f} s); "
          f"{lines[-1].strip()} | {smi}")
    shutil.rmtree(root, ignore_errors=True)
    return 3 * VOS_RAGGED + graph.xcorr_launches * VOS_FULL


FROZEN_ALWAYS = ("features.features.conv1.", "features.features.bn1.",
                 "features.features.layer1.")
LAYER2 = ("features.features.layer2.",)


def synthetic_train_batch(cfg: Config, b: int, device, seed: int = SEED) -> dict:
    """A batch of ``b`` template/search pairs with their labels, as the
    training data pipeline would give it, from synthetic frames.

    Each sample has its own uint8 frame (blocky noise) with a textured target
    of random size. The 127 template is cropped around the target with the
    tracker's context (s_z), the 255 search at 255/127 of that around a
    centre a few pixels off the target. Labels come from the port's
    ``AnchorTarget`` on the target box in search-crop pixels;
    ``label_mask`` is that box as +1 inside, -1 outside, and
    ``label_mask_weight`` is ``cls.max(0)``."""
    rng = np.random.RandomState(seed)
    h, w = TRAIN_FRAME_HW
    anchors = Anchors(cfg.anchors)
    anchors.generate_all_anchors(im_c=255 // 2, size=25)
    target = AnchorTarget(np.random.RandomState(seed))
    coarse = rng.randint(0, 256, size=(b, h // 8 + 1, w // 8 + 1, 3)).astype(np.uint8)
    frames = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)[:, :h, :w].copy()
    grid = np.arange(255, dtype=np.float64)
    keys = ("template", "search", "label_cls", "label_loc", "label_loc_weight", "label_mask",
            "label_mask_weight")
    out = {k: [] for k in keys}
    for i in range(b):
        tw, th = (int(v) for v in rng.randint(60, 140, size=2))
        x0, y0 = int(rng.randint(0, w - tw)), int(rng.randint(0, h - th))
        frames[i, y0:y0 + th, x0:x0 + tw] = rng.randint(0, 256, size=(th, tw, 3))
        cx, cy = x0 + tw / 2, y0 + th / 2
        ctx = 0.5 * (tw + th)
        s_z = math.sqrt((tw + ctx) * (th + ctx))
        s_x = s_z * 255 / 127
        sx, sy = cx + rng.uniform(-12, 12), cy + rng.uniform(-12, 12)
        frame = torch.from_numpy(frames[i]).to(device)
        avg = frame.mean(dim=(0, 1), dtype=torch.float32)
        for key, pos, size, model_sz in (("template", (cx, cy), s_z, 127),
                                         ("search", (sx, sy), s_x, 255)):
            crop = subwindow_crop(frame, torch.tensor([pos], device=device),
                                  torch.tensor([size], device=device), model_sz, avg[None])
            out[key].append(crop[0].permute(2, 0, 1))
        # frame x -> search pixel (x - origin + 0.5) / scale - 0.5, origin as
        # subwindow_crop rounds it (half to even, as np.round)
        scale = s_x / 255
        ox, oy = np.round(sx - (s_x + 1) / 2), np.round(sy - (s_x + 1) / 2)
        box = ((x0 - ox) / scale - 0.5, (y0 - oy) / scale - 0.5,
               (x0 + tw - ox) / scale - 0.5, (y0 + th - oy) / scale - 0.5)
        cls, delta, delta_weight = target(anchors, box, 25)
        inside = (((grid >= box[1]) & (grid <= box[3]))[:, None]
                  & ((grid >= box[0]) & (grid <= box[2]))[None, :])
        for key, value in (("label_cls", cls), ("label_loc", delta),
                           ("label_loc_weight", delta_weight),
                           ("label_mask", np.where(inside, 1.0, -1.0).astype(np.float32)),
                           ("label_mask_weight", cls.max(axis=0).astype(np.float32))):
            out[key].append(torch.from_numpy(value))
    return {k: torch.stack(v).to(device) for k, v in out.items()}


def train_parts(cfg: Config):
    settings = TrainSettings(loss_weight=cfg.loss_weight)
    opt_cfg = OptimizerConfig.from_lr_cfg(cfg.lr, clip=10.0, clip_cfg=cfg.clip)
    return settings, opt_cfg, build_lr_spaces(cfg.lr, TRAIN_EPOCHS)


def build_train_model(batch: dict, device) -> SiamMaskBase:
    """Seeded SiamMask-base weights with BN statistics calibrated on the
    first pair of the batch, as ``build_model`` does for tracking."""
    model = SiamMaskBase(width=64).init_weights(torch.Generator().manual_seed(SEED))
    model = model.to(device).eval()
    with torch.inference_mode(), bn_calibration(model):
        model.forward_train(batch["template"][:1], batch["search"][:1])
    return model


def _state(model, prefixes) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.startswith(prefixes)}


def _same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def phase_train(trainer: Trainer, batch: dict) -> list[int]:
    """The training slice: two frozen steps and two after the unfreeze, with
    the per-step checks; then the loss over 8 steps on the repeated batch."""
    model = trainer.model
    stem0, layer2_0 = _state(model, FROZEN_ALWAYS), _state(model, LAYER2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    for step, epoch in enumerate((0, 0, 1, 1)):
        counts = read_launches()
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        metrics = {k: v.item() for k, v in trainer.step(batch, epoch).items()}
        counts = [a - b for a, b in zip(read_launches(), counts)]
        if not all(math.isfinite(v) for v in metrics.values()) or metrics["skipped"] != 0:
            raise AssertionError(f"step {step}: {metrics}")
        if counts != [3, 3, 3]:
            raise AssertionError(f"step {step}: {counts} forward/grad-input/grad-kernel "
                                 "launches, expected [3, 3, 3]")
        if not _same(_state(model, FROZEN_ALWAYS), stem0):
            raise AssertionError(f"step {step}: the stem or layer1 changed")
        if epoch == 0 and not _same(_state(model, LAYER2), layer2_0):
            raise AssertionError(f"step {step}: layer2 changed while frozen")
        moved = {}
        for name, p in model.named_parameters():
            label = trainer.labels[name]
            if label != "frozen":
                moved.setdefault(label, []).append(not torch.equal(p, before[name]))
        expected = {"neck", "rpn", "mask"} | ({"resnet"} if epoch else set())
        if set(moved) != expected or not all(any(v) for v in moved.values()):
            raise AssertionError(f"step {step}: trainable groups moved: {moved}")
        print(f"[train] step {step} epoch {epoch} ({'unfrozen' if epoch else 'frozen'}): "
              f"total {metrics['total_loss']:.4f} cls {metrics['cls_loss']:.4f} "
              f"loc {metrics['loc_loss']:.4f} mask {metrics['mask_loss']:.4f} "
              f"iou {metrics['iou_mean']:.4f}; launches {counts}; tensors moved "
              + ", ".join(f"{k} {sum(v)}/{len(v)}" for k, v in sorted(moved.items())))
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"[train] 4 steps at B={TRAIN_BATCH}, width 64: launches {launches} "
          "(forward, grad-input, grad-kernel); stem and layer1 bit-identical throughout, "
          "layer2 through epoch 0")
    losses = [trainer.step(batch, 1)["total_loss"].item() for _ in range(8)]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall on a repeated batch: {losses}")
    print("[train] repeated batch, 8 steps: total loss "
          + " ".join(f"{v:.4f}" for v in losses))
    print(f"[train] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          "(torch.cuda.max_memory_allocated)")
    return launches


def _momentum(trainer: Trainer) -> dict:
    names = {p: n for n, p in trainer.model.named_parameters()}
    return {names[p]: s["momentum_buffer"].cpu() for p, s in trainer.optimizer.state.items()}


def phase_train_parity(cfg: Config, init_state: dict, batch: dict) -> None:
    """One frozen-phase step from the same weights and batch (B=2) on the
    card and on the CPU, open loop. Tolerances cover cuDNN's summation order
    against the CPU's (TF32 off): metrics 1e-4 relative; momentum buffers
    (the clipped, decayed gradients) 1e-3 of each tensor's largest entry plus
    1e-5 of the step's, for the tensors whose exact gradient is 0 (the neck's
    BN bias); parameters the same of their update plus two ulps."""
    small = {k: v[:2] for k, v in batch.items()}
    runs = {}
    for device in ("cuda", "cpu"):
        model = SiamMaskBase(width=64)
        model.load_state_dict(init_state)
        trainer = Trainer(model.to(device), *train_parts(cfg), epochs=TRAIN_EPOCHS)
        metrics = trainer.step({k: v.to(device) for k, v in small.items()}, 0)
        runs[device] = ({k: v.item() for k, v in metrics.items()},
                        {n: p.detach().cpu() for n, p in model.named_parameters()},
                        _momentum(trainer), trainer.labels)
    (m_gpu, p_gpu, b_gpu, labels), (m_cpu, p_cpu, b_cpu, _) = runs["cuda"], runs["cpu"]
    for k in m_cpu:
        if not math.isclose(m_gpu[k], m_cpu[k], rel_tol=1e-4, abs_tol=1e-6):
            raise AssertionError(f"metric {k}: card {m_gpu[k]} vs CPU {m_cpu[k]}")
    floor = 1e-5 * max(v.abs().max().item() for v in b_cpu.values())
    worst = (0.0, "")
    for name, ref in b_cpu.items():
        scale = ref.abs().max().item()
        torch.testing.assert_close(b_gpu[name], ref, rtol=1e-3, atol=1e-3 * scale + floor,
                                   msg=lambda m, name=name: f"momentum {name}: {m}")
        err = (b_gpu[name] - ref).abs().max().item() / max(scale, floor)
        worst = max(worst, (err, name))
    updates = {n: (ref - init_state[n]).abs().max().item() for n, ref in p_cpu.items()}
    floor = 1e-5 * max(updates.values())
    for name, ref in p_cpu.items():
        if labels[name] == "frozen":
            if not (torch.equal(p_gpu[name], init_state[name]) and updates[name] == 0):
                raise AssertionError(f"frozen {name} moved")
            continue
        torch.testing.assert_close(p_gpu[name], ref, rtol=2.0 ** -22,
                                   atol=1e-3 * updates[name] + floor,
                                   msg=lambda m, name=name: f"param {name}: {m}")
    print(f"[train-parity] B=2 frozen step, card vs CPU: total loss {m_gpu['total_loss']:.6f} "
          f"vs {m_cpu['total_loss']:.6f}; largest momentum error {worst[0]:.3e} of its "
          f"tensor's largest entry ({worst[1]}); parameters within tolerance")


def phase_train_profile(trainer: Trainer, batch: dict) -> None:
    """One profiled step in each phase: the backward runs through the
    backbone only once it is unfrozen (neck + heads: 14 conv backwards a
    step; with layer2/3: 78)."""
    from torch.profiler import ProfilerActivity, profile

    for epoch, label, expected in ((0, "frozen", 14), (1, "unfrozen", 78)):
        trainer.step(batch, epoch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.step(batch, epoch)
            torch.cuda.synchronize()
        events = prof.key_averages()
        conv_bwd = sum(e.count for e in events if e.key == "aten::convolution_backward")
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        print(f"[profile] {label} step: {conv_bwd} aten::convolution_backward calls "
              f"(expected {expected}); {len(kernels)} kernel names, {device_ms:.2f} ms "
              "device time; top: " + "; ".join(
                  f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
                  for e in top))
        xcorr = [e for e in kernels if "depthwise_xcorr" in e.key]
        print(f"[profile] {label} step, xcorr kernels: " + "; ".join(
            f"{e.key.split('::')[-1].split('(')[0]} {e.self_device_time_total:.2f} us x{e.count}"
            for e in xcorr))
        if conv_bwd != expected:
            raise AssertionError(f"{label}: {conv_bwd} conv backwards, expected {expected}")


def phase_train_timing(trainer: Trainer, batch: dict, smi: str) -> None:
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
        med = statistics.median(times)
        print(f"[train-timing] {label} step, B={TRAIN_BATCH}, width 64, fp32, TF32 off: "
              f"median {med:.2f} ms (CUDA events, 10 warm steps; min {min(times):.2f}, "
              f"max {max(times):.2f}); {TRAIN_BATCH * 1e3 / med:.1f} samples/s | {smi}")


def main() -> None:
    smi = phase_device()
    phase_build()
    records = [phase_kernels(), *phase_grad_kernels()]
    p = Config.load(str(CONFIG)).tracker_config()
    model, tracker, frames = build_model(p)
    cpu_tracker = cpu_tracker_of(model, p)
    state, track_launches = phase_slice(tracker, frames)
    phase_cpu_parity(model, tracker, cpu_tracker, state, frames[STEPS + 2])
    phase_timing(tracker, state, frames[STEPS + 2:], smi)
    video_launches, video_state = phase_video(tracker, frames, smi)
    streams_launches, states = phase_streams(tracker, frames, smi)
    phase_streams_cpu_parity(tracker, cpu_tracker, states, frames[2])
    one = TrackState(video_state.target_pos[None], video_state.target_sz[None],
                     video_state.zf, video_state.avg_chans[None], video_state.score[None])
    phase_layers(tracker, torch.from_numpy(frames[2]).cuda(), one, states)
    vos_launches = phase_vos(model, p, smi)
    del model, tracker, cpu_tracker, state, states, video_state, one
    torch.cuda.empty_cache()

    cfg = Config.load(str(TRAIN_CONFIG), clip=10.0)
    batch = synthetic_train_batch(cfg, TRAIN_BATCH, "cuda")
    print(f"[train] batch: {TRAIN_BATCH} pairs, "
          f"{int((batch['label_cls'] == 1).sum())} positive anchors, "
          f"{int((batch['label_mask_weight'] == 1).sum())} positive mask cells")
    train_model = build_train_model(batch, "cuda")
    init_state = {k: v.detach().cpu().clone() for k, v in train_model.state_dict().items()}
    trainer = Trainer(train_model, *train_parts(cfg), epochs=TRAIN_EPOCHS, unfreeze_at=0.5)
    train_launches = phase_train(trainer, batch)
    phase_train_parity(cfg, init_state, batch)
    phase_train_profile(trainer, batch)
    phase_train_timing(trainer, batch, smi)

    # the forward also runs on the video and 16-stream paths, by graph replay
    paths = {"track": track_launches, "video": [video_launches, 0, 0],
             "streams16": [streams_launches, 0, 0], "vos": [vos_launches, 0, 0],
             "train": train_launches}
    for i, record in enumerate(records):
        record["launches_by_path"] = {k: v[i] for k, v in paths.items()}
        record["launches"] = sum(record["launches_by_path"].values())
    print("[launches] " + ", ".join(f"{k} {v}" for k, v in paths.items())
          + " (forward, grad-input, grad-kernel)")
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms", "launches_by_path"]
    print(smi)
    print(json.dumps({"kernels": [{key: r[key] for key in order} for r in records]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
