#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: ``python3 chip_smoke.py``.

Drives the port's two main paths at the published width (64; 127x127
template, 255x255 search, 25x25x5 anchors) in fp32 with TF32 off, on
synthetic uint8 frames made from a numpy seed, with seeded random weights:

- the SiamMask-sharp track step (``Tracker.init`` / ``Tracker.step``,
  127x127 masks) on 480x854 frames;
- the SiamMask-base stage-1 training step (``Trainer.step``, the
  ``experiments/siammask_base/config.json`` recipe) at batch 64, two steps
  with the backbone frozen and two after the unfreeze.

Phases, each of which raises on failure:

1. device: a CUDA card is required; its name and power limit are printed;
2. build: the hand-written kernels are compiled from ``siammask_tpu_torch/csrc``;
3. the forward xcorr kernel vs its plain version at the tracking shape, B=16,
   the training batch (B=64), a ragged shape and bf16; kernel and plain times
   at B=1 (fp32, bf16) and B=64 (fp32);
4. the two gradient kernels vs their plain versions at B=1, B=64, a ragged
   shape and bf16; kernel and plain times at B=1 and B=64, and the eager
   autograd backward through the kernels vs through the plain forward;
5. the track slice: init + steps, with finite outputs in bounds, three xcorr
   kernel launches per step, and one step under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
6. the same track step on the card and on the CPU from the same state, open
   loop;
7. per-step track latency and frames/s on the card;
8. the training slice: per step finite losses, no skip, 3 + 3 + 3 kernel
   launches, the frozen stages bit-identical and the trainable ones moved;
   then the loss falling over 8 steps on the repeated batch; peak memory;
9. one training step on the card and on the CPU from the same weights and
   batch (B=2), open loop;
10. the profile of one frozen and one unfrozen step (no backbone backward
    while frozen), and train ms/step and samples/s.

The last line is ``{"ok": true, "device": {...}}``; the line before it lists
each kernel with its launches on the main paths, error and times.
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

from siammask_tpu_torch.config import Config
from siammask_tpu_torch.data.anchor_target import AnchorTarget
from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp
from siammask_tpu_torch.ops import _build
from siammask_tpu_torch.ops.sample import subwindow_crop
from siammask_tpu_torch.ops.xcorr import (depthwise_xcorr, depthwise_xcorr_grad_input,
                                          depthwise_xcorr_grad_input_reference,
                                          depthwise_xcorr_grad_kernel,
                                          depthwise_xcorr_grad_kernel_reference,
                                          depthwise_xcorr_reference)
from siammask_tpu_torch.tracker.anchors import Anchors
from siammask_tpu_torch.tracker.tracker import Tracker, TrackState
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
TRAIN_BATCH = 64          # tools/train.py's default
TRAIN_EPOCHS = 2          # epoch 0 frozen, epoch 1 unfrozen (unfreeze_at 0.5)
TRAIN_FRAME_HW = (360, 480)
KERNELS = (depthwise_xcorr, depthwise_xcorr_grad_input, depthwise_xcorr_grad_kernel)


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
    for b, dtype in ((1, torch.float32), (1, torch.bfloat16), (TRAIN_BATCH, torch.float32)):
        x = torch.randn((b, 29, 29, 256), generator=g).to("cuda", dtype)
        k = torch.randn((b, 5, 5, 256), generator=g).to("cuda", dtype)
        kernel, plain = in_turns(depthwise_xcorr, depthwise_xcorr_reference, x, k)
        times[(b, dtype)] = (kernel, plain)
        print(f"[kernel] ({b},29,29,256)*({b},5,5,256) {str(dtype)[6:]}: kernel "
              f"{kernel[0]:.2f} us device / {kernel[1]:.2f} us eager; plain "
              f"{plain[0]:.2f} us device / {plain[1]:.2f} us eager")
    kernel, plain = times[(1, torch.float32)]
    return {"name": "depthwise_xcorr", "route": "cuda",
            "source": "siammask_tpu_torch/csrc/xcorr.cu",
            "replaces": "siammask_tpu/ops/xcorr_pallas.py:67",
            "max_abs_err": errors[((1, 29, 29, 256), torch.float32)],
            "ms": kernel[0] / 1e3, "plain_ms": plain[0] / 1e3}


def phase_grad_kernels() -> list[dict]:
    """The two gradient kernels vs their plain versions on the card; returns
    their records, timed at the training shape (B=64)."""
    g = torch.Generator().manual_seed(SEED + 1)

    def inputs(xs, ks, dtype):
        go = (xs[0], xs[1] - ks[1] + 1, xs[2] - ks[2] + 1, xs[3])
        return tuple(torch.randn(s, generator=g).to("cuda", dtype) for s in (xs, ks, go))

    errors = {}
    for xs, ks, dtype in [((1, 29, 29, 256), (1, 5, 5, 256), torch.float32),
                          ((64, 29, 29, 256), (64, 5, 5, 256), torch.float32),
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

    times = {}
    for b in (1, TRAIN_BATCH):
        x, k, go = inputs((b, 29, 29, 256), (b, 5, 5, 256), torch.float32)
        times[("input", b)] = in_turns(depthwise_xcorr_grad_input,
                                       depthwise_xcorr_grad_input_reference, go, k, 29, 29)
        times[("kernel", b)] = in_turns(depthwise_xcorr_grad_kernel,
                                        depthwise_xcorr_grad_kernel_reference, x, go)
        for which in ("input", "kernel"):
            kernel, plain = times[(which, b)]
            print(f"[grad] grad-{which} B={b} fp32: kernel {kernel[0]:.2f} us device / "
                  f"{kernel[1]:.2f} us eager; plain {plain[0]:.2f} us device / "
                  f"{plain[1]:.2f} us eager")
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

    records = []
    for which in ("input", "kernel"):
        kernel, plain = times[(which, TRAIN_BATCH)]
        records.append({"name": f"depthwise_xcorr_grad_{which}", "route": "cuda",
                        "source": "siammask_tpu_torch/csrc/xcorr.cu",
                        # the custom_vjp backward of depthwise_xcorr_ad
                        "replaces": "siammask_tpu/ops/xcorr_pallas.py:48",
                        "max_abs_err": errors[(which, (TRAIN_BATCH, 29, 29, 256),
                                               torch.float32)],
                        "ms": kernel[0] / 1e3, "plain_ms": plain[0] / 1e3})
    return records


def build_model(p) -> tuple[SiamMaskSharp, Tracker, np.ndarray]:
    model = SiamMaskSharp(width=64).init_weights(torch.Generator().manual_seed(SEED))
    model = model.to("cuda").eval()
    frames = synthetic_frames(STEPS + TIMED_STEPS + 12)
    f0 = torch.from_numpy(frames[0]).cuda()
    avg = f0.mean(dim=(0, 1), dtype=torch.float32)
    pos = torch.tensor(TARGET_POS, device="cuda")
    z = subwindow_crop(f0, pos, torch.tensor(180.0, device="cuda"), 127, avg)
    x = subwindow_crop(f0, pos, torch.tensor(360.0, device="cuda"), 255, avg)
    calibrate_bn(model, z.permute(2, 0, 1)[None].contiguous(),
                 x.permute(2, 0, 1)[None].contiguous())
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


def phase_cpu_parity(model, tracker, p, state: TrackState, frame: np.ndarray) -> None:
    """The same step on the card and on the CPU, from the same state, open
    loop. Tolerances cover cuDNN's summation order against the CPU's over a
    ResNet-50 of random weights."""
    cpu_model = SiamMaskSharp(width=64)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_model.eval()
    cpu_tracker = Tracker(cpu_model, p, "cpu")
    cpu_state = TrackState(*(t.cpu() for t in state))

    with torch.inference_mode():
        x = subwindow_crop(torch.from_numpy(frame), cpu_state.target_pos,
                           torch.tensor(400.0), 255, cpu_state.avg_chans)
        x = x.permute(2, 0, 1)[None].contiguous()
        ref = cpu_model.track_mask(cpu_state.zf, x)
        ours = model.track_mask(state.zf, x.cuda())
        cell = torch.tensor([12, 12])
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
    if out.best_id.item() != ref_out.best_id.item():
        raise AssertionError(f"best_id {out.best_id.item()} vs CPU {ref_out.best_id.item()}")
    # positions in pixels: 1e-2 px
    torch.testing.assert_close(out.target_pos.cpu(), ref_out.target_pos, rtol=0, atol=1e-2)
    torch.testing.assert_close(out.target_sz.cpu(), ref_out.target_sz, rtol=0, atol=1e-2)
    scale = ref_out.mask_logits.abs().max().item()
    torch.testing.assert_close(out.mask_logits.cpu(), ref_out.mask_logits, rtol=0,
                               atol=1e-3 * scale)
    print(f"[parity] step: best_id {out.best_id.item()} on both; pos "
          f"{out.target_pos.cpu().tolist()} vs {ref_out.target_pos.tolist()}; "
          f"mask max_abs_err {(out.mask_logits.cpu() - ref_out.mask_logits).abs().max().item():.3e}")


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
            crop = subwindow_crop(frame, torch.tensor(pos, device=device),
                                  torch.tensor(size, device=device), model_sz, avg)
            out[key].append(crop.permute(2, 0, 1))
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
    state, track_launches = phase_slice(tracker, frames)
    phase_cpu_parity(model, tracker, p, state, frames[STEPS + 2])
    phase_timing(tracker, state, frames[STEPS + 2:], smi)
    del model, tracker, state

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

    for record, a, b in zip(records, track_launches, train_launches):
        record["launches"] = a + b
    print(f"[launches] track slice {track_launches}, training slice {train_launches} "
          "(forward, grad-input, grad-kernel)")
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms"]
    print(smi)
    print(json.dumps({"kernels": [{key: r[key] for key in order} for r in records]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
