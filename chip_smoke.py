#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: ``python3 chip_smoke.py``.

Drives the SiamMask-sharp track step (``Tracker.init`` / ``Tracker.step``)
at the published width (64; 127x127 template, 255x255 search, 25x25x5
anchors, 127x127 masks) in fp32 on synthetic 480x854 uint8 frames made from a
numpy seed, with seeded random weights. Phases, each of which raises on
failure:

1. device: a CUDA card is required; its name and power limit are printed;
2. build: the hand-written kernels are compiled from ``siammask_tpu_torch/csrc``;
3. kernel vs plain version on the card, TF32 off, at the tracking shape,
   B=16, a ragged shape and bf16; kernel and plain times;
4. the slice: init + steps, with finite outputs in bounds, three xcorr
   kernel launches per step, and one step under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
5. the same step on the card and on the CPU (plain versions) from the same
   state and frame, open loop;
6. per-step latency and frames/s on the card.

The last line is ``{"ok": true, "device": {...}}``; the line before it lists
each kernel with its launches on the main path, error and times.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from siammask_tpu_torch.config import Config
from siammask_tpu_torch.models.siammask import SiamMaskSharp
from siammask_tpu_torch.ops import _build
from siammask_tpu_torch.ops.sample import subwindow_crop
from siammask_tpu_torch.ops.xcorr import depthwise_xcorr, depthwise_xcorr_reference
from siammask_tpu_torch.tracker.tracker import Tracker, TrackState

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "experiments" / "siammask_sharp" / "config_davis.json"
FRAME_HW = (480, 854)
TARGET_POS, TARGET_SZ = (300.0, 200.0), (120.0, 90.0)
SEED = 0
STEPS = 20
TIMED_STEPS = 50


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


@torch.inference_mode()
def calibrate_bn(model: SiamMaskSharp, z: torch.Tensor, x: torch.Tensor) -> None:
    """Scale every BatchNorm by the overall standard deviation of its input on
    one template/search pair (running_mean 0, one running_var per layer), so
    random-weight activations stay O(1) like a trained model's and the scores
    do not saturate. One scalar per layer, not per channel, so that nearly dead
    channels are not amplified."""
    def hook(bn, inputs):
        bn.running_mean.zero_()
        bn.running_var.fill_(inputs[0].pow(2).mean())

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.BatchNorm2d)]
    try:
        zf = model.template(z)
        model.track_mask(zf, x)
    finally:
        for h in handles:
            h.remove()


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
    """Kernel vs plain version on the card; returns the slice-shape record."""
    g = torch.Generator().manual_seed(SEED)
    cases = [((1, 29, 29, 256), (1, 5, 5, 256), torch.float32),
             ((16, 29, 29, 256), (16, 5, 5, 256), torch.float32),
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
        scale = ref.float().abs().max().item()
        err = (out.float() - ref.float()).abs().max().item()
        # fp32: the two differ only in summation order; bf16: each side
        # rounds its output to bf16 once
        atol = (1e-4 if dtype == torch.float32 else 2e-2) * scale
        torch.testing.assert_close(out.float(), ref.float(), rtol=1e-5, atol=atol)
        errors[(xs, dtype)] = err
        print(f"[kernel] {xs} * {ks} {str(dtype)[6:]}: max_abs_err {err:.3e} "
              f"(atol {atol:.3e}, max|ref| {scale:.3f})")

    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((1, 29, 29, 256), generator=g).to("cuda", dtype)
        k = torch.randn((1, 5, 5, 256), generator=g).to("cuda", dtype)
        t = {}
        # in turns (plain, kernel, kernel, plain); each side keeps its faster turn
        for name, fn in (("plain", depthwise_xcorr_reference), ("kernel", depthwise_xcorr),
                         ("kernel2", depthwise_xcorr), ("plain2", depthwise_xcorr_reference)):
            t[name] = (graph_us(fn, x, k), eager_us(fn, x, k))
        kernel = [min(t["kernel"][i], t["kernel2"][i]) for i in range(2)]
        plain = [min(t["plain"][i], t["plain2"][i]) for i in range(2)]
        times[dtype] = (kernel, plain)
        print(f"[kernel] (1,29,29,256)*(1,5,5,256) {str(dtype)[6:]}: kernel "
              f"{kernel[0]:.2f} us device / {kernel[1]:.2f} us eager; plain "
              f"{plain[0]:.2f} us device / {plain[1]:.2f} us eager")
    kernel, plain = times[torch.float32]
    return {"name": "depthwise_xcorr", "route": "cuda",
            "source": "siammask_tpu_torch/csrc/xcorr.cu",
            "replaces": "siammask_tpu/ops/xcorr_pallas.py:67",
            "max_abs_err": errors[((1, 29, 29, 256), torch.float32)],
            "ms": kernel[0] / 1e3, "plain_ms": plain[0] / 1e3}


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


def phase_slice(tracker: Tracker, frames: np.ndarray):
    dev_frames = [torch.from_numpy(f).cuda() for f in frames[1:STEPS + 2]]
    torch.cuda.synchronize()
    depthwise_xcorr.launches = 0
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
    launches = depthwise_xcorr.launches
    steps = len(outs)
    if launches != 3 * steps:
        raise AssertionError(f"{launches} xcorr launches in {steps} steps, expected {3 * steps}")
    for out in outs:
        check_output(out, FRAME_HW)
    last = outs[-1]
    print(f"[slice] init + {steps} steps at width 64: {launches} xcorr launches; "
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


def main() -> None:
    smi = phase_device()
    phase_build()
    record = phase_kernels()
    p = Config.load(str(CONFIG)).tracker_config()
    model, tracker, frames = build_model(p)
    state, launches = phase_slice(tracker, frames)
    phase_cpu_parity(model, tracker, p, state, frames[STEPS + 2])
    phase_timing(tracker, state, frames[STEPS + 2:], smi)
    record["launches"] = launches
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms"]
    print(smi)
    print(json.dumps({"kernels": [{key: record[key] for key in order}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
