#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: ``python3 chip_smoke.py``.

Drives the port's main paths at the published width (64; 127x127
template, 255x255 search, 25x25x5 anchors) in fp32 with TF32 off, and then
in the bf16 compute mode (bf16 activations over float32 weights), on
synthetic uint8 frames made from a numpy seed, with seeded random weights:

- the SiamMask-sharp track step (``Tracker.init`` / ``Tracker.step``,
  127x127 masks) on 480x854 frames;
- whole videos: ``Tracker.track_video`` over 64 frames, a CUDA-graph replay
  per frame, and 16 streams on one frame (``init_batched`` /
  ``step_batched`` / ``track_video_multi`` over 32 frames);
- the VOS drivers (``track_vos_batched``, ``track_vos``) on a YouTube-VOS-
  style video of 41 frames and three objects written under ``build/``;
- the other two families through the same tracker: SiamRPN (box only,
  ``Tracker(mask=False)``) and SiamMask-base (``Tracker(refine=False)``,
  63x63 masks), step by step and as ``track_video`` graphs;
- the VOT reset-on-failure driver (``track_vot``) for all three families
  and the test CLI (``siammask_tpu_torch.tools.test.main``) on two VOT2018-
  layout videos written under ``build/``;
- the tune CLI (``siammask_tpu_torch.tools.tune.main``): a VOT grid and a
  VOS grid of SiamMask-sharp cells over those videos, and the eval CLI
  (``siammask_tpu_torch.tools.eval.main``) over the result trees;
- the SiamMask-base stage-1 training step (``Trainer.step``, the
  ``experiments/siammask_base/config.json`` recipe) at batch 64, two steps
  with the backbone frozen and two after the unfreeze;
- the rest of training at batch 64 on a synthetic crop511 set written
  under ``build/``: the data pipeline (``PairDataset``, ``DataLoader``,
  ``to_device``), stage-2 refine training
  (``experiments/siammask_sharp/config.json``, warm-started from a stage-1
  checkpoint), SiamRPN training (``experiments/siamrpn_resnet/config.json``),
  ``Trainer.restore`` and the train CLI (``siammask_tpu_torch.tools.train``);
- the overfit experiment (``siammask_tpu_torch.tools.overfit``): the
  two-stage mask recipe trained through the train CLI at the tool's
  schedule on a synthetic 70-frame clip written under ``build/``, then
  scored by the train step at lr 0 and by held-out tracking;
- data-parallel training (``Trainer(distributed=True)`` over
  ``parallel.dist``) at batch 64, in float32 and in bf16, and the sharded
  stream server (``parallel.serving.ShardedStreamServer``) at 16 streams;
- the bf16 compute mode (``build_model(..., dtype=torch.bfloat16)``): the
  sharp track step, video and 16 streams, the SiamRPN and base videos, the
  VOS and VOT drivers against their fp32 runs, and the stage-1, stage-2 and
  SiamRPN train steps.

Every phase runs on card 0; with two cards or more visible, ``[dp]`` and
``[sharded]`` also run over several cards.

Phases, each of which raises on failure:

1. device: a CUDA card is required; its name and power limit are printed;
2. build: the hand-written kernels are compiled from ``siammask_tpu_torch/csrc``;
   ptxas's registers and spills per kernel are printed, and a packed bf16
   kernel that spills fails the phase;
3. the forward xcorr kernel vs its plain version at the tracking shape, B=16,
   B=32, the training batch (B=64), stage 2's (64,7,7,256)*(64,5,5,256) and a
   ragged shape; kernel, plain and library times at B=1, B=16, B=32, B=64 and
   stage 2's shape; then bf16 (``phase_bf16_kernels``): at B=1, 16, 64 and
   stage 2's shape the packed bf16 kernel (the wrapper on the model's
   tensors) bit-identical to the scalar bf16 kernel (the same inputs at a
   2-byte offset) and both against the plain version, two calls of the
   packed kernel at B=64 and at stage 2's shape bit-identical, C=201 and
   offset pointers on the scalar kernel, and the packed kernel's time beside its
   bound, the plain version, the library call, the fp32 kernel and the
   scalar kernel;
4. the two gradient kernels vs their plain versions at B=1, B=16, B=32,
   B=64, stage 2's shape and a ragged shape; two calls of each at B=64 and
   at stage 2's shape bit-identical; kernel and plain times at B=1, B=16,
   B=32, B=64 and stage 2's shape beside each kernel's bound, and the eager
   autograd backward through the kernels vs through the plain forward;
   then bf16 grad-input and grad-kernel as phase 3 runs the bf16 forward,
   except that the packed grad-kernel (another summation order) is held
   within one bf16 step of the scalar kernel, with the elements that
   differ counted (``check_one_bf16_step``); two calls of each packed
   kernel at B=64 and at stage 2's shape bit-identical;
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
    that says so, where cv2 or PIL is not installed; then ``[bf16-vos]``:
    the batched driver with a bf16 twin of the weights, its per-object mean
    IoU beside the fp32 run's and the two runs' fused masks' IoU;
12. ``[rpn]``: SiamRPN (``experiments/siamrpn_resnet/config.json``, BN
    calibrated as for sharp) as phases 5, 6 and 8 run sharp: init + steps
    with 2 xcorr launches a step, one under ``sync_debug_mode("error")``;
    one step card vs CPU; ``track_video`` over 64 frames through the graph,
    bit-identical to the eager loop, frames/s, profile (2 xcorr kernels a
    frame by name), peak memory;
13. ``[base]``: SiamMask-base with ``refine=False``
    (``experiments/siammask_base/config.json``, out_size 63), the same with 3
    launches a step, and ``step_batched`` at O=2 card vs CPU;
14. ``[vot]``: ``track_vot`` for sharp (mask + Refine), base (mask) and
    SiamRPN (box) on two 40-frame 480x854 VOT2018-layout videos; in one the
    target and its gt jump far outside the search region at frame 20, which
    forces a lost frame (2), four skipped (0) and a re-init (1) whatever the
    weights (the box heads damped by ``damp_box_head``, so that the target is
    still held when the jump comes and the forced sequence shows; other
    losses may occur and are counted); the region library built before the
    drivers' clocks start, its build time printed; the result files checked
    line by line, the xcorr launches against the stepped frames, the region
    overlap's host us a call; then the CLI's ``main`` with the sharp weights as a ``.pth``, its
    results against the driver's; cv2 is required; the data, the result
    trees and the sharp ``.pth`` stay for phases 15-16; then ``[bf16-vot]``:
    the three drivers with bf16 twins of the same weights, each video's
    lost count equal to the fp32 run's, the largest drift in px between the
    bf16 and fp32 regions' centres; then ``[bf16]``: SiamMask-sharp in bf16
    (the calibrated weights, their cls head sharpened: ``sharpen_cls_head``)
    as phases 5, 6, 8 and 9 run it in fp32, card vs CPU at bf16 tolerances
    (``BF16_*``; ``[bf16-parity]``, which also prints the size difference
    as a share of the size over the first six steps from init:
    ``bf16_size_shares``), the graph videos
    bit-identical to their eager loops and every traced xcorr kernel the
    packed bf16 kernel, and SiamRPN and base graph videos in bf16, each
    timing beside its fp32 phase's;
15. ``[tune]``: ``tools.tune.main`` with that ``.pth`` (SiamMask-sharp at
    width 64): a VOT grid over the two videos (penalty_k 0.04 / 0.12 x lr
    0.30 / 0.45 at instance_size 255, then one cell at 271; EAO over frames
    1-40, since the standard 100-356 window is empty on 40 frames) and a VOS
    grid over phase 11's video (seg_thr 0.30 / 0.40, ``track_vos_batched``);
    each cell's score, wall s and frames/s on the drivers' clocks, the chosen
    cells, the xcorr launches against the frames stepped, peak and allocated
    memory after the first and the last cell (no runtime outlives its cell);
    the VOT grid run again over the same out-dir scores 0 cells (the claim
    protocol);
16. ``[eval]``: ``tools.eval.main`` (a spawned process pool; no card) over
    phase 15's VOT tree (each cell's EAO equal to the score ``tune``
    recorded), phase 14's trees (each family's lost number equal to its
    driver's, the CLI's too) and phase 11's fused PNGs beside a copy of the
    annotations (J and F in [0, 1]; the copy J = F = 1); the CLI's wall s a
    tree;
17. the training slice: per step finite losses, no skip, 3 + 3 + 3 kernel
    launches, the frozen stages bit-identical and the trainable ones moved;
    then the loss falling over 8 steps on the repeated batch; peak memory;
18. one training step on the card and on the CPU from the same weights and
    batch (B=2), open loop;
19. the profile of one frozen and one unfrozen step (no backbone backward
    while frozen), and train ms/step and samples/s; then ``[bf16-train]``:
    the same step computing in bf16 from the same weights, its first step
    against the fp32 one (loss, update cosine), 2 frozen and 2 unfrozen
    steps with 3 / 3 / 3 bf16 launches, ms/step and peak memory beside the
    fp32 ones; then ``[trace]``: the Chrome traces of the fp32 and bf16 sharp
    videos' and the bf16 16-stream call's profiles (phases 8 and 14) and of
    a frozen fp32 and bf16 step read by ``tools.trace_report``: device ms
    and share by category (cuDNN conv passes, GEMM, BN, dtype casts,
    NCHW<->NHWC transposes, copies and memsets, reduce/pool, elementwise,
    each xcorr kernel, collectives), the idle time in the trace's window
    with its three longest gaps and its gaps by size, the busy time against
    the untraced call's; the xcorr rows must count the kernels the profiles
    found and the device time be within 2% of the profile's;
20. ``[data]``: 8 batches of 64 from ``PairDataset(seed)`` through
    ``DataLoader`` for the stage-2 and the SiamRPN config, with thread and
    with process workers (min(16, cores)): samples/s of each, the host's
    cores, the two modes' batches bit-identical;
21. ``[train-refine]``: stage 2 warm-started from the stage-1 trainer's
    checkpoint (``merge_state_dict`` reports exactly the ``refine_model.*``
    entries missing), 4 steps on loader batches through ``to_device`` with
    3 / 1 / 1 launches each, backbone, neck and RPN bit-identical
    (parameters and BN buffers), the unused mask head moved by weight decay
    alone; the loss over 8 repeated steps; card vs CPU at B=2, both held to
    the CPU's float64 step; a profile (idle share, top 10) and ms/step,
    samples/s and peak memory; then ``[bf16-train-refine]``: the same task
    in bf16 from the same warm start and loader batch, its first step
    against the fp32 one (loss, update cosine; ``bf16_first_step``), two
    more steps with 3 / 1 / 1 launches, all of them the packed bf16 kernels,
    ms/step and peak memory beside the fp32 ones;
22. ``[train-rpn]``: SiamRPN, 2 frozen and 2 unfrozen steps on loader
    batches with 2 / 2 / 2 launches each, card vs CPU at B=2, a profile and
    the timings of each phase; then ``[bf16-train-rpn]`` as
    ``[bf16-train-refine]`` (a frozen first step, a frozen and an unfrozen
    one after it, 2 / 2 / 2 launches, both phases timed);
23. ``[train-resume]``: 2 SiamRPN steps, a checkpoint, ``Trainer.restore``
    into a fresh trainer, then step 3 bit-identical (weights, BN statistics,
    momentum) to the uninterrupted run, in phase and across the unfreeze
    boundary (where the restore warns and momentum restarts);
24. ``[train-cli]``: ``tools.train.main`` for SiamMask-base (one epoch of 2
    steps), then ``sharp_refine --pretrained`` its checkpoint, then
    ``--resume``: finite losses and a checkpoint from each;
25. ``[dp]`` (run after phase 19): SiamMask-base stage 1 from phase 17's
    weights at global batch 64: the default mode over a world-1 NCCL group
    bit-identical to the no-group step (deterministic cuDNN), frozen and
    unfrozen; two spawned ranks sharing card 0 over gloo, 32 rows each, in
    the default, fused and fused + sync-BN modes, a frozen and an unfrozen
    step each: the default mode against the single-process step (loss rtol
    1e-5, the updates within ``DP_BOUND`` over the step, printed beside the
    distance between the single-process step through cuDNN and through
    PyTorch's native convs, its float32 rounding), the fused modes' update
    direction against the default mode's (cos > 0.98 where the JAX tests
    hold it), the ranks' states bit-identical, 3 / 3 / 3 launches a step a
    rank, collectives a step and ms a step per mode; with two cards or more,
    NCCL over up to four at global batch 64 and 256 against one card
    (samples/s, scaling), then ``tools.train --num-devices`` over all; then
    ``[bf16-dp]``: the two ranks, three modes and two steps again on the
    bf16 twin of the weights, every launch packed, the default mode held to
    the single-process bf16 step within this run's bf16 noise (its updates
    and BN statistics no further from it than it is from the float32 step,
    the loss within 1e-3), the fused modes by direction, ms a step beside
    ``[dp]``'s; with two cards or more, NCCL bf16 scaling beside float32's;
26. ``[overfit]`` (run after phase 24): ``siammask_tpu_torch.tools.overfit
    --prepare --train --evaluate --task mask`` at width 64 with the tool's
    schedule (stage 1: 16 epochs of 64 steps of 8 across the unfreeze;
    stage 2: 24 epochs) on a 70-frame 480x854 clip written under
    ``build/`` (``write_overfit_clip``: a textured ellipse along the
    tool's keyframe boxes), the train CLI's logs in a file there: the
    wall s of each stage, each train run's samples/s on its own clock,
    the report's fit and held-out numbers, which must clear
    ``tests/test_overfit_artifact.py``'s thresholds (mask and total loss
    under init's / 10; held-out mean IoU over init's + 0.2 and over 0.5;
    no more lost frames than init's), and stage 1's log must show the
    backbone's optimizer group from the unfreeze on and not before (those
    thresholds alone pass a stage 1 that never unfreezes and a stage-2
    warmup 10x too high; they catch a warm start that drops the RPN);
    the xcorr launches of the tool's
    own process (its lr-0 train steps and tracking), every kernel at
    least once;
27. ``[sharded]``: SiamMask-sharp, 16 streams on 480x854 frames over 32,
    through ``ShardedStreamServer`` over [cuda:0, cuda:0]: bit-identical to
    each replica's tracker on its 8 streams; against the unsharded
    ``track_video_multi`` at O=16 the same best_id at every frame and
    stream, positions, scores, cell masks and sizes within
    ``tests/test_serving_sharded.py``'s tolerances, and the masks in the
    frame within them once the unsharded cell masks are warped at the
    sharded run's positions (the warp at the unsharded positions is printed
    beside: a position within its tolerance moves the pixels on a mask's
    edge); 3 xcorr
    kernels a frame a replica by name in a profile, aggregate frames/s of
    both; with two cards or more, 16 streams a card over all of them
    against one card.
28. ``[bench]``: ``python3 -m siammask_tpu_torch.bench --summary --iters
    BENCH_ITERS`` (its five rows in bf16, each in its own process) and its
    scan row with ``--fp32``: every row a value above 0 from at least 5
    windows, with the card's name and power limit; every xcorr launch of
    its timed windows a kernel's (3 forward a frame; a training step's
    forward and gradient launches), all packed in bf16 and none in fp32,
    where TF32 must be off; each row's ms beside this run's ``[bf16]``,
    ``[bf16-streams]``, ``[bf16-train]``, ``[bf16-train-refine]`` or
    ``[video]`` ms of the same work.

Before the card's line, ``[time]`` gives the seconds the script held the
card. The last line is ``{"ok": true, "device": {...}}``; the line before it lists
each kernel with its launches on the main paths, error, times, bound and
the time of the one library call (cuDNN's grouped conv) that computes the
same function, with ``launches_by_path`` (track, video, streams16, vos,
rpn, base, vot, tune, train, train_refine, train_rpn, dp: rank 0's of the
two-rank run, overfit: the overfit tool's scoring, not its train CLI
subprocesses, sharded, and the bf16 paths bf16_track, bf16_video,
bf16_streams16, bf16_rpn, bf16_base, bf16_vos, bf16_vot, bf16_train,
bf16_train_refine, bf16_train_rpn, bf16_dp: rank 0's of the two-rank
run, and the bench's rows' timed windows: bf16_bench_scan,
bf16_bench_serving_16streams, bf16_bench_train_frozen,
bf16_bench_train_unfrozen, bf16_bench_train_refine and bench_scan_fp32).
The kernels are the fp32 forward,
grad-input and grad-kernel (``bf16_scalar``: their bf16
instantiation's times at B=1, 16, 64 and stage 2's shape, on inputs at a
2-byte offset) and the packed bf16 forward, grad-input and grad-kernel
(``by_shape``: B=1, 16, 64 and stage 2's shape, each beside the fp32 and
the scalar kernel of the run); the fp32 records also hold the times at
stage 2's shape (``stage2``) and at the data-parallel local batches 16 and
32 (``local_batches``); a bf16 bound is half the fp32 bytes. Each path's
launches go to the packed kernels on the bf16 paths and to the fp32
kernels on the fp32 ones, which the wrappers' ``packed_launches`` counts
and the graphs' ``xcorr_packed_launches`` confirm (``check_route``). A kernel captured in a
CUDA graph passes through its wrapper (and its count) once, at capture; on
the graph paths its launches are the captured launches times the replays,
which phases 8, 9, 12 and 13 confirm by kernel name in a profiler trace.
"""
from __future__ import annotations

import contextlib
import datetime
import hashlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from siammask_tpu_torch.config import Config
from siammask_tpu_torch.data.anchor_target import AnchorTarget
from siammask_tpu_torch.data.dataset import DataLoader, PairDataset, to_device
from siammask_tpu_torch.eval.datasets import load_dataset
from siammask_tpu_torch.eval.region import vot_overlap
from siammask_tpu_torch.models.heads import slice_skip_windows
from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp, SiamRPN
from siammask_tpu_torch.ops import _build
from siammask_tpu_torch.parallel.dist import (_all_reduce, _free_port, init_distributed,
                                              local_rows, spawn)
from siammask_tpu_torch.parallel.serving import ShardedStreamServer
from siammask_tpu_torch.ops.sample import subwindow_crop, warp_back_mask
from siammask_tpu_torch.ops.xcorr import (_to_groups, depthwise_xcorr,
                                          depthwise_xcorr_grad_input,
                                          depthwise_xcorr_grad_input_reference,
                                          depthwise_xcorr_grad_kernel,
                                          depthwise_xcorr_grad_kernel_reference,
                                          depthwise_xcorr_reference)
from siammask_tpu_torch.tracker.anchors import Anchors
from siammask_tpu_torch.tracker.runtime import TrackerRuntime
from siammask_tpu_torch.tracker.tracker import BoxStepOutput, StepOutput, Tracker, TrackState
from siammask_tpu_torch.tracker.vos import track_vos, track_vos_batched
from siammask_tpu_torch.tracker.vot import SKIP, track_vot
from siammask_tpu_torch.tools import overfit, trace_report
from siammask_tpu_torch.tools import train as train_cli
from siammask_tpu_torch.train.checkpoint import merge_state_dict, read_state_dict, save_checkpoint
from siammask_tpu_torch.train.lr import build_lr_spaces
from siammask_tpu_torch.train.trainer import OptimizerConfig, Trainer, TrainSettings

REPO = Path(__file__).resolve().parent
CONFIG = REPO / "experiments" / "siammask_sharp" / "config_davis.json"
TRAIN_CONFIG = REPO / "experiments" / "siammask_base" / "config.json"
RPN_CONFIG = REPO / "experiments" / "siamrpn_resnet" / "config.json"
BASE_CONFIG = TRAIN_CONFIG
VOT_CONFIG = REPO / "experiments" / "siammask_sharp" / "config_vot.json"
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
# the VOT phase: two videos of VOT_FRAMES frames; in vid1 the target and its
# gt jump VOT_DX px right at frame VOT_JUMP, far outside the search region
VOT_FRAMES, VOT_JUMP, VOT_DX = 40, 20, 480
VOT_FORCED = ["2", *["0"] * (SKIP - 1), "1"]     # lost, skipped frames, re-init
VOS_ROOT, VOT_ROOT = REPO / "build" / "vos_smoke", REPO / "build" / "vot_smoke"
SHARP_PTH = "sharp.pth"   # [vot]'s damped sharp weights, which [tune] loads
# the tune grids: penalty_k {0.04, 0.12} x lr {0.30, 0.45} at window_influence
# 0.42 and instance_size 255; one cell at 271; seg_thr {0.30, 0.40} for VOS
TUNE_ROOT = REPO / "build" / "tune_smoke"
_ONE_CELL = ["--penalty-k", "0.04,0.05,0.08", "--window-influence", "0.42,0.425,0.01",
             "--lr", "0.30,0.31,0.15"]
TUNE_VOT = ["--penalty-k", "0.04,0.13,0.08", "--window-influence", "0.42,0.425,0.01",
            "--lr", "0.30,0.46,0.15"]
TUNE_WIDE = [*_ONE_CELL, "--search-region", "271,272,16"]
TUNE_VOS = [*_ONE_CELL, "--seg-thr", "0.30,0.41,0.10"]
TUNE_MEMORY_SLACK = 2**20   # bytes: no cell's runtime may outlive it
TIMED_CALLS = 5
TRAIN_BATCH = 64          # tools/train.py's default
TRAIN_EPOCHS = 2          # epoch 0 frozen, epoch 1 unfrozen (unfreeze_at 0.5)
TRAIN_FRAME_HW = (360, 480)
# the xcorr of stage-2 refine training (143x143 search): the neck's 9x9
# crop through the 3x3 adjust convs, against the 5x5 template
STAGE2_X, STAGE2_K = (TRAIN_BATCH, 7, 7, 256), (TRAIN_BATCH, 5, 5, 256)
# the data-parallel paths' local batches: the training batch over 4 and 2 ranks
LOCAL_BATCHES = (TRAIN_BATCH // 4, TRAIN_BATCH // 2)
# the batches the bf16 kernels are checked and timed at: a track step, 16
# streams, a train step
BF16_BATCHES = (1, 16, TRAIN_BATCH)
# the bf16 forward and grad-input: those batches and stage 2's shape
BF16_SHAPES = {**{f"B={b}": ((b, 29, 29, 256), (b, 5, 5, 256)) for b in BF16_BATCHES},
               "stage2": (STAGE2_X, STAGE2_K)}
TRAIN_WIDTH = 64
DEV = "cuda"
SHARP_TRAIN_CONFIG = REPO / "experiments" / "siammask_sharp" / "config.json"
SMOKE_TRAIN = REPO / "build" / "train_smoke"
# the wrappers; each launches a packed bf16 kernel on the bf16 paths
KERNELS = (depthwise_xcorr, depthwise_xcorr_grad_input, depthwise_xcorr_grad_kernel)
# an H100 SXM's published peaks at 700 W: HBM3 and fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
BF16 = torch.bfloat16
# the bf16 phases' tolerances, card against the CPU (both bf16 activations
# over float32 weights; cuDNN and the CPU's convs round at other points, and
# a bf16 rounding moves a value by up to 2^-9 of it)
BF16_MAP_TOL = 3e-2        # head maps, relative L2 norm
BF16_POS_TOL = 1.0         # px, positions and sizes, plus BF16_SIZE_REL of the size
BF16_SIZE_REL = 1e-2       # the size delta passes a bf16 exp: 2^-8 of the size a rounding
BF16_SCORE_TOL = 2.0 ** -7  # the carried score, two bf16 steps near 1
BF16_MASK_TOL = 3e-2       # sigmoid cell masks, absolute
# the bf16 train step against the float32 one from the same weights and batch
# (2.7e-4 and 0.9935 on an H100; a wrong gradient gives a cosine near 0)
BF16_TRAIN_LOSS_RTOL = 1e-2
BF16_TRAIN_MIN_COS = 0.9   # cosine of the two steps' parameter updates
# numbers a phase keeps for a later phase to print beside its own, by tag
MEASURED: dict = {}
# [trace]: the graph calls whose profile is exported as a Chrome trace (the
# train phases export a frozen step's), and per tag the trace's path, the
# profile's device-busy ms and the xcorr kernels expected in each of
# trace_report's xcorr rows
TRACED = ("video", "bf16", "bf16-streams")
# [bench]: --iters for at least 5 windows of every row (5 x 64 frames, and
# max(5, 320 // 128) windows of 8 training steps)
BENCH_ITERS = 320
# the bench's rows by summary name -> this run's ms ([bf16], [bf16-streams],
# [bf16-train], [bf16-train-refine]) and the per-what of a row's ms
BENCH_BESIDE = {
    "scan": (lambda: MEASURED["bf16"]["ms_frame"], "frame", "[bf16] video"),
    "serving_16streams": (lambda: MEASURED["bf16-streams"]["ms_frame"] / STREAMS,
                          "stream-frame", "[bf16-streams]"),
    "train_frozen": (lambda: MEASURED["bf16-train-timing"]["frozen"][0], "step",
                     "[bf16-train] frozen"),
    "train_unfrozen": (lambda: MEASURED["bf16-train-timing"]["unfrozen"][0], "step",
                       "[bf16-train] unfrozen"),
    "train_refine": (lambda: MEASURED["bf16-train-refine-timing"]["stage-2"][0], "step",
                     "[bf16-train-refine]"),
    "scan_fp32": (lambda: MEASURED["video"]["ms_frame"], "frame", "[video]"),
}
TRACE_DIR = REPO / "build" / "traces"
TRACES: dict = {}
XCORR_ROWS = tuple(cat for cat, _ in trace_report.CATEGORIES if cat.startswith("xcorr"))
# [overfit]: the tool's work tree, its default batch, a train CLI step line
# (its timestamp, epoch and step), an optimizer group's LR on it,
# a stage's wall-time line of the tool
OVERFIT_ROOT = REPO / "build" / "overfit_smoke"
OVERFIT_BATCH = 8
OVERFIT_STEP = re.compile(r"^(\S+ \S+) INFO epoch (\d+) step (\d+) ")
OVERFIT_GROUP = re.compile(r" lr/(\w+)=([0-9.eE+-]+)")
OVERFIT_WALL = re.compile(r"^(.+): ([0-9.]+) s wall$")


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
def calibrate_bn(model: SiamRPN, z: torch.Tensor, x: torch.Tensor) -> None:
    """Scale every BatchNorm by the overall standard deviation of its input on
    one template/search pair (running_mean 0, one running_var per layer), so
    random-weight activations stay O(1) like a trained model's and the scores
    do not saturate. One scalar per layer, not per channel, so that nearly dead
    channels are not amplified. Any of the three families: the search pass is
    ``track_mask`` where the model has one, else ``track``."""
    with bn_calibration(model):
        zf = model.template(z)
        getattr(model, "track_mask", model.track)(zf, x)


@torch.no_grad()
def sharpen_cls_head(model: SiamRPN, z: torch.Tensor, x: torch.Tensor,
                     spread: float = 0.5) -> None:
    """Set the cls head's last 1x1 conv so that each anchor's fg-minus-bg
    logit has mean 0 and standard deviation ``spread`` over the score map of
    one template/search pair. A calibrated random model scores every cell
    near one value (a sigmoid of ~0.69 +- 0.01), which bf16 rounds to a few
    values 2^-8 apart: two bf16 runs that round differently then tie or swap
    their best cells. At 0.5 the map has a peak, as a trained model's does,
    whose margin bf16 rounding does not close, and the sigmoid does not
    saturate."""
    head = model.rpn_model.cls.head[3]
    k = head.out_channels // 2
    score = model.rpn_model.cls(model.template(z), model.features(x)[1]).float()
    logit = score[:, k:] - score[:, :k] - (head.bias[k:] - head.bias[:k])[None, :, None, None]
    scale = spread / logit.std(dim=(0, 2, 3))
    head.weight.mul_(scale.repeat(2)[:, None, None, None])
    head.bias[:k] = 0.0
    head.bias[k:] = -scale * logit.mean(dim=(0, 2, 3))


@torch.no_grad()
def damp_box_head(model: SiamRPN, factor: float = 0.1) -> None:
    """Scale the loc head's last 1x1 conv by ``factor``. Seeded random
    weights, even BN-calibrated, regress box deltas of O(1), a box's width a
    frame, so the box leaves a slow target at once; at 0.1 the box mostly
    holds a target that moves a few pixels a frame, so that the VOT data's
    forced loss is not preempted by an earlier one. It does not rule out
    other losses: random weights still lose the target now and then."""
    head = model.rpn_model.loc.head[3]
    head.weight.mul_(factor)
    head.bias.mul_(factor)


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


def check_one_bf16_step(what: str, out: torch.Tensor, ref: torch.Tensor) -> int:
    """The packed bf16 grad-kernel against the scalar one on the same
    inputs: both sum the same float32 products in other orders and round
    once, so each element is at most one bf16 step (2^-7 of the binade of
    the larger of the two) apart, plus 2^-16 of the largest entry where the
    sums cancel to near zero (a float32 sum's order moves it by ~1e-6 of
    the terms' size). Returns how many elements differ."""
    a, b = out.float(), ref.float()
    step = torch.exp2(torch.floor(torch.log2(torch.maximum(a.abs(), b.abs()))) - 7)
    slack = 2.0 ** -16 * b.abs().max()
    over = int(((a - b).abs() > step + slack).sum())
    differ = int((out != ref).sum())
    if over:
        raise AssertionError(f"[{what}] {over} elements more than one bf16 step apart")
    print(f"[{what}] {differ} of {out.numel()} elements differ, each by at most one bf16 step "
          f"(largest difference {(a - b).abs().max().item():.3e})")
    return differ


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
    spills = []
    for name, r in _build.kernel_resources(path.with_suffix(".log").read_text()).items():
        print(f"[build] ptxas: {name}: {r['registers']} registers, {r['spill_stores']} / "
              f"{r['spill_loads']} bytes spill stores / loads")
        if "bf16x2" in name and (r["spill_stores"] or r["spill_loads"]):
            spills.append(name)
    if spills:
        raise AssertionError(f"[build] packed bf16 kernels that spill: {spills}")
    print("[build] the packed bf16 kernels do not spill")


def offset_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts one element past an
    aligned allocation: for bf16 a pointer 2 bytes off 4-byte alignment,
    which the packed bf16 kernel does not take."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def phase_bf16_kernels(which: str, fp32_ms: dict) -> tuple[dict, dict]:
    """The bf16 forward (``which`` "forward", ``[kernel]``), grad-input
    ("input", ``[grad]``) or grad-kernel ("kernel", ``[grad]``). At each of
    ``BF16_SHAPES`` the wrapper takes the packed kernel on the model's
    contiguous tensors and the scalar bf16 kernel (the kernel's bf16
    instantiation) on the same inputs copied to a 2-byte offset: the
    forward's and grad-input's two outputs must be the same bits,
    grad-kernel's (another summation order) within one bf16 step
    (``check_one_bf16_step``), each within ``check_close``'s bf16 tolerance
    of the plain version; two calls of the packed kernel at B=64 and at
    stage 2's shape must be the same bits. C=201 and offset pointers take
    the scalar kernel and are held to the plain version. Then each shape's
    packed kernel is timed beside its bound, the plain version, the library
    call, the fp32 kernel of this run (``fp32_ms``) and the scalar kernel.
    Returns the packed kernel's record (its times at B=1 for the forward,
    B=64 for the gradients, and ``by_shape``) and the scalar kernel's times
    and errors by shape."""
    tag = "[kernel]" if which == "forward" else "[grad]"
    label = "grad-kernel" if which == "kernel" else which
    wrapper, plain = {
        "forward": (depthwise_xcorr, depthwise_xcorr_reference),
        "input": (depthwise_xcorr_grad_input, depthwise_xcorr_grad_input_reference),
        "kernel": (depthwise_xcorr_grad_kernel, depthwise_xcorr_grad_kernel_reference)}[which]
    g = torch.Generator().manual_seed(SEED + 2)

    def inputs(xs, ks):
        """x, k and the wrapper's arguments (their first two: the library call's)."""
        go = (xs[0], xs[1] - ks[1] + 1, xs[2] - ks[2] + 1, xs[3])
        x, k, go = (torch.randn(s, generator=g).to("cuda", BF16) for s in (xs, ks, go))
        return x, k, {"forward": (x, k), "input": (go, k, xs[1], xs[2]),
                      "kernel": (x, go)}[which]

    def run(args):
        """The wrapper's output and whether it launched the packed kernel."""
        before = wrapper.packed_launches
        out = wrapper(*args)
        torch.cuda.synchronize()
        return out, wrapper.packed_launches - before

    def shifted(args):
        """The arguments with every tensor at a 2-byte offset."""
        return tuple(offset_copy(a) if torch.is_tensor(a) else a for a in args)

    by_shape, scalar = {}, {}
    for name, (xs, ks) in BF16_SHAPES.items():
        x, k, args = inputs(xs, ks)
        args_s = shifted(args)
        (out, n_packed), (out_s, n_scalar) = run(args), run(args_s)
        if (n_packed, n_scalar) != (1, 0):
            raise AssertionError(f"{tag} bf16 {label} {name}: packed launches {n_packed} on "
                                 f"aligned inputs, {n_scalar} at an offset; expected 1, 0")
        ref = plain(*args)
        torch.cuda.synchronize()
        if which == "kernel":
            differ = check_one_bf16_step(f"{label} bf16 {name}: packed vs scalar kernel",
                                         out, out_s)
            err = check_close(f"{label} bf16 {name}: packed kernel", out, ref)
            err_s = check_close(f"{label} bf16 {name}: scalar kernel", out_s, ref)
        else:
            if not torch.equal(out, out_s):
                raise AssertionError(f"{tag} bf16 {label} {name}: the packed kernel's output is "
                                     "not the scalar kernel's")
            differ = 0
            err = err_s = check_close(f"{label} bf16 {name}: packed kernel, bit-identical to the "
                                      "scalar kernel", out, ref)
        if name in (f"B={TRAIN_BATCH}", "stage2"):
            # no atomics: a second call gives the same bits
            if not torch.equal(run(args)[0], out):
                raise AssertionError(f"{tag} bf16 {label} {name}: two calls differ")
            print(f"{tag} bf16 {label} {name}: two calls of the packed kernel bit-identical")
        timed = time_kernel(f"{tag} bf16 {label} {name}, packed kernel", wrapper, plain, args,
                            which, args[:2], x, k)
        scalar_us = graph_us(wrapper, *args_s)
        by_shape[name] = {"max_abs_err": err, **timed, "fp32_kernel_ms": fp32_ms[name],
                          "scalar_ms": scalar_us / 1e3, "differ_from_scalar": differ}
        scalar[name] = {"max_abs_err": err_s, "ms": scalar_us / 1e3}
        print(f"{tag} bf16 {label} {name}: packed kernel {timed['ms'] * 1e3:.2f} us "
              f"({100 * timed['bound_ms'] / timed['ms']:.0f}% of its bound "
              f"{timed['bound_ms'] * 1e3:.2f} us); fp32 kernel {fp32_ms[name] * 1e3:.2f} us; "
              f"scalar bf16 kernel {scalar_us:.2f} us (inputs at a 2-byte offset); plain "
              f"{timed['plain_ms'] * 1e3:.2f} us; library call {timed['library_ms'] * 1e3:.2f} us")
    for name, (xs, ks), offset in (("C=201", ((3, 29, 29, 201), (3, 5, 5, 201)), False),
                                   ("offset pointers", BF16_SHAPES["B=16"], True)):
        _, _, args = inputs(xs, ks)
        args = shifted(args) if offset else args
        out, n_packed = run(args)
        if n_packed:
            raise AssertionError(f"{tag} bf16 {label} {name}: took the packed kernel")
        check_close(f"{label} bf16 {name}: scalar kernel", out, plain(*args))
    main = "B=1" if which == "forward" else f"B={TRAIN_BATCH}"
    suffix = {"forward": "", "input": "_grad_input", "kernel": "_grad_kernel"}[which]
    record = {"name": f"depthwise_xcorr{suffix}_bf16x2", "route": "cuda",
              "source": "siammask_tpu_torch/csrc/xcorr.cu",
              "replaces": "siammask_tpu/ops/xcorr_pallas.py:" + ("67" if which == "forward"
                                                                 else "48"),
              **{k: v for k, v in by_shape[main].items() if k not in ("fp32_kernel_ms",
                                                                      "scalar_ms",
                                                                      "differ_from_scalar")},
              "by_shape": by_shape}
    return record, scalar


def phase_kernels() -> list[dict]:
    """Kernel vs plain version on the card, fp32, then bf16
    (``phase_bf16_kernels``); returns the strip kernel's record, timed at
    the tracking shape (B=1), and the packed bf16 kernel's."""
    g = torch.Generator().manual_seed(SEED)
    cases = [((1, 29, 29, 256), (1, 5, 5, 256), torch.float32),
             ((16, 29, 29, 256), (16, 5, 5, 256), torch.float32),
             ((32, 29, 29, 256), (32, 5, 5, 256), torch.float32),
             ((TRAIN_BATCH, 29, 29, 256), (TRAIN_BATCH, 5, 5, 256), torch.float32),
             (STAGE2_X, STAGE2_K, torch.float32),
             ((3, 17, 23, 200), (3, 4, 3, 200), torch.float32)]
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
    for b, dtype in ((1, torch.float32), (16, torch.float32), (32, torch.float32),
                     (TRAIN_BATCH, torch.float32)):
        x = torch.randn((b, 29, 29, 256), generator=g).to("cuda", dtype)
        k = torch.randn((b, 5, 5, 256), generator=g).to("cuda", dtype)
        times[(b, dtype)] = time_kernel(
            f"[kernel] ({b},29,29,256)*({b},5,5,256) {str(dtype)[6:]}", depthwise_xcorr,
            depthwise_xcorr_reference, (x, k), "forward", (x, k), x, k)
    # stage-2 refine training's shape: one partial strip, a 3x3 output
    x = torch.randn(STAGE2_X, generator=g).to("cuda")
    k = torch.randn(STAGE2_K, generator=g).to("cuda")
    stage2 = time_kernel(f"[kernel] stage 2 {STAGE2_X}*{STAGE2_K} fp32", depthwise_xcorr,
                         depthwise_xcorr_reference, (x, k), "forward", (x, k), x, k)
    fp32_ms = {**{f"B={b}": times[(b, torch.float32)]["ms"] for b in BF16_BATCHES},
               "stage2": stage2["ms"]}
    packed, scalar = phase_bf16_kernels("forward", fp32_ms)
    return [{"name": "depthwise_xcorr", "route": "cuda",
             "source": "siammask_tpu_torch/csrc/xcorr.cu",
             "replaces": "siammask_tpu/ops/xcorr_pallas.py:67",
             "max_abs_err": errors[((1, 29, 29, 256), torch.float32)],
             **times[(1, torch.float32)],
             "stage2": {"max_abs_err": errors[(STAGE2_X, torch.float32)], **stage2},
             "local_batches": {str(b): {"max_abs_err": errors[((b, 29, 29, 256), torch.float32)],
                                        **times[(b, torch.float32)]} for b in LOCAL_BATCHES},
             "bf16_scalar": scalar}, packed]


def phase_grad_kernels() -> list[dict]:
    """The two gradient kernels vs their plain versions on the card, then
    bf16 grad-input and grad-kernel (``phase_bf16_kernels``); returns the
    records of grad-input's strip kernel, grad-kernel and the packed bf16
    grad-input and grad-kernel, timed at the training shape (B=64)."""
    g = torch.Generator().manual_seed(SEED + 1)

    def inputs(xs, ks, dtype):
        go = (xs[0], xs[1] - ks[1] + 1, xs[2] - ks[2] + 1, xs[3])
        return tuple(torch.randn(s, generator=g).to("cuda", dtype) for s in (xs, ks, go))

    errors = {}
    for xs, ks, dtype in [((1, 29, 29, 256), (1, 5, 5, 256), torch.float32),
                          ((16, 29, 29, 256), (16, 5, 5, 256), torch.float32),
                          ((32, 29, 29, 256), (32, 5, 5, 256), torch.float32),
                          ((TRAIN_BATCH, 29, 29, 256), (TRAIN_BATCH, 5, 5, 256), torch.float32),
                          (STAGE2_X, STAGE2_K, torch.float32),
                          ((3, 17, 23, 200), (3, 4, 3, 200), torch.float32)]:
        # bf16: phase_bf16_kernels
        x, k, go = inputs(xs, ks, dtype)
        tag = f"{xs} * {ks} {str(dtype)[6:]}"
        checked = {"kernel": (lambda: depthwise_xcorr_grad_kernel(x, go),
                              depthwise_xcorr_grad_kernel_reference(x, go)),
                   "input": (lambda: depthwise_xcorr_grad_input(go, k, xs[1], xs[2]),
                             depthwise_xcorr_grad_input_reference(go, k, xs[1], xs[2]))}
        outs = {which: call() for which, (call, _) in checked.items()}
        torch.cuda.synchronize()
        for which, (_, ref) in checked.items():
            errors[(which, xs, dtype)] = check_close(f"grad-{which} {tag}", outs[which], ref)
        if xs[0] == TRAIN_BATCH:
            # no atomics: a second call gives the same bits
            for which, (call, _) in checked.items():
                first, again = outs[which], call()
                torch.cuda.synchronize()
                if not torch.equal(again, first):
                    raise AssertionError(f"grad-{which} {tag}: two calls differ")
                print(f"[grad] grad-{which} {tag}: two calls bit-identical")

    times = {}
    for b in (1, 16, 32, TRAIN_BATCH):
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

    # stage-2 refine training's shape: a 3x3 upstream grad
    x, k, go = inputs(STAGE2_X, STAGE2_K, torch.float32)
    times[("input", "stage2")] = time_kernel(
        "[grad] grad-input stage 2 fp32", depthwise_xcorr_grad_input,
        depthwise_xcorr_grad_input_reference, (go, k, *STAGE2_X[1:3]), "input", (go, k), x, k)
    times[("kernel", "stage2")] = time_kernel(
        "[grad] grad-kernel stage 2 fp32", depthwise_xcorr_grad_kernel,
        depthwise_xcorr_grad_kernel_reference, (x, go), "kernel", (x, go), x, k)

    packed, scalar = {}, {}
    for which in ("input", "kernel"):
        fp32_ms = {**{f"B={b}": times[(which, b)]["ms"] for b in BF16_BATCHES},
                   "stage2": times[(which, "stage2")]["ms"]}
        packed[which], scalar[which] = phase_bf16_kernels(which, fp32_ms)
    # the custom_vjp backward of depthwise_xcorr_ad
    return [*({"name": f"depthwise_xcorr_grad_{which}", "route": "cuda",
               "source": "siammask_tpu_torch/csrc/xcorr.cu",
               "replaces": "siammask_tpu/ops/xcorr_pallas.py:48",
               "max_abs_err": errors[(which, (TRAIN_BATCH, 29, 29, 256), torch.float32)],
               **times[(which, TRAIN_BATCH)],
               "stage2": {"max_abs_err": errors[(which, STAGE2_X, torch.float32)],
                          **times[(which, "stage2")]},
               "local_batches": {str(b): {"max_abs_err": errors[(which, (b, 29, 29, 256),
                                                                  torch.float32)],
                                          **times[(which, b)]} for b in LOCAL_BATCHES},
               "bf16_scalar": scalar[which]}
              for which in ("input", "kernel")), packed["input"], packed["kernel"]]


def bf16_twin(model: SiamRPN) -> SiamRPN:
    """The same weights, on the same device, in a model of the same family
    that computes in bf16 (its parameters stay float32)."""
    twin = type(model)(width=model.width, dtype=BF16)
    twin.load_state_dict(model.state_dict())
    return twin.to(next(model.parameters()).device).eval()


def build_model(p, cls=SiamMaskSharp, mask: bool = True, refine: bool = True,
                dtype: torch.dtype | None = None) -> tuple[SiamRPN, Tracker, np.ndarray]:
    """A seeded model of ``cls`` at width 64 on the card, its BN calibrated
    on a crop pair of the first frame, its tracker and the frames. With
    ``dtype`` bf16 the calibrated weights' cls head is sharpened on the same
    pair (``sharpen_cls_head``) and the model is their bf16 twin."""
    model = cls(width=64).init_weights(torch.Generator().manual_seed(SEED))
    model = model.to("cuda").eval()
    frames = synthetic_frames(STEPS + TIMED_STEPS + 12)
    f0 = torch.from_numpy(frames[0]).cuda()
    avg = f0.mean(dim=(0, 1), dtype=torch.float32)
    pos = torch.tensor([TARGET_POS], device="cuda")
    z = subwindow_crop(f0, pos, torch.tensor([180.0], device="cuda"), 127, avg[None])
    x = subwindow_crop(f0, pos, torch.tensor([360.0], device="cuda"), 255, avg[None])
    z, x = z.permute(0, 3, 1, 2).contiguous(), x.permute(0, 3, 1, 2).contiguous()
    calibrate_bn(model, z, x)
    if dtype is not None:
        sharpen_cls_head(model, z, x)
        model = bf16_twin(model)
    return model, Tracker(model, p, "cuda", mask=mask, refine=refine), frames


def xcorr_per_step(tracker: Tracker) -> int:
    """cls and loc, and the mask branch's corr with the mask."""
    return 3 if tracker.mask else 2


def check_output(out, hw, out_size: int = 127) -> None:
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
    if isinstance(out, BoxStepOutput):
        return
    if (tuple(out.mask_in_frame.shape) != (h, w)
            or tuple(out.mask_logits.shape) != (out_size, out_size)):
        raise AssertionError(f"mask shapes {tuple(out.mask_in_frame.shape)}, "
                             f"{tuple(out.mask_logits.shape)}")


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
        fn.packed_launches = 0


def check_route(tag: str, bf16: bool, graph=None) -> None:
    """The kernel that every forward, grad-input and grad-kernel launch
    since the last ``reset_launches``, and every xcorr kernel ``graph``
    captured, took: the packed bf16 kernel on a bf16 path (the model's
    shapes: C=256, contiguous), the fp32 kernel on a float32 one."""
    totals = [fn.launches for fn in KERNELS]
    packed = [fn.packed_launches for fn in KERNELS]
    if graph is not None:
        totals.append(graph.xcorr_launches)
        packed.append(graph.xcorr_packed_launches)
    if packed != (totals if bf16 else [0] * len(totals)):
        raise AssertionError(f"[{tag}] packed bf16 kernel launches {packed} of {totals} "
                             "(forward, grad-input, grad-kernel, captured in a graph)")


def read_launches() -> list[int]:
    return [fn.launches for fn in KERNELS]


def phase_slice(tracker: Tracker, frames: np.ndarray, tag: str = "slice"):
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
    check_route(tag, tracker.model.dtype == BF16)
    steps = len(outs)
    expected = [xcorr_per_step(tracker) * steps, 0, 0]
    if launches != expected:
        raise AssertionError(f"{tag}: {launches} forward/grad-input/grad-kernel launches in "
                             f"{steps} steps, expected {expected}")
    for out in outs:
        check_output(out, FRAME_HW, tracker.p.out_size)
    last = outs[-1]
    print(f"[{tag}] init + {steps} steps at width 64: {launches[0]} xcorr launches; "
          f"step {steps} ran under sync_debug_mode=error; last pos "
          f"{last.target_pos.cpu().tolist()} sz {last.target_sz.cpu().tolist()} "
          f"score {last.score.item():.4f} best_id {last.best_id.item()}")
    return state, launches


def cpu_tracker_of(tracker: Tracker) -> Tracker:
    """The same weights and path in a tracker on the CPU."""
    cpu_model = type(tracker.model)(width=64, dtype=tracker.model.dtype)
    cpu_model.load_state_dict({k: v.cpu() for k, v in tracker.model.state_dict().items()})
    return Tracker(cpu_model.eval(), tracker.p, "cpu", mask=tracker.mask, refine=tracker.refine)


def check_step_close(what: str, out, ref, bf16: bool = False) -> float:
    """A step's outputs against a reference step of other kernels (cuDNN's
    summation order against the CPU's, or another batch size): the same
    best_id, positions and sizes within 1e-2 px, the mask (Refine's or the
    63x63 head's) within 1e-3 of its largest magnitude. With ``bf16``: the
    same best_id, positions and sizes within BF16_POS_TOL plus BF16_SIZE_REL
    of the reference's larger side, the score within BF16_SCORE_TOL and the
    mask within BF16_MASK_TOL. Returns the mask's max abs error (0 for a
    box-only step)."""
    ref = type(ref)(*(v.to(out.best_id.device) for v in ref))
    if not torch.equal(out.best_id, ref.best_id):
        raise AssertionError(f"{what}: best_id {out.best_id.tolist()} vs {ref.best_id.tolist()}")
    pos_tol = 1e-2
    if bf16:
        pos_tol = BF16_POS_TOL + BF16_SIZE_REL * ref.target_sz.abs().max().item()
        # the size difference as a share of the size: BF16_SIZE_REL's scale
        diff = (out.target_sz - ref.target_sz).abs()
        share = (diff / ref.target_sz.abs()).max().item()
        print(f"{what}: size {[round(v, 2) for v in ref.target_sz.tolist()]} px, difference "
              f"{[round(v, 3) for v in diff.tolist()]} px, at most {100 * share:.3f}% of its "
              f"side (tolerance {pos_tol:.3f} px)")
    torch.testing.assert_close(out.target_pos, ref.target_pos, rtol=0, atol=pos_tol)
    torch.testing.assert_close(out.target_sz, ref.target_sz, rtol=0, atol=pos_tol)
    if bf16:
        torch.testing.assert_close(out.score, ref.score, rtol=0, atol=BF16_SCORE_TOL)
    if isinstance(ref, BoxStepOutput):
        return 0.0
    a, b = out.mask_logits.float(), ref.mask_logits.float()
    atol = BF16_MASK_TOL if bf16 else 1e-3 * b.abs().max().item()
    torch.testing.assert_close(a, b, rtol=0, atol=atol)
    return (a - b).abs().max().item()


def head_maps(model, zf: torch.Tensor, x: torch.Tensor) -> dict:
    """The model's raw maps on one search crop: score and loc, the 63x63
    mask head's map (base) or Refine's logits at the centre cell (sharp)."""
    if isinstance(model, SiamMaskSharp):
        out = model.track_mask(zf, x)
        cell = torch.tensor([[12, 12]], device=x.device)
        return {"score": out.score, "loc": out.loc,
                "refine logits": model.track_refine(out.skips, out.corr, cell)}
    if isinstance(model, SiamMaskBase):
        return dict(zip(("score", "loc", "mask head"), model.track_mask(zf, x)))
    return dict(zip(("score", "loc"), model.track(zf, x)))


def phase_cpu_parity(tracker, cpu_tracker, state: TrackState, frame: np.ndarray,
                     tag: str = "parity", bf16: bool = False) -> None:
    """The same step on the card and on the CPU, from the same state, open
    loop. Tolerances cover cuDNN's summation order against the CPU's over a
    ResNet-50 of random weights; with ``bf16``, the maps within BF16_MAP_TOL
    in relative L2 norm and the step at ``check_step_close``'s bf16
    tolerances (the size difference printed as a share of its side)."""
    cpu_state = TrackState(*(t.cpu() for t in state))

    with torch.inference_mode():
        x = subwindow_crop(torch.from_numpy(frame), cpu_state.target_pos[None],
                           torch.tensor([400.0]), 255, cpu_state.avg_chans[None])
        x = x.permute(0, 3, 1, 2).contiguous()
        refs = head_maps(cpu_tracker.model, cpu_state.zf, x)
        ours = head_maps(tracker.model, state.zf, x.cuda())
    # maps: relative floor, 1e-3 of the largest magnitude (fp32, TF32 off)
    for name, b in refs.items():
        a, b = ours[name].cpu().float(), b.float()
        if bf16:
            rel = ((a - b).norm() / b.norm()).item()
            if not rel <= BF16_MAP_TOL:
                raise AssertionError(f"[{tag}] {name}: relative L2 error {rel:.3e}")
            print(f"[{tag}] {name}: relative L2 error {rel:.3e} (tolerance {BF16_MAP_TOL:.0e})")
            continue
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3 * scale)
        print(f"[{tag}] {name}: max_abs_err {err:.3e} (atol {1e-3 * scale:.3e})")

    _, out = tracker.step(state, torch.from_numpy(frame).cuda())
    _, ref_out = cpu_tracker.step(cpu_state, frame)
    err = check_step_close(f"[{tag}] step, card vs CPU", out, ref_out, bf16)
    print(f"[{tag}] step: best_id {out.best_id.item()} on both; pos "
          f"{out.target_pos.cpu().tolist()} vs {ref_out.target_pos.tolist()}; score "
          f"{out.score.item():.6f} vs {ref_out.score.item():.6f}; mask max_abs_err {err:.3e}")


def bf16_size_shares(tracker, cpu_tracker, frames: np.ndarray, tag: str) -> None:
    """The bf16 step's size difference, card against the CPU, as a share of
    the size, over the first steps from init (``frames[0]`` inits, then one
    step a frame, each from the card's state after the one before), where
    the size grows from TARGET_SZ: the scale of BF16_SIZE_REL. Where both
    pick one cell the step is held to ``check_step_close``'s bf16
    tolerances; where they pick two, each side's cell and score are printed
    and no size is compared: the two sides' bf16 maps differ by rounding,
    and off the crop ``sharpen_cls_head`` set the score margin on, random
    weights leave cells close enough for it to move the argmax."""
    state = tracker.init(frames[0], TARGET_POS, TARGET_SZ)
    for i, frame in enumerate(frames[1:], 1):
        new_state, out = tracker.step(state, torch.from_numpy(frame).cuda())
        _, ref = cpu_tracker.step(TrackState(*(t.cpu() for t in state)), frame)
        if out.best_id.item() == ref.best_id.item():
            check_step_close(f"[{tag}] step {i} from init, card vs CPU", out, ref, bf16=True)
        else:
            print(f"[{tag}] step {i} from init: the card's best cell {out.best_id.item()} "
                  f"(score {out.score.item():.6f}), the CPU's {ref.best_id.item()} (score "
                  f"{ref.score.item():.6f}): other cells, no size compared")
        state = new_state


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


def stacked(outs: list):
    return type(outs[0])(*(torch.stack(v) for v in zip(*outs)))


def check_bit_identical(what: str, outs, ref, final: TrackState,
                        ref_final: TrackState) -> None:
    """A graph replay against the eager loop: the same kernels in the same
    order, so the same best_id at every frame and the same bits."""
    if not torch.equal(outs.best_id, ref.best_id):
        bad = (outs.best_id != ref.best_id).nonzero()[:, 0].tolist()
        raise AssertionError(f"{what}: best_id differs at frames {bad}")
    if type(outs) is not type(ref):
        raise AssertionError(f"{what}: {type(outs).__name__} vs {type(ref).__name__}")
    for name, a, b in (*zip(outs._fields, outs, ref),
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


def profile_call(fn, trace: str | None = None) -> tuple[list, float, float]:
    """One call under torch.profiler: (the averaged events, the device-busy
    ms summed over kernels and copies, the call's ms by CUDA events). With
    ``trace``, the profile is also exported as a Chrome trace for
    ``[trace]`` (``export_trace``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
    events = prof.key_averages()
    busy = device_busy_ms(events)
    if trace is not None:
        export_trace(trace, prof, busy)
    return events, busy, start.elapsed_time(end)


def device_busy_ms(events) -> float:
    """The device time of a profile's kernels, copies and memsets. A
    ``record_function`` span (the optimizer's ``Optimizer.step#SGD.step``)
    also shows as device time, over the kernels it encloses: left out."""
    return sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation) / 1e3


def export_trace(tag: str, prof, busy: float, xcorr: dict | None = None) -> None:
    """``prof``'s Chrome trace under TRACE_DIR for ``[trace]``, with the
    profile's device-busy ms and the xcorr kernels expected by row (set
    later by the caller when None)."""
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / f"{tag}.json"
    prof.export_chrome_trace(str(path))
    TRACES[tag] = {"path": path, "busy": busy, "xcorr": xcorr}


def check_graph_profile(what: str, call, frames: int, streams: int,
                        per_frame: int = 3) -> None:
    """Profiles one graph call, confirms ``per_frame`` xcorr kernels a
    frame by kernel name in its trace and prints device ms a frame, the idle
    share and the host's CUDA calls a frame. A trace has come back short of
    a few kernels (189 of 192 once on an H100, the replays all
    bit-identical to the eager loop): a short trace is taken once more
    before the check fails."""
    expected = per_frame * frames
    for attempt in (1, 2):
        events, busy, call_ms = profile_call(call, what if what in TRACED else None)
        xcorr = sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                    and "depthwise_xcorr" in e.key)
        if xcorr == expected:
            break
        if attempt == 2 or xcorr > expected:
            raise AssertionError(f"{what}: {xcorr} xcorr kernels in the trace of {frames} "
                                 f"frames, expected {expected}")
        print(f"[{what}] the profiler's trace held {xcorr} of {expected} xcorr kernels; "
              "profiling the call once more")
    host = {k: sum(e.count for e in events if e.key == k)
            for k in ("cudaGraphLaunch", "cudaMemcpyAsync", "cudaLaunchKernel")}
    idle = 100 * (1 - busy / call_ms)
    packed = sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                 and "depthwise_xcorr_strip_bf16x2_kernel" in e.key)
    MEASURED.setdefault(what, {}).update(
        device_ms_frame=busy / frames, idle=idle, xcorr=xcorr, xcorr_packed=packed)
    if what in TRACED:
        TRACES[what]["xcorr"] = {XCORR_ROWS[3]: packed, XCORR_ROWS[0]: xcorr - packed}
    print(f"[{what}] profiled call: {xcorr} xcorr kernels by name ({xcorr // frames} a frame); "
          f"device busy {busy:.3f} ms of {call_ms:.3f} ms, {busy / frames:.3f} ms a frame "
          f"({busy / (frames * streams):.3f} ms a stream-frame), idle share "
          f"{idle:.1f}%; host calls a frame: "
          + ", ".join(f"{k} {v / frames:.1f}" for k, v in host.items()))
    kernels = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    print(f"[{what}] profiled call, top 10 by self device time: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in kernels[:10]))


def phase_video(tracker: Tracker, frames: np.ndarray, smi: str,
                tag: str = "video") -> tuple[int, TrackState]:
    """track_video over VIDEO_T frames on the card: a CUDA-graph replay per
    frame, against the eager step loop; returns the xcorr launches of the
    graph path (captured launches times replays) and the final state."""
    t = VIDEO_T
    per_frame = xcorr_per_step(tracker)
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
    check_route(tag, tracker.model.dtype == BF16, graph)
    if counted[0] == 0 or counted[1:] != [0, 0] or graph.xcorr_launches != per_frame:
        raise AssertionError(f"{tag}: {counted} launches through the wrappers, "
                             f"{graph.xcorr_launches} xcorr kernels captured "
                             f"(expected {per_frame})")
    peak = torch.cuda.max_memory_allocated()
    check_bit_identical(tag, outs, eager, final, st)
    for i in range(t):
        check_output(type(outs)(*(v[i] for v in outs)), FRAME_HW, tracker.p.out_size)
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = tracker.track_video(state, dev[1:])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check_bit_identical(f"{tag}, second call", again[1], eager, again[0], st)
    print(f"[{tag}] track_video, T={t}, width 64, 480x854 uint8: a CUDA graph of the step "
          f"({graph.xcorr_launches} xcorr kernels captured; {counted[0]} xcorr launches "
          f"through the wrapper, warm-up and capture), {graph.xcorr_launches * t} xcorr "
          f"launches by replay; best_id and every output bit-identical to the eager step "
          f"loop; the second call ran under sync_debug_mode=error; peak memory "
          f"{peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held before the call)")
    event_ms, wall_ms = time_calls(lambda: tracker.track_video(state, dev[1:]))
    med = statistics.median(event_ms)
    MEASURED.setdefault(tag, {}).update(ms_frame=med / t, fps=t * 1e3 / med,
                                        peak_gib=peak / 2**30)
    print(f"[{tag}] {TIMED_CALLS} calls of T={t}: median {med:.3f} ms (CUDA events; min "
          f"{min(event_ms):.3f}, max {max(event_ms):.3f}), {med / t:.3f} ms a frame, "
          f"{t * 1e3 / med:.1f} frames/s; host clock to the end "
          f"{statistics.median(wall_ms):.3f} ms | {smi}")
    check_graph_profile(tag, lambda: tracker.track_video(state, dev[1:]),
                        t, 1, per_frame)
    return graph.xcorr_launches * t, final


def stream_state(states: TrackState, i: int) -> TrackState:
    return TrackState(states.target_pos[i], states.target_sz[i], states.zf[i:i + 1],
                      states.avg_chans[i], states.score[i])


def phase_streams(tracker: Tracker, frames: np.ndarray, smi: str, tag: str = "streams",
                  single: bool = True) -> tuple[int, TrackState]:
    """STREAMS objects on one video: init_batched, step_batched against the
    single-stream step of each stream (with ``single``), track_video_multi
    against the eager step_batched loop; returns the xcorr launches of the
    16-stream paths and the states after one step."""
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
    check_route(tag, tracker.model.dtype == BF16)
    if step_launches != [3, 0, 0]:
        raise AssertionError(f"step_batched: {step_launches} launches, expected [3, 0, 0]")
    if single:
        errs = []
        for i in range(o):
            _, one = tracker.step(stream_state(states, i), dev[1])
            errs.append(check_step_close(f"stream {i}", StepOutput(*(v[i] for v in out)), one))
            check_output(one, FRAME_HW)
        print(f"[{tag}] init_batched + step_batched at O={o}: 3 xcorr launches at B={o}; each "
              f"stream against the single-stream step: best_id equal, pos/sz within 1e-2 px, "
              f"largest mask error {max(errs):.3e}; best_id {out.best_id.tolist()}")
    else:
        for i in range(o):
            check_output(StepOutput(*(v[i] for v in out)), FRAME_HW)
        print(f"[{tag}] init_batched + step_batched at O={o}: 3 xcorr launches at B={o}; "
              f"outputs finite and in bounds; best_id {out.best_id.tolist()}")
    events, busy, call_ms = profile_call(lambda: tracker.step_batched(states, dev[1]))
    kernels = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.self_device_time_total, reverse=True)
    print(f"[{tag}] profiled eager step_batched at O={o}: device busy {busy:.3f} ms of "
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
    check_route(tag, tracker.model.dtype == BF16, graph)
    if counted[0] == 0 or counted[1:] != [0, 0] or graph.xcorr_launches != 3:
        raise AssertionError(f"{tag}: {counted} launches through the wrappers, "
                             f"{graph.xcorr_launches} xcorr kernels captured (expected 3)")
    check_bit_identical(tag, outs, eager, final, st)
    if outs.mask_in_frame.shape != (t, o, *FRAME_HW) or not torch.isfinite(outs.mask_in_frame).all():
        raise AssertionError(f"{tag}: masks {tuple(outs.mask_in_frame.shape)}")
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] track_video_multi, O={o}, T={t}: {graph.xcorr_launches * t} xcorr "
          f"launches by replay at B={o}; best_id and every output bit-identical to the eager "
          f"step_batched loop; peak memory {peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB "
          "held before the phase)")
    event_ms, wall_ms = time_calls(lambda: tracker.track_video_multi(states, dev[1:]))
    med = statistics.median(event_ms)
    MEASURED.setdefault(tag, {}).update(ms_frame=med / t, fps=o * t * 1e3 / med,
                                        peak_gib=peak / 2**30)
    print(f"[{tag}] {TIMED_CALLS} calls of O={o}, T={t}: median {med:.3f} ms (CUDA events; "
          f"min {min(event_ms):.3f}, max {max(event_ms):.3f}), {med / t:.3f} ms a frame, "
          f"{o * t * 1e3 / med:.1f} aggregate frames/s; host clock to the end "
          f"{statistics.median(wall_ms):.3f} ms | {smi}")
    check_graph_profile(tag, lambda: tracker.track_video_multi(states, dev[1:]), t, o)
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
                             frame: np.ndarray, tag: str = "streams-parity") -> None:
    """step_batched for two streams on the card and on the CPU, from the same
    state, open loop, at phase 6's tolerances."""
    two = TrackState(*(v[:2] for v in states))
    _, out = tracker.step_batched(two, torch.from_numpy(frame).cuda())
    _, ref = cpu_tracker.step_batched(TrackState(*(v.cpu() for v in two)), frame)
    err = check_step_close("step_batched, card vs CPU", out, ref)
    print(f"[{tag}] step_batched at O=2, card vs CPU: best_id {out.best_id.tolist()} "
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
    driver's object-frames/s. The video and the batched driver's fused PNGs
    stay under VOS_ROOT for ``[tune]`` and ``[eval]``. Returns its xcorr
    launches (through the wrapper and by replay). Needs cv2 and PIL, the
    drivers' image I/O."""
    try:
        import cv2  # noqa: F401
        import PIL  # noqa: F401
    except ImportError as e:
        print(f"[vos] skipped: the VOS drivers' image I/O is not installed ({e})")
        return 0
    root = VOS_ROOT
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
    check_route("vos", False, graph)
    if launches != [3 * VOS_RAGGED, 0, 0] or graph.xcorr_launches != 3:
        raise AssertionError(f"vos: {launches} launches through the wrappers (expected "
                             f"{[3 * VOS_RAGGED, 0, 0]}), {graph.xcorr_launches} captured")
    iou_b = np.asarray(iou_b)
    if iou_b.shape != (3, 4) or not np.all((iou_b >= 0) & (iou_b <= 1)):
        raise AssertionError(f"vos: IoU {iou_b}")
    MEASURED["vos"] = {"iou": iou_b}
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
    return 3 * VOS_RAGGED + graph.xcorr_launches * VOS_FULL


def phase_family(tag: str, cls, config: Path, mask: bool, refine: bool, smi: str):
    """Another model family through the port's tracker on the card, as the
    sharp phases 5, 6 and 8 drive SiamMask-sharp: init and STEPS steps (one
    under sync_debug_mode("error")), one step on the card against the CPU
    from the same state, ``track_video`` over VIDEO_T frames through the
    CUDA graph against the eager step loop, its frames/s, profile and peak
    memory; with the mask, ``step_batched`` at O=2 on the card against the
    CPU. Returns the model and the xcorr launches of the init-and-steps run
    and the graph's replays."""
    p = Config.load(str(config)).tracker_config()
    model, tracker, frames = build_model(p, cls, mask, refine)
    cpu_tracker = cpu_tracker_of(tracker)
    state, launches = phase_slice(tracker, frames, tag)
    phase_cpu_parity(tracker, cpu_tracker, state, frames[STEPS + 2], tag)
    video_launches, _ = phase_video(tracker, frames, smi, tag)
    if mask:
        rng = np.random.RandomState(SEED)
        states = tracker.init_batched(frames[0], rng.uniform(100, 400, (2, 2)).astype(np.float32),
                                      rng.uniform(60, 200, (2, 2)).astype(np.float32))
        phase_streams_cpu_parity(tracker, cpu_tracker, states, frames[2], f"{tag}-parity")
    return model, launches[0] + video_launches


def write_vot_dataset(root: Path) -> None:
    """Two VOT2018-layout videos under ``root`` (``list.txt``; per video
    VOT_FRAMES JPEG frames of 480x854 in ``color/`` and an 8-point
    ``groundtruth.txt``): a textured rectangle moving over blocky noise. In
    ``vid1`` the target and its gt jump VOT_DX px right at frame VOT_JUMP."""
    import cv2

    rng = np.random.RandomState(SEED + 2)
    h, w = FRAME_HW
    # (top-left x, y, width, height, drift x, y a frame, jump)
    videos = {"vid0": (150, 150, 110, 90, 3, 2, 0), "vid1": (120, 250, 100, 80, 2, -1, VOT_DX)}
    for name, (x0, y0, tw, th, vx, vy, jump) in videos.items():
        (root / name / "color").mkdir(parents=True)
        coarse = rng.randint(0, 256, size=(h // 8 + 1, w // 8 + 1, 3)).astype(np.uint8)
        background = np.repeat(np.repeat(coarse, 8, axis=0), 8, axis=1)[:h, :w]
        patch = rng.randint(0, 256, size=(th, tw, 3)).astype(np.uint8)
        gt = []
        for f in range(VOT_FRAMES):
            x = x0 + vx * f + (jump if f >= VOT_JUMP else 0)
            y = y0 + vy * f
            im = background.copy()
            im[y:y + th, x:x + tw] = patch
            cv2.imwrite(str(root / name / "color" / f"{f + 1:08d}.jpg"), im)
            gt.append([x, y, x + tw, y, x + tw, y + th, x, y + th])
        np.savetxt(root / name / "groundtruth.txt", np.array(gt, float), delimiter=",",
                   fmt="%.4f")
    (root / "list.txt").write_text("".join(f"{name}\n" for name in videos))


def check_vot_lines(what: str, lines: list[str], numbers: int, jumps: bool) -> int:
    """A VOT result file: 1 first; each 2 followed by the skipped 0s and the
    re-init 1; every other line a region of ``numbers`` numbers; in the
    jumping video the forced lost / skip / re-init at VOT_JUMP. Returns the
    frames the tracker stepped (the regions and the 2s)."""
    if len(lines) != VOT_FRAMES or lines[0] != "1":
        raise AssertionError(f"{what}: {len(lines)} lines, the first {lines[:1]}")
    i = 1
    while i < len(lines):
        if lines[i] == "2":
            tail = lines[i:i + len(VOT_FORCED)]
            if tail != VOT_FORCED[:len(tail)]:
                raise AssertionError(f"{what}: frames {i}-: {tail}")
            i += len(VOT_FORCED)
        elif len(lines[i].split(",")) != numbers:
            raise AssertionError(f"{what}: frame {i}: {lines[i]!r}")
        else:
            i += 1
    if jumps and lines[VOT_JUMP:VOT_JUMP + len(VOT_FORCED)] != VOT_FORCED:
        raise AssertionError(f"{what}: frames {VOT_JUMP}-: "
                             f"{lines[VOT_JUMP:VOT_JUMP + len(VOT_FORCED)]}")
    return sum(line not in ("0", "1") for line in lines)


def phase_vot(models: dict, smi: str) -> tuple[int, dict]:
    """The VOT driver on the card, through ``load_dataset`` as a user calls
    it: ``track_vot`` for sharp (mask and Refine, ``config_vot.json``), base
    (mask) and SiamRPN (box) on two videos written under ``build/``, the
    result files checked line by line; then the test CLI's ``main`` on the
    same data with the sharp weights saved as a ``.pth``. The box heads are
    damped first (``damp_box_head``), so that the target is still held when
    the forced jump comes; other losses can occur and are printed. The
    region library is built and loaded before the drivers' clocks start.
    The data, the result trees and the sharp ``.pth`` stay under VOT_ROOT for
    ``[tune]`` and ``[eval]``. Returns the xcorr launches, which the result
    files account for, and each tracker's lost count as its driver returned
    it (the CLI's as ``cli``)."""
    import cv2  # noqa: F401  (the driver reads frames with it; a missing cv2 fails here)

    from siammask_tpu_torch.tools import test as cli

    root = VOT_ROOT
    shutil.rmtree(root, ignore_errors=True)
    write_vot_dataset(root / "VOT2018")
    dataset = load_dataset("VOT2018", str(root))
    t0 = time.perf_counter()
    vot_overlap([0, 0, 4, 4], [1, 1, 4, 4])         # g++ builds the library at first use
    print(f"[vot] region library built and loaded in {time.perf_counter() - t0:.3f} s "
          f"(g++ -O2, host clock), before the drivers' clocks start")
    families = {"sharp": (VOT_CONFIG, True, True), "base": (BASE_CONFIG, True, False),
                "rpn": (RPN_CONFIG, False, False)}
    torch.cuda.synchronize()
    reset_launches()
    stepped, lost_by_tracker = {}, {}
    for name, (config, mask, refine) in families.items():
        damp_box_head(models[name])
        runtime = TrackerRuntime(models[name], Config.load(str(config)).tracker_config(),
                                 "cuda", mask=mask, refine=refine)
        lines, lost, speeds, stepped[name] = [], [], [], 0
        for video in dataset.values():
            n, fps = track_vot(runtime, video, mask_enable=mask,
                               result_dir=str(root / "results"), tracker_name=name,
                               log=lines.append)
            result = (root / "results" / "VOT2018" / name / "baseline" / video["name"]
                      / f"{video['name']}_001.txt").read_text().splitlines()
            stepped[name] += check_vot_lines(f"vot {name} {video['name']}", result,
                                             8 if mask else 4, video["name"] == "vid1")
            lost.append(n)
            speeds.append(fps)
        lost_by_tracker[name] = sum(lost)
        print(f"[vot] {name} ({'mask' if mask else 'box'}{', Refine' if refine else ''}): "
              f"lost {lost} in {list(dataset)}, the jump's 2 / {SKIP - 1} x 0 / 1 at frames "
              f"{VOT_JUMP}-{VOT_JUMP + SKIP}; driver's fps (file reads excluded) "
              + ", ".join(f"{v:.1f}" for v in speeds) + f" | {smi}")
    launches = read_launches()
    check_route("vot", False)
    gt = dataset["vid1"]["gt"][VOT_JUMP - 1]
    pred = gt + np.tile([7.5, -4.25], 4)
    t0 = time.perf_counter()
    for _ in range(2000):
        vot_overlap(gt, pred, FRAME_HW[::-1])
    print(f"[vot] region overlap (host C++, 8-point polygons, frame bounds): "
          f"{(time.perf_counter() - t0) / 2000 * 1e6:.2f} us a call, host clock over 2000 calls")
    expected = sum(k * stepped[n] for n, k in (("sharp", 3), ("base", 3), ("rpn", 2)))
    if launches != [expected, 0, 0]:
        raise AssertionError(f"vot: {launches} launches, expected {[expected, 0, 0]} from "
                             f"the stepped frames {stepped}")

    ckpt = root / SHARP_PTH
    torch.save({"state_dict": {f"module.{k}": v.cpu()
                               for k, v in models["sharp"].state_dict().items()}}, ckpt)
    t0 = time.perf_counter()
    totals = cli.main(["--config", str(VOT_CONFIG), "--resume", str(ckpt), "--mask", "--refine",
                       "--dataset", "VOT2018", "--data-dir", str(root),
                       "--result-dir", str(root / "cli"), "--tracker-name", "cli"])
    wall = time.perf_counter() - t0
    cli_launches = read_launches()[0] - expected
    worst = 0.0
    for name in dataset:
        ours, driver = ((root / sub / "VOT2018" / tracker / "baseline" / name / f"{name}_001.txt")
                        .read_text().splitlines()
                        for sub, tracker in (("cli", "cli"), ("results", "sharp")))
        # the same weights through a fresh model on the card: the same
        # markers, the same regions up to the conv algorithms' rounding
        for a, b in zip(ours, driver):
            if (a in ("0", "1", "2") or b in ("0", "1", "2")) and a != b:
                raise AssertionError(f"vot: the CLI's {name} markers differ from the driver's")
            if a not in ("0", "1", "2"):
                worst = max(worst, float(np.abs(np.array(a.split(","), float)
                                                - np.array(b.split(","), float)).max()))
        if len(ours) != len(driver) or worst > 1e-2:
            raise AssertionError(f"vot: the CLI's {name} result differs from the driver's "
                                 f"({len(ours)} lines, largest region difference {worst})")
    if totals["videos"] != 2 or cli_launches != 3 * stepped["sharp"]:
        raise AssertionError(f"vot: CLI totals {totals}, {cli_launches} launches")
    print(f"[vot] CLI main --mask --refine --resume sharp.pth: totals {totals}; the driver's "
          f"markers, regions within {worst:.4f} px; {cli_launches} xcorr launches; "
          f"{wall:.2f} s for the call")
    lost_by_tracker["cli"] = totals["lost"]
    return expected + cli_launches, lost_by_tracker


def tune_cells(out: dict, what: str) -> str:
    """One line per scored cell of a ``tune.main`` return."""
    return "; ".join(f"{c['tag']} {what} {c['score']:.6f} ({c['seconds']:.2f} s, "
                     f"{c['fps']:.1f} fps)" for c in out["cells"])


def phase_tune(smi: str) -> tuple[int, dict]:
    """``tools.tune.main`` on the card with [vot]'s sharp weights: the VOT
    grid over [vot]'s two videos (TUNE_VOT at 255, then one cell at 271,
    EAO over frames 1..VOT_FRAMES), the VOS grid over [vos]'s video
    (TUNE_VOS, seg_thr 0.3 and 0.4), and the VOT grid again, which finds
    every cell claimed. Checks the scores finite, the xcorr launches against
    the frames stepped (the VOS windows are shorter than the driver's
    32-frame chunk, so every step goes through ``step_batched`` and its
    wrapper) and that no cell's runtime outlives it on the card. Returns
    the launches and {tag: score} of the VOT cells."""
    from siammask_tpu_torch.tools import tune

    ckpt = str(VOT_ROOT / SHARP_PTH)
    vot = ["--config", str(VOT_CONFIG), "--resume", ckpt, "--dataset", "VOT2018",
           "--data-dir", str(VOT_ROOT), "--out-dir", str(TUNE_ROOT / "vot"),
           "--eao-interval", f"1,{VOT_FRAMES}"]
    vos = ["--config", str(CONFIG), "--resume", ckpt, "--dataset", "ytb_vos",
           "--data-dir", str(VOS_ROOT), "--out-dir", str(TUNE_ROOT / "vos"), *TUNE_VOS]
    shutil.rmtree(TUNE_ROOT, ignore_errors=True)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    runs = {"vot": tune.main([*vot, *TUNE_VOT]), "vot271": tune.main([*vot, *TUNE_WIDE]),
            "vos": tune.main(vos)}
    wall = time.perf_counter() - t0
    launches = read_launches()
    check_route("tune", False)
    again = tune.main([*vot, *TUNE_VOT])
    cells = [c for run in runs.values() for c in run["cells"]]
    scored = [run["scored"] for run in runs.values()]
    if scored != [4, 1, 2] or again["scored"] != 0:
        raise AssertionError(f"tune: {scored} cells scored, {again['scored']} on the re-run")
    if not all(math.isfinite(c["score"]) for c in cells):
        raise AssertionError(f"tune: scores {[c['score'] for c in cells]}")
    stepped = 0
    for c in runs["vot"]["cells"] + runs["vot271"]["cells"]:
        for name in ("vid0", "vid1"):
            path = (TUNE_ROOT / "vot" / "results" / "VOT2018" / c["tag"] / "baseline" / name
                    / f"{name}_001.txt")
            stepped += check_vot_lines(f"tune {c['tag']} {name}",
                                       path.read_text().splitlines(), 8, False)
    expected = 3 * stepped + 3 * (VOS_FRAMES - 1) * len(runs["vos"]["cells"])
    if launches != [expected, 0, 0]:
        raise AssertionError(f"tune: {launches} launches, expected {[expected, 0, 0]}")
    first, last = cells[0], cells[-1]
    growth = last["allocated_bytes"] - first["allocated_bytes"]
    if growth > TUNE_MEMORY_SLACK:
        raise AssertionError(f"tune: {growth} bytes more allocated after the last cell than "
                             "after the first")
    print(f"[tune] VOT grid ({VOT_CONFIG.name}, [vot]'s 2 x {VOT_FRAMES} frames 480x854, "
          f"EAO over frames 1-{VOT_FRAMES}): {scored[0]} cells at 255 and {scored[1]} at 271 "
          f"scored: {tune_cells(runs['vot'], 'EAO')}; {tune_cells(runs['vot271'], 'EAO')}")
    print(f"[tune] VOS grid ({CONFIG.name}, [vos]'s {VOS_FRAMES} frames, 3 objects, "
          f"track_vos_batched): {scored[2]} cells scored: {tune_cells(runs['vos'], 'mean IoU')}")
    best = {k: max(cs, key=lambda c: c["score"]) for k, cs in
            (("VOT", runs["vot"]["cells"] + runs["vot271"]["cells"]),
             ("VOS", runs["vos"]["cells"]))}
    print("[tune] chosen: " + "; ".join(f"{k} {c['tag']} ({c['score']:.6f})"
                                       for k, c in best.items())
          + f"; the VOT grid again over the same out-dir: {again['scored']} cells scored "
          f"(all claimed); {wall:.2f} s for the three calls (model loads included)")
    print(f"[tune] xcorr launches: depthwise_xcorr {launches[0]} (3 x {stepped} VOT frames "
          f"stepped + 3 x {VOS_FRAMES - 1} x {scored[2]} VOS steps), "
          f"depthwise_xcorr_grad_input {launches[1]}, depthwise_xcorr_grad_kernel "
          f"{launches[2]}")
    print(f"[tune] memory: peak {first['peak_bytes'] / 2**20:.1f} MiB in the first cell, "
          f"{last['peak_bytes'] / 2**20:.1f} MiB in the last; allocated after them "
          f"{first['allocated_bytes'] / 2**20:.1f} / {last['allocated_bytes'] / 2**20:.1f} MiB "
          f"(growth {growth} bytes) | {smi}")
    return launches[0], {c["tag"]: c["score"] for c in runs["vot"]["cells"] + runs["vot271"]["cells"]}


def phase_eval(tune_scores: dict, lost_by_tracker: dict) -> None:
    """``tools.eval.main`` (process-pool fan-out, no card) over three trees:
    [tune]'s VOT cells, whose EAO must be the score ``tune`` recorded, to
    the last digit; [vot]'s and its CLI's trees, whose lost numbers must be
    the drivers'; [vos]'s fused PNGs beside a copy of the annotations, J and
    F in [0, 1] and the copy at J = F = 1. Removes the three trees."""
    from siammask_tpu_torch.tools import eval as eval_cli

    eao = ["--eao-interval", f"1,{VOT_FRAMES}"]
    trees = {"tune": ["--dataset", "VOT2018", "--dataset-dir", str(VOT_ROOT),
                      "--result-dir", str(TUNE_ROOT / "vot" / "results"), *eao],
             "vot": ["--dataset", "VOT2018", "--dataset-dir", str(VOT_ROOT),
                     "--result-dir", str(VOT_ROOT / "results"), *eao],
             "vot-cli": ["--dataset", "VOT2018", "--dataset-dir", str(VOT_ROOT),
                         "--result-dir", str(VOT_ROOT / "cli"), *eao],
             "vos": ["--dataset", "ytb_vos", "--dataset-dir", str(VOS_ROOT),
                     "--result-dir", str(VOS_ROOT / "results")]}
    gt = VOS_ROOT / "results" / "ytb_vos" / "gt" / "vid"
    shutil.copytree(VOS_ROOT / "ytb_vos" / "valid" / "Annotations" / "vid", gt)
    summaries, walls = {}, {}
    for name, args in trees.items():
        t0 = time.perf_counter()
        summaries[name] = eval_cli.main(args)
        walls[name] = time.perf_counter() - t0
    eaos = {tag: s["eao"] for tag, s in summaries["tune"].items()}
    if eaos != tune_scores:
        raise AssertionError(f"eval: EAO {eaos} against tune's {tune_scores}")
    lost = {t: s["lost_number"] for tree in ("vot", "vot-cli") for t, s in summaries[tree].items()}
    if lost != lost_by_tracker:
        raise AssertionError(f"eval: lost numbers {lost} against the drivers' {lost_by_tracker}")
    vos = summaries["vos"]
    jf = [vos["SiamMask"][k] for k in ("J_seen", "F_seen")]
    if not all(0 <= v <= 1 for v in jf) or vos["gt"]["J_seen"] != 1 or vos["gt"]["F_seen"] != 1:
        raise AssertionError(f"eval: ytb_vos summary {vos}")
    print(f"[eval] VOT, [tune]'s tree: EAO of the {len(eaos)} cells equal to tune's scores "
          f"(best {max(eaos.values()):.6f}); [vot]'s trees: lost numbers {lost} equal to the "
          f"drivers'; ytb_vos: SiamMask J {jf[0]:.4f} F {jf[1]:.4f}, the annotations against "
          "themselves J = F = 1")
    print("[eval] CLI wall s a tree (host clock, spawned pool included): "
          + ", ".join(f"{k} {v:.2f}" for k, v in walls.items()))
    for root in (TUNE_ROOT, VOT_ROOT, VOS_ROOT):
        shutil.rmtree(root, ignore_errors=True)


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
    settings = TrainSettings(task="base", loss_weight=cfg.loss_weight, mask_pad=32)
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
    check_route("train", False)
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


def loaded_model(cls, state: dict, device, dtype: torch.dtype | None = None):
    model = cls(width=TRAIN_WIDTH, dtype=dtype)
    model.load_state_dict(state)
    return model.to(device)


def phase_train_parity(make_trainer, init_state: dict, batch: dict,
                       tag: str = "train-parity") -> None:
    """One frozen-phase step from the same weights and batch (B=2) on the
    card and on the CPU, open loop; ``make_trainer(device)`` builds the
    trainer on ``init_state``. Tolerances cover cuDNN's summation order
    against the CPU's (TF32 off): metrics 1e-4 relative; momentum buffers
    (the clipped, decayed gradients) 1e-3 of each tensor's largest entry plus
    1e-5 of the step's, for the tensors whose exact gradient is 0 (the neck's
    BN bias); parameters the same of their update plus two ulps."""
    small = {k: v[:2] for k, v in batch.items()}
    runs = {}
    for device in (DEV, "cpu"):
        trainer = make_trainer(device)
        model = trainer.model
        metrics = trainer.step({k: v.to(device) for k, v in small.items()}, 0)
        runs[device] = ({k: v.item() for k, v in metrics.items()},
                        {n: p.detach().cpu() for n, p in model.named_parameters()},
                        _momentum(trainer), trainer.labels)
    (m_gpu, p_gpu, b_gpu, labels), (m_cpu, p_cpu, b_cpu, _) = runs[DEV], runs["cpu"]
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
    print(f"[{tag}] B=2 frozen step, card vs CPU: total loss {m_gpu['total_loss']:.6f} "
          f"vs {m_cpu['total_loss']:.6f}; largest momentum error {worst[0]:.3e} of its "
          f"tensor's largest entry ({worst[1]}); parameters within tolerance")


def _step_error(ours: dict, ref: dict) -> float:
    """A step's relative error over all its tensors,
    sqrt(sum |ours - ref|^2 / sum |ref|^2), in float64."""
    err = sum(((ours[n].double() - ref[n].double()) ** 2).sum().item() for n in ref)
    return math.sqrt(err / sum((ref[n].double() ** 2).sum().item() for n in ref))


def phase_refine_parity(make_trainer, init_state: dict, batch: dict, tag: str) -> None:
    """One B=2 stage-2 step from the same weights and batch on the card
    (float32) and on the CPU in float32 and in float64. Stage 2's mask corr
    normalises 50 values a channel in train-mode BN at B=2 (its 5x5
    template map), which leaves float32 rounding of ~1% of a tensor in some
    gradients (0.9% in one H100 run, more than ``phase_train_parity``'s
    1e-3): so both float32 steps are held to the float64 one. The card's
    whole-step error in momentum and in parameter updates is at most 10
    times the CPU float32 step's own, or 1e-2 where that is larger (cuDNN's
    FFT and Winograd convs round more than the CPU's direct ones; a wrong
    kernel is off by O(1)). Metrics within 1e-4 of the CPU float32 step's;
    frozen entries exact."""
    small = {k: v[:2] for k, v in batch.items()}
    runs = {}
    for name, device, dtype in ((DEV, DEV, torch.float32), ("cpu", "cpu", torch.float32),
                                ("cpu64", "cpu", torch.float64)):
        trainer = make_trainer(device)
        trainer.model.to(dtype)
        data = {k: v.to(device, dtype) if v.is_floating_point() else v.to(device)
                for k, v in small.items()}
        metrics = trainer.step(data, 0)
        runs[name] = ({k: v.item() for k, v in metrics.items()},
                      {n: p.detach().cpu() for n, p in trainer.model.named_parameters()},
                      _momentum(trainer), trainer.labels)
    (m_gpu, p_gpu, b_gpu, labels), (m_cpu, p_cpu, b_cpu, _) = runs[DEV], runs["cpu"]
    p_64, b_64 = runs["cpu64"][1], runs["cpu64"][2]
    for k in m_cpu:
        if not math.isclose(m_gpu[k], m_cpu[k], rel_tol=1e-4, abs_tol=1e-6):
            raise AssertionError(f"[{tag}] metric {k}: card {m_gpu[k]} vs CPU {m_cpu[k]}")
    trained = [n for n, label in labels.items() if label != "frozen"]
    for n, label in labels.items():
        if label == "frozen" and not torch.equal(p_gpu[n], init_state[n]):
            raise AssertionError(f"[{tag}] frozen {n} moved")
    update = lambda params: {n: params[n].double() - init_state[n].double() for n in trained}
    errors = {what: (_step_error(ours, ref), _step_error(cpu, ref)) for what, ours, cpu, ref in
              (("momentum", b_gpu, b_cpu, b_64),
               ("updates", update(p_gpu), update(p_cpu), update(p_64)))}
    for what, (card, cpu) in errors.items():
        if not card <= max(10 * cpu, 1e-2):
            raise AssertionError(f"[{tag}] {what}: the card's float32 step is {card:.3e} off "
                                 f"the float64 step, the CPU's float32 step {cpu:.3e}")
    print(f"[{tag}] B=2 step, card vs CPU: total loss {m_gpu['total_loss']:.6f} vs "
          f"{m_cpu['total_loss']:.6f}; whole-step error against the CPU's float64 step: "
          + "; ".join(f"{what} card {card:.3e}, CPU float32 {cpu:.3e}"
                      for what, (card, cpu) in errors.items()))


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
        device_ms = device_busy_ms(events)
        if epoch == 0:
            export_trace("train-frozen", prof, device_ms, dict.fromkeys(XCORR_ROWS[:3], 3))
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


def phase_train_timing(trainer: Trainer, batch: dict, smi: str, tag: str = "train-timing",
                       phases=((0, "frozen"), (1, "unfrozen")), mode: str = "fp32") -> None:
    """ms/step and samples/s of each phase (median of 10 warm steps by CUDA
    events), and the peak memory of those steps."""
    for epoch, label in phases:
        for _ in range(3):
            trainer.step(batch, epoch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(10):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            trainer.step(batch, epoch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        med = statistics.median(times)
        b = batch["template"].shape[0]
        MEASURED.setdefault(tag, {})[label] = (med, torch.cuda.max_memory_allocated() / 2**30)
        print(f"[{tag}] {label} step, B={b}, width {TRAIN_WIDTH}, {mode}, TF32 off: "
              f"median {med:.2f} ms (CUDA events, 10 warm steps; min {min(times):.2f}, "
              f"max {max(times):.2f}); {b * 1e3 / med:.1f} samples/s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {smi}")


HEAD = "mask_model.mask.head."
REFINE_FROZEN = ("features.", "rpn_model.")


def write_crop_dataset(root: Path, videos: int = 8, tracks: int = 2, frames: int = 4,
                       seed: int = SEED) -> tuple[str, str]:
    """A synthetic crop511 training set in the COCO layout the training
    configs read: ``{video}/{frame:06d}.{track:02d}.x.jpg`` (blocky noise
    with a textured target near the centre), its ``.m.png`` mask and a
    ``train.json`` of corner boxes. Returns (root, anno path)."""
    import cv2

    rng = np.random.RandomState(seed)
    anno = {}
    for v in range(videos):
        video = root / f"video_{v}"
        video.mkdir(parents=True)
        anno[video.name] = {}
        for t in range(tracks):
            boxes = {}
            for f in range(frames):
                coarse = rng.randint(0, 256, size=(65, 65, 3)).astype(np.uint8)
                img = np.repeat(np.repeat(coarse, 8, axis=0), 8, axis=1)[:511, :511].copy()
                w, h = (int(x) for x in rng.randint(90, 200, size=2))
                x0 = int(255 - w // 2 + rng.randint(-12, 13))
                y0 = int(255 - h // 2 + rng.randint(-12, 13))
                img[y0:y0 + h, x0:x0 + w] = rng.randint(0, 256, size=(h, w, 3))
                mask = np.zeros((511, 511), np.uint8)
                mask[y0:y0 + h, x0:x0 + w] = 255
                cv2.imwrite(str(video / f"{f:06d}.{t:02d}.x.jpg"), img)
                cv2.imwrite(str(video / f"{f:06d}.{t:02d}.m.png"), mask)
                boxes[f"{f:06d}"] = [x0, y0, x0 + w - 1, y0 + h - 1]
            anno[video.name][f"{t:02d}"] = boxes
    (root / "train.json").write_text(json.dumps(anno))
    return str(root), str(root / "train.json")


def train_data_config(config: Path, root: str, anno: str, num: int) -> dict:
    """An experiment config (JSON dict) with the synthetic set as its only
    training source, ``num`` pairs an epoch."""
    raw = json.loads(config.read_text())
    raw["train_datasets"]["datasets"] = {"coco": {"root": root, "anno": anno,
                                                  "frame_range": 2}}
    raw["train_datasets"]["num"] = num
    return raw


def phase_data(configs: dict) -> dict:
    """``PairDataset(seed)`` through ``DataLoader``, 8 batches of
    TRAIN_BATCH for each config, with thread and with process workers:
    samples/s of each and the host's cores; the two modes give the same
    batches bit for bit. Returns the thread run's first 4 batches of each
    config."""
    workers = min(16, os.cpu_count() or 1)
    kept = {}
    for name, raw in configs.items():
        cfg = Config.from_dict(raw)
        runs = {}
        for mode in ("thread", "process"):
            dataset = PairDataset(cfg.train_datasets, cfg.anchors, seed=SEED)
            loader = DataLoader(dataset, TRAIN_BATCH, num_workers=workers, workers_mode=mode)
            t0 = time.perf_counter()
            runs[mode] = list(loader)
            dt = time.perf_counter() - t0
            n = sum(len(b["template"]) for b in runs[mode])
            print(f"[data] {name} ({cfg.train_datasets['search_size']}^2 search): {len(runs[mode])} "
                  f"batches of {TRAIN_BATCH} through DataLoader, {workers} {mode} workers: "
                  f"{dt:.2f} s, {n / dt:.1f} samples/s")
        search = cfg.train_datasets["search_size"]
        for a, b in zip(runs["thread"], runs["process"]):
            if a.keys() != b.keys() or not all(np.array_equal(a[k], b[k]) for k in a):
                raise AssertionError(f"[data] {name}: thread and process batches differ")
            if a["search"].shape != (TRAIN_BATCH, search, search, 3):
                raise AssertionError(f"[data] {name}: search {a['search'].shape}")
        positives = sum(int((b["label_mask_weight"].reshape(TRAIN_BATCH, -1).max(1) > 0).sum())
                        for b in runs["thread"])
        print(f"[data] {name}: thread and process batches bit-identical; "
              f"{positives} of {len(runs['thread']) * TRAIN_BATCH} pairs with mask positives")
        kept[name] = runs["thread"][:4]
    print(f"[data] host: {os.cpu_count()} cores (os.cpu_count)")
    return kept


def task_trainer(raw: dict, task: str, model) -> Trainer:
    """A ``Trainer`` of ``task`` over ``model`` with the recipe of the
    config ``raw``, TRAIN_EPOCHS epochs, unfreezing at half of them."""
    cfg = Config.from_dict(raw, clip=10.0)
    settings = TrainSettings.for_search(task, cfg.loss_weight,
                                        cfg.train_datasets["search_size"])
    opt_cfg = OptimizerConfig.from_lr_cfg(cfg.lr, clip=10.0, clip_cfg=cfg.clip)
    return Trainer(model, settings, opt_cfg, build_lr_spaces(cfg.lr, TRAIN_EPOCHS),
                   epochs=TRAIN_EPOCHS, unfreeze_at=0.5)


def run_train_steps(tag: str, trainer: Trainer, batches, epochs, per_step: list[int],
                    groups, frozen, on_step=None) -> list[int]:
    """One step a batch at ``epochs``, each checked: finite metrics and no
    skip, ``per_step`` (forward, grad-input, grad-kernel) launches, the
    entries under ``frozen(epoch)`` (parameters and BN buffers)
    bit-identical to their values before the first step, and every
    trainable group of ``groups(epoch)`` moved. Returns the launches."""
    model = trainer.model
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    reset_launches()
    for step, (batch, epoch) in enumerate(zip(batches, epochs)):
        counts = read_launches()
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        bufs = {n: trainer.optimizer.state[p]["momentum_buffer"].clone()
                for n, p in model.named_parameters() if p in trainer.optimizer.state}
        metrics = {k: v.item() for k, v in trainer.step(batch, epoch).items()}
        counts = [a - b for a, b in zip(read_launches(), counts)]
        if not all(math.isfinite(v) for v in metrics.values()) or metrics["skipped"] != 0:
            raise AssertionError(f"[{tag}] step {step}: {metrics}")
        if counts != per_step:
            raise AssertionError(f"[{tag}] step {step}: {counts} forward/grad-input/"
                                 f"grad-kernel launches, expected {per_step}")
        now = model.state_dict()
        held = [k for k in start if k.startswith(frozen(epoch))]
        if not held or not all(torch.equal(now[k], start[k]) for k in held):
            raise AssertionError(f"[{tag}] step {step}: a frozen entry changed")
        moved = {}
        for name, p in model.named_parameters():
            label = trainer.labels[name]
            if label != "frozen":
                moved.setdefault(label, []).append(not torch.equal(p, before[name]))
        if set(moved) != groups(epoch) or not all(any(v) for v in moved.values()):
            raise AssertionError(f"[{tag}] step {step}: trainable groups moved: {moved}")
        if on_step is not None:
            on_step(before, bufs)
        print(f"[{tag}] step {step} epoch {epoch}: "
              + " ".join(f"{k} {v:.4f}" for k, v in metrics.items() if k != "skipped")
              + f"; launches {counts}; {len(held)} frozen entries bit-identical; tensors "
              "moved " + ", ".join(f"{k} {sum(v)}/{len(v)}" for k, v in sorted(moved.items())))
    check_route(tag, False)
    return read_launches()


def check_head_decay(trainer: Trainer, before: dict, bufs: dict) -> None:
    """The mask corr's 1x1 head, which sharp's training graph never calls:
    zero gradient, momentum ``0.9 m + wd w`` and ``w - lr m``, so it moves by
    weight decay alone, as the JAX package's optax chain moves it."""
    opt = trainer.optimizer
    group = next(g for g in opt.param_groups if g["name"] == "mask")
    for name, p in trainer.model.named_parameters():
        if not name.startswith(HEAD):
            continue
        if p.grad is None or torch.count_nonzero(p.grad):
            raise AssertionError(f"{name}: the loss reached the unused head")
        buf = opt.state[p]["momentum_buffer"]
        expected = group["weight_decay"] * before[name]
        if name in bufs:
            expected = expected + group["momentum"] * bufs[name]
        torch.testing.assert_close(buf, expected, rtol=1e-5, atol=1e-12)
        torch.testing.assert_close(p.detach(), before[name] - group["lr"] * buf,
                                   rtol=1e-6, atol=1e-12)
        if before[name].any() and torch.equal(p, before[name]):
            raise AssertionError(f"{name} did not decay")


def loss_falls(tag: str, trainer: Trainer, batch: dict, epoch: int) -> None:
    """8 steps on one batch: the mean loss of the last four is below the
    first. Stage 2's loss swings by ~10% from step to step under momentum
    (14.17 12.70 13.67 14.95 14.74 13.22 12.05 12.66 on an H100), so one
    step against one would be a coin toss near the end."""
    losses = [trainer.step(batch, epoch)["total_loss"].item() for _ in range(8)]
    if not statistics.mean(losses[4:]) < losses[0]:
        raise AssertionError(f"[{tag}] the loss did not fall on a repeated batch: {losses}")
    print(f"[{tag}] repeated batch, 8 steps: total loss " + " ".join(f"{v:.4f}" for v in losses))


def train_profile(tag: str, trainer: Trainer, batch: dict, epoch: int, label: str,
                  launches: int) -> None:
    """One profiled step: device busy against the step's CUDA-event time
    (the idle share), the xcorr kernels by name (``launches`` of them) and
    the top 10 device ops."""
    trainer.step(batch, epoch)
    for attempt in (1, 2):   # a short trace is taken once more (check_graph_profile)
        events, busy, call_ms = profile_call(lambda: trainer.step(batch, epoch))
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        xcorr = {e.key.split("::")[-1].split("(")[0]: e.count for e in kernels
                 if "depthwise_xcorr" in e.key}
        if sum(xcorr.values()) == launches:
            break
        if attempt == 2 or sum(xcorr.values()) > launches:
            raise AssertionError(f"[{tag}] {xcorr} xcorr kernels in the trace, "
                                 f"expected {launches}")
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    print(f"[{tag}] profiled {label} step: device busy {busy:.2f} ms of {call_ms:.2f} ms, idle "
          f"share {100 * (1 - busy / call_ms):.1f}%; xcorr kernels by name {xcorr}; top 10: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.2f} ms x{e.count}"
                      for e in top))


def phase_train_refine(base_trainer: Trainer, raw: dict, batches: list,
                       smi: str) -> tuple[list[int], dict, dict]:
    """Stage 2 of the two-stage recipe at TRAIN_BATCH, warm-started from a
    stage-1 checkpoint of ``base_trainer``: 4 steps on loader batches
    through ``to_device`` (3 / 1 / 1 launches a step, backbone, neck and RPN
    bit-identical, the unused head decaying), the loss over 8 repeated
    steps, card vs CPU at B=2, a profile, ms/step and peak memory. Returns
    the launches, the warm-started weights and the first loader batch on
    the card."""
    path = str(SMOKE_TRAIN / "stage1.pth")
    save_checkpoint(path, base_trainer.model.state_dict(), base_trainer.optimizer.state_dict(),
                    epoch=TRAIN_EPOCHS, arch="SiamMaskBase",
                    anchor_cfg=Config.from_dict(raw).anchors.to_dict())
    model = SiamMaskSharp(width=TRAIN_WIDTH).init_weights(torch.Generator().manual_seed(SEED + 1))
    missing, unused = merge_state_dict(model, read_state_dict(path))
    refine = sorted(k for k in model.state_dict() if k.startswith("refine_model."))
    if sorted(missing) != refine or unused:
        raise AssertionError(f"[train-refine] warm start: missing {missing}, unused {unused}")
    print(f"[train-refine] warm start from a stage-1 checkpoint: {len(missing)} entries kept at "
          f"init, all refine_model.*; none unused")
    init_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trainer = task_trainer(raw, "sharp_refine", model.to(DEV))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = run_train_steps(
        "train-refine", trainer, to_device(iter(batches), DEV), (0, 0, 1, 1), [3, 1, 1],
        lambda epoch: {"mask", "refine"}, lambda epoch: REFINE_FROZEN,
        on_step=lambda before, bufs: check_head_decay(trainer, before, bufs))
    print(f"[train-refine] 4 steps at B={TRAIN_BATCH}, 143^2 search, 3x3 grid: launches "
          f"{launches}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; the "
          "mask head decayed by weight decay alone at every step")
    batch = next(to_device(iter(batches[:1]), DEV))
    loss_falls("train-refine", trainer, batch, 1)
    phase_refine_parity(lambda device: task_trainer(
        raw, "sharp_refine", loaded_model(SiamMaskSharp, init_state, device)),
        init_state, batch, "train-refine-parity")
    train_profile("train-refine", trainer, batch, 1, "stage-2", 5)
    phase_train_timing(trainer, batch, smi, "train-refine-timing", ((1, "stage-2"),))
    return launches, init_state, batch


def phase_train_rpn(raw: dict, batches: list, smi: str) -> tuple[list[int], dict, dict]:
    """SiamRPN at TRAIN_BATCH, 255^2 search: two frozen and two unfrozen
    steps on loader batches (2 / 2 / 2 launches a step), card vs CPU at
    B=2, a profile and ms/step per phase. Returns the launches, the
    initial weights and the first loader batch on the card."""
    model = SiamRPN(width=TRAIN_WIDTH).init_weights(torch.Generator().manual_seed(SEED + 2))
    dev_batches = list(to_device(iter(batches), DEV))
    model = model.to(DEV).eval()
    with torch.inference_mode(), bn_calibration(model):
        model.forward_train(dev_batches[0]["template"][:1], dev_batches[0]["search"][:1])
    init_state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    trainer = task_trainer(raw, "siamrpn", model)
    launches = run_train_steps(
        "train-rpn", trainer, dev_batches, (0, 0, 1, 1), [2, 2, 2],
        lambda epoch: {"neck", "rpn"} | ({"resnet"} if epoch else set()),
        lambda epoch: FROZEN_ALWAYS if epoch else FROZEN_ALWAYS + LAYER2)
    print(f"[train-rpn] 4 steps at B={TRAIN_BATCH} (2 frozen, 2 unfrozen): launches {launches}")
    phase_train_parity(lambda device: task_trainer(
        raw, "siamrpn", loaded_model(SiamRPN, init_state, device)),
        init_state, dev_batches[0], "train-rpn-parity")
    for epoch, label in ((0, "frozen"), (1, "unfrozen")):
        train_profile("train-rpn", trainer, dev_batches[0], epoch, label, 6)
    phase_train_timing(trainer, dev_batches[0], smi, "train-rpn-timing")
    return launches, init_state, dev_batches[0]


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms and PyTorch's deterministic kernels
    while open (warning where an op has none)."""
    flags = torch.backends.cudnn.deterministic, torch.are_deterministic_algorithms_enabled()
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = flags[0]
        torch.use_deterministic_algorithms(flags[1])


def phase_train_resume(raw: dict, init_state: dict, batches: list) -> None:
    """SiamRPN at TRAIN_BATCH: k=2 steps, a checkpoint, ``Trainer.restore``
    into a fresh trainer and model, then step k+1 on both, which must give
    the same bits, weights, BN statistics and momentum; then the same across
    the unfreeze boundary (saved after epoch 0, resumed at epoch 1), where
    the restore warns and momentum restarts on both sides. Deterministic
    cuDNN algorithms while it runs."""
    dev_batches = list(to_device(iter(batches), DEV))

    def snapshot(trainer):
        names = {p: n for n, p in trainer.model.named_parameters()}
        return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
                {names[p]: s["momentum_buffer"].clone()
                 for p, s in trainer.optimizer.state.items()})

    with deterministic():
        for boundary in (False, True):
            resume_epoch = 1 if boundary else 0
            straight = task_trainer(raw, "siamrpn",
                                     loaded_model(SiamRPN, init_state, DEV))
            for batch in dev_batches[:2]:
                straight.step(batch, 0)
            path = str(SMOKE_TRAIN / f"resume_{resume_epoch}.pth")
            save_checkpoint(path, straight.model.state_dict(), straight.optimizer.state_dict(),
                            epoch=resume_epoch)
            straight.step(dev_batches[2], resume_epoch)
            fresh = SiamRPN(width=TRAIN_WIDTH).init_weights(
                torch.Generator().manual_seed(SEED + 9)).to(DEV)
            resumed = task_trainer(raw, "siamrpn", fresh)
            with _captured_warnings() as warnings:
                if resumed.restore(path) != resume_epoch:
                    raise AssertionError("[train-resume] restore returned another epoch")
            if bool(warnings) != boundary or (len(resumed.optimizer.state) == 0) != boundary:
                raise AssertionError(f"[train-resume] boundary {boundary}: warnings "
                                     f"{warnings}, {len(resumed.optimizer.state)} momenta")
            resumed.step(dev_batches[2], resume_epoch)
            (s_a, m_a), (s_b, m_b) = snapshot(straight), snapshot(resumed)
            if s_a.keys() != s_b.keys() or m_a.keys() != m_b.keys():
                raise AssertionError("[train-resume] the two runs hold other entries")
            differ = [k for k in s_a if not torch.equal(s_a[k], s_b[k])]
            differ += [k for k in m_a if not torch.equal(m_a[k], m_b[k])]
            if differ:
                raise AssertionError(f"[train-resume] step 3 differs: {differ[:5]}")
            print(f"[train-resume] {'across the unfreeze boundary' if boundary else 'in phase'}"
                  f": 2 steps, checkpoint (epoch {resume_epoch}), restore into a fresh trainer"
                  f"{' (warned: momentum restarts)' if boundary else ''}, step 3 at epoch "
                  f"{resume_epoch}: {len(s_a)} state entries and {len(m_a)} momentum buffers "
                  "bit-identical to the uninterrupted run")


@contextlib.contextmanager
def _captured_warnings():
    """The WARNING records of the trainer's logger while open."""
    import logging

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    log = logging.getLogger("siammask_tpu_torch.train.trainer")
    handler = Keep(level=logging.WARNING)
    log.addHandler(handler)
    try:
        yield records
    finally:
        log.removeHandler(handler)


def phase_train_cli(configs: dict) -> None:
    """``tools.train.main`` on the synthetic set at TRAIN_BATCH, width 64:
    SiamMask-base for one epoch of 2 steps, then ``sharp_refine``
    warm-started from its checkpoint, then resumed for a second epoch.
    Each run's losses are finite and it writes its checkpoint."""
    workers = str(min(16, os.cpu_count() or 1))
    paths = {}
    for name, raw in configs.items():
        raw = dict(raw, train_datasets=dict(raw["train_datasets"], num=2 * TRAIN_BATCH))
        paths[name] = SMOKE_TRAIN / f"cli_{name}.json"
        paths[name].write_text(json.dumps(raw))
    out = SMOKE_TRAIN / "cli"
    common = ["--batch", str(TRAIN_BATCH), "--workers", workers, "--width", str(TRAIN_WIDTH),
              "--log-interval", "1", "--seed", str(SEED), "--device", DEV]
    runs = [("base", ["--config", str(paths["base"]), "--task", "base", "--epochs", "1",
                      "--save-dir", str(out / "base")], out / "base" / "checkpoint_e1.pth"),
            ("sharp_refine --pretrained",
             ["--config", str(paths["sharp"]), "--task", "sharp_refine", "--epochs", "1",
              "--save-dir", str(out / "sharp"), "--pretrained",
              str(out / "base" / "checkpoint_e1.pth")], out / "sharp" / "checkpoint_e1.pth"),
            ("sharp_refine --resume",
             ["--config", str(paths["sharp"]), "--task", "sharp_refine", "--epochs", "2",
              "--save-dir", str(out / "sharp"), "--resume",
              str(out / "sharp" / "checkpoint_e1.pth")], out / "sharp" / "checkpoint_e2.pth")]
    for label, argv, written in runs:
        t0 = time.perf_counter()
        metrics = train_cli.main([*argv, *common])
        dt = time.perf_counter() - t0
        if not metrics or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"[train-cli] {label}: {metrics}")
        if not written.exists():
            raise AssertionError(f"[train-cli] {label}: no {written.name}")
        print(f"[train-cli] {label}: {dt:.2f} s for 2 steps of {TRAIN_BATCH} (model build, "
              f"loader, steps, checkpoint); total loss {metrics['total_loss']:.4f}; wrote "
              f"{written.relative_to(SMOKE_TRAIN)}")


# [dp]: the data-parallel modes, each from the stage-1 weights; the two
# tensors whose update direction the fused modes are held to
DP_MODES = (("default", {}), ("fused", {"fused_allreduce": True}),
            ("fused+sync_bn", {"fused_allreduce": True, "sync_bn": True}))
DP_DIRECTION = ("rpn_model.loc.head.3.weight", "features.features.layer2.0.conv1.weight")
# those held to cos > 0.98 per (mode, epoch), as the JAX tests hold them
# (tests/test_training.py): the RPN head in the frozen phase; layer2 once it
# trains with synced BN (local BN moves the unfrozen backbone's gradients)
DP_GATED = {("fused", 0): DP_DIRECTION[:1], ("fused+sync_bn", 0): DP_DIRECTION[:1],
            ("fused+sync_bn", 1): DP_DIRECTION}
DP_TIMED = 2
# the default mode's updates against the single-process step's, over the
# step, frozen / unfrozen: about three times the distance measured on an
# H100 (1.97e-3 / 8.8e-3-9.5e-3), which is float32 rounding: the same
# comparison in float64 holds to 1e-9 (tests/test_torch_parallel.py), and
# one process's step through cuDNN against PyTorch's native convs is as far
# apart (printed beside, ``dp_float32_noise``); local BN puts the fused step
# 0.13 / 0.95 off, printed too
DP_BOUND = {0: 1e-2, 1: 3e-2}
SMOKE_DP = REPO / "build" / "dp_smoke"


def _state_digest(model) -> str:
    h = hashlib.sha256()
    for v in model.state_dict().values():
        h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def dp_rank(rank: int, world: int, device, init_state: dict, batch: dict, modes, keep,
            timed: int, dtype: torch.dtype | None = None) -> dict:
    """One rank of a data-parallel run (``parallel.dist.spawn``): for each
    mode of ``modes`` a frozen and an unfrozen step, each on a fresh trainer
    over a model computing in ``dtype`` (None: float32) from
    ``init_state``, on this rank's rows of ``batch``; then ``timed``
    unfrozen steps after a warm one, by the host clock to a synchronize.
    Per step: metrics, kernel launches (and those of the packed bf16
    kernels), collectives, a digest of the state, and the state's tensors
    (all with ``keep`` None, else those named)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.load(str(TRAIN_CONFIG), clip=10.0)
    rows = local_rows(batch["template"].shape[0], rank, world)
    local = {k: v[rows].to(device) for k, v in batch.items()}
    out = {}
    for name, kwargs in modes:
        steps = []
        for epoch in (0, 1):
            model = loaded_model(SiamMaskBase, init_state, device, dtype)
            trainer = Trainer(model, *train_parts(cfg), epochs=TRAIN_EPOCHS, distributed=True,
                              **kwargs)
            torch.cuda.synchronize()
            reset_launches()
            calls = _all_reduce.calls
            metrics = {k: v.item() for k, v in trainer.step(local, epoch).items()}
            torch.cuda.synchronize()
            steps.append({"metrics": metrics, "launches": read_launches(),
                          "packed": [fn.packed_launches for fn in KERNELS],
                          "collectives": _all_reduce.calls - calls,
                          "digest": _state_digest(model),
                          "state": {k: v.detach().cpu().clone()
                                    for k, v in model.state_dict().items()
                                    if keep is None or k in keep}})
        ms = []
        torch.cuda.reset_peak_memory_stats()
        for i in range(timed + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.step(local, 1)
            torch.cuda.synchronize()
            if i:
                ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"steps": steps, "ms": ms, "peak": torch.cuda.max_memory_allocated()}
    return out


def _cos(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return (a @ b / (a.norm() * b.norm())).item()


def _updates(state: dict, init_state: dict, labels: dict) -> dict:
    return {n: state[n].double() - init_state[n].double()
            for n, label in labels.items() if label != "frozen"}


def check_dp_close(what: str, ours: dict, ref: dict, init_state: dict, labels: dict,
                   bound: float) -> float:
    """A data-parallel step's state against the single-process step's, both
    float32 with TF32 off: the updates within ``bound`` of their norm over
    the whole step (``_step_error``; ``DP_BOUND``), frozen tensors
    bit-identical, BN statistics within 1e-3 of their largest entry.
    Returns the step's error."""
    step = _step_error(_updates(ours, init_state, labels), _updates(ref, init_state, labels))
    if not step <= bound:
        raise AssertionError(f"{what}: the step's updates are {step:.3e} off the single "
                             f"process's (bound {bound:.0e})")
    for name, label in labels.items():
        if label == "frozen" and not torch.equal(ours[name], ref[name]):
            raise AssertionError(f"{what}: frozen {name} differs")
    for name, v in ref.items():
        if name.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(ours[name], v, rtol=1e-3,
                                       atol=1e-3 * v.abs().max().item(),
                                       msg=lambda m, name=name: f"{what} {name}: {m}")
    return step


def dp_world_one(init_state: dict, batch: dict) -> dict:
    """[dp] world 1 over NCCL: a frozen and an unfrozen default-mode step
    against the no-group step from the same weights, bit for bit (cuDNN's
    deterministic algorithms on both). Returns per epoch the no-group
    step's (metrics, state, labels)."""
    cfg = Config.load(str(TRAIN_CONFIG), clip=10.0)

    def step(epoch: int, distributed: bool):
        model = loaded_model(SiamMaskBase, init_state, DEV)
        trainer = Trainer(model, *train_parts(cfg), epochs=TRAIN_EPOCHS,
                          distributed=distributed)
        metrics = {k: v.item() for k, v in trainer.step(batch, epoch).items()}
        state = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        return metrics, state, dict(trainer.labels)

    with deterministic():
        refs = {epoch: step(epoch, False) for epoch in (0, 1)}
        init_distributed("cuda", rank=0, world=1,
                         init_method=f"tcp://127.0.0.1:{_free_port()}", timeout=600)
        try:
            for epoch in (0, 1):
                metrics, state, _ = step(epoch, True)
                if metrics != refs[epoch][0] or not _same(state, refs[epoch][1]):
                    raise AssertionError(f"[dp] world 1 over NCCL, epoch {epoch}: the step "
                                         "differs from the no-group step")
        finally:
            torch.distributed.destroy_process_group()
    print(f"[dp] world 1 over NCCL ({torch.cuda.get_device_name(0)}): the default-mode "
          "frozen and unfrozen steps bit-identical to the no-group steps (metrics, weights, "
          "BN statistics; deterministic cuDNN)")
    return refs


def dp_float32_noise(init_state: dict, batch: dict, refs: dict) -> dict:
    """Per epoch (0 frozen, 1 unfrozen), how far float32 rounding alone
    moves the single-process step: its updates through PyTorch's native
    convs (cuDNN off) against ``refs``' through cuDNN, over the step."""
    cfg = Config.load(str(TRAIN_CONFIG), clip=10.0)
    noise = {}
    torch.backends.cudnn.enabled = False
    try:
        for epoch in (0, 1):
            model = loaded_model(SiamMaskBase, init_state, DEV)
            Trainer(model, *train_parts(cfg), epochs=TRAIN_EPOCHS).step(batch, epoch)
            state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
            _, ref_state, labels = refs[epoch]
            noise[epoch] = _step_error(_updates(state, init_state, labels),
                                       _updates(ref_state, init_state, labels))
    finally:
        torch.backends.cudnn.enabled = True
    return noise


def check_dp_ranks(tag: str, name: str, phase: str, runs: list, step: int,
                   bf16: bool) -> dict:
    """A data-parallel step on every rank of ``runs``: the ranks' states
    bit-identical, 3 launches of each kernel a rank, all of the packed bf16
    kernels' with ``bf16`` and none else, the metrics finite with no skip.
    Returns rank 0's step."""
    if len({r["steps"][step]["digest"] for r in runs}) != 1:
        raise AssertionError(f"[{tag}] {name} {phase}: the ranks' states differ")
    for r in runs:
        got = r["steps"][step]
        if got["launches"] != [3, 3, 3] or got["packed"] != ([3, 3, 3] if bf16 else [0, 0, 0]):
            raise AssertionError(f"[{tag}] {name} {phase}: launches {got['launches']}, packed "
                                 f"{got['packed']}, expected [3, 3, 3] "
                                 f"({'all' if bf16 else 'none'} packed)")
    ours = runs[0]["steps"][step]
    if not all(math.isfinite(v) for v in ours["metrics"].values()) \
            or ours["metrics"]["skipped"] != 0:
        raise AssertionError(f"[{tag}] {name} {phase}: {ours['metrics']}")
    return ours


def check_dp_direction(tag: str, name: str, epoch: int, ours: dict, default: dict,
                       init_state: dict, ref_state: dict, labels: dict) -> str:
    """A fused mode's step held by its update direction against the default
    mode's (``default``: rank 0's run of it) where ``DP_GATED`` says, cos >
    0.98; returns the line that reports it, with its updates' distance from
    the single process's (``ref_state``)."""
    other = default["steps"][epoch]["state"]
    coss = {k: _cos(ours["state"][k] - init_state[k], other[k] - init_state[k])
            for k in DP_DIRECTION if epoch or not k.startswith("features.")}
    gated = DP_GATED.get((name, epoch), ())
    if not all(coss[k] > 0.98 for k in gated):
        raise AssertionError(f"[{tag}] {name} {'unfrozen' if epoch else 'frozen'}: update "
                             f"direction against the default mode {coss}, {gated} held to "
                             "cos > 0.98")
    off = _step_error(_updates(ours["state"], init_state, labels),
                      _updates(ref_state, init_state, labels))
    return (f"total loss {ours['metrics']['total_loss']:.6f}; updates {off:.3e} off the single "
            "process's; update direction against the default mode: "
            + ", ".join(f"{k} cos {c:.5f}{' (> 0.98)' if k in gated else ''}"
                        for k, c in coss.items()))


def phase_dp(init_state: dict, batch: dict, smi: str) -> list[int]:
    """[dp]: SiamMask-base stage 1 at width 64, global batch TRAIN_BATCH,
    data parallel. World 1 over NCCL against the no-group step; then two
    ranks sharing card 0 over gloo (NCCL refuses two ranks on one card),
    TRAIN_BATCH // 2 rows each, in the default mode, the fused mode and the
    fused mode with sync-BN, a frozen and an unfrozen step each: the default
    mode against the single-process step, the fused modes' update direction
    against the default mode's, the ranks' states bit-identical, 3 launches
    of each kernel a step on each rank. With two cards or more, NCCL over
    up to four of them at global batch 64 and 256 against one card, and the
    train CLI over all of them. Returns rank 0's launches in the two-rank
    run (forward, grad-input, grad-kernel)."""
    refs = dp_world_one(init_state, batch)
    noise = dp_float32_noise(init_state, batch, refs)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    t0 = time.perf_counter()
    ranks = spawn(dp_rank, 2, "cuda", init_state, cpu_batch, DP_MODES, None, DP_TIMED,
                  backend="gloo", local_ranks=[0, 0], timeout=600)
    print(f"[dp] two ranks on {torch.cuda.get_device_name(0)} over gloo (the collectives "
          f"staged through the host by gloo), {TRAIN_BATCH // 2} rows each: spawned and "
          f"run in {time.perf_counter() - t0:.2f} s")
    labels = {e: refs[e][2] for e in (0, 1)}
    launches = [0, 0, 0]
    MEASURED["dp"] = {"refs": refs, "ms": {}}
    for name, _ in DP_MODES:
        runs = [r[name] for r in ranks]
        for step, epoch in enumerate((0, 1)):
            phase = "unfrozen" if epoch else "frozen"
            ours = check_dp_ranks("dp", name, phase, runs, step, bf16=False)
            launches = [a + b for a, b in zip(launches, ours["launches"])]
            ref_metrics, ref_state, _ = refs[epoch]
            if name == "default":
                if not math.isclose(ours["metrics"]["total_loss"], ref_metrics["total_loss"],
                                    rel_tol=1e-5):
                    raise AssertionError(f"[dp] default {phase}: total loss "
                                         f"{ours['metrics']['total_loss']} vs the single "
                                         f"process's {ref_metrics['total_loss']}")
                step_err = check_dp_close(f"[dp] default {phase}", ours["state"], ref_state,
                                          init_state, labels[epoch], DP_BOUND[epoch])
                detail = (f"total loss {ours['metrics']['total_loss']:.6f} vs "
                          f"{ref_metrics['total_loss']:.6f} single-process; updates "
                          f"{step_err:.3e} off the single process's over the step "
                          f"(bound {DP_BOUND[epoch]:.0e}; float32 rounding alone, the "
                          f"single-process step through cuDNN against native convs: "
                          f"{noise[epoch]:.3e})")
            else:
                detail = check_dp_direction("dp", name, epoch, ours, ranks[0]["default"],
                                            init_state, ref_state, labels[epoch])
            print(f"[dp] {name}, {phase} step: {detail}; ranks bit-identical; launches "
                  f"{ours['launches']} a rank; {ours['collectives']} collectives a rank")
        ms = runs[0]["ms"]
        MEASURED["dp"]["ms"][name] = statistics.median(ms)
        print(f"[dp] {name}: {statistics.median(ms):.2f} ms an unfrozen step (median of "
              f"{len(ms)}, host clock to a synchronize; min {min(ms):.2f}), global batch "
              f"{TRAIN_BATCH}, two ranks sharing one card over gloo: a check of the "
              f"semantics, not a speed record; peak {runs[0]['peak'] / 2**30:.2f} GiB a "
              f"rank | {smi}")
    if torch.cuda.device_count() >= 2:
        phase_dp_cards(init_state, smi)
    else:
        print("[dp] one card visible: NCCL over several cards and the train CLI's "
              "--num-devices not run")
    return launches


def phase_dp_cards(init_state: dict, smi: str, dtype: torch.dtype | None = None) -> None:
    """NCCL over min(4, cards) cards at global batch 64 and 256 against one
    card (a world-1 group), default and fused modes, on a model computing in
    ``dtype`` (None: float32): samples/s of an unfrozen step and the
    scaling (bf16's beside float32's of this run); then, in float32,
    ``tools.train --num-devices`` over every card for two steps."""
    cfg = Config.load(str(TRAIN_CONFIG), clip=10.0)
    n = min(4, torch.cuda.device_count())
    modes = DP_MODES[:2]
    tag = "dp" if dtype is None else "bf16-dp"
    scaling = MEASURED.setdefault(tag, {}).setdefault("scaling", {})
    for gb in (TRAIN_BATCH, 4 * TRAIN_BATCH):
        batch = {k: v.cpu() for k, v in synthetic_train_batch(cfg, gb, DEV).items()}
        rates = {}
        for world in (1, n):
            runs = spawn(dp_rank, world, "cuda", init_state, batch, modes, (), DP_TIMED, dtype,
                         timeout=600)
            for name, _ in modes:
                if len({r[name]["steps"][1]["digest"] for r in runs}) != 1:
                    raise AssertionError(f"[{tag}] {name} over {world} cards: ranks differ")
                if dtype is not None and runs[0][name]["steps"][1]["packed"] != [3, 3, 3]:
                    raise AssertionError(f"[{tag}] {name} over {world} cards: packed launches "
                                         f"{runs[0][name]['steps'][1]['packed']}")
                ms = statistics.median(runs[0][name]["ms"])
                rates[(name, world)] = gb * 1e3 / ms
                print(f"[{tag}] NCCL, {world} card(s), global batch {gb} ({gb // world} a "
                      f"card), {name}: {ms:.2f} ms an unfrozen step, "
                      f"{rates[(name, world)]:.1f} samples/s; "
                      f"{runs[0][name]['steps'][1]['collectives']} collectives a step; peak "
                      f"{runs[0][name]['peak'] / 2**30:.2f} GiB a card | {smi}")
        for name, _ in modes:
            scaling[(name, gb)] = rates[(name, n)] / rates[(name, 1)]
            beside = "" if dtype is None else \
                f" (float32 {MEASURED['dp']['scaling'][(name, gb)]:.2f}x)"
            print(f"[{tag}] scaling at global batch {gb}, {name}: {n} cards "
                  f"{scaling[(name, gb)]:.2f}x one card{beside}")
    if dtype is not None:
        return
    shutil.rmtree(SMOKE_DP, ignore_errors=True)
    root, anno = write_crop_dataset(SMOKE_DP / "crop511")
    config = SMOKE_DP / "base.json"
    config.write_text(json.dumps(train_data_config(TRAIN_CONFIG, root, anno, 2 * TRAIN_BATCH)))
    count = torch.cuda.device_count()
    t0 = time.perf_counter()
    metrics = train_cli.main(["--config", str(config), "--task", "base", "--epochs", "1",
                              "--batch", str(TRAIN_BATCH), "--workers", "4", "--width",
                              str(TRAIN_WIDTH), "--seed", str(SEED), "--log-interval", "1",
                              "--save-dir", str(SMOKE_DP / "snap"), "--num-devices", str(count)])
    if not all(math.isfinite(v) for v in metrics.values()) \
            or not (SMOKE_DP / "snap" / "checkpoint_e1.pth").exists():
        raise AssertionError(f"[dp] train CLI over {count} cards: {metrics}")
    print(f"[dp] tools.train --num-devices {count}: 2 steps of {TRAIN_BATCH} in "
          f"{time.perf_counter() - t0:.2f} s (spawn, model build, loader, checkpoint); total "
          f"loss {metrics['total_loss']:.4f}; rank 0 wrote checkpoint_e1.pth")
    shutil.rmtree(SMOKE_DP)

def phase_bf16_dp(init_state: dict, batch: dict, smi: str) -> list[int]:
    """``[bf16-dp]``: ``[dp]``'s two ranks sharing card 0 over gloo, 32 rows
    each, the three modes, a frozen and an unfrozen step each, on the bf16
    twin of the stage-1 weights: the ranks' states bit-identical, 3 / 3 / 3
    launches a step a rank, all of the packed bf16 kernels. The default
    mode against the single-process bf16 step, bf16 noise measured in this
    run as the yardstick: its updates and its BN running statistics no
    further from the single process's than the single-process bf16 step's
    are from ``[dp]``'s float32 one, its total loss within 1e-3 relative.
    The fused modes by update direction against the default mode, as in
    ``[dp]``. ms an unfrozen step beside ``[dp]``'s. With two cards or
    more, NCCL at global batch 64 and 256 against one card
    (``phase_dp_cards``). Returns rank 0's launches."""
    cfg = Config.load(str(TRAIN_CONFIG), clip=10.0)
    refs32 = MEASURED["dp"]["refs"]
    refs = {}
    for epoch in (0, 1):
        trainer = Trainer(loaded_model(SiamMaskBase, init_state, DEV, BF16), *train_parts(cfg),
                          epochs=TRAIN_EPOCHS)
        metrics = {k: v.item() for k, v in trainer.step(batch, epoch).items()}
        refs[epoch] = (metrics, {k: v.detach().cpu().clone()
                                 for k, v in trainer.model.state_dict().items()})
    del trainer
    t0 = time.perf_counter()
    ranks = spawn(dp_rank, 2, "cuda", init_state, {k: v.cpu() for k, v in batch.items()},
                  DP_MODES, None, DP_TIMED, BF16, backend="gloo", local_ranks=[0, 0],
                  timeout=600)
    print(f"[bf16-dp] two ranks on {torch.cuda.get_device_name(0)} over gloo, "
          f"{TRAIN_BATCH // 2} rows each, bf16 over float32 weights: spawned and run in "
          f"{time.perf_counter() - t0:.2f} s")
    launches = [0, 0, 0]
    for name, _ in DP_MODES:
        runs = [r[name] for r in ranks]
        for step, epoch in enumerate((0, 1)):
            phase = "unfrozen" if epoch else "frozen"
            ours = check_dp_ranks("bf16-dp", name, phase, runs, step, bf16=True)
            launches = [a + b for a, b in zip(launches, ours["launches"])]
            (ref_metrics, ref_state), (_, state32, labels) = refs[epoch], refs32[epoch]
            if name != "default":
                detail = check_dp_direction("bf16-dp", name, epoch, ours, ranks[0]["default"],
                                            init_state, ref_state, labels)
            else:
                loss_rel = abs(ours["metrics"]["total_loss"] / ref_metrics["total_loss"] - 1)
                off = _step_error(_updates(ours["state"], init_state, labels),
                                  _updates(ref_state, init_state, labels))
                noise = _step_error(_updates(ref_state, init_state, labels),
                                    _updates(state32, init_state, labels))
                bn = [k for k in ref_state if k.endswith(("running_mean", "running_var"))]
                bn_off = _step_error({k: ours["state"][k] for k in bn},
                                     {k: ref_state[k] for k in bn})
                bn_noise = _step_error({k: ref_state[k] for k in bn},
                                       {k: state32[k] for k in bn})
                if not (loss_rel <= 1e-3 and off <= noise and bn_off <= bn_noise):
                    raise AssertionError(
                        f"[bf16-dp] default {phase}: total loss {ours['metrics']['total_loss']} "
                        f"vs {ref_metrics['total_loss']} single-process bf16; updates {off:.3e} "
                        f"and BN statistics {bn_off:.3e} off it, against bf16's own "
                        f"{noise:.3e} / {bn_noise:.3e} off float32")
                for k, label in labels.items():
                    if label == "frozen" and not torch.equal(ours["state"][k], init_state[k]):
                        raise AssertionError(f"[bf16-dp] default {phase}: frozen {k} moved")
                detail = (f"total loss {ours['metrics']['total_loss']:.6f} vs "
                          f"{ref_metrics['total_loss']:.6f} single-process bf16 ({loss_rel:.2e} "
                          f"relative, bound 1e-3); updates {off:.3e} off the single-process "
                          f"bf16 step's, BN statistics {bn_off:.3e}, against that step's "
                          f"{noise:.3e} / {bn_noise:.3e} off float32's (the bound)")
            print(f"[bf16-dp] {name}, {phase} step: {detail}; ranks bit-identical; launches "
                  f"{ours['launches']} a rank, all packed; {ours['collectives']} collectives "
                  "a rank")
        ms = statistics.median(runs[0]["ms"])
        fp32 = MEASURED["dp"]["ms"][name]
        print(f"[bf16-dp] {name}: {ms:.2f} ms an unfrozen step (median of {len(runs[0]['ms'])}, "
              f"host clock to a synchronize) beside [dp]'s float32 {fp32:.2f} ms (float32 / "
              f"bf16 {fp32 / ms:.2f}x), two ranks sharing one card over gloo; peak "
              f"{runs[0]['peak'] / 2**30:.2f} GiB a rank | {smi}")
    if torch.cuda.device_count() >= 2:
        phase_dp_cards(init_state, smi, BF16)
    return launches

# ---------------- bf16 compute ----------------


def check_bf16_kernels(tag: str) -> None:
    """Every xcorr kernel in ``tag``'s profiled graph call is the packed
    bf16 kernel, by its name in the trace."""
    got = MEASURED[tag]
    if not got["xcorr"] or got["xcorr_packed"] != got["xcorr"]:
        raise AssertionError(f"[{tag}] {got['xcorr_packed']} of {got['xcorr']} xcorr kernels in "
                             "the trace are the packed bf16 kernel")


def print_beside(tag: str, fp32_tag: str, smi: str) -> None:
    """A bf16 graph path's numbers beside the fp32 path's of this run."""
    b, a = MEASURED[tag], MEASURED[fp32_tag]
    print(f"[bf16] {tag} beside {fp32_tag}: ms a frame {b['ms_frame']:.3f} vs "
          f"{a['ms_frame']:.3f} (fp32 / bf16 {a['ms_frame'] / b['ms_frame']:.2f}x); "
          f"frames/s {b['fps']:.1f} vs {a['fps']:.1f}; device ms a frame "
          f"{b['device_ms_frame']:.3f} vs {a['device_ms_frame']:.3f}; idle {b['idle']:.1f}% vs "
          f"{a['idle']:.1f}%; peak memory {b['peak_gib']:.2f} vs {a['peak_gib']:.2f} GiB | {smi}")


def phase_bf16(smi: str) -> dict:
    """``[bf16]``: SiamMask-sharp at width 64 computing in bf16 over float32
    weights (``build_model(dtype=bf16)``: the calibrated weights, their cls
    head sharpened, so that the card and the CPU do not tie on the best
    cell): init and STEPS steps, 3 xcorr launches each, one under
    sync_debug_mode("error"); one step on the card against the CPU's bf16
    port from the same state (maps within BF16_MAP_TOL, the same best cell,
    ``check_step_close``'s bf16 tolerances); ``track_video`` over VIDEO_T
    frames through the CUDA graph, bit-identical to the eager bf16 loop;
    STREAMS streams over STREAMS_T frames, bit-identical to the eager
    ``step_batched`` loop; each with frames/s, device ms a frame, idle
    share, peak memory and a profile's top 10, printed beside the fp32
    ``[video]`` / ``[streams]`` numbers of this run. Then SiamRPN (box only)
    and SiamMask-base (63x63 masks) graph videos in bf16, beside ``[rpn]`` /
    ``[base]``. Every xcorr kernel in the graph paths' traces is a bf16
    instantiation. Returns the xcorr launches by path."""
    p = Config.load(str(CONFIG)).tracker_config()
    model, tracker, frames = build_model(p, dtype=BF16)
    state, track = phase_slice(tracker, frames, "bf16")
    cpu_tracker = cpu_tracker_of(tracker)
    phase_cpu_parity(tracker, cpu_tracker, state, frames[STEPS + 2], "bf16-parity", bf16=True)
    bf16_size_shares(tracker, cpu_tracker, frames[:7], "bf16-parity")
    video, _ = phase_video(tracker, frames, smi, "bf16")
    streams, _ = phase_streams(tracker, frames, smi, "bf16-streams", single=False)
    del model, tracker, state
    torch.cuda.empty_cache()
    paths = {"bf16_track": track, "bf16_video": [video, 0, 0],
             "bf16_streams16": [streams, 0, 0]}
    for name, cls, config, mask in (("rpn", SiamRPN, RPN_CONFIG, False),
                                    ("base", SiamMaskBase, BASE_CONFIG, True)):
        p = Config.load(str(config)).tracker_config()
        _, family_tracker, family_frames = build_model(p, cls, mask, False, BF16)
        launches, _ = phase_video(family_tracker, family_frames, smi, f"bf16-{name}")
        paths[f"bf16_{name}"] = [launches, 0, 0]
        del family_tracker
        torch.cuda.empty_cache()
    for tag, fp32_tag in (("bf16", "video"), ("bf16-streams", "streams"), ("bf16-rpn", "rpn"),
                          ("bf16-base", "base")):
        check_bf16_kernels(tag)
        print_beside(tag, fp32_tag, smi)
    return paths


def phase_bf16_vos(model: SiamMaskSharp, p, smi: str) -> int:
    """``[bf16-vos]``: ``track_vos_batched`` as ``[vos]`` drives it, with a
    bf16 twin of ``[vos]``'s weights on its video: the per-object mean IoU
    against the annotations at the driver's thresholds beside ``[vos]``'s
    fp32 ones, and each object's IoU between the two runs' fused masks,
    pooled over the video. Skipped with ``[vos]``. Returns the xcorr
    launches (through the wrapper and by replay)."""
    if "vos" not in MEASURED:
        print("[bf16-vos] skipped: [vos] did not run")
        return 0
    import cv2

    video = load_dataset("ytb_vos", str(VOS_ROOT))["vid"]
    runtime = TrackerRuntime(bf16_twin(model), p, "cuda")
    track_vos_batched(runtime, video, scan_chunk=VOS_CHUNK, log=lambda *_: None)  # captures
    torch.cuda.synchronize()
    reset_launches()
    out = VOS_ROOT / "results_bf16"
    iou, fps = track_vos_batched(runtime, video, scan_chunk=VOS_CHUNK, result_dir=str(out),
                                 dataset="ytb_vos", save_mask=True, log=lambda *_: None)
    launches = read_launches()
    graph = runtime.tracker.graphs[(3, *FRAME_HW, torch.uint8)]
    check_route("bf16-vos", True, graph)
    if launches != [3 * VOS_RAGGED, 0, 0] or graph.xcorr_launches != 3:
        raise AssertionError(f"bf16-vos: {launches} launches through the wrappers, "
                             f"{graph.xcorr_launches} captured")
    iou, ref = np.asarray(iou), MEASURED["vos"]["iou"]
    if iou.shape != ref.shape or not np.all((iou >= 0) & (iou <= 1)):
        raise AssertionError(f"bf16-vos: IoU {iou}")

    def fused(tree: Path) -> list:
        return [cv2.imread(str(f), cv2.IMREAD_UNCHANGED) for f in
                sorted((tree / "ytb_vos" / "SiamMask" / "vid").glob("*.png"))]

    ours, theirs = fused(out), fused(VOS_ROOT / "results")
    if not len(ours) == len(theirs) == VOS_FRAMES:
        raise AssertionError(f"bf16-vos: {len(ours)} and {len(theirs)} fused masks")
    agree = []
    for k in (1, 2, 3):
        inter = sum(int(((a == k) & (b == k)).sum()) for a, b in zip(ours, theirs))
        union = sum(int(((a == k) | (b == k)).sum()) for a, b in zip(ours, theirs))
        agree.append(inter / max(union, 1))
    shutil.rmtree(out)
    print(f"[bf16-vos] track_vos_batched in bf16 on [vos]'s video ({VOS_FRAMES} frames, 3 "
          f"objects): {launches[0]} xcorr launches through step_batched, "
          f"{graph.xcorr_launches * VOS_FULL} by replay; per-object mean IoU at thresholds "
          f"0.30/0.35/0.40/0.45: bf16 {np.round(iou.astype(float), 4).tolist()} vs fp32 "
          f"{np.round(ref.astype(float), 4).tolist()} "
          f"(largest |bf16 - fp32| {np.abs(iou - ref).max():.4f}); IoU of the bf16 and fp32 "
          f"fused masks per object {[round(a, 4) for a in agree]}; {fps:.1f} object-frames/s "
          f"| {smi}")
    return 3 * VOS_RAGGED + graph.xcorr_launches * VOS_FULL


def region_centre(line: str) -> np.ndarray:
    """The centre of a VOT result region: an x, y, w, h box or a polygon."""
    v = np.array(line.split(","), float)
    return v[:2] + v[2:] / 2 if len(v) == 4 else v.reshape(-1, 2).mean(0)


def phase_bf16_vot(models: dict, smi: str) -> int:
    """``[bf16-vot]``: ``track_vot`` for sharp, base and SiamRPN with bf16
    twins of ``[vot]``'s damped weights on ``[vot]``'s two videos: each
    video's lost count equal to the fp32 run's (the 2s in ``[vot]``'s result
    files), the result files checked line by line as ``[vot]`` checks them,
    and the largest distance in px between the bf16 and the fp32 regions'
    centres over the frames both tracked. Returns the xcorr launches."""
    dataset = load_dataset("VOT2018", str(VOT_ROOT))
    out = VOT_ROOT / "results_bf16"
    families = {"sharp": (VOT_CONFIG, True, True), "base": (BASE_CONFIG, True, False),
                "rpn": (RPN_CONFIG, False, False)}
    torch.cuda.synchronize()
    reset_launches()
    stepped = {}
    for name, (config, mask, refine) in families.items():
        runtime = TrackerRuntime(bf16_twin(models[name]),
                                 Config.load(str(config)).tracker_config(), "cuda", mask=mask,
                                 refine=refine)
        stepped[name], lost, ref_lost, speeds, drift = 0, [], [], [], 0.0
        for video in dataset.values():
            n, fps = track_vot(runtime, video, mask_enable=mask, result_dir=str(out),
                               tracker_name=name, log=lambda *_: None)
            lines, ref = ((tree / "VOT2018" / name / "baseline" / video["name"]
                           / f"{video['name']}_001.txt").read_text().splitlines()
                          for tree in (out, VOT_ROOT / "results"))
            stepped[name] += check_vot_lines(f"bf16-vot {name} {video['name']}", lines,
                                             8 if mask else 4, video["name"] == "vid1")
            lost.append(n)
            ref_lost.append(ref.count("2"))
            speeds.append(fps)
            for a, b in zip(lines, ref):
                if a not in ("0", "1", "2") and b not in ("0", "1", "2"):
                    drift = max(drift, float(np.linalg.norm(region_centre(a) - region_centre(b))))
        if lost != ref_lost:
            raise AssertionError(f"bf16-vot {name}: lost {lost} in bf16, {ref_lost} in fp32")
        print(f"[bf16-vot] {name}: lost {lost} in {list(dataset)}, as in fp32; the largest "
              f"distance between the bf16 and fp32 regions' centres {drift:.2f} px; driver's "
              "fps (file reads excluded) " + ", ".join(f"{v:.1f}" for v in speeds) + f" | {smi}")
    launches = read_launches()
    check_route("bf16-vot", True)
    expected = sum(k * stepped[n] for n, k in (("sharp", 3), ("base", 3), ("rpn", 2)))
    if launches != [expected, 0, 0]:
        raise AssertionError(f"bf16-vot: {launches} launches, expected {[expected, 0, 0]} from "
                             f"the stepped frames {stepped}")
    shutil.rmtree(out)
    return expected


def bf16_first_step(tag: str, make_trainer, init_state: dict, batch: dict,
                    epoch: int = 0) -> tuple[Trainer, dict]:
    """The first step at ``epoch`` of ``make_trainer(dtype)`` (a trainer on
    the card over ``init_state``'s weights; dtype None or bf16) in float32
    and in bf16 on ``batch``: the bf16 step finite with no skip, its total
    loss within BF16_TRAIN_LOSS_RTOL of the float32 one and the cosine of
    the two steps' parameter updates above BF16_TRAIN_MIN_COS (their
    relative distance printed). The launch counts start at 0 before the
    bf16 step. Returns the bf16 trainer and its model's state before the
    step."""
    runs = {}
    for dtype in (None, BF16):
        trainer = make_trainer(dtype)
        if dtype is BF16:
            start = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
            torch.cuda.synchronize()
            reset_launches()
        metrics = {k: v.item() for k, v in trainer.step(batch, epoch).items()}
        update = {n: p.detach().double() - init_state[n].to(DEV).double()
                  for n, p in trainer.model.named_parameters() if trainer.labels[n] != "frozen"}
        runs[dtype] = (trainer, metrics, torch.cat([u.flatten() for u in update.values()]))
    (m32, u32), (trainer, m16, u16) = runs.pop(None)[1:], runs.pop(BF16)
    cos = (u16 @ u32 / (u16.norm() * u32.norm())).item()
    rel = ((u16 - u32).norm() / u32.norm()).item()
    loss_rel = abs(m16["total_loss"] - m32["total_loss"]) / abs(m32["total_loss"])
    if not (all(math.isfinite(v) for v in m16.values()) and m16["skipped"] == 0):
        raise AssertionError(f"[{tag}] step 0: {m16}")
    if not (loss_rel <= BF16_TRAIN_LOSS_RTOL and cos > BF16_TRAIN_MIN_COS):
        raise AssertionError(f"[{tag}] first step's loss {m16['total_loss']} vs fp32 "
                             f"{m32['total_loss']}, update cosine {cos}")
    losses = [k for k in m16 if k.endswith("_loss") and k != "total_loss"]
    print(f"[{tag}] first step (epoch {epoch}), B={batch['template'].shape[0]}, bf16 against "
          f"fp32 from the same weights and batch: total loss {m16['total_loss']:.4f} vs "
          f"{m32['total_loss']:.4f} ({loss_rel:.2e} relative; "
          + ", ".join(f"{k[:-5]} {m16[k]:.4f} vs {m32[k]:.4f}" for k in losses)
          + f"); parameter updates: cosine {cos:.4f}, relative distance {rel:.3e}")
    return trainer, start


def phase_bf16_train(init_state: dict, batch: dict, cfg: Config, smi: str) -> list[int]:
    """``[bf16-train]``: SiamMask-base stage 1 at batch TRAIN_BATCH computing
    in bf16 over float32 weights, from ``[train]``'s initial weights on its
    batch. The first (frozen) step against the fp32 step from the same
    weights and batch (``bf16_first_step``). Then a second frozen and two
    unfrozen steps: each finite, no skip, 3 / 3 / 3 launches, the stem and
    layer1 unchanged, layer2 unchanged while frozen; a profiled unfrozen
    step whose xcorr kernels are all the packed bf16 kernels (3 forward and
    3 of each gradient); ms/step by CUDA events and peak memory per phase
    beside ``[train-timing]``'s fp32 numbers. Returns the launches of the
    four steps."""
    trainer, start = bf16_first_step(
        "bf16-train", lambda dtype: Trainer(loaded_model(SiamMaskBase, init_state, DEV, dtype),
                                            *train_parts(cfg), epochs=TRAIN_EPOCHS,
                                            unfreeze_at=0.5), init_state, batch)
    model = trainer.model
    stem0 = {k: v for k, v in start.items() if k.startswith(FROZEN_ALWAYS)}
    layer2_0 = {k: v for k, v in start.items() if k.startswith(LAYER2)}
    counts = read_launches()
    if counts != [3, 3, 3]:
        raise AssertionError(f"bf16-train step 0: {counts} launches, expected [3, 3, 3]")
    for step, epoch in ((1, 0), (2, 1), (3, 1)):
        before = read_launches()
        metrics = {k: v.item() for k, v in trainer.step(batch, epoch).items()}
        counts = [a - b for a, b in zip(read_launches(), before)]
        if (not all(math.isfinite(v) for v in metrics.values()) or metrics["skipped"] != 0
                or counts != [3, 3, 3]):
            raise AssertionError(f"bf16-train step {step}: {metrics}, launches {counts}")
        if not _same(_state(model, FROZEN_ALWAYS), stem0):
            raise AssertionError(f"bf16-train step {step}: the stem or layer1 changed")
        if epoch == 0 and not _same(_state(model, LAYER2), layer2_0):
            raise AssertionError(f"bf16-train step {step}: layer2 changed while frozen")
        print(f"[bf16-train] step {step} epoch {epoch} ({'unfrozen' if epoch else 'frozen'}): "
              f"total {metrics['total_loss']:.4f} cls {metrics['cls_loss']:.4f} loc "
              f"{metrics['loc_loss']:.4f} mask {metrics['mask_loss']:.4f} iou "
              f"{metrics['iou_mean']:.4f}; launches {counts}")
    launches = read_launches()
    check_route("bf16-train", True)
    events, busy, step_ms = profile_call(lambda: trainer.step(batch, 1))
    names = {e.key: e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA
             and "depthwise_xcorr" in e.key}
    packed = sum(c for k, c in names.items() if "depthwise_xcorr_strip_bf16x2_kernel" in k)
    grad_kernel = sum(c for k, c in names.items()
                      if "depthwise_xcorr_grad_kernel_bf16x2_kernel" in k)
    if (packed, grad_kernel) != (6, 3) or sum(names.values()) != 9:
        raise AssertionError(f"bf16-train: xcorr kernels in a step's trace {names}")
    kinds = sorted({re.search(r"depthwise_xcorr\w*<[^>]*>", k).group(0) for k in names})
    print(f"[bf16-train] profiled unfrozen step: 9 xcorr kernels, all packed bf16 kernels "
          f"({', '.join(kinds)}); device busy {busy:.2f} ms of {step_ms:.2f} ms")
    trainer.step(batch, 0)
    profile_call(lambda: trainer.step(batch, 0), "bf16-train-frozen")
    TRACES["bf16-train-frozen"]["xcorr"] = dict.fromkeys(XCORR_ROWS[3:], 3)
    phase_train_timing(trainer, batch, smi, "bf16-train-timing", mode="bf16")
    for label in ("frozen", "unfrozen"):
        (ms16, peak16), (ms32, peak32) = (MEASURED[t][label] for t in ("bf16-train-timing",
                                                                        "train-timing"))
        print(f"[bf16-train] {label} step beside [train-timing]: {ms16:.2f} vs {ms32:.2f} ms "
              f"(fp32 / bf16 {ms32 / ms16:.2f}x), {TRAIN_BATCH * 1e3 / ms16:.1f} vs "
              f"{TRAIN_BATCH * 1e3 / ms32:.1f} samples/s; peak memory {peak16:.2f} vs "
              f"{peak32:.2f} GiB | {smi}")
    return launches


def phase_bf16_train_task(tag: str, make_trainer, init_state: dict, batch: dict, epochs: tuple,
                          per_step: list[int], phases, fp32_tag: str, smi: str) -> list[int]:
    """``[bf16-train-refine]`` / ``[bf16-train-rpn]``: a task's trainer
    (``make_trainer(dtype)``) computing in bf16 over float32 weights, from
    its fp32 phase's initial weights on its first loader batch: the first
    step at ``epochs[0]`` against the fp32 step (``bf16_first_step``), then
    a step at each of ``epochs[1:]``, each finite with no skip and
    ``per_step`` launches; every xcorr launch of those steps the packed
    bf16 kernels (``check_route``); ms/step by CUDA events and peak memory
    of each of ``phases`` beside the fp32 phase's (``fp32_tag``) of this
    run. Fewer steps than the fp32 phase, to keep the smoke inside the chip
    tool's time limit. Returns the launches of its steps."""
    trainer, _ = bf16_first_step(tag, make_trainer, init_state, batch, epochs[0])
    counts = read_launches()
    if counts != per_step:
        raise AssertionError(f"[{tag}] step 0: {counts} launches, expected {per_step}")
    for step, epoch in enumerate(epochs[1:], 1):
        before = read_launches()
        metrics = {k: v.item() for k, v in trainer.step(batch, epoch).items()}
        counts = [a - b for a, b in zip(read_launches(), before)]
        if (not all(math.isfinite(v) for v in metrics.values()) or metrics["skipped"] != 0
                or counts != per_step):
            raise AssertionError(f"[{tag}] step {step}: {metrics}, launches {counts}")
        print(f"[{tag}] step {step} epoch {epoch}: "
              + " ".join(f"{k} {v:.4f}" for k, v in metrics.items() if k != "skipped")
              + f"; launches {counts}")
    launches = read_launches()
    check_route(tag, True)
    print(f"[{tag}] {len(epochs)} steps at B={batch['template'].shape[0]}: launches "
          f"{launches}, all packed bf16 kernels")
    phase_train_timing(trainer, batch, smi, f"{tag}-timing", phases, mode="bf16")
    for _, label in phases:
        (ms16, peak16), (ms32, peak32) = (MEASURED[t][label] for t in (f"{tag}-timing",
                                                                        fp32_tag))
        print(f"[{tag}] {label} step beside [{fp32_tag}]: {ms16:.2f} vs {ms32:.2f} ms (fp32 / "
              f"bf16 {ms32 / ms16:.2f}x); peak memory {peak16:.2f} vs {peak32:.2f} GiB | {smi}")
    return launches


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def host_ms(fn, calls: int = TIMED_CALLS) -> float:
    """Median host ms of ``calls`` calls, each ended by a synchronize of
    every card (work on several cards; CUDA events see one stream)."""
    fn()
    times = []
    for _ in range(calls):
        sync_all()
        t0 = time.perf_counter()
        fn()
        sync_all()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rewarp(tracker: Tracker, cell_masks: torch.Tensor, outs, pos0: torch.Tensor,
           sz0: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Cell masks (T, O, S, S) warped into the frame as the tracker warps
    frame t's, from the state before it (``pos0`` / ``sz0`` at t = 0, else
    ``outs``' frame t - 1) and ``outs``' best cells: (T, O, H, W)."""
    warped = []
    for t in range(cell_masks.shape[0]):
        pos = pos0 if t == 0 else outs.target_pos[t - 1]
        sz = sz0 if t == 0 else outs.target_sz[t - 1]
        s_x_full, _ = tracker._search_window(TrackState(pos, sz, None, None, None))
        back = tracker._back_box(pos, s_x_full, tracker._cells(outs.best_id[t]), *hw)
        warped.append(warp_back_mask(cell_masks[t], back, hw))
    return torch.stack(warped)


def check_sharded(what: str, tracker: Tracker, outs, ref, final: list, ref_final,
                  pos0: np.ndarray, sz0: np.ndarray) -> dict:
    """Sharded outputs against the unsharded tracker's at O=16 (cuDNN picks
    its algorithms by batch, so 8 rows a replica round otherwise than 16):
    the same best_id everywhere; positions, scores, the cell masks and the
    final sizes within ``tests/test_serving_sharded.py``'s tolerances
    (rtol 1e-5 / atol 1e-4; masks 1e-4 / 1e-3). The masks in the frame are
    held to the masks' tolerance once the unsharded cell masks are warped at
    the sharded run's positions (``rewarp``, which gives back the sharded
    run's own masks to 1e-6 from its cell masks); the difference at the
    unsharded positions, where an edge pixel moves with a position inside
    its tolerance, is returned beside. Returns the max abs differences and
    the pixels beyond 1e-3."""
    if not torch.equal(outs.best_id, ref.best_id):
        bad = (outs.best_id != ref.best_id).nonzero().tolist()[:8]
        raise AssertionError(f"{what}: best_id differs at (frame, stream) {bad}")
    sizes = torch.cat([st.target_sz.to(ref_final.target_sz.device) for st in final])
    dev = outs.target_pos.device
    pos0, sz0 = torch.from_numpy(pos0).to(dev), torch.from_numpy(sz0).to(dev)
    hw = tuple(outs.mask_in_frame.shape[-2:])
    own = rewarp(tracker, outs.mask_logits, outs, pos0, sz0, hw)
    moved = rewarp(tracker, ref.mask_logits, outs, pos0, sz0, hw)
    errs = {}
    for name, a, b, tol in (("target_pos", outs.target_pos, ref.target_pos, (1e-5, 1e-4)),
                            ("score", outs.score, ref.score, (1e-5, 1e-4)),
                            ("mask_logits", outs.mask_logits, ref.mask_logits, (1e-4, 1e-3)),
                            ("mask_in_frame re-warped from its own cell masks",
                             outs.mask_in_frame, own, (0.0, 1e-6)),
                            ("mask_in_frame, unsharded cell masks at the sharded positions",
                             outs.mask_in_frame, moved, (1e-4, 1e-3)),
                            ("final target_sz", sizes, ref_final.target_sz, (1e-5, 1e-4))):
        torch.testing.assert_close(a, b, rtol=tol[0], atol=tol[1],
                                   msg=lambda m, name=name: f"{what} {name}: {m}")
        errs[name] = (a - b).abs().max().item()
    diff = (outs.mask_in_frame - ref.mask_in_frame).abs()
    errs["mask_in_frame at the unsharded positions"] = diff.max().item()
    errs["of its pixels beyond 1e-3"] = int((diff > 1e-3).sum())
    return errs


def check_shards_bit_identical(what: str, server, states: list, frames: torch.Tensor,
                               final: list, outs) -> None:
    """The server against its replicas' own trackers run one after another
    on their shares of the streams, the same frames: the split, the
    threads and the gather change no bit."""
    per = outs.best_id.shape[1] // len(server.replicas)
    for i, (replica, st) in enumerate(zip(server.replicas, states)):
        ref_final, ref = replica.track_video_multi(st, frames)
        mine = type(outs)(*(v[:, i * per:(i + 1) * per] for v in outs))
        check_bit_identical(f"{what}, replica {i}", mine, type(ref)(*(v.to(mine.best_id.device)
                                                                       for v in ref)),
                            TrackState(*(v.to(mine.best_id.device) for v in final[i])),
                            TrackState(*(v.to(mine.best_id.device) for v in ref_final)))


def sharded_setup(p):
    """The [sharded] cell: sharp at width 64 (``build_model``), its frames,
    STREAMS streams' centres and sizes, and the unsharded
    ``track_video_multi`` over STREAMS_T frames: (tracker, frames, pos, sz,
    initial states, final states, outputs)."""
    _, tracker, frames = build_model(p)
    rng = np.random.RandomState(SEED)
    pos = rng.uniform(100, 400, (STREAMS, 2)).astype(np.float32)
    sz = rng.uniform(60, 200, (STREAMS, 2)).astype(np.float32)
    dev = torch.from_numpy(frames[:STREAMS_T + 1]).cuda()
    ref_states = tracker.init_batched(dev[0], pos, sz)
    return (tracker, frames, pos, sz, ref_states,
            *tracker.track_video_multi(ref_states, dev[1:]))


def phase_sharded_cards(tracker: Tracker, frames: np.ndarray, pos: np.ndarray, sz: np.ndarray,
                        ref, ref_final, smi: str) -> None:
    """STREAMS streams a card over every card against one card at STREAMS:
    card 0's streams are the one-card run's (checked as [sharded] checks),
    aggregate frames/s and the scaling; both take host frames, uploaded in
    the call once a card."""
    o, t, count = STREAMS, STREAMS_T, torch.cuda.device_count()
    rng = np.random.RandomState(SEED + 1)
    many = np.concatenate([pos, rng.uniform(100, 400, ((count - 1) * o, 2))]).astype(np.float32)
    sizes = np.concatenate([sz, rng.uniform(60, 200, ((count - 1) * o, 2))]).astype(np.float32)
    cards = ShardedStreamServer(tracker, [f"cuda:{i}" for i in range(count)])
    cards_states = cards.init_batched(frames[0], many, sizes)
    cards_final, cards_outs = cards.track_video(cards_states, frames[1:t + 1])
    first = type(cards_outs)(*(v[:, :o] for v in cards_outs))
    errs = check_sharded(f"[sharded] {count} cards, card 0's streams", tracker, first, ref,
                         cards_final[:1], ref_final, pos, sz)
    print(f"[sharded] {count} cards, card 0's {o} streams against the one-card run: best_id "
          "equal, max abs diff " + ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else
                                            f"{k} {v}" for k, v in errs.items()))
    ref_states = tracker.init_batched(frames[0], pos, sz)
    cards_ms = host_ms(lambda: cards.track_video(cards_states, frames[1:t + 1]))
    one_ms = host_ms(lambda: tracker.track_video_multi(ref_states, frames[1:t + 1]))
    one, agg = o * t * 1e3 / one_ms, count * o * t * 1e3 / cards_ms
    print(f"[sharded] {count} cards, {o} streams a card (O={count * o}), T={t}: "
          f"{cards_ms:.2f} ms a call, {agg:.1f} aggregate frames/s against {one:.1f} on one "
          f"card at O={o} ({one_ms:.2f} ms): {agg / one:.2f}x; card 0's streams as the "
          f"one-card run's; both take host frames, uploaded in the call, once a card | {smi}")


def phase_sharded(p, smi: str) -> int:
    """[sharded]: SiamMask-sharp at width 64, STREAMS streams on 480x854
    frames over STREAMS_T frames through ``ShardedStreamServer`` over
    [cuda:0, cuda:0] (two replicas, one thread and one CUDA graph each)
    against the unsharded ``track_video_multi``; aggregate frames/s of both;
    3 xcorr kernels a frame a replica by name in a profile. With two cards
    or more, STREAMS streams a card over every card against one card.
    Returns the xcorr launches of the two-replica call (captured x
    replays)."""
    tracker, frames, pos, sz, ref_states, ref_final, ref = sharded_setup(p)
    o, t = STREAMS, STREAMS_T
    dev = torch.from_numpy(frames[:t + 1]).cuda()
    server = ShardedStreamServer(tracker, ["cuda:0", "cuda:0"])
    states = server.init_batched(frames[0], pos, sz)
    reset_launches()
    final, outs = server.track_video(states, frames[1:t + 1])
    sync_all()
    counted = read_launches()
    graphs = [r.graphs[(o // 2, *FRAME_HW, torch.uint8)] for r in server.replicas]
    for graph in graphs:
        check_route("sharded", False, graph)
    if counted[0] == 0 or counted[1:] != [0, 0] or any(g.xcorr_launches != 3 for g in graphs):
        raise AssertionError(f"[sharded] {counted} launches through the wrappers, "
                             f"{[g.xcorr_launches for g in graphs]} xcorr kernels captured")
    check_shards_bit_identical("[sharded]", server, states, dev[1:], final, outs)
    errs = check_sharded("[sharded]", tracker, outs, ref, final, ref_final, pos, sz)
    launches = sum(g.xcorr_launches for g in graphs) * t
    print(f"[sharded] ShardedStreamServer over [cuda:0, cuda:0], O={o}, T={t}, width 64: "
          f"{launches} xcorr launches by replay at B={o // 2} a replica; every output "
          f"bit-identical to each replica's own track_video_multi on its {o // 2} streams; "
          f"against the unsharded one at O={o}: best_id equal at every frame and stream, max "
          "abs diff "
          + ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
                      for k, v in errs.items()))
    ms = host_ms(lambda: server.track_video(states, dev[1:]))
    ref_ms = host_ms(lambda: tracker.track_video_multi(ref_states, dev[1:]))
    print(f"[sharded] O={o}, T={t}: two replicas on one card {ms:.2f} ms a call "
          f"({o * t * 1e3 / ms:.1f} aggregate frames/s), unsharded {ref_ms:.2f} ms "
          f"({o * t * 1e3 / ref_ms:.1f}); host clock to a synchronize, median of "
          f"{TIMED_CALLS}; replicas sharing a card: a check, not a speed record | {smi}")
    check_graph_profile("sharded", lambda: server.track_video(states, dev[1:]), t, o,
                        per_frame=3 * len(graphs))
    if torch.cuda.device_count() >= 2:
        phase_sharded_cards(tracker, frames, pos, sz, ref, ref_final, smi)
    else:
        print("[sharded] one card visible: the server over several cards not run")
    return launches


def write_overfit_clip(root: Path, hw: tuple[int, int] = FRAME_HW, seed: int = SEED) -> None:
    """The overfit tool's clip under ``root``: ``overfit.N_FRAMES`` uint8
    JPEG frames ``{f:05d}.jpg`` of ``hw``. A seeded static background of
    blue-green blobs with fine grain; a target, a textured warm-coloured
    ellipse (one seeded texture, scaled to the box) filling
    ``overfit.interpolate_boxes()[f]``; seeded pixel noise a frame."""
    import cv2

    rng = np.random.RandomState(seed)
    h, w = hw
    blobs = rng.randint(30, 180, (h // 24 + 2, w // 24 + 2, 3)).astype(np.float32)
    blobs[..., 2] *= 0.5                                  # BGR: little red
    background = cv2.resize(blobs, (w, h), interpolation=cv2.INTER_CUBIC)
    background += rng.normal(0.0, 12.0, (h, w, 3))
    texture = np.stack([rng.uniform(0, 90, (16, 16)), rng.uniform(60, 200, (16, 16)),
                        rng.uniform(170, 255, (16, 16))], axis=-1).astype(np.float32)
    root.mkdir(parents=True, exist_ok=True)
    for f, (x0, y0, x1, y1) in enumerate(overfit.interpolate_boxes()):
        im = background.copy()
        bw, bh = int(round(x1 - x0)), int(round(y1 - y0))
        ix, iy = int(round(x0)), int(round(y0))
        inside = np.zeros((bh, bw), np.uint8)
        cv2.ellipse(inside, (bw // 2, bh // 2), (bw // 2, bh // 2), 0, 0, 360, 1, -1)
        patch = cv2.resize(texture, (bw, bh), interpolation=cv2.INTER_LINEAR)
        region = im[iy:iy + bh, ix:ix + bw]
        region[inside == 1] = patch[inside == 1]
        im += np.random.RandomState(seed + 1 + f).normal(0.0, 6.0, (h, w, 3))
        cv2.imwrite(str(root / f"{f:05d}.jpg"), np.clip(im, 0, 255).astype(np.uint8))


@contextlib.contextmanager
def stderr_to(path: Path):
    """While open, this process's file descriptor 2 (and so the stderr of
    the subprocesses it starts) writes to ``path``."""
    sys.stderr.flush()
    saved = os.dup(2)
    try:
        with open(path, "wb") as f:
            os.dup2(f.fileno(), 2)
            yield
    finally:
        sys.stderr.flush()
        os.dup2(saved, 2)
        os.close(saved)


def train_log_runs(path: Path) -> list[dict]:
    """The train CLI runs of a log, in order: each run's last step, and its
    seconds an iteration from the step lines' millisecond timestamps (the
    CLI's own clock, data waits, epoch starts and checkpoint saves
    included), from its first step line on (the interval before it holds
    the start): over the run (``s_it``), and over the first and the second
    half of its epochs (``s_it_halves``; the train CLI unfreezes at half);
    and the optimizer groups each half logs with an LR over 0
    (``lr_groups_halves``)."""
    runs = []
    for line in path.read_text().splitlines():
        if " INFO torch " in line:
            runs.append([])
        elif m := OVERFIT_STEP.match(line):
            t = datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp()
            groups = {g for g, lr in OVERFIT_GROUP.findall(line) if float(lr) > 0}
            runs[-1].append((t, int(m.group(2)), int(m.group(3)), groups))

    def s_it(points: list) -> float:
        return (points[-1][0] - points[0][0]) / (points[-1][2] - points[0][2])

    out = []
    for points in runs:
        half = (points[-1][1] + 1) / 2
        first = [p for p in points if p[1] < half]
        second = first[-1:] + [p for p in points if p[1] >= half]
        out.append({"steps": points[-1][2], "s_it": s_it(points),
                    "s_it_halves": [s_it(first), s_it(second)],
                    "lr_groups_halves": [sorted(set().union(*(p[3] for p in half_points)))
                                         for half_points in (first, second[1:])]})
    return out


def phase_overfit(smi: str) -> list[int]:
    """``[overfit]``: ``siammask_tpu_torch.tools.overfit`` ``--prepare --train
    --evaluate --task mask`` at width 64 with its default schedule on the
    clip of ``write_overfit_clip`` (480x854): stage 1 for 16 epochs of 64
    steps of 8 across the unfreeze, stage 2 for 24. The train CLI's logs go
    to a file, read for each stage's samples/s on its clock
    (``train_log_runs``). The report must clear the thresholds
    ``tests/test_overfit_artifact.py`` pins for the JAX run's: mask and
    total loss under init's / 10, held-out mean IoU over init's + 0.2 and
    over 0.5, no more lost frames than init's; and stage 1's log must show
    the backbone's optimizer group (``lr/resnet``) in the second half of its
    epochs and not in the first. Returns the xcorr launches of the tool's own process (the scoring: the lr-0 train
    step and the tracking), all fp32 kernels."""
    shutil.rmtree(OVERFIT_ROOT, ignore_errors=True)
    clip, work = OVERFIT_ROOT / "clip", OVERFIT_ROOT / "work"
    write_overfit_clip(clip)
    walls = {}

    def log(msg: str) -> None:
        if m := OVERFIT_WALL.match(msg):
            walls[m.group(1)] = float(m.group(2))
        if not msg.startswith("{"):       # the report's summary: printed below
            print(f"[overfit] {msg}")

    train_log = OVERFIT_ROOT / "train.log"
    reset_launches()
    with stderr_to(train_log):
        report = overfit.main(["--prepare", "--train", "--evaluate", "--task", "mask",
                               "--work-dir", str(work), "--frames-dir", str(clip)], log=log)
    sync_all()
    launches = read_launches()
    check_route("overfit", False)
    runs = train_log_runs(train_log)
    fit, held = report["train_fit"], report["held_out_tracking"]
    for label, run in zip(("stage 1", "stage 2"), runs):
        print(f"[overfit] {label}: {run['steps']} steps of {OVERFIT_BATCH}, "
              f"{walls[label]:.1f} s wall; {run['s_it']:.4f} s/it, "
              f"{OVERFIT_BATCH / run['s_it']:.1f} samples/s on the train CLI's clock "
              f"(halves of its epochs {run['s_it_halves'][0]:.4f} / "
              f"{run['s_it_halves'][1]:.4f} s/it) | " + smi)
    for s in ("init", "trained"):
        f, h = fit[s], held[s]
        print(f"[overfit] {s}: train fit mask_loss {f['mask_loss']:.4f} total_loss "
              f"{f['total_loss']:.4f} iou_at_5 {f['iou_at_5']:.4f} iou_mean "
              f"{f['iou_mean']:.4f}; held-out mean IoU {h['mean_iou']:.4f} (min "
              f"{h['min_iou']:.4f}), lost {h['lost']}")
    print(f"[overfit] wall s: prepare {walls['prepare']:.1f}, stage 1 {walls['stage 1']:.1f}, "
          f"stage 2 {walls['stage 2']:.1f}, evaluate {walls['evaluate']:.1f}; xcorr launches "
          f"of the scoring {launches} (the train CLI's subprocesses not counted)")
    init, trained = fit["init"], fit["trained"]
    gates = {"mask loss under init's / 10": trained["mask_loss"] < init["mask_loss"] / 10,
             "total loss under init's / 10": trained["total_loss"] < init["total_loss"] / 10,
             "held-out mean IoU over init's + 0.2":
                 held["trained"]["mean_iou"] > held["init"]["mean_iou"] + 0.2,
             "held-out mean IoU over 0.5": held["trained"]["mean_iou"] > 0.5,
             "lost no more than init's": held["trained"]["lost"] <= held["init"]["lost"],
             "stage 1 trains the backbone from the unfreeze on, not before":
                 [("resnet" in g) for g in runs[0]["lr_groups_halves"]] == [False, True]}
    failed = [k for k, ok in gates.items() if not ok]
    if failed or len(runs) != 2 or 0 in launches:
        raise AssertionError(f"[overfit] failed: {failed}; {len(runs)} train runs; "
                             f"launches {launches}")
    shutil.rmtree(OVERFIT_ROOT)
    return launches


def run_bench(argv: list[str], timeout: float) -> dict:
    """``python3 -m siammask_tpu_torch.bench <argv>`` from the repo root: its
    result line; its stderr breadcrumbs are printed. Raises unless it exits
    0 with a result line."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, "-m", "siammask_tpu_torch.bench", *argv],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=timeout)
    for line in proc.stderr.splitlines():
        if line.startswith(("bench", "  [")):
            print(f"[bench] {' '.join(argv)}: {line.strip()}")
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"[bench] {' '.join(argv)}: rc={proc.returncode}; "
                             f"{(lines or [''])[-1][:2000]} {proc.stderr[-2000:]}")
    return json.loads(lines[-1])


def check_bench_row(name: str, row: dict, bf16: bool) -> list[int]:
    """A bench row: no error, a value above 0 from at least 5 windows on
    the card, its name and power limit; every xcorr launch of its timed
    windows a kernel's (3 forward a frame, the training steps' forward and
    gradient launches), packed in bf16, none packed in fp32, where TF32 is
    off. Returns its launches (forward, grad-input, grad-kernel)."""
    if "error" in row or not row.get("value", 0) > 0 or row.get("windows", 0) < 5:
        raise AssertionError(f"[bench] {name}: {row}")
    if row["device"] != "cuda" or not row["name"] or not row["power_limit"]:
        raise AssertionError(f"[bench] {name}: device {row['device']}, card {row['name']}, "
                             f"{row['power_limit']}")
    launches = row["xcorr_launches"]
    counts = [launches[k]["launches"] for k in ("forward", "grad_input", "grad_kernel")]
    packed = [launches[k]["packed"] for k in ("forward", "grad_input", "grad_kernel")]
    training = name.startswith("train")
    if counts[0] == 0 or (training and 0 in counts) or packed != (counts if bf16 else [0] * 3):
        raise AssertionError(f"[bench] {name}: xcorr launches {counts}, packed {packed}")
    if not bf16 and row["tf32"]:
        raise AssertionError(f"[bench] {name}: TF32 is on in a float32 row")
    return counts


def phase_bench(smi: str) -> dict:
    """``[bench]``: ``python3 -m siammask_tpu_torch.bench --summary --iters
    BENCH_ITERS`` (the five rows in bf16, a process each), then its scan row
    with ``--fp32``, each row held by ``check_bench_row`` and printed beside
    this run's ms of the same work on the calibrated weights
    (``BENCH_BESIDE``: the bench fills its weights by the JAX bench's rule).
    Returns the rows' launches by path."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    summary = run_bench(["--summary", "--iters", str(BENCH_ITERS)], timeout=600)
    rows = {**summary["summary"],
            "scan_fp32": run_bench(["--scan", str(VIDEO_T), "--fp32", "--iters",
                                    str(BENCH_ITERS)], timeout=150)}
    paths = {}
    for name, row in rows.items():
        bf16 = name != "scan_fp32"
        counts = check_bench_row(name, row, bf16)
        paths[f"bf16_bench_{name}" if bf16 else f"bench_{name}"] = counts
        ms, what, beside = BENCH_BESIDE[name]
        per = (row["device_step_ms"] if "device_step_ms" in row else
               row["device_step_us"] / 1e3)
        lo, hi = ((row["device_step_ms_min"], row["device_step_ms_max"])
                  if "device_step_ms" in row else
                  (row["device_step_us_min"] / 1e3, row["device_step_us_max"] / 1e3))
        flops = (f"{row['model_gflops_per_frame']} GFLOP a frame, MFU {row['mfu_pct']}%"
                 if "model_gflops_per_frame" in row else
                 f"{row['train_gflops_per_step']} GFLOP a step, MFU {row['train_mfu_pct']}%")
        print(f"[bench] {name}: {row['metric']} {row['value']} {row['unit']}; {per:.3f} ms a "
              f"{what} (median of {row['windows']} windows, {lo:.3f}-{hi:.3f}); beside "
              f"{beside} {ms():.3f} ms a {what} in this run; {flops}; xcorr launches "
              f"{counts}, {'all packed bf16' if bf16 else 'fp32 kernels, TF32 off'} | "
              f"{row['name']}, {row['power_limit']}")
    print(f"[bench] headline {summary['metric']} {summary['value']} {summary['unit']}; "
          f"{len(rows)} rows in {time.perf_counter() - t0:.1f} s | {smi}")
    return paths


def phase_trace(smi: str) -> None:
    """``[trace]``: each Chrome trace the profiled calls exported (the fp32
    and bf16 sharp videos, the bf16 16-stream call, the fp32 and bf16
    frozen stage-1 steps) read by ``tools.trace_report``: device ms and
    share by category, the idle time in the window of the device events
    with its three longest gaps, the top two kernels of each category. Its
    xcorr rows must count the kernels the phase expected, and its device
    time (self time summed) must be within 2% of the profile's busy ms.
    The busy time is also given as a share of the untraced call's
    CUDA-event time: tracing adds time between the kernels (and slows
    some). The traces are removed."""
    untraced = {"video": VIDEO_T * MEASURED["video"]["ms_frame"],
                "bf16": VIDEO_T * MEASURED["bf16"]["ms_frame"],
                "bf16-streams": STREAMS_T * MEASURED["bf16-streams"]["ms_frame"],
                "train-frozen": MEASURED["train-timing"]["frozen"][0],
                "bf16-train-frozen": MEASURED["bf16-train-timing"]["frozen"][0]}
    for tag, entry in TRACES.items():
        t0 = time.perf_counter()
        table = trace_report.report(trace_report.load_trace_events(str(entry["path"])))
        got = {row: table["categories"].get(row, {}).get("calls", 0) for row in XCORR_ROWS}
        want = {row: entry["xcorr"].get(row, 0) for row in XCORR_ROWS}
        if got != want:
            raise AssertionError(f"[trace] {tag}: xcorr kernels by row {got}, expected {want}")
        if not abs(table["total_ms"] - entry["busy"]) <= 0.02 * entry["busy"]:
            raise AssertionError(f"[trace] {tag}: {table['total_ms']:.3f} ms of device time in "
                                 f"the trace, {entry['busy']:.3f} ms in the profile")
        print(f"[trace] {tag}: device time {table['total_ms']:.3f} ms (the profile's "
              f"{entry['busy']:.3f}); window {table['window_ms']:.3f} ms, busy "
              f"{table['busy_ms']:.3f}, idle {table['idle_ms']:.3f} ms "
              f"({100 * table['idle_share']:.1f}%), longest gaps "
              + ", ".join(f"{d:.3f} ms at +{s:.3f}" for s, d in table["gaps"])
              + "; gaps by size " + ", ".join(f"< {edge:g} us {n} ({ms:.3f} ms)"
                                              for edge, n, ms in table["gap_bins"])
              + f"; the untraced call {untraced[tag]:.3f} ms by CUDA events, the traced "
              f"busy time {100 * table['busy_ms'] / untraced[tag]:.1f}% of it; xcorr rows "
              f"{({k: v for k, v in got.items() if v})}; read in "
              f"{time.perf_counter() - t0:.2f} s | {smi}")
        for cat, row in table["categories"].items():
            top = [n for n, op in table["ops"].items() if op["category"] == cat][:2]
            print(f"[trace] {tag} | {cat}: {row['ms']:.3f} ms, {100 * row['share']:.1f}%, "
                  f"{row['calls']} calls; top: " + " ; ".join(n[:90] for n in top))
    shutil.rmtree(TRACE_DIR)


def main() -> None:
    t_start = time.monotonic()
    smi = phase_device()
    phase_build()
    strip, packed = phase_kernels()
    strip_input, grad_kernel, packed_input, packed_grad_kernel = phase_grad_kernels()
    records = [strip, strip_input, grad_kernel, packed, packed_input, packed_grad_kernel]
    p = Config.load(str(CONFIG)).tracker_config()
    model, tracker, frames = build_model(p)
    cpu_tracker = cpu_tracker_of(tracker)
    state, track_launches = phase_slice(tracker, frames)
    phase_cpu_parity(tracker, cpu_tracker, state, frames[STEPS + 2])
    phase_timing(tracker, state, frames[STEPS + 2:], smi)
    video_launches, video_state = phase_video(tracker, frames, smi)
    streams_launches, states = phase_streams(tracker, frames, smi)
    phase_streams_cpu_parity(tracker, cpu_tracker, states, frames[2])
    one = TrackState(video_state.target_pos[None], video_state.target_sz[None],
                     video_state.zf, video_state.avg_chans[None], video_state.score[None])
    phase_layers(tracker, torch.from_numpy(frames[2]).cuda(), one, states)
    vos_launches = phase_vos(model, p, smi)
    bf16_vos_launches = phase_bf16_vos(model, p, smi)
    del tracker, cpu_tracker, state, states, video_state, one
    torch.cuda.empty_cache()
    rpn_model, rpn_launches = phase_family("rpn", SiamRPN, RPN_CONFIG, False, False, smi)
    torch.cuda.empty_cache()
    base_model, base_launches = phase_family("base", SiamMaskBase, BASE_CONFIG, True, False, smi)
    torch.cuda.empty_cache()
    vot_models = {"sharp": model, "base": base_model, "rpn": rpn_model}
    vot_launches, lost_by_tracker = phase_vot(vot_models, smi)
    bf16_vot_launches = phase_bf16_vot(vot_models, smi)
    del model, rpn_model, base_model, vot_models
    torch.cuda.empty_cache()
    bf16_paths = phase_bf16(smi)
    torch.cuda.empty_cache()
    tune_launches, tune_scores = phase_tune(smi)
    phase_eval(tune_scores, lost_by_tracker)
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
    phase_train_parity(lambda device: Trainer(loaded_model(SiamMaskBase, init_state, device),
                                              *train_parts(cfg), epochs=TRAIN_EPOCHS),
                       init_state, batch)
    phase_train_profile(trainer, batch)
    phase_train_timing(trainer, batch, smi)
    bf16_train_launches = phase_bf16_train(init_state, batch, cfg, smi)
    phase_trace(smi)
    torch.cuda.empty_cache()
    dp_launches = phase_dp(init_state, batch, smi)
    bf16_dp_launches = phase_bf16_dp(init_state, batch, smi)

    # the data pipeline and the other training tasks, on a synthetic set
    shutil.rmtree(SMOKE_TRAIN, ignore_errors=True)
    root, anno = write_crop_dataset(SMOKE_TRAIN / "crop511")
    configs = {"sharp": train_data_config(SHARP_TRAIN_CONFIG, root, anno, 8 * TRAIN_BATCH),
               "rpn": train_data_config(RPN_CONFIG, root, anno, 8 * TRAIN_BATCH)}
    loaded = phase_data(configs)
    train_refine_launches, refine_state, refine_batch = phase_train_refine(
        trainer, configs["sharp"], loaded["sharp"], smi)
    del trainer, train_model, batch
    torch.cuda.empty_cache()
    bf16_refine_launches = phase_bf16_train_task(
        "bf16-train-refine", lambda dtype: task_trainer(
            configs["sharp"], "sharp_refine",
            loaded_model(SiamMaskSharp, refine_state, DEV, dtype)),
        refine_state, refine_batch, (0, 0, 1), [3, 1, 1], ((1, "stage-2"),),
        "train-refine-timing", smi)
    del refine_batch
    torch.cuda.empty_cache()
    train_rpn_launches, rpn_state, rpn_batch = phase_train_rpn(configs["rpn"], loaded["rpn"], smi)
    torch.cuda.empty_cache()
    bf16_rpn_launches = phase_bf16_train_task(
        "bf16-train-rpn", lambda dtype: task_trainer(
            configs["rpn"], "siamrpn", loaded_model(SiamRPN, rpn_state, DEV, dtype)),
        rpn_state, rpn_batch, (0, 0, 1), [2, 2, 2], ((0, "frozen"), (1, "unfrozen")),
        "train-rpn-timing", smi)
    del rpn_batch
    torch.cuda.empty_cache()
    phase_train_resume(configs["rpn"], rpn_state, loaded["rpn"])
    phase_train_cli({"base": train_data_config(TRAIN_CONFIG, root, anno, 2 * TRAIN_BATCH),
                     "sharp": configs["sharp"]})
    shutil.rmtree(SMOKE_TRAIN)
    torch.cuda.empty_cache()
    overfit_launches = phase_overfit(smi)
    torch.cuda.empty_cache()
    sharded_launches = phase_sharded(p, smi)
    torch.cuda.empty_cache()
    bench_paths = phase_bench(smi)

    # the forward also runs on the video and 16-stream paths, by graph replay
    paths = {"track": track_launches, "video": [video_launches, 0, 0],
             "streams16": [streams_launches, 0, 0], "vos": [vos_launches, 0, 0],
             "rpn": [rpn_launches, 0, 0], "base": [base_launches, 0, 0],
             "vot": [vot_launches, 0, 0], "tune": [tune_launches, 0, 0],
             "train": train_launches,
             "train_refine": train_refine_launches, "train_rpn": train_rpn_launches,
             "dp": dp_launches, "overfit": overfit_launches,
             "sharded": [sharded_launches, 0, 0],
             **bf16_paths, "bf16_vos": [bf16_vos_launches, 0, 0],
             "bf16_vot": [bf16_vot_launches, 0, 0], "bf16_train": bf16_train_launches,
             "bf16_train_refine": bf16_refine_launches, "bf16_train_rpn": bf16_rpn_launches,
             "bf16_dp": bf16_dp_launches, **bench_paths}
    # by kernel: check_route held every bf16 path's launches to the packed
    # kernels and every fp32 path's to the fp32 kernels
    by_kernel = {k: [0, 0, 0, *v] if k.startswith("bf16") else [*v, 0, 0, 0]
                 for k, v in paths.items()}
    for i, record in enumerate(records):
        record["launches_by_path"] = {k: v[i] for k, v in by_kernel.items()}
        record["launches"] = sum(record["launches_by_path"].values())
    print("[launches] " + ", ".join(f"{k} {v}" for k, v in by_kernel.items())
          + " (strip forward, strip grad-input, grad-kernel, packed bf16 forward, packed bf16 "
          "grad-input, packed bf16 grad-kernel)")
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms", "launches_by_path", "stage2", "local_batches",
             "bf16_scalar", "by_shape"]
    print(f"[time] the card held {time.monotonic() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [{key: r[key] for key in order if key in r} for r in records]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
