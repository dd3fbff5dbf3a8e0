#!/usr/bin/env python3
"""Card checks of the PyTorch port on one NVIDIA card: ``python3 chip_smoke.py``.

Drives the port's main paths at the published width (64; 127x127
template, 255x255 search, 25x25x5 anchors) in fp32 with TF32 off, and then
in the bf16 compute mode (bf16 activations over float32 weights), on
synthetic uint8 frames made from a numpy seed, with seeded random weights
(``tests/_torch_weights.py``), and checks each against a reference: its
plain version, the eager loop, the CPU, the fp32 run or the JAX recipe's
numbers. It measures no speed of the port: ``perfbench/run.py`` does. Its
only times are the hand-written kernels' own (phases 3 and 4) beside their
bounds and the one library call that computes the same function.

The paths:

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
- the metric-level parity harness (``siammask_tpu_torch.tools.metric_parity``):
  the VOT reset protocol and VOS fusion over a pseudo-benchmark of two
  105-frame videos, the card against the CPU in float32 and bf16 against
  float32, scored as EAO/A/R and J/F;
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
4b. ``[bn-train]`` (``phase_bn_train``): the train-mode BatchNorm kernels
   (``ops/bn_train.py``) at each BN shape and chain (ReLU, residual) of an
   unfrozen SiamMask-base step at batch 64 (``BN_STEP``): the output and dx
   within one bf16 step of the plain version; each kernel's time beside its
   bytes' bound; the forward and the backward against the plain version's
   and against ATen's ``F.batch_norm`` -> add -> ReLU; the sums over a step;
5. the track slice: init + steps, with finite outputs in bounds, three xcorr
   kernel launches per step, and one step under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync);
6. the same track step on the card and on the CPU from the same state, open
   loop;
7. the video: ``track_video`` over 64 frames on the card against the eager
   ``step`` loop from the same state (the same ``best_id`` at every frame,
   every output bit-identical), one call under ``sync_debug_mode("error")``,
   3 xcorr kernels a frame by name in a profiled call;
8. 16 streams: ``init_batched`` (centres U(100, 400), sizes U(60, 200)),
   ``step_batched`` with 3 xcorr launches at B=16 and each stream against
   the single-stream ``step`` from the same state, ``track_video_multi``
   over 32 frames against the eager ``step_batched`` loop (bit-identical),
   3 xcorr kernels a frame by name in a profiled graph call;
9. ``step_batched`` at O=2 on the card and on the CPU from the same state,
   open loop;
10. the VOS drivers: ``track_vos_batched`` (ragged stretches through
    ``step_batched``, one full window through the graph, a re-init at the
    late start; 3 xcorr launches a frame) against ``track_vos``, the late
    object absent before its start; skipped, with a line that says so,
    where cv2 or PIL is not installed; then ``[bf16-vos]``: the batched
    driver with a bf16 twin of the weights, its per-object mean IoU beside
    the fp32 run's and the two runs' fused masks' IoU;
11. ``[rpn]``: SiamRPN (``experiments/siamrpn_resnet/config.json``, BN
    calibrated as for sharp) as phases 5, 6 and 7 run sharp: init + steps
    with 2 xcorr launches a step, one under ``sync_debug_mode("error")``;
    one step card vs CPU; ``track_video`` over 64 frames through the graph,
    bit-identical to the eager loop, 2 xcorr kernels a frame by name;
12. ``[base]``: SiamMask-base with ``refine=False``
    (``experiments/siammask_base/config.json``, out_size 63), the same with 3
    launches a step, and ``step_batched`` at O=2 card vs CPU;
13. ``[vot]``: ``track_vot`` for sharp (mask + Refine), base (mask) and
    SiamRPN (box) on two 40-frame 480x854 VOT2018-layout videos; in one the
    target and its gt jump far outside the search region at frame 20, which
    forces a lost frame (2), four skipped (0) and a re-init (1) whatever the
    weights (the box heads damped by ``damp_box_head``, so that the target is
    still held when the jump comes and the forced sequence shows; other
    losses may occur and are counted); the region library built before the
    drivers run; the result files checked line by line, the xcorr launches
    against the stepped frames; then the CLI's ``main`` with the sharp
    weights as a ``.pth``, its results against the driver's; cv2 is
    required; the data, the result trees and the sharp ``.pth`` stay for
    phases 14-15; then ``[bf16-vot]``: the three drivers with bf16 twins of
    the same weights, each video's lost count equal to the fp32 run's, the
    largest drift in px between the bf16 and fp32 regions' centres; then
    ``[bf16]``: SiamMask-sharp in bf16 (the calibrated weights, their cls
    head sharpened: ``sharpen_cls_head``) as phases 5, 6, 7 and 8 run it in
    fp32, card vs CPU at bf16 tolerances (``BF16_*``; ``[bf16-parity]``,
    which also prints the size difference as a share of the size over the
    first six steps from init: ``bf16_size_shares``), the graph videos
    bit-identical to their eager loops and every xcorr kernel in their
    traces the packed bf16 kernel, and SiamRPN and base graph videos in
    bf16;
14. ``[tune]``: ``tools.tune.main`` with that ``.pth`` (SiamMask-sharp at
    width 64): a VOT grid over the two videos (penalty_k 0.04 / 0.12 x lr
    0.30 / 0.45 at instance_size 255, then one cell at 271; EAO over frames
    1-40, since the standard 100-356 window is empty on 40 frames) and a VOS
    grid over phase 10's video (seg_thr 0.30 / 0.40, ``track_vos_batched``);
    each cell's score, the chosen cells, the xcorr launches against the
    frames stepped, the memory allocated after the first and the last cell
    (no runtime outlives its cell); the VOT grid run again over the same
    out-dir scores 0 cells (the claim protocol);
15. ``[eval]``: ``tools.eval.main`` (a spawned process pool; no card) over
    phase 14's VOT tree (each cell's EAO equal to the score ``tune``
    recorded), phase 13's trees (each family's lost number equal to its
    driver's, the CLI's too) and phase 10's fused PNGs beside a copy of the
    annotations (J and F in [0, 1]; the copy J = F = 1);
16. the training slice: per step finite losses, no skip, 3 + 3 + 3 kernel
    launches, the frozen stages bit-identical and the trainable ones moved;
    then the loss falling over 8 steps on the repeated batch;
17. one training step on the card and on the CPU from the same weights and
    batch (B=2), open loop;
18. the profile of one frozen and one unfrozen step (no backbone backward
    while frozen); then ``[bf16-train]``: the same step computing in bf16
    from the same weights, its first step against the fp32 one (loss,
    update cosine), 2 frozen and 2 unfrozen steps with 3 / 3 / 3 bf16
    launches, and a profiled step whose xcorr kernels are all packed;
19. ``[data]``: 8 batches of 64 from ``PairDataset(seed)`` through
    ``DataLoader`` for the stage-2 and the SiamRPN config, with thread and
    with process workers (min(16, cores)): the two modes' batches
    bit-identical;
20. ``[train-refine]``: stage 2 warm-started from the stage-1 trainer's
    checkpoint (``merge_state_dict`` reports exactly the ``refine_model.*``
    entries missing), 4 steps on loader batches through ``to_device`` with
    3 / 1 / 1 launches each, backbone, neck and RPN bit-identical
    (parameters and BN buffers), the unused mask head moved by weight decay
    alone; the loss over 8 repeated steps; card vs CPU at B=2, both held to
    the CPU's float64 step; the xcorr kernels by name in a profile; then
    ``[bf16-train-refine]``: the same task in bf16 from the same warm start
    and loader batch, its first step against the fp32 one (loss, update
    cosine; ``bf16_first_step``), two more steps with 3 / 1 / 1 launches,
    all of them the packed bf16 kernels;
21. ``[train-rpn]``: SiamRPN, 2 frozen and 2 unfrozen steps on loader
    batches with 2 / 2 / 2 launches each, card vs CPU at B=2, the xcorr
    kernels by name in a profile of each phase; then ``[bf16-train-rpn]``
    as ``[bf16-train-refine]`` (a frozen first step, a frozen and an
    unfrozen one after it, 2 / 2 / 2 launches);
22. ``[train-resume]``: 2 SiamRPN steps, a checkpoint, ``Trainer.restore``
    into a fresh trainer, then step 3 bit-identical (weights, BN statistics,
    momentum) to the uninterrupted run, in phase and across the unfreeze
    boundary (where the restore warns and momentum restarts);
23. ``[train-cli]``: ``tools.train.main`` for SiamMask-base (one epoch of 2
    steps), then ``sharp_refine --pretrained`` its checkpoint, then
    ``--resume``: finite losses and a checkpoint from each;
24. ``[dp]`` (run after phase 18): SiamMask-base stage 1 from phase 16's
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
    rank, collectives a step; with two cards or more, NCCL over up to four
    and over one at global batch 64 and 256 (the ranks' states
    bit-identical), then ``tools.train --num-devices`` over all; then
    ``[bf16-dp]``: the two ranks, three modes and two steps again on the
    bf16 twin of the weights, every launch packed, the default mode held to
    the single-process bf16 step within this run's bf16 noise (its updates
    and BN statistics no further from it than it is from the float32 step,
    the loss within 1e-3), the fused modes by direction; with two cards or
    more, NCCL in bf16 as in float32;
25. ``[overfit]`` (run after phase 23): ``siammask_tpu_torch.tools.overfit
    --prepare --train --evaluate --task mask`` at width 64 with the tool's
    schedule (stage 1: 16 epochs of 64 steps of 8 across the unfreeze;
    stage 2: 24 epochs) on a 70-frame 480x854 clip written under
    ``build/`` (``write_overfit_clip``: a textured ellipse along the
    tool's keyframe boxes), the train CLI's logs in a file there: the
    report's fit and held-out numbers, which must clear
    ``tests/test_overfit_artifact.py``'s thresholds (mask and total loss
    under init's / 10; held-out mean IoU over init's + 0.2 and over 0.5;
    no more lost frames than init's), and stage 1's log must show the
    backbone's optimizer group from the unfreeze on and not before (those
    thresholds alone pass a stage 1 that never unfreezes and a stage-2
    warmup 10x too high; they catch a warm start that drops the RPN), and
    each logged ``lr/<group>`` of each stage must be ``build_lr_spaces`` of
    the recipe's schedule (``OVERFIT_SCHEDULES``) at its epoch times the
    group's multiplier;
    the xcorr launches of the tool's
    own process (its lr-0 train steps and tracking), every kernel at
    least once;
26. ``[sharded]``: SiamMask-sharp, 16 streams on 480x854 frames over 32,
    through ``ShardedStreamServer`` over [cuda:0, cuda:0]: bit-identical to
    each replica's tracker on its 8 streams; against the unsharded
    ``track_video_multi`` at O=16 the same best_id at every frame and
    stream, positions, scores, cell masks and sizes within
    ``tests/test_serving_sharded.py``'s tolerances, and the masks in the
    frame within them once the unsharded cell masks are warped at the
    sharded run's positions (the warp at the unsharded positions is printed
    beside: a position within its tolerance moves the pixels on a mask's
    edge); 3 xcorr kernels a frame a replica by name in a profile; with
    two cards or more, 16 streams a card over all of them, card 0's
    against one card;
27. ``[metric-parity]`` (run after phase 15):
    ``siammask_tpu_torch.tools.metric_parity`` on SiamMask-sharp at width
    64, seeded weights tempered on the card (LSUV): the card in float32
    makes the pseudo-benchmark (two 105-frame videos that reorder the
    first 36 frames of ``write_overfit_clip``'s clip, their gt its own
    no-reset trajectory displaced over two 5-frame windows each, and those
    frames' VOS masks) and
    runs the VOT reset protocol in box mode; the CPU runs it in the same
    process and must make the same protocol decisions (marker lines: lost,
    skipped and re-init frames) with a mean per-frame box overlap of at
    least ``MP_MIN_IOU``; bf16 on the card runs it, and its EAO/A/R/lost
    deltas to float32 (the bf16 deployment delta) and both runs' reset
    frames are printed; then the mask-polygon protocol and VOS fusion in
    float32 and bf16 on the card, EAO/A/lost and J/F printed with their
    deltas, not held; xcorr launches 2 a tracked frame in box mode and 3
    with the mask, packed in bf16.

Before the card's line, ``[time]`` gives the seconds the script held the
card. The last line is ``{"ok": true, "device": {...}}``; the line before it lists
each kernel with its launches on the main paths, error, times, bound and
the time of the one library call (cuDNN's grouped conv) that computes the
same function, with ``launches_by_path`` (track, video, streams16, vos,
rpn, base, vot, tune, metric_parity, train, train_refine, train_rpn, dp:
rank 0's of the two-rank run, overfit: the overfit tool's scoring, not its
train CLI subprocesses, sharded, and the bf16 paths bf16_track,
bf16_video, bf16_streams16, bf16_rpn, bf16_base, bf16_vos, bf16_vot,
bf16_metric_parity, bf16_train, bf16_train_refine, bf16_train_rpn,
bf16_dp: rank 0's of the two-rank run).
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
which phases 7, 8, 11, 12 and 26 confirm by kernel name in a profiler trace.
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
from siammask_tpu_torch.tools import overfit
from siammask_tpu_torch.tools.overfit import write_overfit_clip
from siammask_tpu_torch.tools import train as train_cli
from siammask_tpu_torch.train.checkpoint import merge_state_dict, read_state_dict, save_checkpoint
from siammask_tpu_torch.train.lr import build_lr_spaces
from siammask_tpu_torch.train.trainer import OptimizerConfig, Trainer, TrainSettings

REPO = Path(__file__).resolve().parent
# the seeded weights the CPU and card tests share: tests/ is no package, so
# its helpers import as top-level modules, as under pytest
sys.path.insert(0, str(REPO / "tests"))
from _torch_weights import (BF16, BF16_MAP_TOL, FRAME_HW, FRAMES, SEED, TARGET_POS,  # noqa: E402
                            TARGET_SZ, bf16_steps_over, bf16_twin, bn_calibration,
                            build_model, check_step_close, damp_box_head, eager_step,
                            head_maps, relu_ties)
CONFIG = REPO / "experiments" / "siammask_sharp" / "config_davis.json"
TRAIN_CONFIG = REPO / "experiments" / "siammask_base" / "config.json"
RPN_CONFIG = REPO / "experiments" / "siamrpn_resnet" / "config.json"
BASE_CONFIG = TRAIN_CONFIG
VOT_CONFIG = REPO / "experiments" / "siammask_sharp" / "config_vot.json"
STEPS = 20
VIDEO_T = FRAMES - 1
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
# the bf16 train step against the float32 one from the same weights and batch
# (2.7e-4 and 0.9935 on an H100; a wrong gradient gives a cosine near 0)
BF16_TRAIN_LOSS_RTOL = 1e-2
BF16_TRAIN_MIN_COS = 0.9   # cosine of the two steps' parameter updates
# [overfit]: the tool's work tree, its default batch, a train CLI step line
# (its timestamp, epoch and step), an optimizer group's LR on it,
# a stage's wall-time line of the tool
OVERFIT_ROOT = REPO / "build" / "overfit_smoke"
OVERFIT_BATCH = 8
OVERFIT_STEP = re.compile(r"^(\S+ \S+) INFO epoch (\d+) step (\d+) ")
OVERFIT_GROUP = re.compile(r" lr/(\w+)=([0-9.eE+-]+)")
OVERFIT_WALL = re.compile(r"^(.+): ([0-9.]+) s wall$")
# the overfit recipe's LR schedule and epochs a stage (tools/overfit.py's
# stage configs and --epochs1 / --epochs2), which [overfit] holds the rates
# its train CLI logs to; the log prints a rate with 6 decimals
OVERFIT_SCHEDULES = {
    "stage 1": ({"type": "log", "start_lr": 0.005, "end_lr": 0.001}, 16),
    "stage 2": ({"type": "log", "start_lr": 0.003, "end_lr": 0.001,
                 "warmup": {"start_lr": 0.001, "end_lr": 0.003, "type": "step", "step": 1,
                            "epoch": 2}}, 24),
}
OVERFIT_LR_ATOL = 6e-7
# [metric-parity]: the harness's work tree; the clip frames its benchmark
# uses (two videos of 3 * MP_FRAMES - 3 frames: 105, the fewest over the
# EAO interval's 100 that the CPU's half, the phase's cost, allows); the
# least mean overlap of the card's and the CPU's float32 boxes
MP_ROOT = REPO / "build" / "metric_parity_smoke"
MP_FRAMES = 36
MP_MIN_IOU = 0.99


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
    path = _build.build()
    _build.load_library()
    print(f"[build] {path.relative_to(REPO)} ready")
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


# (C, R, relu, residual, calls a step): every train-mode BN call of an
# unfrozen SiamMask-base step at batch 64 (the template's and the search's
# layer2 and layer3, the neck's, the heads'), 75 in all
BN_STEP = [(128, 14400, True, False, 7), (128, 61504, True, False, 8),
           (128, 254016, True, False, 1), (256, 1600, True, False, 3),
           (256, 14400, False, False, 1), (256, 14400, True, False, 12),
           (256, 40000, True, False, 3), (256, 53824, True, False, 3),
           (256, 61504, False, False, 1), (256, 61504, True, False, 12),
           (512, 14400, False, False, 1), (512, 14400, True, True, 4),
           (512, 61504, False, False, 1), (512, 61504, True, True, 4),
           (1024, 14400, False, False, 1), (1024, 14400, True, True, 6),
           (1024, 61504, False, False, 1), (1024, 61504, True, True, 6)]


def _bn_rows(rows: int) -> tuple[int, int, int]:
    """(N, H, W) of ``rows`` rows at batch 64 (a square map), else (1, rows, 1)."""
    side = math.isqrt(rows // 64)
    return (64, side, side) if 64 * side * side == rows else (1, rows, 1)


def _bn_chain_aten(x, z, w, b, mean, var, relu):
    out = F.batch_norm(x, mean, var, w, b, True, 0.1, 1e-5)
    out = out if z is None else out + z
    return F.relu(out, inplace=True) if relu else out


def phase_bn_train() -> dict:
    """``[bn-train]``: each chain of ``BN_STEP`` once: the kernels' output and
    dx against the plain version (one bf16 step, ``check_bn_step``; dx
    without the ReLU's ties, ``_torch_weights.relu_ties``), each
    kernel's device time (``graph_us``) beside its bytes' bound at
    ``PEAK_BYTES_PER_S``, the forward (statistics + normalise) and backward
    (reduction + elementwise) against the plain version's and ATen's chain,
    timed in turns (ATen, kernels, kernels, ATen; each side its faster
    turn; the backward as forward-and-backward less the forward). Prints a
    line a chain and the sums over a step; returns them."""
    from siammask_tpu_torch.ops import bn_train

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    per_step = {"kernels_ms": 0.0, "bound_ms": 0.0, "aten_ms": 0.0, "plain_ms": 0.0}
    rows_out = []
    for c, rows, relu, residual, calls in BN_STEP:
        n, h, w = _bn_rows(rows)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=DEV)

        x, z, dy = ((randn(n, c, h, w) * 2 + 0.5).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last) for _ in range(3))
        z = z if residual else None
        w, b = 1 + 0.3 * randn(c), 0.2 * randn(c)
        stats = [randn(c), randn(c).abs() + 0.5]
        mask = ((bn_train._MASK_FROM_Y if residual else bn_train._MASK_RECOMPUTE) if relu
                else bn_train._MASK_NONE)
        mean, invstd = bn_train.batch_stats(x, *stats, 0.1, 1e-5)
        y = bn_train.normalize(x, mean, invstd, w, b, z, relu)
        sums, g = bn_train.backward_reduce(dy, x, y, mean, invstd, w, b, mask)
        dx = bn_train.backward_elemt(g, x, mean, invstd, w, b, sums,
                                     mask == bn_train._MASK_RECOMPUTE)
        xr = x.detach().requires_grad_()
        ref = bn_train.bn_train_reference(xr, w, b, *[s.clone() for s in stats], 0.1, 1e-5, z,
                                          relu)
        (ref_dx,) = torch.autograd.grad(ref, xr, dy)
        check_bn_step(f"bn-train C={c} R={rows} y", y, ref)
        check_bn_step(f"bn-train C={c} R={rows} dx", dx, ref_dx,
                      relu_ties(x, z, w, b, 1e-5) if relu else None)

        m = x.numel() * x.element_size()
        nbytes = {"stats": m, "apply": (3 if residual else 2) * m,
                  "reduce": (4 if relu and residual else 2) * m, "elemt": 3 * m}
        t = {"stats": graph_us(bn_train.batch_stats, x, *stats, 0.1, 1e-5),
             "apply": graph_us(bn_train.normalize, x, mean, invstd, w, b, z, relu),
             "reduce": graph_us(bn_train.backward_reduce, dy, x, y, mean, invstd, w, b, mask),
             "elemt": graph_us(bn_train.backward_elemt, g, x, mean, invstd, w, b, sums,
                               mask == bn_train._MASK_RECOMPUTE)}
        bound = {k: v / PEAK_BYTES_PER_S * 1e6 for k, v in nbytes.items()}

        def chain(fn):
            """(forward, forward and backward) of ``fn`` from fresh leaves,
            made in the call so that autograd runs on the capturing stream."""
            def forward():
                ins = [t.detach().requires_grad_() for t in (x, w, b, z) if t is not None]
                return ins, fn(ins[0], ins[3] if residual else None, ins[1], ins[2], *stats,
                               relu)

            def both():
                ins, out = forward()
                return torch.autograd.grad(out, ins, dy)
            return forward, both

        def ours(xx, zz, ww, bb, mm, vv, rr):
            return bn_train.bn_train(xx, ww, bb, mm, vv, 0.1, 1e-5, zz, rr)

        def plain(xx, zz, ww, bb, mm, vv, rr):
            return bn_train.bn_train_reference(xx, ww, bb, mm, vv, 0.1, 1e-5, zz, rr)

        sides = {"aten": chain(_bn_chain_aten), "kernels": chain(ours), "plain": chain(plain)}
        times = {}      # side: (forward, backward = forward and backward less forward)
        for side in ("aten", "kernels", "kernels", "aten", "plain"):
            fwd, both = (graph_us(f, n=20) for f in sides[side])
            old = times.get(side, (math.inf, math.inf))
            times[side] = (min(old[0], fwd), min(old[1], both - fwd))
        record = {"c": c, "rows": rows, "relu": relu, "residual": residual, "calls": calls,
                  "kernel_us": t, "bound_us": bound,
                  "share_of_bound": {k: bound[k] / t[k] for k in t},
                  "forward_us": {k: v[0] for k, v in times.items()},
                  "backward_us": {k: v[1] for k, v in times.items()}}
        rows_out.append(record)
        print(f"[bn-train] C={c} R={rows} relu={relu} residual={residual} x{calls}: "
              + ", ".join(f"{k} {t[k]:.1f} us ({100 * bound[k] / t[k]:.0f}% of "
                          f"{bound[k]:.1f})" for k in t)
              + "; forward / backward us: " + ", ".join(
                  f"{k} {v[0]:.1f} / {v[1]:.1f}" for k, v in times.items()))
        per_step["kernels_ms"] += calls * sum(t.values()) / 1e3
        per_step["bound_ms"] += calls * sum(bound.values()) / 1e3
        per_step["aten_ms"] += calls * sum(times["aten"]) / 1e3
        per_step["plain_ms"] += calls * sum(times["plain"]) / 1e3
        del x, z, dy, y, g, dx, ref, ref_dx, sides
    share = 100 * per_step["bound_ms"] / per_step["kernels_ms"]
    print(f"[bn-train] a step's 75 chains: kernels {per_step['kernels_ms']:.3f} ms (bound "
          f"{per_step['bound_ms']:.3f} ms, {share:.0f}%), ATen's chain "
          f"{per_step['aten_ms']:.3f} ms, plain {per_step['plain_ms']:.3f} ms")
    return {"per_step": per_step, "chains": rows_out}


def check_bn_step(what: str, out: torch.Tensor, ref: torch.Tensor, skip=None) -> None:
    """Each element within one bf16 step of the plain version's
    (``_torch_weights.bf16_steps_over``), ``skip`` left out."""
    over = bf16_steps_over(out, ref, skip)
    if over:
        raise AssertionError(f"[{what}] {over} elements more than one bf16 step off")
    print(f"[{what}] within one bf16 step; {int((out != ref).sum())} of {out.numel()} differ"
          + ("" if skip is None else f", {int(skip.sum())} ReLU ties left out"))


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


def train_step_launches(trainer: Trainer, batch: dict, epoch: int) -> tuple[dict, list[int]]:
    """One ``trainer.step`` (its metrics read to the host) and its xcorr
    launches (forward, grad-input, grad-kernel): through the wrappers where
    it ran eagerly or captured its graph, else the replayed graph's
    captured launches."""
    before = read_launches()
    metrics = {k: v.item() for k, v in trainer.step(batch, epoch).items()}
    counts = [a - b for a, b in zip(read_launches(), before)]
    if not any(counts) and trainer.graphs:
        counts = list(next(reversed(trainer.graphs.values())).xcorr_launches)
    return metrics, counts


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


def profiled(call):
    """The averaged events of one call under torch.profiler (host and card)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return prof.key_averages()


def xcorr_kernels(what: str, call, expected: int) -> dict:
    """The xcorr kernels by name in the trace of one call, ``expected`` in
    all. A trace has come back short of a few kernels (189 of 192 once on
    an H100, the replays all bit-identical to the eager loop): a short
    trace is taken once more before the check fails."""
    for attempt in (1, 2):
        names = {e.key: e.count for e in profiled(call)
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "depthwise_xcorr" in e.key}
        got = sum(names.values())
        if got == expected:
            return names
        if attempt == 2 or got > expected:
            raise AssertionError(f"[{what}] {got} xcorr kernels in the trace, expected "
                                 f"{expected}: {names}")
        print(f"[{what}] the profiler's trace held {got} of {expected} xcorr kernels; "
              "profiling the call once more")


def check_graph_profile(what: str, call, frames: int, per_frame: int = 3,
                        bf16: bool = False) -> None:
    """Confirms ``per_frame`` xcorr kernels a frame by kernel name in the
    trace of one graph call (the wrappers count a graph's kernels only at
    capture), with ``bf16`` every one of them the packed bf16 kernel."""
    names = xcorr_kernels(what, call, per_frame * frames)
    packed = sum(n for k, n in names.items() if "depthwise_xcorr_strip_bf16x2_kernel" in k)
    if bf16 and packed != per_frame * frames:
        raise AssertionError(f"[{what}] {packed} of {per_frame * frames} xcorr kernels in the "
                             "trace are the packed bf16 kernel")
    print(f"[{what}] profiled call: {per_frame * frames} xcorr kernels by name "
          f"({per_frame} a frame), {packed} of them the packed bf16 kernel")


def phase_video(tracker: Tracker, frames: np.ndarray, tag: str = "video") -> int:
    """track_video over VIDEO_T frames on the card: a CUDA-graph replay per
    frame, against the eager step loop; returns the xcorr launches of the
    graph path (captured launches times replays)."""
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
          f"loop; the second call ran under sync_debug_mode=error")
    check_graph_profile(tag, lambda: tracker.track_video(state, dev[1:]), t, per_frame,
                        tracker.model.dtype == BF16)
    return graph.xcorr_launches * t


def stream_state(states: TrackState, i: int) -> TrackState:
    return TrackState(states.target_pos[i], states.target_sz[i], states.zf[i:i + 1],
                      states.avg_chans[i], states.score[i])


def phase_streams(tracker: Tracker, frames: np.ndarray, tag: str = "streams",
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
    print(f"[{tag}] track_video_multi, O={o}, T={t}: {graph.xcorr_launches * t} xcorr "
          f"launches by replay at B={o}; best_id and every output bit-identical to the eager "
          "step_batched loop")
    check_graph_profile(tag, lambda: tracker.track_video_multi(states, dev[1:]), t,
                        bf16=tracker.model.dtype == BF16)
    return step_launches[0] + graph.xcorr_launches * t, stepped


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


def phase_vos(model: SiamMaskSharp, p) -> tuple[int, np.ndarray | None]:
    """The VOS drivers on the card, through ``load_dataset`` as a user calls
    them: ``track_vos_batched`` (scan_chunk VOS_CHUNK: ragged stretches
    through ``step_batched``, a full window through the CUDA graph, a re-init
    of the late object) against the sequential ``track_vos``. The video and
    the batched driver's fused PNGs stay under VOS_ROOT for ``[tune]`` and
    ``[eval]``. Returns its xcorr launches (through the wrapper and by
    replay) and its IoU, None where it is skipped. Needs cv2 and PIL, the
    drivers' image I/O."""
    try:
        import cv2  # noqa: F401
        import PIL  # noqa: F401
    except ImportError as e:
        print(f"[vos] skipped: the VOS drivers' image I/O is not installed ({e})")
        return 0, None
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
    iou_b, _ = track_vos_batched(runtime, video, scan_chunk=VOS_CHUNK,
                                 result_dir=str(root / "results"), dataset="ytb_vos",
                                 save_mask=True, log=lambda *_: None)
    launches = read_launches()
    graph = runtime.tracker.graphs[(3, *FRAME_HW, torch.uint8)]
    check_route("vos", False, graph)
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
    iou_s, _ = track_vos(runtime, video, log=lambda *_: None)
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
    return 3 * VOS_RAGGED + graph.xcorr_launches * VOS_FULL, iou_b


def phase_family(tag: str, cls, config: Path, mask: bool, refine: bool):
    """Another model family through the port's tracker on the card, as the
    sharp phases 5, 6 and 7 drive SiamMask-sharp: init and STEPS steps (one
    under sync_debug_mode("error")), one step on the card against the CPU
    from the same state, ``track_video`` over VIDEO_T frames through the
    CUDA graph against the eager step loop and its xcorr kernels by name in
    a profile; with the mask, ``step_batched`` at O=2 on the card against the
    CPU. Returns the model and the xcorr launches of the init-and-steps run
    and the graph's replays."""
    p = Config.load(str(config)).tracker_config()
    model, tracker, frames = build_model(p, cls, mask, refine)
    cpu_tracker = cpu_tracker_of(tracker)
    state, launches = phase_slice(tracker, frames, tag)
    phase_cpu_parity(tracker, cpu_tracker, state, frames[STEPS + 2], tag)
    video_launches = phase_video(tracker, frames, tag)
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


def phase_vot(models: dict) -> tuple[int, dict]:
    """The VOT driver on the card, through ``load_dataset`` as a user calls
    it: ``track_vot`` for sharp (mask and Refine, ``config_vot.json``), base
    (mask) and SiamRPN (box) on two videos written under ``build/``, the
    result files checked line by line; then the test CLI's ``main`` on the
    same data with the sharp weights saved as a ``.pth``. The box heads are
    damped first (``damp_box_head``), so that the target is still held when
    the forced jump comes; other losses can occur and are printed. The
    region library is built and loaded before the drivers run.
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
    vot_overlap([0, 0, 4, 4], [1, 1, 4, 4])         # g++ builds the library at first use
    families = {"sharp": (VOT_CONFIG, True, True), "base": (BASE_CONFIG, True, False),
                "rpn": (RPN_CONFIG, False, False)}
    torch.cuda.synchronize()
    reset_launches()
    stepped, lost_by_tracker = {}, {}
    for name, (config, mask, refine) in families.items():
        damp_box_head(models[name])
        runtime = TrackerRuntime(models[name], Config.load(str(config)).tracker_config(),
                                 "cuda", mask=mask, refine=refine)
        lost, stepped[name] = [], 0
        for video in dataset.values():
            n, _ = track_vot(runtime, video, mask_enable=mask,
                             result_dir=str(root / "results"), tracker_name=name,
                             log=lambda *_: None)
            result = (root / "results" / "VOT2018" / name / "baseline" / video["name"]
                      / f"{video['name']}_001.txt").read_text().splitlines()
            stepped[name] += check_vot_lines(f"vot {name} {video['name']}", result,
                                             8 if mask else 4, video["name"] == "vid1")
            lost.append(n)
        lost_by_tracker[name] = sum(lost)
        print(f"[vot] {name} ({'mask' if mask else 'box'}{', Refine' if refine else ''}): "
              f"lost {lost} in {list(dataset)}, the jump's 2 / {SKIP - 1} x 0 / 1 at frames "
              f"{VOT_JUMP}-{VOT_JUMP + SKIP}")
    launches = read_launches()
    check_route("vot", False)
    expected = sum(k * stepped[n] for n, k in (("sharp", 3), ("base", 3), ("rpn", 2)))
    if launches != [expected, 0, 0]:
        raise AssertionError(f"vot: {launches} launches, expected {[expected, 0, 0]} from "
                             f"the stepped frames {stepped}")

    ckpt = root / SHARP_PTH
    torch.save({"state_dict": {f"module.{k}": v.cpu()
                               for k, v in models["sharp"].state_dict().items()}}, ckpt)
    totals = cli.main(["--config", str(VOT_CONFIG), "--resume", str(ckpt), "--mask", "--refine",
                       "--dataset", "VOT2018", "--data-dir", str(root),
                       "--result-dir", str(root / "cli"), "--tracker-name", "cli"])
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
          f"markers, regions within {worst:.4f} px; {cli_launches} xcorr launches")
    lost_by_tracker["cli"] = totals["lost"]
    return expected + cli_launches, lost_by_tracker


def tune_cells(out: dict, what: str) -> str:
    """One line per scored cell of a ``tune.main`` return."""
    return "; ".join(f"{c['tag']} {what} {c['score']:.6f}" for c in out["cells"])


def phase_tune() -> tuple[int, dict]:
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
    runs = {"vot": tune.main([*vot, *TUNE_VOT]), "vot271": tune.main([*vot, *TUNE_WIDE]),
            "vos": tune.main(vos)}
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
          "(all claimed)")
    print(f"[tune] xcorr launches: depthwise_xcorr {launches[0]} (3 x {stepped} VOT frames "
          f"stepped + 3 x {VOS_FRAMES - 1} x {scored[2]} VOS steps), "
          f"depthwise_xcorr_grad_input {launches[1]}, depthwise_xcorr_grad_kernel "
          f"{launches[2]}")
    print(f"[tune] memory allocated after the last cell {growth} bytes beyond the first's "
          f"(at most {TUNE_MEMORY_SLACK}): no cell's runtime outlives it")
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
    summaries = {name: eval_cli.main(args) for name, args in trees.items()}
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
    for root in (TUNE_ROOT, VOT_ROOT, VOS_ROOT):
        shutil.rmtree(root, ignore_errors=True)


def tracked_frames(tree: Path, name: str) -> int:
    """The frames a VOT tree's driver tracked: every line but the (re-)init
    and skipped markers."""
    files = (tree / "VOT2018" / name / "baseline").glob("*/*_001.txt")
    return sum(line not in ("0", "1") for f in files for line in f.read_text().splitlines())


def temper_launches(model, iters: int) -> tuple[int, int]:
    """The forward xcorr launches that ``metric_parity.temper(model, frame,
    iters)`` makes, worked out from the order in which one forward of
    ``temper``'s (template, track_mask, track_refine at one cell) runs the
    convs: the measuring forward of a conv stops at the conv's first output,
    so it makes the launches before that point, or a whole forward's if the
    conv never runs; ``iters`` sweeps, then two whole forwards (the centring
    and the check). Returns (that count, the launches of the forward run
    here to find it)."""
    convs = [m for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    first: dict = {}

    def hook(m, inp, out):
        first.setdefault(m, depthwise_xcorr.launches)

    hooks = [c.register_forward_hook(hook) for c in convs]
    device = next(model.parameters()).device
    start = depthwise_xcorr.launches
    try:
        with torch.no_grad():
            out = model.track_mask(model.template(torch.zeros(1, 3, 127, 127, device=device)),
                                   torch.zeros(1, 3, 255, 255, device=device))
            model.track_refine(out.skips, out.corr, torch.tensor([[12, 12]], device=device))
    finally:
        for h in hooks:
            h.remove()
    whole = depthwise_xcorr.launches - start
    sweep = sum(first.get(c, start + whole) - start for c in convs)
    return iters * sweep + 2 * whole, whole


def phase_metric_parity() -> tuple[int, int]:
    """``[metric-parity]``: ``siammask_tpu_torch.tools.metric_parity`` (its
    ``run`` on its own arguments) on SiamMask-sharp at width 64, seeded
    weights tempered on the card. The card in float32 makes the benchmark
    (two videos of 3 * MP_FRAMES - 3 frames, gt displaced over two windows
    each, and a VOS video of MP_FRAMES) and runs the VOT protocol in box
    mode; the CPU runs it in the same process on that benchmark and must
    make the same protocol decisions (marker lines, so lost and reset
    frames) with a mean per-frame box overlap of at least MP_MIN_IOU; bf16
    on the card runs it too, and its deltas to float32 are printed; then
    mask-polygon mode and VOS fusion in float32 and in bf16 on the card,
    printed, not held (tempered random masks are razor-edge for
    minAreaRect). Each card run's xcorr launches must be 2 a tracked frame
    in box mode and 3 with the mask (the benchmark's run: those of its
    no-reset passes too, and the tempering's, which must be what
    ``temper_launches`` works out), all fp32 kernels in float32 and all
    packed in bf16. Returns the forward launches of the float32 and of the
    bf16 runs."""
    from siammask_tpu_torch.tools import metric_parity as mp

    shutil.rmtree(MP_ROOT, ignore_errors=True)
    bench, trees = MP_ROOT / "benchmark", MP_ROOT / "results"
    video_len, launches = 3 * MP_FRAMES - 3, {False: 0, True: 0}
    tempering: dict = {}
    real_temper = mp.temper

    def pinned_temper(model, frame, iters=2):
        expected, extra = temper_launches(model, iters)
        before = depthwise_xcorr.launches
        real_temper(model, frame, iters)
        made = depthwise_xcorr.launches - before
        if made != expected:
            raise AssertionError(f"[metric-parity] the tempering made {made} xcorr launches, "
                                 f"its forwards {expected}")
        tempering["launches"], tempering["extra"] = made, extra
        return model

    def run(tag: str, argv: list[str], card: bool = True, bf16: bool = False) -> dict:
        if card:
            sync_all()
            reset_launches()
        out = mp.run(mp.parse_args(["--work-dir", str(MP_ROOT), "--frames", str(MP_FRAMES),
                                    "--tracker-name", tag, *argv]),
                     log=lambda msg: print(f"[metric-parity] {tag}: {msg}"))
        if card:
            sync_all()
            check_route(f"metric-parity {tag}", bf16)
            got = read_launches()
            box = "--box-only" in argv
            want = (2 if box else 3) * tracked_frames(trees, tag)
            if not box:
                want += 3 * (MP_FRAMES - 1)                       # VOS
            if "--make-benchmark" in argv:
                # the no-reset runs, the tempering's forwards and the one
                # forward that counted them
                want += (3 * (2 * (video_len - 1) + MP_FRAMES - 1) + tempering["launches"]
                         + tempering["extra"])
                print(f"[metric-parity] {tag}: {tempering['launches']} xcorr launches in the "
                      f"tempering, as its forwards make")
            if got != [want, 0, 0]:
                raise AssertionError(f"[metric-parity] {tag}: xcorr launches {got}, expected "
                                     f"{[want, 0, 0]}")
            launches[bf16] += read_launches()[0]
        return out

    def scores(out: dict, keys=("eao", "accuracy", "robustness", "lost")) -> str:
        s = out["scores"]
        return ", ".join(f"{k} {s[k]:.4f}" for k in keys if k in s)

    def resets(out: dict) -> str:
        return "; ".join(f"{v} lost {d['lost_frames']} init {d['init_frames']}"
                         for v, d in out["scores"]["videos"].items())

    mp.temper = pinned_temper
    try:
        fp32 = run("card_fp32_box", ["--make-benchmark", "--box-only"])
    finally:
        mp.temper = real_temper
    cpu = run("cpu_fp32_box", ["--benchmark", str(bench), "--box-only", "--device", "cpu",
                               "--compare", str(trees / "VOT2018" / "card_fp32_box")], card=False)
    cmp = cpu["compare"]
    settings = json.loads((bench / "benchmark.json").read_text())
    print(f"[metric-parity] benchmark: 2 videos of {video_len} frames from a {MP_FRAMES}-frame "
          f"480x854 clip, gt displaced over 5 frames from {settings['fail_windows']}, VOS "
          f"{MP_FRAMES} frames; made on the card in float32")
    print(f"[metric-parity] box, card float32 against the CPU's: same decisions "
          f"{cmp['same_decisions']}, box overlap mean {cmp['iou_mean']:.6f} min "
          f"{cmp['iou_min']:.6f} over {cmp['frames_compared']} frames; card {scores(fp32)}; CPU "
          f"{scores(cpu)}; {resets(fp32)}")
    if (not cmp["same_decisions"] or cmp["iou_mean"] < MP_MIN_IOU
            or cpu["scores"]["videos"] != fp32["scores"]["videos"]
            or cpu["scores"]["lost"] != fp32["scores"]["lost"]):
        raise AssertionError(f"[metric-parity] the CPU's protocol decisions or boxes differ "
                             f"from the card's: {cmp}; {resets(cpu)}")
    bf16 = run("card_bf16_box", ["--benchmark", str(bench), "--box-only", "--dtype", "bfloat16",
                                 "--compare", str(trees / "VOT2018" / "card_fp32_box")], bf16=True)
    print(f"[metric-parity] box, card bf16 against card float32 (the bf16 deployment delta): "
          f"{scores(bf16)}; deltas "
          + ", ".join(f"{k} {v:.4f}" for k, v in bf16["compare"]["deltas"].items())
          + f"; same decisions {bf16['compare']['same_decisions']}, box overlap mean "
          f"{bf16['compare']['iou_mean']:.4f}; bf16 {resets(bf16)}; float32 {resets(fp32)}")
    mask = run("card_fp32_mask", ["--benchmark", str(bench)])
    bf16_mask = run("card_bf16_mask", ["--benchmark", str(bench), "--dtype", "bfloat16",
                                       "--compare", str(trees / "VOT2018" / "card_fp32_mask")],
                    bf16=True)
    keys = ("eao", "accuracy", "lost", "J", "F")
    print(f"[metric-parity] mask-polygon and VOS, card float32: {scores(mask, keys)}; bf16: "
          f"{scores(bf16_mask, keys)}; deltas "
          + ", ".join(f"{k} {v:.4f}" for k, v in bf16_mask["compare"]["deltas"].items())
          + f"; float32 {resets(mask)}; bf16 {resets(bf16_mask)} (recorded, not held)")
    print(f"[metric-parity] xcorr launches float32 {launches[False]}, bf16 {launches[True]} "
          "(packed)")
    shutil.rmtree(MP_ROOT)
    return launches[False], launches[True]


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
    reset_launches()
    launches = [0, 0, 0]
    for step, epoch in enumerate((0, 0, 1, 1)):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        metrics, counts = train_step_launches(trainer, batch, epoch)
        launches = [a + b for a, b in zip(launches, counts)]
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
    check_route("train", False)
    print(f"[train] 4 steps at B={TRAIN_BATCH}, width 64: launches {launches} "
          "(forward, grad-input, grad-kernel); stem and layer1 bit-identical throughout, "
          "layer2 through epoch 0")
    losses = [trainer.step(batch, 1)["total_loss"].item() for _ in range(8)]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall on a repeated batch: {losses}")
    print("[train] repeated batch, 8 steps: total loss "
          + " ".join(f"{v:.4f}" for v in losses))
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
    """One profiled eager step in each phase (a graph replay shows no
    operator): the backward runs through the backbone only once it is
    unfrozen (neck + heads: 14 conv backwards a step; with layer2/3: 78)."""
    for epoch, label, expected in ((0, "frozen", 14), (1, "unfrozen", 78)):
        eager_step(trainer, batch, epoch)
        events = profiled(lambda: eager_step(trainer, batch, epoch))
        conv_bwd = sum(e.count for e in events if e.key == "aten::convolution_backward")
        xcorr = {e.key.split("::")[-1].split("(")[0]: e.count for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA and "depthwise_xcorr" in e.key}
        print(f"[profile] {label} step: {conv_bwd} aten::convolution_backward calls "
              f"(expected {expected}); xcorr kernels by name {xcorr}")
        if conv_bwd != expected:
            raise AssertionError(f"{label}: {conv_bwd} conv backwards, expected {expected}")


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
    TRAIN_BATCH for each config, with thread and with process workers: the
    two modes give the same batches bit for bit. Returns the thread run's
    first 4 batches of each config."""
    workers = min(16, os.cpu_count() or 1)
    kept = {}
    for name, raw in configs.items():
        cfg = Config.from_dict(raw)
        runs = {}
        for mode in ("thread", "process"):
            dataset = PairDataset(cfg.train_datasets, cfg.anchors, seed=SEED)
            loader = DataLoader(dataset, TRAIN_BATCH, num_workers=workers, workers_mode=mode)
            runs[mode] = list(loader)
        search = cfg.train_datasets["search_size"]
        for a, b in zip(runs["thread"], runs["process"]):
            if a.keys() != b.keys() or not all(np.array_equal(a[k], b[k]) for k in a):
                raise AssertionError(f"[data] {name}: thread and process batches differ")
            if a["search"].shape != (TRAIN_BATCH, search, search, 3):
                raise AssertionError(f"[data] {name}: search {a['search'].shape}")
        positives = sum(int((b["label_mask_weight"].reshape(TRAIN_BATCH, -1).max(1) > 0).sum())
                        for b in runs["thread"])
        print(f"[data] {name} ({search}^2 search): {len(runs['thread'])} batches of "
              f"{TRAIN_BATCH} through DataLoader, {workers} thread and {workers} process "
              f"workers, bit-identical; {positives} of {len(runs['thread']) * TRAIN_BATCH} "
              "pairs with mask positives")
        kept[name] = runs["thread"][:4]
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
    launches = [0, 0, 0]
    for step, (batch, epoch) in enumerate(zip(batches, epochs)):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        bufs = {n: trainer.optimizer.state[p]["momentum_buffer"].clone()
                for n, p in model.named_parameters() if p in trainer.optimizer.state}
        metrics, counts = train_step_launches(trainer, batch, epoch)
        launches = [a + b for a, b in zip(launches, counts)]
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
    return launches


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


def check_train_kernels(tag: str, trainer: Trainer, batch: dict, epoch: int, label: str,
                        launches: int) -> None:
    """The xcorr kernels by name, ``launches`` of them, in the trace of one
    warm step."""
    trainer.step(batch, epoch)
    xcorr = {k.split("::")[-1].split("(")[0]: n for k, n in
             xcorr_kernels(tag, lambda: trainer.step(batch, epoch), launches).items()}
    print(f"[{tag}] profiled {label} step: xcorr kernels by name {xcorr}")


def phase_train_refine(base_trainer: Trainer, raw: dict,
                       batches: list) -> tuple[list[int], dict, dict]:
    """Stage 2 of the two-stage recipe at TRAIN_BATCH, warm-started from a
    stage-1 checkpoint of ``base_trainer``: 4 steps on loader batches
    through ``to_device`` (3 / 1 / 1 launches a step, backbone, neck and RPN
    bit-identical, the unused head decaying), the loss over 8 repeated
    steps, card vs CPU at B=2, the xcorr kernels by name in a profile. Returns
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
    launches = run_train_steps(
        "train-refine", trainer, to_device(iter(batches), DEV), (0, 0, 1, 1), [3, 1, 1],
        lambda epoch: {"mask", "refine"}, lambda epoch: REFINE_FROZEN,
        on_step=lambda before, bufs: check_head_decay(trainer, before, bufs))
    print(f"[train-refine] 4 steps at B={TRAIN_BATCH}, 143^2 search, 3x3 grid: launches "
          f"{launches}; the mask head decayed by weight decay alone at every step")
    batch = next(to_device(iter(batches[:1]), DEV))
    loss_falls("train-refine", trainer, batch, 1)
    phase_refine_parity(lambda device: task_trainer(
        raw, "sharp_refine", loaded_model(SiamMaskSharp, init_state, device)),
        init_state, batch, "train-refine-parity")
    check_train_kernels("train-refine", trainer, batch, 1, "stage-2", 5)
    return launches, init_state, batch


def phase_train_rpn(raw: dict, batches: list) -> tuple[list[int], dict, dict]:
    """SiamRPN at TRAIN_BATCH, 255^2 search: two frozen and two unfrozen
    steps on loader batches (2 / 2 / 2 launches a step), card vs CPU at
    B=2, the xcorr kernels by name in a profile of each phase. Returns the launches, the
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
        check_train_kernels("train-rpn", trainer, dev_batches[0], epoch, label, 6)
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
        metrics = train_cli.main([*argv, *common])
        if not metrics or not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"[train-cli] {label}: {metrics}")
        if not written.exists():
            raise AssertionError(f"[train-cli] {label}: no {written.name}")
        print(f"[train-cli] {label}: 2 steps of {TRAIN_BATCH}; total loss "
              f"{metrics['total_loss']:.4f}; wrote {written.relative_to(SMOKE_TRAIN)}")


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
            dtype: torch.dtype | None = None) -> dict:
    """One rank of a data-parallel run (``parallel.dist.spawn``): for each
    mode of ``modes`` a frozen and an unfrozen step, each on a fresh trainer
    over a model computing in ``dtype`` (None: float32) from
    ``init_state``, on this rank's rows of ``batch``. Per step (a list
    by mode): metrics, kernel launches (and those of the packed bf16
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
        out[name] = steps
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
    against the no-group eager step from the same weights, bit for bit (cuDNN's
    deterministic algorithms on both). Returns per epoch the no-group
    step's (metrics, state, labels)."""
    cfg = Config.load(str(TRAIN_CONFIG), clip=10.0)

    def step(epoch: int, distributed: bool):
        model = loaded_model(SiamMaskBase, init_state, DEV)
        trainer = Trainer(model, *train_parts(cfg), epochs=TRAIN_EPOCHS,
                          distributed=distributed)
        out = trainer.step(batch, epoch) if distributed else eager_step(trainer, batch, epoch)
        metrics = {k: v.item() for k, v in out.items()}
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
            eager_step(Trainer(model, *train_parts(cfg), epochs=TRAIN_EPOCHS), batch, epoch)
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
    if len({r[step]["digest"] for r in runs}) != 1:
        raise AssertionError(f"[{tag}] {name} {phase}: the ranks' states differ")
    for r in runs:
        got = r[step]
        if got["launches"] != [3, 3, 3] or got["packed"] != ([3, 3, 3] if bf16 else [0, 0, 0]):
            raise AssertionError(f"[{tag}] {name} {phase}: launches {got['launches']}, packed "
                                 f"{got['packed']}, expected [3, 3, 3] "
                                 f"({'all' if bf16 else 'none'} packed)")
    ours = runs[0][step]
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
    other = default[epoch]["state"]
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


def phase_dp(init_state: dict, batch: dict) -> tuple[list[int], dict]:
    """[dp]: SiamMask-base stage 1 at width 64, global batch TRAIN_BATCH,
    data parallel. World 1 over NCCL against the no-group step; then two
    ranks sharing card 0 over gloo (NCCL refuses two ranks on one card),
    TRAIN_BATCH // 2 rows each, in the default mode, the fused mode and the
    fused mode with sync-BN, a frozen and an unfrozen step each: the default
    mode against the single-process step, the fused modes' update direction
    against the default mode's, the ranks' states bit-identical, 3 launches
    of each kernel a step on each rank. With two cards or more, NCCL over
    up to four of them at global batch 64 and 256 and on one card, and the
    train CLI over all of them. Returns rank 0's launches in the two-rank
    run (forward, grad-input, grad-kernel) and the single-process steps'
    (metrics, state, labels) by epoch."""
    refs = dp_world_one(init_state, batch)
    noise = dp_float32_noise(init_state, batch, refs)
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    ranks = spawn(dp_rank, 2, "cuda", init_state, cpu_batch, DP_MODES, None,
                  backend="gloo", local_ranks=[0, 0], timeout=600)
    print(f"[dp] two ranks on {torch.cuda.get_device_name(0)} over gloo (the collectives "
          f"staged through the host by gloo), {TRAIN_BATCH // 2} rows each")
    labels = {e: refs[e][2] for e in (0, 1)}
    launches = [0, 0, 0]
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
    if torch.cuda.device_count() >= 2:
        phase_dp_cards(init_state)
    else:
        print("[dp] one card visible: NCCL over several cards and the train CLI's "
              "--num-devices not run")
    return launches, refs


def phase_dp_cards(init_state: dict, dtype: torch.dtype | None = None) -> None:
    """NCCL over min(4, cards) cards and over one card (a world-1 group) at
    global batch 64 and 256, default and fused modes, on a model computing
    in ``dtype`` (None: float32): the ranks' states bit-identical after an
    unfrozen step, all launches packed in bf16; then, in float32,
    ``tools.train --num-devices`` over every card for two steps."""
    cfg = Config.load(str(TRAIN_CONFIG), clip=10.0)
    n = min(4, torch.cuda.device_count())
    modes = DP_MODES[:2]
    tag = "dp" if dtype is None else "bf16-dp"
    for gb in (TRAIN_BATCH, 4 * TRAIN_BATCH):
        batch = {k: v.cpu() for k, v in synthetic_train_batch(cfg, gb, DEV).items()}
        for world in (1, n):
            runs = spawn(dp_rank, world, "cuda", init_state, batch, modes, (), dtype,
                         timeout=600)
            for name, _ in modes:
                if len({r[name][1]["digest"] for r in runs}) != 1:
                    raise AssertionError(f"[{tag}] {name} over {world} cards: ranks differ")
                if dtype is not None and runs[0][name][1]["packed"] != [3, 3, 3]:
                    raise AssertionError(f"[{tag}] {name} over {world} cards: packed launches "
                                         f"{runs[0][name][1]['packed']}")
                print(f"[{tag}] NCCL, {world} card(s), global batch {gb} ({gb // world} a "
                      f"card), {name}: an unfrozen step, ranks bit-identical; "
                      f"{runs[0][name][1]['collectives']} collectives a step")
    if dtype is not None:
        return
    shutil.rmtree(SMOKE_DP, ignore_errors=True)
    root, anno = write_crop_dataset(SMOKE_DP / "crop511")
    config = SMOKE_DP / "base.json"
    config.write_text(json.dumps(train_data_config(TRAIN_CONFIG, root, anno, 2 * TRAIN_BATCH)))
    count = torch.cuda.device_count()
    metrics = train_cli.main(["--config", str(config), "--task", "base", "--epochs", "1",
                              "--batch", str(TRAIN_BATCH), "--workers", "4", "--width",
                              str(TRAIN_WIDTH), "--seed", str(SEED), "--log-interval", "1",
                              "--save-dir", str(SMOKE_DP / "snap"), "--num-devices", str(count)])
    if not all(math.isfinite(v) for v in metrics.values()) \
            or not (SMOKE_DP / "snap" / "checkpoint_e1.pth").exists():
        raise AssertionError(f"[dp] train CLI over {count} cards: {metrics}")
    print(f"[dp] tools.train --num-devices {count}: 2 steps of {TRAIN_BATCH}; total loss "
          f"{metrics['total_loss']:.4f}; rank 0 wrote checkpoint_e1.pth")
    shutil.rmtree(SMOKE_DP)

def phase_bf16_dp(init_state: dict, batch: dict, refs32: dict) -> list[int]:
    """``[bf16-dp]``: ``[dp]``'s two ranks sharing card 0 over gloo, 32 rows
    each, the three modes, a frozen and an unfrozen step each, on the bf16
    twin of the stage-1 weights: the ranks' states bit-identical, 3 / 3 / 3
    launches a step a rank, all of the packed bf16 kernels. The default
    mode against the single-process bf16 step, bf16 noise measured in this
    run as the yardstick: its updates and its BN running statistics no
    further from the single process's than the single-process bf16 step's
    are from ``[dp]``'s float32 one, its total loss within 1e-3 relative.
    The fused modes by update direction against the default mode, as in
    ``[dp]`` (``refs32``: its single-process float32 steps by epoch). With
    two cards or more, NCCL at global batch 64 and 256 and on one card
    (``phase_dp_cards``). Returns rank 0's launches."""
    cfg = Config.load(str(TRAIN_CONFIG), clip=10.0)
    refs = {}
    for epoch in (0, 1):
        trainer = Trainer(loaded_model(SiamMaskBase, init_state, DEV, BF16), *train_parts(cfg),
                          epochs=TRAIN_EPOCHS)
        metrics = {k: v.item() for k, v in trainer.step(batch, epoch).items()}
        refs[epoch] = (metrics, {k: v.detach().cpu().clone()
                                 for k, v in trainer.model.state_dict().items()})
    del trainer
    ranks = spawn(dp_rank, 2, "cuda", init_state, {k: v.cpu() for k, v in batch.items()},
                  DP_MODES, None, BF16, backend="gloo", local_ranks=[0, 0], timeout=600)
    print(f"[bf16-dp] two ranks on {torch.cuda.get_device_name(0)} over gloo, "
          f"{TRAIN_BATCH // 2} rows each, bf16 over float32 weights")
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
    if torch.cuda.device_count() >= 2:
        phase_dp_cards(init_state, BF16)
    return launches

# ---------------- bf16 compute ----------------


def phase_bf16() -> dict:
    """``[bf16]``: SiamMask-sharp at width 64 computing in bf16 over float32
    weights (``build_model(dtype=bf16)``: the calibrated weights, their cls
    head sharpened, so that the card and the CPU do not tie on the best
    cell): init and STEPS steps, 3 xcorr launches each, one under
    sync_debug_mode("error"); one step on the card against the CPU's bf16
    port from the same state (maps within BF16_MAP_TOL, the same best cell,
    ``check_step_close``'s bf16 tolerances); ``track_video`` over VIDEO_T
    frames through the CUDA graph, bit-identical to the eager bf16 loop;
    STREAMS streams over STREAMS_T frames, bit-identical to the eager
    ``step_batched`` loop. Then SiamRPN (box only) and SiamMask-base (63x63
    masks) graph videos in bf16. Every xcorr kernel in the graph paths'
    traces is the packed bf16 kernel. Returns the xcorr launches by path."""
    p = Config.load(str(CONFIG)).tracker_config()
    model, tracker, frames = build_model(p, dtype=BF16)
    state, track = phase_slice(tracker, frames, "bf16")
    cpu_tracker = cpu_tracker_of(tracker)
    phase_cpu_parity(tracker, cpu_tracker, state, frames[STEPS + 2], "bf16-parity", bf16=True)
    bf16_size_shares(tracker, cpu_tracker, frames[:7], "bf16-parity")
    video = phase_video(tracker, frames, "bf16")
    streams, _ = phase_streams(tracker, frames, "bf16-streams", single=False)
    del model, tracker, state
    torch.cuda.empty_cache()
    paths = {"bf16_track": track, "bf16_video": [video, 0, 0],
             "bf16_streams16": [streams, 0, 0]}
    for name, cls, config, mask in (("rpn", SiamRPN, RPN_CONFIG, False),
                                    ("base", SiamMaskBase, BASE_CONFIG, True)):
        p = Config.load(str(config)).tracker_config()
        _, family_tracker, family_frames = build_model(p, cls, mask, False, BF16)
        launches = phase_video(family_tracker, family_frames, f"bf16-{name}")
        paths[f"bf16_{name}"] = [launches, 0, 0]
        del family_tracker
        torch.cuda.empty_cache()
    return paths


def phase_bf16_vos(model: SiamMaskSharp, p, ref: np.ndarray | None) -> int:
    """``[bf16-vos]``: ``track_vos_batched`` as ``[vos]`` drives it, with a
    bf16 twin of ``[vos]``'s weights on its video: the per-object mean IoU
    against the annotations at the driver's thresholds beside ``[vos]``'s
    fp32 ones, and each object's IoU between the two runs' fused masks,
    pooled over the video. Skipped with ``[vos]``. Returns the xcorr
    launches (through the wrapper and by replay)."""
    if ref is None:
        print("[bf16-vos] skipped: [vos] did not run")
        return 0
    import cv2

    video = load_dataset("ytb_vos", str(VOS_ROOT))["vid"]
    runtime = TrackerRuntime(bf16_twin(model), p, "cuda")
    track_vos_batched(runtime, video, scan_chunk=VOS_CHUNK, log=lambda *_: None)  # captures
    torch.cuda.synchronize()
    reset_launches()
    out = VOS_ROOT / "results_bf16"
    iou, _ = track_vos_batched(runtime, video, scan_chunk=VOS_CHUNK, result_dir=str(out),
                               dataset="ytb_vos", save_mask=True, log=lambda *_: None)
    launches = read_launches()
    graph = runtime.tracker.graphs[(3, *FRAME_HW, torch.uint8)]
    check_route("bf16-vos", True, graph)
    if launches != [3 * VOS_RAGGED, 0, 0] or graph.xcorr_launches != 3:
        raise AssertionError(f"bf16-vos: {launches} launches through the wrappers, "
                             f"{graph.xcorr_launches} captured")
    iou = np.asarray(iou)
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
          f"fused masks per object {[round(a, 4) for a in agree]}")
    return 3 * VOS_RAGGED + graph.xcorr_launches * VOS_FULL


def region_centre(line: str) -> np.ndarray:
    """The centre of a VOT result region: an x, y, w, h box or a polygon."""
    v = np.array(line.split(","), float)
    return v[:2] + v[2:] / 2 if len(v) == 4 else v.reshape(-1, 2).mean(0)


def phase_bf16_vot(models: dict) -> int:
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
        stepped[name], lost, ref_lost, drift = 0, [], [], 0.0
        for video in dataset.values():
            n, _ = track_vot(runtime, video, mask_enable=mask, result_dir=str(out),
                             tracker_name=name, log=lambda *_: None)
            lines, ref = ((tree / "VOT2018" / name / "baseline" / video["name"]
                           / f"{video['name']}_001.txt").read_text().splitlines()
                          for tree in (out, VOT_ROOT / "results"))
            stepped[name] += check_vot_lines(f"bf16-vot {name} {video['name']}", lines,
                                             8 if mask else 4, video["name"] == "vid1")
            lost.append(n)
            ref_lost.append(ref.count("2"))
            for a, b in zip(lines, ref):
                if a not in ("0", "1", "2") and b not in ("0", "1", "2"):
                    drift = max(drift, float(np.linalg.norm(region_centre(a) - region_centre(b))))
        if lost != ref_lost:
            raise AssertionError(f"bf16-vot {name}: lost {lost} in bf16, {ref_lost} in fp32")
        print(f"[bf16-vot] {name}: lost {lost} in {list(dataset)}, as in fp32; the largest "
              f"distance between the bf16 and fp32 regions' centres {drift:.2f} px")
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


def phase_bf16_train(init_state: dict, batch: dict, cfg: Config) -> list[int]:
    """``[bf16-train]``: SiamMask-base stage 1 at batch TRAIN_BATCH computing
    in bf16 over float32 weights, from ``[train]``'s initial weights on its
    batch. The first (frozen) step against the fp32 step from the same
    weights and batch (``bf16_first_step``). Then a second frozen and two
    unfrozen steps: each finite, no skip, 3 / 3 / 3 launches, the stem and
    layer1 unchanged, layer2 unchanged while frozen; a profiled unfrozen
    step whose xcorr kernels are all the packed bf16 kernels (3 forward and
    3 of each gradient). Returns the launches of the four steps."""
    trainer, start = bf16_first_step(
        "bf16-train", lambda dtype: Trainer(loaded_model(SiamMaskBase, init_state, DEV, dtype),
                                            *train_parts(cfg), epochs=TRAIN_EPOCHS,
                                            unfreeze_at=0.5), init_state, batch)
    model = trainer.model
    stem0 = {k: v for k, v in start.items() if k.startswith(FROZEN_ALWAYS)}
    layer2_0 = {k: v for k, v in start.items() if k.startswith(LAYER2)}
    launches = counts = read_launches()
    if counts != [3, 3, 3]:
        raise AssertionError(f"bf16-train step 0: {counts} launches, expected [3, 3, 3]")
    for step, epoch in ((1, 0), (2, 1), (3, 1)):
        metrics, counts = train_step_launches(trainer, batch, epoch)
        launches = [a + b for a, b in zip(launches, counts)]
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
    check_route("bf16-train", True)
    names = {e.key: e.count for e in profiled(lambda: trainer.step(batch, 1))
             if e.device_type == torch.autograd.DeviceType.CUDA and "depthwise_xcorr" in e.key}
    packed = sum(c for k, c in names.items() if "depthwise_xcorr_strip_bf16x2_kernel" in k)
    grad_kernel = sum(c for k, c in names.items()
                      if "depthwise_xcorr_grad_kernel_bf16x2_kernel" in k)
    if (packed, grad_kernel) != (6, 3) or sum(names.values()) != 9:
        raise AssertionError(f"bf16-train: xcorr kernels in a step's trace {names}")
    kinds = sorted({re.search(r"depthwise_xcorr\w*<[^>]*>", k).group(0) for k in names})
    print(f"[bf16-train] profiled unfrozen step: 9 xcorr kernels, all packed bf16 kernels "
          f"({', '.join(kinds)})")
    return launches


def phase_bf16_train_task(tag: str, make_trainer, init_state: dict, batch: dict, epochs: tuple,
                          per_step: list[int]) -> list[int]:
    """``[bf16-train-refine]`` / ``[bf16-train-rpn]``: a task's trainer
    (``make_trainer(dtype)``) computing in bf16 over float32 weights, from
    its fp32 phase's initial weights on its first loader batch: the first
    step at ``epochs[0]`` against the fp32 step (``bf16_first_step``), then
    a step at each of ``epochs[1:]``, each finite with no skip and
    ``per_step`` launches; every xcorr launch of those steps the packed
    bf16 kernels (``check_route``). Fewer steps than the fp32 phase.
    Returns the launches of its steps."""
    trainer, _ = bf16_first_step(tag, make_trainer, init_state, batch, epochs[0])
    launches = counts = read_launches()
    if counts != per_step:
        raise AssertionError(f"[{tag}] step 0: {counts} launches, expected {per_step}")
    for step, epoch in enumerate(epochs[1:], 1):
        metrics, counts = train_step_launches(trainer, batch, epoch)
        launches = [a + b for a, b in zip(launches, counts)]
        if (not all(math.isfinite(v) for v in metrics.values()) or metrics["skipped"] != 0
                or counts != per_step):
            raise AssertionError(f"[{tag}] step {step}: {metrics}, launches {counts}")
        print(f"[{tag}] step {step} epoch {epoch}: "
              + " ".join(f"{k} {v:.4f}" for k, v in metrics.items() if k != "skipped")
              + f"; launches {counts}")
    check_route(tag, True)
    print(f"[{tag}] {len(epochs)} steps at B={batch['template'].shape[0]}: launches "
          f"{launches}, all packed bf16 kernels")
    return launches


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


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


def phase_sharded_cards(tracker: Tracker, frames: np.ndarray, pos: np.ndarray, sz: np.ndarray,
                        ref, ref_final) -> None:
    """STREAMS streams a card over every card against one card at STREAMS:
    card 0's streams are the one-card run's (checked as [sharded] checks);
    the server takes host frames, uploaded in the call once a card."""
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


def phase_sharded(p) -> int:
    """[sharded]: SiamMask-sharp at width 64, STREAMS streams on 480x854
    frames over STREAMS_T frames through ``ShardedStreamServer`` over
    [cuda:0, cuda:0] (two replicas, one thread and one CUDA graph each)
    against the unsharded ``track_video_multi``; 3 xcorr kernels a frame a
    replica by name in a profile. With two cards or more, STREAMS streams a
    card over every card against one card. Returns the xcorr launches of the
    two-replica call (captured x replays)."""
    _, tracker, frames = build_model(p)
    o, t = STREAMS, STREAMS_T
    rng = np.random.RandomState(SEED)
    pos = rng.uniform(100, 400, (o, 2)).astype(np.float32)
    sz = rng.uniform(60, 200, (o, 2)).astype(np.float32)
    dev = torch.from_numpy(frames[:t + 1]).cuda()
    ref_final, ref = tracker.track_video_multi(tracker.init_batched(dev[0], pos, sz), dev[1:])
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
    check_graph_profile("sharded", lambda: server.track_video(states, dev[1:]), t,
                        per_frame=3 * len(graphs))
    if torch.cuda.device_count() >= 2:
        phase_sharded_cards(tracker, frames, pos, sz, ref, ref_final)
    else:
        print("[sharded] one card visible: the server over several cards not run")
    return launches


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
    (``lr_groups_halves``); and each step line's epoch with its rates by
    group (``rates``)."""
    runs = []
    for line in path.read_text().splitlines():
        if " INFO torch " in line:
            runs.append([])
        elif m := OVERFIT_STEP.match(line):
            t = datetime.datetime.strptime(m.group(1), "%Y-%m-%d %H:%M:%S,%f").timestamp()
            rates = {g: float(lr) for g, lr in OVERFIT_GROUP.findall(line)}
            runs[-1].append((t, int(m.group(2)), int(m.group(3)),
                             {g for g, lr in rates.items() if lr > 0}, rates))

    def s_it(points: list) -> float:
        return (points[-1][0] - points[0][0]) / (points[-1][2] - points[0][2])

    out = []
    for points in runs:
        half = (points[-1][1] + 1) / 2
        first = [p for p in points if p[1] < half]
        second = first[-1:] + [p for p in points if p[1] >= half]
        out.append({"steps": points[-1][2], "s_it": s_it(points),
                    "s_it_halves": [s_it(first), s_it(second)],
                    "rates": [(p[1], p[4]) for p in points],
                    "lr_groups_halves": [sorted(set().union(*(p[3] for p in half_points)))
                                         for half_points in (first, second[1:])]})
    return out


def schedule_mismatches(run: dict, lr_cfg: dict, epochs: int) -> list[str]:
    """A train run's logged rates against the schedule: each step line's
    ``lr/<group>`` must be ``build_lr_spaces(lr_cfg, epochs)`` at the line's
    epoch times the group's multiplier (``OptimizerConfig.from_lr_cfg``),
    within the log's rounding, and the run must log its last epoch. Returns
    what differs, at most 5 lines of it."""
    spaces = build_lr_spaces(lr_cfg, epochs)
    mults = OptimizerConfig.from_lr_cfg(lr_cfg).lr_mults()
    bad = [f"epoch {e} lr/{g}={lr} against {want:.6f}"
           for e, rates in run["rates"] for g, lr in rates.items()
           if not abs(lr - (want := spaces[min(e, epochs - 1)] * mults[g])) <= OVERFIT_LR_ATOL]
    last = run["rates"][-1][0] if run["rates"] else None
    if last != epochs - 1:
        bad.insert(0, f"last logged epoch {last}, the schedule's {epochs - 1}")
    return bad[:5]


def phase_overfit() -> list[int]:
    """``[overfit]``: ``siammask_tpu_torch.tools.overfit`` ``--prepare --train
    --evaluate --task mask`` at width 64 with its default schedule on the
    clip of ``write_overfit_clip`` (480x854): stage 1 for 16 epochs of 64
    steps of 8 across the unfreeze, stage 2 for 24. The train CLI's logs go
    to a file, read back by ``train_log_runs``. The report must clear the thresholds
    ``tests/test_overfit_artifact.py`` pins for the JAX run's: mask and
    total loss under init's / 10, held-out mean IoU over init's + 0.2 and
    over 0.5, no more lost frames than init's; and stage 1's log must show
    the backbone's optimizer group (``lr/resnet``) in the second half of its
    epochs and not in the first; each stage's logged rates must follow its
    schedule in ``OVERFIT_SCHEDULES`` (``schedule_mismatches``). Returns the xcorr launches of the tool's own process (the scoring: the lr-0 train
    step and the tracking), all fp32 kernels."""
    shutil.rmtree(OVERFIT_ROOT, ignore_errors=True)
    clip, work = OVERFIT_ROOT / "clip", OVERFIT_ROOT / "work"
    write_overfit_clip(clip)

    def log(msg: str) -> None:
        # the report is printed below; the stages' wall times are not checks
        if not msg.startswith("{") and not OVERFIT_WALL.match(msg):
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
        print(f"[overfit] {label}: {run['steps']} steps of {OVERFIT_BATCH}")
    for s in ("init", "trained"):
        f, h = fit[s], held[s]
        print(f"[overfit] {s}: train fit mask_loss {f['mask_loss']:.4f} total_loss "
              f"{f['total_loss']:.4f} iou_at_5 {f['iou_at_5']:.4f} iou_mean "
              f"{f['iou_mean']:.4f}; held-out mean IoU {h['mean_iou']:.4f} (min "
              f"{h['min_iou']:.4f}), lost {h['lost']}")
    print(f"[overfit] xcorr launches of the scoring {launches} (the train CLI's subprocesses "
          "not counted)")
    init, trained = fit["init"], fit["trained"]
    gates = {"mask loss under init's / 10": trained["mask_loss"] < init["mask_loss"] / 10,
             "total loss under init's / 10": trained["total_loss"] < init["total_loss"] / 10,
             "held-out mean IoU over init's + 0.2":
                 held["trained"]["mean_iou"] > held["init"]["mean_iou"] + 0.2,
             "held-out mean IoU over 0.5": held["trained"]["mean_iou"] > 0.5,
             "lost no more than init's": held["trained"]["lost"] <= held["init"]["lost"],
             "stage 1 trains the backbone from the unfreeze on, not before":
                 [("resnet" in g) for g in runs[0]["lr_groups_halves"]] == [False, True]}
    for label, run in zip(OVERFIT_SCHEDULES, runs):
        bad = schedule_mismatches(run, *OVERFIT_SCHEDULES[label])
        gates[f"{label}'s logged rates follow its schedule: {bad}"] = not bad
        print(f"[overfit] {label}: {sum(len(r) for _, r in run['rates'])} logged rates held "
              f"to build_lr_spaces x the group's multiplier, {len(bad)} off")
    failed = [k for k, ok in gates.items() if not ok]
    if failed or len(runs) != 2 or 0 in launches:
        raise AssertionError(f"[overfit] failed: {failed}; {len(runs)} train runs; "
                             f"launches {launches}")
    shutil.rmtree(OVERFIT_ROOT)
    return launches


def main() -> None:
    t_start = time.monotonic()
    smi = phase_device()
    phase_build()
    strip, packed = phase_kernels()
    strip_input, grad_kernel, packed_input, packed_grad_kernel = phase_grad_kernels()
    phase_bn_train()
    records = [strip, strip_input, grad_kernel, packed, packed_input, packed_grad_kernel]
    p = Config.load(str(CONFIG)).tracker_config()
    model, tracker, frames = build_model(p)
    cpu_tracker = cpu_tracker_of(tracker)
    state, track_launches = phase_slice(tracker, frames)
    phase_cpu_parity(tracker, cpu_tracker, state, frames[STEPS + 2])
    video_launches = phase_video(tracker, frames)
    streams_launches, states = phase_streams(tracker, frames)
    phase_streams_cpu_parity(tracker, cpu_tracker, states, frames[2])
    vos_launches, vos_iou = phase_vos(model, p)
    bf16_vos_launches = phase_bf16_vos(model, p, vos_iou)
    del tracker, cpu_tracker, state, states
    torch.cuda.empty_cache()
    rpn_model, rpn_launches = phase_family("rpn", SiamRPN, RPN_CONFIG, False, False)
    torch.cuda.empty_cache()
    base_model, base_launches = phase_family("base", SiamMaskBase, BASE_CONFIG, True, False)
    torch.cuda.empty_cache()
    vot_models = {"sharp": model, "base": base_model, "rpn": rpn_model}
    vot_launches, lost_by_tracker = phase_vot(vot_models)
    bf16_vot_launches = phase_bf16_vot(vot_models)
    del model, rpn_model, base_model, vot_models
    torch.cuda.empty_cache()
    bf16_paths = phase_bf16()
    torch.cuda.empty_cache()
    tune_launches, tune_scores = phase_tune()
    phase_eval(tune_scores, lost_by_tracker)
    torch.cuda.empty_cache()
    mp_launches, bf16_mp_launches = phase_metric_parity()
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
    bf16_train_launches = phase_bf16_train(init_state, batch, cfg)
    torch.cuda.empty_cache()
    dp_launches, dp_refs = phase_dp(init_state, batch)
    bf16_dp_launches = phase_bf16_dp(init_state, batch, dp_refs)

    # the data pipeline and the other training tasks, on a synthetic set
    shutil.rmtree(SMOKE_TRAIN, ignore_errors=True)
    root, anno = write_crop_dataset(SMOKE_TRAIN / "crop511")
    configs = {"sharp": train_data_config(SHARP_TRAIN_CONFIG, root, anno, 8 * TRAIN_BATCH),
               "rpn": train_data_config(RPN_CONFIG, root, anno, 8 * TRAIN_BATCH)}
    loaded = phase_data(configs)
    train_refine_launches, refine_state, refine_batch = phase_train_refine(
        trainer, configs["sharp"], loaded["sharp"])
    del trainer, train_model, batch
    torch.cuda.empty_cache()
    bf16_refine_launches = phase_bf16_train_task(
        "bf16-train-refine", lambda dtype: task_trainer(
            configs["sharp"], "sharp_refine",
            loaded_model(SiamMaskSharp, refine_state, DEV, dtype)),
        refine_state, refine_batch, (0, 0, 1), [3, 1, 1])
    del refine_batch
    torch.cuda.empty_cache()
    train_rpn_launches, rpn_state, rpn_batch = phase_train_rpn(configs["rpn"], loaded["rpn"])
    torch.cuda.empty_cache()
    bf16_rpn_launches = phase_bf16_train_task(
        "bf16-train-rpn", lambda dtype: task_trainer(
            configs["rpn"], "siamrpn", loaded_model(SiamRPN, rpn_state, DEV, dtype)),
        rpn_state, rpn_batch, (0, 0, 1), [2, 2, 2])
    del rpn_batch
    torch.cuda.empty_cache()
    phase_train_resume(configs["rpn"], rpn_state, loaded["rpn"])
    phase_train_cli({"base": train_data_config(TRAIN_CONFIG, root, anno, 2 * TRAIN_BATCH),
                     "sharp": configs["sharp"]})
    shutil.rmtree(SMOKE_TRAIN)
    torch.cuda.empty_cache()
    overfit_launches = phase_overfit()
    torch.cuda.empty_cache()
    sharded_launches = phase_sharded(p)

    # the forward also runs on the video and 16-stream paths, by graph replay
    paths = {"track": track_launches, "video": [video_launches, 0, 0],
             "streams16": [streams_launches, 0, 0], "vos": [vos_launches, 0, 0],
             "rpn": [rpn_launches, 0, 0], "base": [base_launches, 0, 0],
             "vot": [vot_launches, 0, 0], "tune": [tune_launches, 0, 0],
             "metric_parity": [mp_launches, 0, 0],
             "train": train_launches,
             "train_refine": train_refine_launches, "train_rpn": train_rpn_launches,
             "dp": dp_launches, "overfit": overfit_launches,
             "sharded": [sharded_launches, 0, 0],
             **bf16_paths, "bf16_vos": [bf16_vos_launches, 0, 0],
             "bf16_vot": [bf16_vot_launches, 0, 0],
             "bf16_metric_parity": [bf16_mp_launches, 0, 0], "bf16_train": bf16_train_launches,
             "bf16_train_refine": bf16_refine_launches, "bf16_train_rpn": bf16_rpn_launches,
             "bf16_dp": bf16_dp_launches}
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
