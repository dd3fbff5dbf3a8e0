"""The channels_last path on the card: the tracker's crops and the
trainer's batches go to the model as NHWC memory, so cuDNN runs every conv
on NHWC with no layout transposes.

- A width-64 bf16 SiamMask-sharp ``StepGraph`` at O=16 on 480x854 frames
  (weights as ``chip_smoke.py``'s: BN calibrated, cls head sharpened, box
  head damped):
  every conv of its warm-up and capture takes channels_last, one replay's
  profile holds no NCHW<->NHWC transpose kernel, the xcorr launches a
  frame are the three packed kernels as before, and the boxes, scores and
  masks of four open-loop frames agree with the same weights' NCHW step
  within ``PERF.md`` section 2's ``sharp_vos_16obj`` limits, measured as
  the benchmark's check measures them (at the channels_last run's cell).
- One stage-1 ``Trainer.step`` at batch 8: every conv takes channels_last,
  and the parameters and their gradients stay NCHW-contiguous float32.

Marked ``cuda``; they skip without a card. The file imports only the
port: ``python -m pytest tests/test_torch_layout_card.py -m cuda -q``.
"""
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from siammask_tpu_torch.bench import train_batch
from siammask_tpu_torch.config import Config
from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp
from siammask_tpu_torch.tracker import tracker as tracker_module
from siammask_tpu_torch.tracker.tracker import Tracker
from siammask_tpu_torch.train.lr import build_lr_spaces
from siammask_tpu_torch.train.trainer import OptimizerConfig, Trainer, TrainSettings
from siammask_tpu_torch.utils import trace
from _torch_weights import build_model, damp_box_head

from test_torch_graph import cuda_device  # noqa: F401  (fixture)

EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"
OBJECTS = 16
FRAMES = 4
TRANSPOSES = ("nchwtonhwc", "nhwctonchw")
# PERF.md section 2, sharp_vos_16obj: score_gap.mean, box_err.mean, mask_mae
SCORE_LIMIT, BOX_LIMIT, MASK_LIMIT = 0.002, 0.005, 0.016


def _convs(fn):
    before = trace.counters()
    out = fn()
    after = trace.counters()
    return out, {k: after.get(k, 0) - before.get(k, 0)
                 for k in ("conv.channels_last", "conv.contiguous")}


def _kernels(fn) -> dict:
    """Device kernel names of one call of ``fn`` and their counts."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if e.device_type.name == "CUDA"}


@pytest.mark.cuda
def test_vos_graph_runs_channels_last_on_card(cuda_device, monkeypatch):
    p = Config.load(str(EXPERIMENTS / "siammask_sharp" / "config_davis.json")).tracker_config()
    model, tracker, frames = build_model(p, SiamMaskSharp, dtype=torch.bfloat16)
    damp_box_head(model)  # as the benchmark's weights: random deltas x0.1
    frames = torch.from_numpy(frames[:FRAMES + 1]).to(cuda_device)
    h, w = frames.shape[1:3]
    rng = np.random.RandomState(5)
    pos = torch.tensor(np.stack([rng.uniform(100, w - 100, OBJECTS),
                                 rng.uniform(100, h - 100, OBJECTS)], 1), dtype=torch.float32)
    sz = torch.tensor(rng.uniform(60, 200, (OBJECTS, 2)), dtype=torch.float32)

    state = tracker.init_batched(frames[0], pos, sz)
    graph, counts = _convs(lambda: tracker.step_graph(state, frames[1:]))
    assert counts["conv.contiguous"] == 0 and counts["conv.channels_last"] > 0, counts
    assert graph.xcorr_launches == graph.xcorr_packed_launches == 3
    with torch.inference_mode():       # as ``track_video_multi`` replays
        kernels = _kernels(lambda: graph.run(state, frames[1:2]))
    assert not [k for k in kernels if any(t in k.lower() for t in TRANSPOSES)], kernels
    assert sum(n for k, n in kernels.items() if "depthwise_xcorr" in k) == 3, kernels

    # the same weights through the NCHW path (the program before channels_last),
    # with its own template, from the channels_last run's state before each
    # frame and at the cell that run took, as the benchmark's check holds the
    # program (bf16 ties part two runs' own argmax); its penalised score map
    # gives the score gap
    monkeypatch.setattr(tracker_module, "model_input", lambda t: t.contiguous())
    ref_tracker = Tracker(model, p, cuda_device)
    ref_zf = ref_tracker.init_batched(frames[0], pos, sz).zf
    st = state
    gaps, boxes, masks = [], [], []
    for t in range(1, FRAMES + 1):
        with torch.inference_mode():
            new_st, out = graph.run(st, frames[t:t + 1])
        out = type(out)(*(v[0] for v in out))
        pscores = []

        def at_cell(pscore, dim):
            pscores.append(pscore)
            return out.best_id.clone()

        with monkeypatch.context() as m:
            m.setattr(torch, "argmax", at_cell)
            (_, ref), ref_counts = _convs(
                lambda: ref_tracker.step_batched(st._replace(zf=ref_zf), frames[t]))
        assert ref_counts["conv.channels_last"] == 0 and ref_counts["conv.contiguous"] > 0
        pscore, = pscores
        gaps.append(pscore.max(1).values - pscore.gather(1, out.best_id[:, None])[:, 0])
        units = st.target_sz.prod(1).clamp(min=1).sqrt()
        boxes.append(torch.maximum((out.target_pos - ref.target_pos).abs(),
                                   (out.target_sz - ref.target_sz).abs()).amax(1) / units)
        # over the warped cell (outside it the frame reads the border, -1)
        inside = (out.mask_in_frame > -1) | (ref.mask_in_frame > -1)
        diff = (out.mask_in_frame - ref.mask_in_frame).abs() * inside
        masks.append(diff.sum(dim=(1, 2)) / inside.sum(dim=(1, 2)).clamp(min=1))
        st = new_st
    score_gap = torch.cat(gaps).mean().item()
    box_err = torch.cat(boxes).mean().item()
    mask_mae = torch.cat(masks).max().item()
    print(f"[layout] score_gap.mean {score_gap:.6f} box_err.mean {box_err:.6f} "
          f"mask_mae {mask_mae:.6f}")
    assert score_gap <= SCORE_LIMIT
    assert box_err <= BOX_LIMIT
    assert mask_mae <= MASK_LIMIT


@pytest.mark.cuda
def test_train_step_runs_channels_last_on_card(cuda_device):
    config = EXPERIMENTS / "siammask_base" / "config.json"
    cfg = Config.load(str(config), clip=10.0)
    model = SiamMaskBase(width=64, dtype=torch.bfloat16)
    model = model.init_weights(torch.Generator().manual_seed(0)).to(cuda_device)
    trainer = Trainer(model, TrainSettings.for_search("base", cfg.loss_weight, 255),
                      OptimizerConfig.from_lr_cfg(cfg.lr, clip=10.0, clip_cfg=cfg.clip),
                      build_lr_spaces(cfg.lr, 2), epochs=2)
    batch = train_batch(8, 255, 25, cuda_device)
    assert batch["search"].is_contiguous()
    metrics, counts = _convs(lambda: trainer.step(batch, 1))
    assert counts["conv.contiguous"] == 0 and counts["conv.channels_last"] > 0, counts
    assert torch.isfinite(metrics["total_loss"])
    for name, prm in model.named_parameters():
        assert prm.dtype == torch.float32 and prm.is_contiguous(), name
        assert prm.grad is None or prm.grad.is_contiguous(), name
