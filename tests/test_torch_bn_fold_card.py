"""Eval-mode BatchNorm folded into its conv on the card (``ops/bn_fold.py``,
``models/resnet.py`` ``conv_bn``): each conv -> BN (-> add) -> ReLU of the
tracker runs as one cuDNN call of the folded weight and bias.

- A width-64 bf16 SiamMask-sharp ``StepGraph`` at O=16 on 480x854 frames
  (weights as ``chip_smoke.py``'s): one step folds every conv -> BN pair it
  runs (counted from the module tree), the capture the same for each of
  its two warm-ups and the capture itself; a replay's profile holds no
  ``batch_norm`` kernel; the replay gives the eager folded step's bits;
  ``bench.count_flops`` counts the folded step's FLOPs as the unfolded's.
- The folded float32 step (TF32 off) against the unfolded one, from the
  same state: the card-parity tolerances of ``chip_smoke.py``
  (``check_step_close``, the maps within 1e-3 of their largest entry).
- The stem's running variance changed in place after a capture: the next
  ``track_video_multi`` (a replay of the kept graph) takes it, and gives
  the eager loop's bits with the new statistics.
- One stage-1 ``Trainer.step`` at batch 8: the frozen stages' pairs fold,
  twice a step (template and search); no train-mode pair does.

Marked ``cuda``; they skip without a card. The file imports only the port:
``python -m pytest tests/test_torch_bn_fold_card.py -m cuda -q``.
"""
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from siammask_tpu_torch import bench
from siammask_tpu_torch.bench import train_batch
from siammask_tpu_torch.config import Config
from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp
from siammask_tpu_torch.ops import bn_fold
from siammask_tpu_torch.ops.sample import subwindow_crop
from siammask_tpu_torch.train.lr import build_lr_spaces
from siammask_tpu_torch.train.trainer import OptimizerConfig, Trainer, TrainSettings
from siammask_tpu_torch.utils import trace
from _torch_weights import build_model, check_step_close, damp_box_head, head_maps

from test_torch_graph import cuda_device  # noqa: F401  (fixture)

EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"
CONFIG = EXPERIMENTS / "siammask_sharp" / "config_davis.json"
OBJECTS = 16


def _folded(fn):
    before = trace.counters().get("conv.bn_folded", 0)
    out = fn()
    return out, trace.counters().get("conv.bn_folded", 0) - before


def _bns(module) -> list:
    return [m for m in module.modules() if isinstance(m, torch.nn.BatchNorm2d)]


def _sharp_step_pairs(model: SiamMaskSharp) -> int:
    """The conv -> BN pairs a sharp tracking step runs: every BN of the
    model but its 1x1 mask head's (the step runs Refine on the corr vector,
    not the head map)."""
    return len(_bns(model)) - len(_bns(model.mask_model.mask.head))


def _setup(device, dtype, objects: int = OBJECTS, frames: int = 3):
    p = Config.load(str(CONFIG)).tracker_config()
    model, tracker, video = build_model(p, SiamMaskSharp, dtype=dtype)
    damp_box_head(model)  # as the benchmark's weights: random deltas x0.1
    video = torch.from_numpy(video[:frames + 1]).to(device)
    h, w = video.shape[1:3]
    rng = np.random.RandomState(5)
    pos = torch.tensor(np.stack([rng.uniform(100, w - 100, objects),
                                 rng.uniform(100, h - 100, objects)], 1), dtype=torch.float32)
    sz = torch.tensor(rng.uniform(60, 200, (objects, 2)), dtype=torch.float32)
    return model, tracker, video, tracker.init_batched(video[0], pos, sz)


@pytest.mark.cuda
def test_vos_graph_folds_every_pair_on_card(cuda_device, monkeypatch):
    model, tracker, frames, state = _setup(cuda_device, torch.bfloat16)
    pairs = _sharp_step_pairs(model)
    (_, eager), n = _folded(lambda: tracker.step_batched(state, frames[1]))
    assert n == pairs == 52
    graph, n = _folded(lambda: tracker.step_graph(state, frames[1:]))
    assert n == 3 * pairs           # two warm-ups and the capture
    with torch.inference_mode():       # as ``track_video_multi`` replays
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, replayed = graph.run(state, frames[1:2])
            torch.cuda.synchronize()
    kernels = [e.key for e in prof.key_averages() if e.device_type.name == "CUDA"]
    assert not [k for k in kernels if "batch_norm" in k], kernels
    for name, a, b in zip(eager._fields, replayed, eager):
        assert torch.equal(a[0], b), name

    folded_flops, _ = bench.count_flops(lambda: tracker.step_batched(state, frames[1]))
    monkeypatch.setattr(bn_fold, "DEVICES", ())
    unfolded_flops, _ = bench.count_flops(lambda: tracker.step_batched(state, frames[1]))
    assert folded_flops == unfolded_flops > 0


@pytest.mark.cuda
def test_folded_float32_step_matches_unfolded_on_card(cuda_device, monkeypatch):
    assert not torch.backends.cudnn.allow_tf32
    model, tracker, frames, state = _setup(cuda_device, None, objects=4, frames=1)
    x = subwindow_crop(frames[1], state.target_pos, torch.full((4,), 360.0, device=cuda_device),
                       255, state.avg_chans)
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        (maps, out), n = _folded(lambda: (head_maps(model, state.zf, x),
                                          tracker.step_batched(state, frames[1])[1]))
        assert n == 2 * _sharp_step_pairs(model)
        monkeypatch.setattr(bn_fold, "DEVICES", ())
        (ref_maps, ref), n = _folded(lambda: (head_maps(model, state.zf, x),
                                              tracker.step_batched(state, frames[1])[1]))
        assert n == 0
    for name, b in ref_maps.items():
        scale = b.abs().max().item()
        torch.testing.assert_close(maps[name], b, rtol=0, atol=1e-3 * scale)
        print(f"[fold fp32] {name}: max_abs_err {(maps[name] - b).abs().max().item():.3e} "
              f"of {scale:.3f}")
    err = check_step_close("fold fp32", out, ref)
    print(f"[fold fp32] step mask max_abs_err {err:.3e}")


@pytest.mark.cuda
def test_running_var_changed_after_capture_is_replayed_on_card(cuda_device):
    model, tracker, frames, state = _setup(cuda_device, torch.bfloat16, objects=4)
    before = tracker.track_video_multi(state, frames[1:])[1]       # captures
    with torch.no_grad():
        model.features.features.bn1.running_var.mul_(1.5)     # the stem's
    _, after = tracker.track_video_multi(state, frames[1:])        # the kept graph
    assert len(tracker.graphs) == 1
    st, loop = state, []
    for frame in frames[1:]:
        st, out = tracker.step_batched(st, frame)
        loop.append(out)
    for i, name in enumerate(after._fields):
        assert torch.equal(after[i], torch.stack([o[i] for o in loop])), name
    assert not torch.equal(after.mask_logits, before.mask_logits)


@pytest.mark.cuda
def test_train_step_folds_only_the_frozen_pairs_on_card(cuda_device):
    cfg = Config.load(str(EXPERIMENTS / "siammask_base" / "config.json"), clip=10.0)
    model = SiamMaskBase(width=64, dtype=torch.bfloat16)
    model = model.init_weights(torch.Generator().manual_seed(0)).to(cuda_device)
    trainer = Trainer(model, TrainSettings.for_search("base", cfg.loss_weight, 255),
                      OptimizerConfig.from_lr_cfg(cfg.lr, clip=10.0, clip_cfg=cfg.clip),
                      build_lr_spaces(cfg.lr, 2), epochs=2)
    batch = train_batch(8, 255, 25, cuda_device)
    metrics, n = _folded(lambda: trainer.step(batch, 1))
    assert torch.isfinite(metrics["total_loss"])
    frozen = [m for m in _bns(model) if not m.training and not m.weight.requires_grad]
    training = [m for m in _bns(model) if m.training]
    assert frozen and training
    assert n == 2 * len(frozen)        # the template and the search pass
