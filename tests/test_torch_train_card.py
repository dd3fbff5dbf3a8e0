"""Training steps on the card against the CPU: one stage-2 refine step
(``sharp_refine``, 143x143 search) and one SiamRPN step (255x255), at width
8, B=2, from the same weights and batch, TF32 off. Each step launches the
xcorr kernels it should (3 / 1 / 1 and 2 / 2 / 2). Marked ``cuda``; they
skip without a card. The file imports only the port:
``python -m pytest tests/test_torch_train_card.py -m cuda -q``.

Tolerances cover cuDNN's summation order against the CPU's: metrics 1e-4
relative, momentum buffers 1e-3 of each tensor's largest entry plus 1e-5 of
the step's (``chip_smoke.py``'s card-vs-CPU phases)."""
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from siammask_tpu_torch.config import Config
from siammask_tpu_torch.data.anchor_target import AnchorTarget
from siammask_tpu_torch.models.siammask import SiamMaskSharp, SiamRPN
from siammask_tpu_torch.ops.xcorr import (depthwise_xcorr, depthwise_xcorr_grad_input,
                                          depthwise_xcorr_grad_kernel)
from siammask_tpu_torch.tracker.anchors import Anchors
from siammask_tpu_torch.train.lr import build_lr_spaces
from siammask_tpu_torch.train.trainer import OptimizerConfig, Trainer, TrainSettings

EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"
WIDTH = 8
B = 2
# task -> (model, config, xcorr launches a step: forward, grad-input, grad-kernel)
TASKS = {"sharp_refine": (SiamMaskSharp, EXPERIMENTS / "siammask_sharp" / "config.json",
                          [3, 1, 1]),
         "siamrpn": (SiamRPN, EXPERIMENTS / "siamrpn_resnet" / "config.json", [2, 2, 2])}
KERNELS = (depthwise_xcorr, depthwise_xcorr_grad_input, depthwise_xcorr_grad_kernel)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def make_batch(cfg: Config, seed=0) -> dict:
    """Noise images and anchor targets for a box near the centre of each
    search crop, NCHW."""
    search, size = cfg.train_datasets["search_size"], cfg.train_datasets["size"]
    rng = np.random.RandomState(seed)
    anchors = Anchors(cfg.anchors)
    anchors.generate_all_anchors(im_c=search // 2, size=size)
    target = AnchorTarget(np.random.RandomState(seed))
    out = {k: [] for k in ("label_cls", "label_loc", "label_loc_weight", "label_mask",
                           "label_mask_weight")}
    for _ in range(B):
        cx, cy = search // 2 + rng.uniform(-8, 8, 2)
        w, h = rng.uniform(52, 78, 2)
        box = (cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)
        c, d, dw = target(anchors, box, size)
        m = -np.ones((search, search), np.float32)
        m[int(box[1]):int(box[3]), int(box[0]):int(box[2])] = 1.0
        for k, v in zip(out, (c, d, dw, m, c.max(axis=0).astype(np.float32))):
            out[k].append(torch.from_numpy(v))
    batch = {k: torch.stack(v) for k, v in out.items()}
    batch["template"] = torch.from_numpy(rng.uniform(0, 255, (B, 3, 127, 127)).astype(np.float32))
    batch["search"] = torch.from_numpy(
        rng.uniform(0, 255, (B, 3, search, search)).astype(np.float32))
    return batch


def _step(task, state, batch, device):
    cls, config, _ = TASKS[task]
    cfg = Config.load(str(config), clip=10.0)
    model = cls(width=WIDTH)
    model.load_state_dict(state)
    trainer = Trainer(model.to(device),
                      TrainSettings.for_search(task, cfg.loss_weight,
                                               cfg.train_datasets["search_size"]),
                      OptimizerConfig.from_lr_cfg(cfg.lr, clip=10.0, clip_cfg=cfg.clip),
                      build_lr_spaces(cfg.lr, 2), epochs=2)
    before = [fn.launches for fn in KERNELS]
    metrics = trainer.step({k: v.to(device) for k, v in batch.items()}, 0)
    torch.cuda.synchronize()
    launches = [fn.launches - b for fn, b in zip(KERNELS, before)]
    names = {p: n for n, p in model.named_parameters()}
    momentum = {names[p]: s["momentum_buffer"].cpu() for p, s in trainer.optimizer.state.items()}
    return ({k: v.item() for k, v in metrics.items()}, momentum,
            {k: v.cpu() for k, v in model.state_dict().items()}, launches, trainer.labels)


@pytest.mark.cuda
@pytest.mark.parametrize("task", list(TASKS))
def test_train_step_on_card_matches_cpu(cuda_device, task):
    cls, config, per_step = TASKS[task]
    batch = make_batch(Config.load(str(config)))
    state = cls(width=WIDTH).init_weights(torch.Generator().manual_seed(0)).state_dict()
    m_gpu, b_gpu, s_gpu, launches, labels = _step(task, state, batch, cuda_device)
    m_cpu, b_cpu, s_cpu, cpu_launches, _ = _step(task, state, batch, torch.device("cpu"))
    assert launches == per_step and cpu_launches == [0, 0, 0]
    assert set(m_gpu) == set(m_cpu) and m_gpu["skipped"] == 0.0
    for k in m_cpu:
        assert math.isclose(m_gpu[k], m_cpu[k], rel_tol=1e-4, abs_tol=1e-6), k
    assert b_gpu.keys() == b_cpu.keys()
    floor = 1e-5 * max(v.abs().max().item() for v in b_cpu.values())
    for name, ref in b_cpu.items():
        torch.testing.assert_close(b_gpu[name], ref, rtol=1e-3,
                                   atol=1e-3 * ref.abs().max().item() + floor)
    for name, label in labels.items():
        if label == "frozen":
            assert torch.equal(s_gpu[name], state[name]), name
    if task == "sharp_refine":  # the frozen BN statistics too
        for name in s_gpu:
            if name.startswith(("features.", "rpn_model.")):
                assert torch.equal(s_gpu[name], state[name]), name
