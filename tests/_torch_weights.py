"""Seeded, BN-calibrated weights and synthetic frames for the PyTorch port.

Shared by the CPU parity tests, the card tests (``tests/*_card.py``) and
``chip_smoke.py``: random weights scaled so that activations stay O(1) like a
trained model's (``calibrate_bn``, ``bn_calibration``), the cls head given a
peak that bf16 rounding does not tie (``sharpen_cls_head``), the box head
damped so that a slow target is held (``damp_box_head``), and the card
against the CPU at the tolerances that cuDNN's summation order and bf16
rounding allow (``check_step_close``), and a trainer's eager step on the
card (``eager_step``). Imports the port only, never JAX.
Imported as a top-level module (``from _torch_weights import ...``), as
``_torch_dp`` is: under pytest ``tests/`` is on the path, and
``chip_smoke.py`` puts it there. ``from tests._torch_weights`` is not used
because a machine may have another ``tests`` package installed.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp, SiamRPN
from siammask_tpu_torch.ops.sample import subwindow_crop
from siammask_tpu_torch.tracker.tracker import BoxStepOutput, Tracker
from siammask_tpu_torch.train.trainer import Trainer, train_step

FRAME_HW = (480, 854)
TARGET_POS, TARGET_SZ = (300.0, 200.0), (120.0, 90.0)
SEED = 0
FRAMES = 65               # build_model's frames: the init frame and a 64-frame video
BF16 = torch.bfloat16
# the bf16 tolerances, card against the CPU (both bf16 activations over
# float32 weights; cuDNN and the CPU's convs round at other points, and a
# bf16 rounding moves a value by up to 2^-9 of it)
BF16_MAP_TOL = 3e-2        # head maps, relative L2 norm
BF16_POS_TOL = 1.0         # px, positions and sizes, plus BF16_SIZE_REL of the size
BF16_SIZE_REL = 1e-2       # the size delta passes a bf16 exp: 2^-8 of the size a rounding
BF16_SCORE_TOL = 2.0 ** -7  # the carried score, two bf16 steps near 1
BF16_MASK_TOL = 3e-2       # sigmoid cell masks, absolute


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


def bf16_twin(model: SiamRPN) -> SiamRPN:
    """The same weights, on the same device, in a model of the same family
    that computes in bf16 (its parameters stay float32)."""
    twin = type(model)(width=model.width, dtype=BF16)
    twin.load_state_dict(model.state_dict())
    return twin.to(next(model.parameters()).device).eval()


def build_model(p, cls=SiamMaskSharp, mask: bool = True, refine: bool = True,
                dtype: torch.dtype | None = None) -> tuple[SiamRPN, Tracker, np.ndarray]:
    """A seeded model of ``cls`` at width 64 on the card, its BN calibrated
    on a crop pair of the first frame, its tracker and FRAMES frames. With
    ``dtype`` bf16 the calibrated weights' cls head is sharpened on the same
    pair (``sharpen_cls_head``) and the model is their bf16 twin."""
    model = cls(width=64).init_weights(torch.Generator().manual_seed(SEED))
    model = model.to("cuda").eval()
    frames = synthetic_frames(FRAMES)
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


def eager_step(trainer: Trainer, batch: dict, epoch: int) -> dict:
    """``Trainer.step`` on its eager path whatever ``uses_graph`` picks:
    ``epoch``'s phase, then ``train_step`` at its LR. The reference a graph
    replay is held to (fused SGD rounds apart from foreach SGD), and the
    step whose operators a profile shows (a replay shows none)."""
    trainer._ensure_phase(epoch)
    lr = float(trainer.lr_spaces[min(epoch, len(trainer.lr_spaces) - 1)])
    return train_step(trainer.model, trainer.optimizer, batch, lr, trainer.settings,
                      trainer.opt_cfg)
