"""Training engine for one card: per-module LR groups, progressive backbone
unfreeze, grad clipping, NaN guard, resume.

Counterpart of ``siammask_tpu/train/trainer.py`` (the reference's
``tools/train_siammask.py``, ``train_siamrpn.py`` and
``train_siammask_refine.py``), for every task the JAX package trains
(``TrainSettings.task``):

- ``siamrpn``: SiamRPN, cls and loc losses;
- ``base``: SiamMask-base stage 1, plus the 63x63 mask loss on 127x127
  windows of the search mask padded by 32;
- ``sharp``: SiamMask-sharp end to end, the mask loss on the refined masks
  of every cell (``forward_train``);
- ``sharp_refine``: stage 2 of the two-stage recipe: the backbone, neck and
  RPN heads frozen in eval-mode BN (``SiamMaskSharp.fix_for_refine``), the
  mask corr and Refine trained, and no unfreeze.

- Optimizer: SGD, momentum 0.9, weight decay 1e-4, no dampening, no
  Nesterov, one param group per label: ``resnet`` (backbone stages, x0.1 of
  the feature LR), ``neck``, ``rpn``, ``mask``, ``refine``. Frozen
  parameters are in no group and take no gradient.
- ``clip_grad_norm_`` then ``SGD.step`` is the JAX package's optax chain
  (clip_by_global_norm -> add_decayed_weights -> trace -> scale(mult) ->
  x(-lr)): both feed ``g + wd * w`` to the momentum buffer, and on the first
  step both set the buffer to it. optax decays every leaf of a group, a
  leaf the loss does not reach too (sharp's 1x1 mask head, which
  ``forward_train`` never calls), so such a parameter is given a zero
  gradient before the step; ``torch.optim.SGD`` would skip it.
- Progressive unfreeze: at ``epoch / epochs >= unfreeze_at`` layer2/3
  unfreeze (``ResNet50Tracking.unfix``, which owns ``requires_grad`` and the
  BN mode of every backbone stage) and the optimizer is rebuilt with fresh
  momentum, as the reference does.
- Loss = w_cls * cls + w_loc * loc + w_mask * mask; a step whose loss is
  non-finite or above 1e4 in magnitude changes nothing.
- ``Trainer.restore`` resumes from a ``train/checkpoint.py`` checkpoint:
  weights, epoch, and momentum when the checkpoint's param groups are the
  current phase's.

Data-parallel training (``distributed``: one process per device in a
``torch.distributed`` group, each with its rows of the global batch;
``parallel/dist.py``) has the JAX ``make_train_step(mesh=...)``'s modes:

- default: the global-batch step, exactly. Every training-mode BN syncs
  its batch statistics over the group (``parallel/sync_bn.py``), each loss
  divides by the global batch's counts (``global_counts``, one all-reduce
  before the forward), and the gradients and metrics are summed, the
  gradients in one flat bucket;
- ``fused_allreduce``: DDP's semantics, as the JAX step's shard_map: local
  BN and local normalizers; the gradients averaged in one flat bucket; the
  BN running statistics and the metrics averaged;
- ``fused_allreduce`` + ``sync_bn``: the same with BN statistics synced.

A bf16 model (``SiamMaskBase(dtype=torch.bfloat16)``, the JAX package's
``Trainer`` over a bf16 flax model) trains through the same step, on one
process or under ``distributed`` in every mode and with ``remat``: float32
parameters (but a sharp model's deconv built from scratch, bf16 with its
gradient and momentum, as optax keeps a bf16 leaf), bf16 activations, bf16
xcorr kernels forward and backward, float32 losses and gradients, the NaN
guard on the float32 loss. No
collective carries a bf16 tensor: sync-BN reduces its statistics in
float32 (flax's ``force_float32_reductions``), the gradient bucket and the
BN running statistics are float32 (the parameters' and buffers' dtype; the
bf16 deconv of a model built from scratch joins the bucket in float32),
and the loss normalizers and metrics go over in float64.

Every rank clips the exchanged gradients and decides the NaN guard on the
reduced loss, so all ranks step or skip together and hold the same
weights. ``remat`` recomputes the forward in the backward
(``torch.utils.checkpoint``): the same step, with the activations of one
forward freed; the train-mode BN running statistics are restored after the
recompute, which would otherwise update them twice.
"""
from __future__ import annotations

import contextlib
import logging
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from siammask_tpu_torch.models.losses import (POS_PER_SAMPLE, select_cross_entropy_loss,
                                              select_mask_logistic_loss, weight_l1_loss)
from siammask_tpu_torch.parallel.dist import all_reduce_tensors
from siammask_tpu_torch.parallel.sync_bn import convert_sync_bn
from siammask_tpu_torch.train.checkpoint import load_checkpoint
from siammask_tpu_torch.utils import trace

TASKS = ("siamrpn", "base", "sharp", "sharp_refine")
GROUPS = ("resnet", "neck", "rpn", "mask", "refine")
# the split clip's three norms: backbone+neck jointly, rpn, mask+refine
CLIP_GROUPS = {"resnet": "feature", "neck": "feature", "rpn": "rpn", "mask": "mask",
               "refine": "mask"}
_HEADS = {"rpn_model": "rpn", "mask_model": "mask", "refine_model": "refine"}


def _label_for(name: str, unfreeze_backbone: bool, train_refine_only: bool) -> str:
    top = name.split(".")[0]
    if train_refine_only:
        return {"mask_model": "mask", "refine_model": "refine"}.get(top, "frozen")
    if name.startswith("features.downsample."):
        return "neck"
    if name.startswith("features.features."):
        if name.split(".")[2] in ("conv1", "bn1", "layer1"):
            return "frozen"
        return "resnet" if unfreeze_backbone else "frozen"
    if top in _HEADS:
        return _HEADS[top]
    raise KeyError(f"unknown parameter {name}")


def label_params(model: nn.Module, unfreeze_backbone: bool,
                 train_refine_only: bool = False) -> dict[str, str]:
    """Parameter name -> optimizer-group label (a group of ``GROUPS`` or
    ``frozen``). The stem and layer1 are always frozen; layer2/3 follow the
    unfreeze schedule; ``train_refine_only`` (stage-2 refine training) freezes
    everything but the mask head and Refine."""
    return {name: _label_for(name, unfreeze_backbone, train_refine_only)
            for name, _ in model.named_parameters()}


@dataclass
class OptimizerConfig:
    momentum: float = 0.9
    weight_decay: float = 1e-4
    # the global clip norm; with clip_split (the reference train_siammask.py's
    # per-module clip) the backbone+neck one, and the rpn and mask+refine
    # grads are clipped to their own limits
    clip: float = 10.0
    clip_split: bool = False
    clip_rpn: float = 10.0
    clip_mask: float = 10.0
    feature_lr_mult: float = 1.0
    rpn_lr_mult: float = 1.0
    mask_lr_mult: float = 1.0

    @classmethod
    def from_lr_cfg(cls, lr_cfg: dict, clip: float = 10.0,
                    clip_cfg: dict | None = None) -> "OptimizerConfig":
        clip_cfg = clip_cfg or {}
        feature = clip_cfg.get("feature") or clip
        return cls(feature_lr_mult=lr_cfg.get("feature_lr_mult", 1.0),
                   rpn_lr_mult=lr_cfg.get("rpn_lr_mult", 1.0),
                   mask_lr_mult=lr_cfg.get("mask_lr_mult", 1.0),
                   clip=feature,
                   clip_split=bool(clip_cfg.get("split", False)),
                   clip_rpn=clip_cfg.get("rpn") or clip,
                   clip_mask=clip_cfg.get("mask") or feature)

    def lr_mults(self) -> dict[str, float]:
        return {"resnet": 0.1 * self.feature_lr_mult, "neck": self.feature_lr_mult,
                "rpn": self.rpn_lr_mult, "mask": self.mask_lr_mult,
                "refine": self.mask_lr_mult}


def build_optimizer(model: nn.Module, cfg: OptimizerConfig, unfreeze_backbone: bool,
                    train_refine_only: bool = False):
    """SGD with one group per non-empty label -> (optimizer, labels). Each
    group carries its ``name`` and LR ``mult``; ``train_step`` sets
    ``lr = lr_spaces[epoch] * mult``."""
    labels = label_params(model, unfreeze_backbone, train_refine_only)
    mults = cfg.lr_mults()
    params = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        if labels[name] != "frozen":
            params[labels[name]].append(p)
    groups = [{"params": ps, "name": g, "mult": mults[g], "lr": 0.0}
              for g, ps in params.items() if ps]
    optimizer = torch.optim.SGD(groups, lr=0.0, momentum=cfg.momentum, dampening=0.0,
                                weight_decay=cfg.weight_decay, nesterov=False)
    return optimizer, labels


@dataclass
class TrainSettings:
    task: str = "sharp"                     # one of TASKS
    loss_weight: tuple = (1.0, 1.0, 36.0)   # (cls, loc, mask)
    o_sz: int = 63                          # the base mask head's rows
    g_sz: int = 127                         # the ground-truth windows
    mask_pad: int = 32                      # 32 for a 255 search, 0 for 143

    def __post_init__(self):
        if self.task not in TASKS:
            raise ValueError(f"unknown task {self.task!r}, expected one of {TASKS}")

    @classmethod
    def for_search(cls, task: str, loss_weight, search_size: int) -> "TrainSettings":
        """The training CLI's settings: the mask windows unpadded when the
        search is under 255 (sharp's 143), else padded by 32."""
        return cls(task=task, loss_weight=tuple(loss_weight),
                   mask_pad=0 if search_size < 255 else 32)


def _clip(optimizer: torch.optim.Optimizer, cfg: OptimizerConfig) -> None:
    if not cfg.clip_split:
        params = [p for g in optimizer.param_groups for p in g["params"]]
        torch.nn.utils.clip_grad_norm_(params, cfg.clip)
        return
    limits = {"feature": cfg.clip, "rpn": cfg.clip_rpn, "mask": cfg.clip_mask}
    split = {k: [] for k in limits}
    for g in optimizer.param_groups:
        split[CLIP_GROUPS[g["name"]]].extend(g["params"])
    for k, params in split.items():
        if params:
            torch.nn.utils.clip_grad_norm_(params, limits[k])


def _train_bn_buffers(model: nn.Module) -> list[torch.Tensor]:
    return [buf for m in model.modules() if isinstance(m, nn.BatchNorm2d) and m.training
            for buf in m.buffers()]


def _forward(model: nn.Module, template: torch.Tensor, search: torch.Tensor, task: str):
    """(score, loc, mask prediction or None) of the task's training graph."""
    if task == "siamrpn":
        return (*model.forward_train(template, search), None)
    if task == "base":
        return model.forward_train(template, search)
    train = task != "sharp_refine"
    return model.forward_train(template, search, train_backbone_neck=train, train_rpn=train)


@contextlib.contextmanager
def _bn_buffers_kept(model: nn.Module):
    """While open, train-mode BN buffers may change; they are put back after."""
    bufs = _train_bn_buffers(model)
    saved = [b.clone() for b in bufs]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, old in zip(bufs, saved):
                b.copy_(old)


def _remat_forward(model: nn.Module, template: torch.Tensor, search: torch.Tensor, task: str):
    """``_forward`` whose activations are recomputed in the backward. The
    recompute runs train-mode BN again: its running statistics are restored
    after it (the forward's update stands), and a synced BN issues its
    collectives again, on every rank alike."""
    return checkpoint(_forward, model, template, search, task, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _bn_buffers_kept(model)))


def global_counts(batch: dict, task: str) -> dict:
    """The global batch's loss normalizers, the keyword arguments of the
    losses: positive and negative anchors and (mask tasks) the valid mask
    rows, each rank's top-k selection of its positive cells (the sampler's
    16 positives a sample make those the global top-k's), summed over the
    group by one all-reduce; and the global batch, every rank's rows alike."""
    cls = batch["label_cls"]
    b = cls.shape[0]
    counts = [(cls == 1).sum(), (cls == 0).sum()]
    if task != "siamrpn":
        w = batch["label_mask_weight"]
        counts.append((w == 1).sum().clamp(max=min(POS_PER_SAMPLE * b, w.numel())))
    counts = torch.stack(counts).to(torch.float64)
    all_reduce_tensors([counts])
    return {"npos": counts[0], "nneg": counts[1], "nval": counts[2] if len(counts) > 2 else None,
            "batch": b * dist.get_world_size()}


def _reduce_metrics(metrics: dict, op: str) -> dict:
    """Every metric summed or averaged over the group, one collective."""
    names = list(metrics)
    flat = torch.stack([metrics[k].detach().to(torch.float64) for k in names])
    all_reduce_tensors([flat], op)
    return {k: v.to(metrics[k].dtype) for k, v in zip(names, flat.unbind())}


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer, batch: dict, lr: float,
               settings: TrainSettings, opt_cfg: OptimizerConfig, distributed: bool = False,
               fused_allreduce: bool = False, remat: bool = False) -> dict[str, torch.Tensor]:
    """One step of ``settings.task`` (the JAX ``make_train_step``): forward,
    loss, backward, clip, NaN guard, SGD step. Returns the JAX package's
    metrics for the task, as 0-d tensors on the model's device: SiamRPN has
    no mask prediction and so no mask loss and no mask metrics; the mask
    families report every term, a zero-weighted one too.

    ``distributed``: this rank's rows of the global batch, in the default
    mode or ``fused_allreduce`` (the module docstring); the metrics are the
    global batch's. Sync-BN is the model's (``Trainer`` converts it).

    Train-mode BN updates its running variance with the biased batch
    variance, as flax does (``models.resnet.BatchNorm2d``; the original
    PyTorch reference's ``nn.BatchNorm2d`` takes the unbiased one)."""
    w_cls, w_loc, w_mask = settings.loss_weight
    with trace.span("train.prepare"):
        for g in optimizer.param_groups:
            g["lr"] = lr * g["mult"]
        # BN running statistics change during the forward: keep them for a skip
        bn_before = [buf.clone() for buf in _train_bn_buffers(model)]
        optimizer.zero_grad(set_to_none=True)

        exact = distributed and not fused_allreduce
        counts = global_counts(batch, settings.task) if exact else {}
    forward = _remat_forward if remat else _forward
    with trace.span("train.forward"):
        score, loc, pred_mask = forward(model, batch["template"], batch["search"],
                                        settings.task)
    with trace.span("train.loss"):
        cls_loss = select_cross_entropy_loss(score, batch["label_cls"], counts.get("npos"),
                                             counts.get("nneg"))
        loc_loss = weight_l1_loss(loc, batch["label_loc"], batch["label_loc_weight"],
                                  counts.get("batch"))
        metrics = {"cls_loss": cls_loss, "loc_loss": loc_loss}
        total = w_cls * cls_loss + w_loc * loc_loss
        if pred_mask is not None:
            m = select_mask_logistic_loss(pred_mask, batch["label_mask"],
                                          batch["label_mask_weight"], o_sz=settings.o_sz,
                                          g_sz=settings.g_sz, padding=settings.mask_pad,
                                          nval=counts.get("nval"))
            total = total + w_mask * m.loss
            metrics.update(mask_loss=m.loss, iou_mean=m.iou_mean, iou_at_5=m.iou_at_5,
                           iou_at_7=m.iou_at_7, mask_pos_overflow=m.pos_overflow)
        metrics["total_loss"] = total
    with trace.span("train.backward"):
        total.backward()
        # optax decays and carries momentum for every leaf of a group, reached
        # by the loss or not: give such a parameter a zero gradient (which also
        # keeps the bucket's layout fixed)
        params = [p for g in optimizer.param_groups for p in g["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    if distributed:
        with trace.span("train.exchange"):
            op = "mean" if fused_allreduce else "sum"
            all_reduce_tensors([p.grad for p in params], op)
            if fused_allreduce:
                all_reduce_tensors([b for b in _train_bn_buffers(model)
                                    if b.is_floating_point()], "mean")
            metrics = _reduce_metrics(metrics, op)
    with trace.span("train.clip"):
        _clip(optimizer, opt_cfg)

    # NaN/huge-loss guard (reference train_siammask.py): decided on the host
    # from one read of the loss a step, as the reference does (a batch-64
    # step is long next to that sync); distributed, from the reduced loss,
    # so every rank decides alike
    with trace.span("train.sync"):
        loss = metrics["total_loss"].item()
    ok = math.isfinite(loss) and abs(loss) <= 1e4
    with trace.span("train.optimizer"):
        if ok:
            optimizer.step()
        else:
            with torch.no_grad():
                for buf, old in zip(_train_bn_buffers(model), bn_before):
                    buf.copy_(old)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["skipped"] = torch.tensor(0.0 if ok else 1.0, device=total.device)
    return metrics


class Trainer:
    """Epoch-driven loop: owns the optimizer rebuild at the unfreeze
    boundary, the LR schedule and resume. IO-free: callers drive it with
    batches of device tensors, NCHW images (B, 3, H, W) in 0..255 and the
    labels of ``AnchorTarget`` (``data/dataset.py``'s ``to_device`` gives
    them).

    ``distributed`` runs ``train_step``'s data-parallel modes over the
    initialised default group (each rank passes its rows of the global
    batch); the default mode and ``sync_bn`` convert the model's BN to
    ``SyncBatchNorm2d`` in place. Without ``distributed``,
    ``fused_allreduce`` and ``sync_bn`` do nothing, as in the JAX
    ``Trainer`` without a mesh."""

    def __init__(self, model: nn.Module, settings: TrainSettings, opt_cfg: OptimizerConfig,
                 lr_spaces: np.ndarray, epochs: int, unfreeze_at: float = 0.5,
                 distributed: bool = False, fused_allreduce: bool = False,
                 sync_bn: bool = False, remat: bool = False):
        if distributed and not dist.is_initialized():
            raise RuntimeError("distributed=True needs an initialised process group "
                               "(parallel.dist.init_distributed)")
        self.model = model
        self.settings = settings
        self.opt_cfg = opt_cfg
        self.lr_spaces = lr_spaces
        self.epochs = epochs
        self.unfreeze_at = unfreeze_at
        self.distributed = distributed
        self.fused_allreduce = fused_allreduce and distributed
        self.remat = remat
        if distributed and (sync_bn or not fused_allreduce):
            convert_sync_bn(model)
        self._unfrozen = None
        self.optimizer = None
        self.labels = None
        self.steps = 0          # steps taken: the request id of the step's spans
        self._ensure_phase(0)

    def _ensure_phase(self, epoch: int) -> None:
        """At the unfreeze boundary: flip layer2/3 (gradients and BN mode)
        and rebuild the optimizer with fresh momentum. ``sharp_refine``
        never unfreezes."""
        refine_only = self.settings.task == "sharp_refine"
        unfrozen = not refine_only and epoch / self.epochs >= self.unfreeze_at
        if unfrozen == self._unfrozen:
            return
        self._unfrozen = unfrozen
        self.model.features.features.unfix(unfrozen)
        if refine_only:
            self.model.fix_for_refine(True)
        self.model.train()
        self.optimizer, self.labels = build_optimizer(self.model, self.opt_cfg, unfrozen,
                                                      refine_only)

    def restore(self, path: str) -> int:
        """Resume from a checkpoint: the weights, then the phase of its epoch
        (``min(epoch, epochs - 1)``), then the momentum, when the
        checkpoint's param groups (names and sizes) are the phase's; across
        the unfreeze boundary they are not, and momentum starts fresh, as the
        boundary's rebuild would. Returns the epoch to resume from."""
        ck = load_checkpoint(path)
        self.model.load_state_dict(ck["state_dict"])
        epoch = ck["epoch"]
        self._ensure_phase(min(epoch, self.epochs - 1))
        saved = ck["optimizer"]
        if saved is not None:
            theirs, ours = _group_layout(saved), _group_layout(self.optimizer.state_dict())
            if theirs == ours:
                self.optimizer.load_state_dict(saved)
            else:
                logging.getLogger(__name__).warning(
                    "optimizer state not restored: the checkpoint's param groups %s are "
                    "not this phase's %s (the other side of the unfreeze boundary); "
                    "momentum restarts", theirs, ours)
        return epoch

    def step(self, batch: dict, epoch: int) -> dict[str, torch.Tensor]:
        with trace.span("train.step", request=self.steps):
            self.steps += 1
            self._ensure_phase(epoch)
            lr = float(self.lr_spaces[min(epoch, len(self.lr_spaces) - 1)])
            return train_step(self.model, self.optimizer, batch, lr, self.settings,
                              self.opt_cfg, self.distributed, self.fused_allreduce, self.remat)


def _group_layout(state: dict) -> list[tuple[str, int]]:
    """(name, parameter count) of each group of an optimizer state_dict."""
    return [(g.get("name"), len(g["params"])) for g in state["param_groups"]]
