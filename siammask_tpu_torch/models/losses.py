"""Training losses: anchor-sampled cross-entropy, weighted L1, and the per-cell
mask logistic loss with its IoU metrics.

Counterpart of ``siammask_tpu/models/losses.py`` in NCHW (the reference's
``models/siammask.py`` base and ``models/siammask_sharp.py`` sharp losses):

- cls: NLL of the 2-way log-softmax, averaged separately over positive and
  negative anchors (label -1 is ignored), combined 0.5/0.5. The score's
  channels are blocked (2, k): ``score.view(B, 2, k, S, S)``.
- loc: per-anchor L1 summed over the 4 coordinates, weighted by
  ``loc_weight`` (1/num_pos on positives), summed, divided by the batch.
  Channels blocked (4, k).
- mask: ``softplus(-y * x)`` between each positive cell's predicted mask and
  its ground-truth window (g_sz x g_sz at stride 8 in the mask padded by
  ``padding``: 32 for the base 255 search, 0 for sharp). The base branch
  (4-D ``p_m``) upsamples each selected 63x63 row to 127x127 with
  align-corners bilinear; the sharp branch (2-D ``p_m``) takes rows as they
  are.

Shapes stay static as in the JAX package: the positive cells are a top-k of
``16 * B`` rows (``POS_PER_SAMPLE``, the target sampler's cap), and only those
windows are gathered, never all S*S of them.

Data-parallel training in the exact mode (``train/trainer.py``) gives each
loss the global count it normalizes by (positive and negative anchors, the
batch, the valid mask rows): each rank's loss is then its share of the
global-batch loss, and the shares sum to it. With no count given, each
loss normalizes by its own batch's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from siammask_tpu_torch.ops.resize import upsample_bilinear_align_corners

# the anchor target sampler's per-sample cap on positives; sizes the gather
POS_PER_SAMPLE = 16


def select_cross_entropy_loss(pred_cls: torch.Tensor, label_cls: torch.Tensor,
                              npos: torch.Tensor | None = None,
                              nneg: torch.Tensor | None = None) -> torch.Tensor:
    """pred_cls: (B, 2k, S, S) raw logits; label_cls: (B, k, S, S) in
    {-1 ignore, 0 neg, 1 pos}. ``npos`` / ``nneg``: the positive and
    negative anchors to divide by (this batch's when None)."""
    b, ck, s1, s2 = pred_cls.shape
    logp = F.log_softmax(pred_cls.view(b, 2, ck // 2, s1, s2), dim=1)
    pos = (label_cls == 1).to(logp.dtype)
    neg = (label_cls == 0).to(logp.dtype)
    npos = pos.sum() if npos is None else npos.to(logp.dtype)
    nneg = neg.sum() if nneg is None else nneg.to(logp.dtype)
    loss_pos = -(logp[:, 1] * pos).sum() / npos.clamp(min=1.0)
    loss_neg = -(logp[:, 0] * neg).sum() / nneg.clamp(min=1.0)
    return 0.5 * loss_pos + 0.5 * loss_neg


def weight_l1_loss(pred_loc: torch.Tensor, label_loc: torch.Tensor,
                   loss_weight: torch.Tensor, batch: int | None = None) -> torch.Tensor:
    """pred_loc: (B, 4k, S, S); label_loc: (B, 4, k, S, S); loss_weight:
    (B, k, S, S). ``batch``: the batch to divide by (B when None)."""
    b, ck, s1, s2 = pred_loc.shape
    diff = (pred_loc.view(b, 4, ck // 4, s1, s2) - label_loc).abs().sum(dim=1)
    return (diff * loss_weight).sum() / (b if batch is None else batch)


class MaskLossOut(NamedTuple):
    loss: torch.Tensor
    iou_mean: torch.Tensor
    iou_at_5: torch.Tensor
    iou_at_7: torch.Tensor
    # positives beyond the gather's capacity (0 unless max_pos is set below
    # 16 x batch): a silent undersample shows as a train metric
    pos_overflow: torch.Tensor


def _iou_rows(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Per-row mask IoU: pred >= 0 against label == 1."""
    p = pred >= 0
    lab = label == 1
    inter = (p & lab).sum(dim=-1).float()
    union = (p | lab).sum(dim=-1).float()
    return inter / union.clamp(min=1.0)


def select_mask_logistic_loss(p_m: torch.Tensor, mask: torch.Tensor, weight: torch.Tensor,
                              o_sz: int = 63, g_sz: int = 127, padding: int = 32,
                              max_pos: int | None = None,
                              nval: torch.Tensor | None = None) -> MaskLossOut:
    """p_m: (B, o_sz**2, S, S) raw mask-head output (base), or
    (B*S*S, g_sz**2) refined logits, cells row-major per sample (sharp).
    mask: (B, H, W) ground truth in {-1, +1}; weight: (B, S, S), 1 on
    positive cells. ``max_pos`` caps the positive rows (default 16 x B).
    ``nval``: the valid rows to divide the loss and the IoU metrics by
    (this batch's selected positives when None)."""
    w_flat = weight.reshape(-1)
    if max_pos is None:
        max_pos = POS_PER_SAMPLE * weight.shape[0]
    sel_w, sel_idx = torch.topk(w_flat, min(max_pos, w_flat.numel()))
    valid = (sel_w == 1).to(torch.float32)
    n_sel = valid.sum()
    overflow = (w_flat == 1).sum().to(torch.float32) - n_sel

    sgrid = weight.shape[1]
    if (mask.shape[1] + 2 * padding - g_sz) // 8 + 1 != sgrid:
        raise ValueError(f"mask {tuple(mask.shape)} with padding {padding} does not "
                         f"unfold to the {sgrid}x{sgrid} weight grid")
    cells = sgrid * sgrid
    bi, cell = sel_idx // cells, sel_idx % cells
    ys, xs = cell // sgrid, cell % sgrid

    # the selected ground-truth windows, gathered from the padded mask
    pad_m = F.pad(mask, (padding, padding, padding, padding))
    ar = torch.arange(g_sz, device=mask.device)
    rows = (8 * ys)[:, None] + ar
    cols = (8 * xs)[:, None] + ar
    gt_sel = pad_m[bi[:, None, None], rows[:, :, None], cols[:, None, :]]
    gt_sel = gt_sel.reshape(-1, g_sz * g_sz)

    if p_m.dim() == 4:
        pred_sel = p_m[bi, :, ys, xs].reshape(-1, o_sz, o_sz, 1)
        pred_sel = upsample_bilinear_align_corners(pred_sel, (g_sz, g_sz))
        pred_sel = pred_sel.reshape(-1, g_sz * g_sz)
    else:
        pred_sel = p_m.index_select(0, sel_idx)

    per_row = F.softplus(-gt_sel * pred_sel).mean(dim=-1)
    denom = (n_sel if nval is None else nval.to(torch.float32)).clamp(min=1.0)
    loss = (per_row * valid).sum() / denom
    iou = _iou_rows(pred_sel, gt_sel)
    return MaskLossOut(loss, (iou * valid).sum() / denom,
                       ((iou > 0.5) * valid).sum() / denom,
                       ((iou > 0.7) * valid).sum() / denom, overflow)
