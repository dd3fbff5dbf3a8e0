"""Single-object SiamMask-sharp tracker on the device.

Counterpart of the ``mask=True, refine=True`` path of
``siammask_tpu/tracker/tracker.py``. One ``step`` runs the whole frame on the
model's device -- sub-window crop, backbone and heads, anchor decode,
scale/ratio penalty, cosine-window argmax, state update, Refine at the best
cell, sigmoid and warp-back to the frame -- without a host sync: no
``.item()``, no copy to the host, no branch on a device value. Anchors, the
window and the frame-bound clamps are device constants built once.

The numerics are the reference's: context-scaled crop sizes rounded half to
even, the decode/penalty formulas, the EMA size update, the sub-box/back-box
warp geometry and the final clamp.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from siammask_tpu_torch.config import TrackerConfig
from siammask_tpu_torch.ops.sample import subwindow_crop, warp_back_mask
from siammask_tpu_torch.tracker.anchors import generate_score_map_anchors


class TrackState(NamedTuple):
    target_pos: torch.Tensor   # (2,) center x, y in frame coords
    target_sz: torch.Tensor    # (2,) w, h in frame coords
    zf: torch.Tensor           # (1, 256, 7, 7) template features
    avg_chans: torch.Tensor    # (3,) frame channel means (crop border)
    score: torch.Tensor        # () best score of the last step


class StepOutput(NamedTuple):
    target_pos: torch.Tensor     # (2,) updated center (clamped)
    target_sz: torch.Tensor      # (2,) updated size (clamped)
    score: torch.Tensor          # () score at the best cell
    best_id: torch.Tensor        # () flat argmax over (k, S, S)
    mask_in_frame: torch.Tensor  # (im_h, im_w) soft mask in frame coords
    mask_logits: torch.Tensor    # (out_sz, out_sz) sigmoid mask in cell coords


def make_window(p: TrackerConfig) -> np.ndarray:
    s = p.score_size
    if p.windowing == "cosine":
        w = np.outer(np.hanning(s), np.hanning(s))
    else:
        w = np.ones((s, s))
    return np.tile(w.flatten(), p.anchor_num).astype(np.float32)


def _context_size(target_sz, context_amount):
    wc = target_sz[0] + context_amount * target_sz.sum()
    hc = target_sz[1] + context_amount * target_sz.sum()
    return torch.sqrt(wc * hc)


class Tracker:
    """Tracker for one SiamMaskSharp model (already on ``device``, in eval
    mode) and one config. Frames are (H, W, 3) uint8 or float arrays or
    tensors; a tensor already on the device is used as it is."""

    def __init__(self, model, p: TrackerConfig, device: torch.device | str):
        self.model = model
        self.p = p
        self.device = torch.device(device)
        self.anchor = torch.as_tensor(
            generate_score_map_anchors(p.anchor_config(), p.score_size), device=self.device)
        self.window = torch.as_tensor(make_window(p), device=self.device)
        self._bounds: dict[tuple[int, int], tuple[torch.Tensor, ...]] = {}

    def _frame(self, frame) -> torch.Tensor:
        return torch.as_tensor(frame, device=self.device)

    def _clamps(self, im_h: int, im_w: int):
        """(0, 0), (10, 10) and (W, H) for the final clamp, per frame size."""
        key = (im_h, im_w)
        if key not in self._bounds:
            f32 = dict(dtype=torch.float32, device=self.device)
            self._bounds[key] = (torch.zeros(2, **f32), torch.full((2,), 10.0, **f32),
                                 torch.tensor([im_w, im_h], **f32))
        return self._bounds[key]

    @torch.inference_mode()
    def init(self, frame, target_pos, target_sz) -> TrackState:
        """frame (H, W, 3); target_pos / target_sz: (2,) center and size."""
        p = self.p
        frame = self._frame(frame)
        self._clamps(frame.shape[0], frame.shape[1])  # built here, not in a step
        target_pos = torch.as_tensor(target_pos, dtype=torch.float32, device=self.device)
        target_sz = torch.as_tensor(target_sz, dtype=torch.float32, device=self.device)
        avg_chans = frame.mean(dim=(0, 1), dtype=torch.float32)
        s_z = torch.round(_context_size(target_sz, p.context_amount))
        z_crop = subwindow_crop(frame, target_pos, s_z, p.exemplar_size, avg_chans)
        zf = self.model.template(z_crop.permute(2, 0, 1)[None].contiguous())
        return TrackState(target_pos, target_sz, zf, avg_chans,
                          torch.zeros((), dtype=torch.float32, device=self.device))

    @torch.inference_mode()
    def step(self, state: TrackState, frame) -> tuple[TrackState, StepOutput]:
        p = self.p
        k, s = p.anchor_num, p.score_size
        frame = self._frame(frame)
        im_h, im_w = frame.shape[0], frame.shape[1]
        target_pos, target_sz = state.target_pos, state.target_sz

        # search-region geometry
        s_x = _context_size(target_sz, p.context_amount)
        scale_x = p.exemplar_size / s_x
        pad = (p.instance_size - p.exemplar_size) / 2 / scale_x
        s_x_full = torch.round(s_x + 2 * pad)
        crop_xy = target_pos - s_x_full / 2

        x_crop = subwindow_crop(frame, target_pos, s_x_full, p.instance_size, state.avg_chans)
        out = self.model.track_mask(state.zf, x_crop.permute(2, 0, 1)[None].contiguous())

        # decode; NCHW channels are blocked (2, k) / (4, k), so a reshape
        # gives the anchor-major (C, k*S*S) layout of the anchor table
        logits = out.score.reshape(2, k * s * s)
        score = torch.sigmoid(logits[1] - logits[0])     # 2-way softmax fg prob
        delta = out.loc.reshape(4, k * s * s)
        dx = delta[0] * self.anchor[:, 2] + self.anchor[:, 0]
        dy = delta[1] * self.anchor[:, 3] + self.anchor[:, 1]
        # exp overflows fp32 past 88; |delta| <= 20 is identity for real boxes
        dw = torch.exp(delta[2].clamp(-20.0, 20.0)) * self.anchor[:, 2]
        dh = torch.exp(delta[3].clamp(-20.0, 20.0)) * self.anchor[:, 3]

        def change(r):
            return torch.maximum(r, 1.0 / r)

        def ssz(w, h):
            pad_ = (w + h) * 0.5
            return torch.sqrt((w + pad_) * (h + pad_))

        target_in_crop = target_sz * scale_x
        s_c = change(ssz(dw, dh) / ssz(target_in_crop[0], target_in_crop[1]))
        r_c = change((target_in_crop[0] / target_in_crop[1]) / (dw / dh))
        penalty = torch.exp(-(r_c * s_c - 1) * p.penalty_k)
        pscore = penalty * score * (1 - p.window_influence) + self.window * p.window_influence
        best = torch.argmax(pscore)
        bi = best.view(1)

        def at(v):
            return v.index_select(0, bi)[0]

        # state update
        lr = at(penalty) * at(score) * p.lr
        new_pos = target_pos + torch.stack([at(dx), at(dy)]) / scale_x
        pred_wh = torch.stack([at(dw), at(dh)]) / scale_x
        new_sz = target_sz * (1 - lr) + pred_wh * lr

        # refine at the best cell, then warp back to the frame
        cell = best % (s * s)
        delta_y = cell // s
        delta_x = cell % s
        logits_m = self.model.track_refine(out.skips, out.corr, torch.stack([delta_y, delta_x]))
        mask_cell = torch.sigmoid(logits_m.reshape(p.out_size, p.out_size))

        sc = s_x_full / p.instance_size
        sub_x = crop_xy[0] + (delta_x - p.base_size / 2) * p.total_stride * sc
        sub_y = crop_xy[1] + (delta_y - p.base_size / 2) * p.total_stride * sc
        sub_w = sc * p.exemplar_size
        s2 = p.out_size / sub_w
        back_box = torch.stack([-sub_x * s2, -sub_y * s2, im_w * s2, im_h * s2])
        mask_in_frame = warp_back_mask(mask_cell, back_box, (im_h, im_w))

        # clamp into the frame
        zero, ten, wh = self._clamps(im_h, im_w)
        new_pos = torch.minimum(torch.maximum(new_pos, zero), wh)
        new_sz = torch.minimum(torch.maximum(new_sz, ten), wh)

        best_score = at(score).to(torch.float32)
        new_state = state._replace(target_pos=new_pos, target_sz=new_sz, score=best_score)
        return new_state, StepOutput(new_pos, new_sz, best_score, best,
                                     mask_in_frame, mask_cell)
