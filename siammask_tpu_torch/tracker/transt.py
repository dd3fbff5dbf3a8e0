"""The TransT tracker on the device: one object, O objects on one frame, and
whole videos, box only.

The published tracker (chenxin-dlut/TransT ``pysot_toolkit/trackers/
tracker.py``), per frame and object:

- the search crop: a square of side ``ceil(sqrt(w_x h_x))`` at the target,
  ``w_x = w + (f - 1)(w + h) / 2`` (``h_x`` alike) with ``f`` =
  ``search_factor`` (4), resized to the model's search size (256) with the
  frame's per-channel mean as the border (``ops/sample.py``
  ``subwindow_crop``, the SiamMask trackers' crop); the template's alike,
  with ``template_factor`` (2) at the template size (128), once, at init;
- the network (``models/transt.py``): foreground probability (the softmax's
  index 0) and box on each of the 32 x 32 search tokens;
- the score ``p (1 - wi) + hann(32) (x) hann(32) wi``, ``wi`` =
  ``window_influence`` (0.49), its argmax, and that token's box as
  predicted, scaled by the crop side, with no size smoothing: the centre
  ``pos + (cx, cy) s_x - s_x / 2``, the size ``(w, h) s_x``; the centre
  clipped to the frame, each side to ``[10, frame side]``.

The settings are read from the tracker config ``p`` (an experiment
config's ``hp``: ``template_factor``, ``search_factor``,
``window_influence``); the crop sizes from the model's ``TransTConfig``.

State and entry points are ``SiameseTracker``'s (``tracker/tracker.py``):
a ``TrackState`` whose ``zf`` holds the template's projected tokens (O,
256, d), computed once in ``init_batched``; ``step`` / ``step_batched``
return a ``BoxStepOutput``; on a card ``track_video_multi`` replays one
CUDA graph a frame, captured for each (O, H, W, frame dtype), after the
folded BatchNorm weights are brought up to date. No step syncs with the
host.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from siammask_tpu_torch.models.transt import TransT
from siammask_tpu_torch.ops.sample import subwindow_crop
from siammask_tpu_torch.tracker.tracker import BoxStepOutput, SiameseTracker, TrackState
from siammask_tpu_torch.utils import trace

MIN_SIDE = 10.0     # the published clip's least box side


@dataclass(frozen=True)
class TransTParams:
    template_factor: float = 2.0
    search_factor: float = 4.0
    window_influence: float = 0.49

    @classmethod
    def of(cls, p) -> "TransTParams":
        """The settings a tracker config holds, the published ones where it
        has no such attribute (a ``TrackerConfig`` always has
        ``window_influence``: give it the experiment config's ``hp``)."""
        return cls(**{f.name: getattr(p, f.name) for f in fields(cls) if hasattr(p, f.name)})


def crop_side(target_sz: torch.Tensor, factor: float) -> torch.Tensor:
    """(O,) ``ceil(sqrt(w_c h_c))`` of each (w, h) with context ``factor``."""
    extra = (factor - 1) * target_sz.sum(-1) / 2
    return torch.ceil(torch.sqrt((target_sz[..., 0] + extra) * (target_sz[..., 1] + extra)))


class TransTTracker(SiameseTracker):
    """The tracker of a ``TransT`` model (on ``device``, in eval mode); ``p``
    a tracker config (the module docstring). Box only."""

    mask = False

    def __init__(self, model: TransT, p, device: torch.device | str):
        super().__init__()
        self.model = model
        self.hp = TransTParams.of(p)
        self.device = torch.device(device)
        n = model.cfg.search_side
        self.window = torch.as_tensor(np.outer(np.hanning(n), np.hanning(n)).ravel(),
                                      dtype=torch.float32, device=self.device)
        self.frame_index = 0

    def _before_capture(self, im_h: int, im_w: int) -> None:
        self.model.consts(self.device)      # made once, never under capture

    @torch.inference_mode()
    def init_batched(self, frame, target_pos, target_sz) -> TrackState:
        """O objects on one frame: target_pos / target_sz (O, 2). One
        template pass at batch O; the video's next frame is then frame 1."""
        with trace.span("tracker.init_batched", request=0):
            cfg = self.model.cfg
            frame = self._frame(frame)
            pos = torch.as_tensor(target_pos, dtype=torch.float32, device=self.device)
            sz = torch.as_tensor(target_sz, dtype=torch.float32, device=self.device)
            o = pos.shape[0]
            self.frame_index = 1
            avg = frame.mean(dim=(0, 1), dtype=torch.float32).expand(o, -1).contiguous()
            z = subwindow_crop(frame, pos, crop_side(sz, self.hp.template_factor),
                               cfg.template_size, avg)
            zf = self.model.template(self.model.preprocess(z))
            return TrackState(pos, sz, zf, avg, torch.zeros(o, dtype=torch.float32,
                                                            device=self.device))

    def search(self, state: TrackState, frame: torch.Tensor) -> tuple:
        """The search crop and the network for O objects: foreground
        probabilities (O, N), boxes (O, N, 4) in crop fractions, both
        float32, and the crop sides (O,)."""
        s_x = crop_side(state.target_sz, self.hp.search_factor)
        x = subwindow_crop(frame, state.target_pos, s_x, self.model.cfg.search_size,
                           state.avg_chans)
        logits, boxes = self.model.track(state.zf, self.model.preprocess(x))
        fg = torch.softmax(logits.float(), dim=-1)[..., 0]
        return fg, boxes.float(), s_x

    def _step_body(self, state: TrackState, frame: torch.Tensor):
        im_h, im_w = frame.shape[0], frame.shape[1]
        fg, boxes, s_x = self.search(state, frame)
        wi = self.hp.window_influence
        best = torch.argmax(fg * (1 - wi) + self.window * wi, dim=1)
        box = boxes.gather(1, best[:, None, None].expand(-1, 1, 4))[:, 0] * s_x[:, None]
        centre = state.target_pos + box[:, :2] - s_x[:, None] / 2
        new_pos = torch.stack([centre[:, 0].clamp(0, im_w), centre[:, 1].clamp(0, im_h)], 1)
        new_sz = torch.stack([box[:, 2].clamp(max=im_w).clamp(min=MIN_SIDE),
                              box[:, 3].clamp(max=im_h).clamp(min=MIN_SIDE)], 1)
        score = fg.gather(1, best[:, None])[:, 0]
        new_state = state._replace(target_pos=new_pos, target_sz=new_sz, score=score)
        return new_state, BoxStepOutput(new_pos, new_sz, score, best)
