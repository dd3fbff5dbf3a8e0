"""The tracker on the device: one object, O objects at once, and whole
videos, for the three model families.

Counterpart of ``siammask_tpu/tracker/tracker.py``. ``mask`` and ``refine``
pick the path, as the reference's ``--mask``/``--refine``:

- ``mask=True, refine=True``: SiamMask-sharp, Refine at the best cell to a
  127x127 mask;
- ``mask=True, refine=False``: the raw 63x63 mask head's vector at the
  best cell (SiamMask-base, or SiamMask-sharp without its Refine);
- ``mask=False``: box only (any family; SiamRPN has nothing else), and the
  step returns a ``BoxStepOutput`` with no mask fields.

One step runs the whole frame on the model's device -- sub-window crop,
backbone and heads, anchor decode, scale/ratio penalty, cosine-window
argmax, state update and, with the mask, the cell's mask, its sigmoid and
the warp-back to the frame -- without a host sync: no ``.item()``, no copy
to the host, no branch on a device value. Anchors, the window and the
frame-bound clamps are device constants built once.

There is one step body, ``_step_body``, with a leading stream axis O: the
JAX package's ``vmap`` of its step over streams, written out. Every stream
shares the frame and carries its own state. ``step`` is its O=1 case, so
the single-object and the batched paths run the same kernels.

- ``init`` / ``step``: one object (TrackState leaves (2,), (2,),
  (1, 256, 7, 7), (3,), ()).
- ``init_batched`` / ``step_batched``: O objects on one frame (every leaf
  with a leading O axis: (O, 2), (O, 2), (O, 256, 7, 7), (O, 3), (O,)).
- ``track_video`` / ``track_video_multi``: T frames (T, H, W, 3), the
  counterparts of the JAX package's ``lax.scan``; every output is stacked
  along a leading T axis. On a CUDA device the frames are replayed through a
  CUDA graph of the step (``StepGraph``), one per (O, H, W, frame dtype),
  the most recently used kept on the tracker; on the CPU they are a plain
  loop over the step.

The crops are NHWC; on a card they go to the model as channels_last views
(``ops/layout.py`` ``model_input``), so its maps stay NHWC through every
conv; on the CPU they are copied to NCHW.

The numerics are the reference's: context-scaled crop sizes rounded half to
even, the decode/penalty formulas, the EMA size update, the sub-box/back-box
warp geometry and the final clamp.

A bf16 model (``build_model(..., dtype=torch.bfloat16)``) runs the JAX
package's bf16 step with ``latency_lowerings=False``: the crop stays float32
from the uint8 frame; the maps, their score sigmoid, the template features
in the state (``zf``) and the cell mask (``mask_logits``) are bf16; the
float32 anchors, window and penalty promote the decode, so the positions,
sizes and the carried score are float32, and the warp-back blends the bf16
mask with float32 fractions into a float32 ``mask_in_frame``. The step's
signature, and so a ``StepGraph``'s key, does not depend on the dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from siammask_tpu_torch.config import TrackerConfig
from siammask_tpu_torch.models.siammask import (SiamMaskBase, SiamMaskSharp, TrackOutputs,
                                                at_cells)
from siammask_tpu_torch.ops import _build
from siammask_tpu_torch.ops.layout import model_input
from siammask_tpu_torch.ops.sample import subwindow_crop, warp_back_mask
from siammask_tpu_torch.ops.xcorr import depthwise_xcorr
from siammask_tpu_torch.tracker.anchors import generate_score_map_anchors
from siammask_tpu_torch.utils import trace

MAX_GRAPHS = 2      # captured step graphs a tracker keeps, most recently used


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
    mask_logits: torch.Tensor    # (out_sz, out_sz) sigmoid mask in cell coords (model dtype)


class BoxStepOutput(NamedTuple):
    """A box-only step's outputs: tensors only, so a CUDA graph can hold them."""
    target_pos: torch.Tensor
    target_sz: torch.Tensor
    score: torch.Tensor
    best_id: torch.Tensor


def _batch(state: TrackState) -> TrackState:
    """One object's state as the O=1 batched state (zf has its axis already)."""
    return TrackState(state.target_pos[None], state.target_sz[None], state.zf,
                      state.avg_chans[None], state.score[None])


def _unbatch(state: TrackState) -> TrackState:
    return TrackState(state.target_pos[0], state.target_sz[0], state.zf,
                      state.avg_chans[0], state.score[0])


def make_window(p: TrackerConfig) -> np.ndarray:
    s = p.score_size
    if p.windowing == "cosine":
        w = np.outer(np.hanning(s), np.hanning(s))
    else:
        w = np.ones((s, s))
    return np.tile(w.flatten(), p.anchor_num).astype(np.float32)


def _context_size(target_sz, context_amount):
    """sqrt(wc * hc) of each stream's (..., 2) size."""
    total = target_sz.sum(-1)
    wc = target_sz[..., 0] + context_amount * total
    hc = target_sz[..., 1] + context_amount * total
    return torch.sqrt(wc * hc)


class StepGraph:
    """The batched step captured as one CUDA graph for (O, H, W, frame dtype).

    Inputs and outputs live in static buffers: ``frame`` and ``state`` in,
    ``out`` out. The captured step ends by copying the new state into
    ``state``, so a replay advances the state on the device and nothing goes
    to the host between frames. ``xcorr_launches`` is the number of xcorr
    kernels captured, ``xcorr_packed_launches`` the packed bf16 kernel's
    among them: each replay launches that many without passing through the
    wrapper (whose counts move only at capture).

    The warm-up and the capture run on ``side``, one stream kept by the
    tracker: a library workspace is kept per stream, so a new stream for
    every capture would hold one more workspace each time (32 MiB each on an
    H100)."""

    def __init__(self, tracker: Tracker, state: TrackState, frame: torch.Tensor,
                 side: torch.cuda.Stream):
        device = frame.device
        _build.load_library()           # nvcc runs at first use, never under capture
        self.frame = frame.clone()
        self.state = TrackState(*(t.clone() for t in state))
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):     # warm-up, as torch.cuda.graph asks
            for _ in range(2):
                tracker._step_body(self.state, self.frame)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = depthwise_xcorr.launches, depthwise_xcorr.packed_launches
        with torch.cuda.graph(self.graph, stream=side):
            new_state, self.out = tracker._step_body(self.state, self.frame)
            for static, new in zip(self.state, new_state):
                if new is not static:
                    static.copy_(new)
        self.xcorr_launches = depthwise_xcorr.launches - before[0]
        self.xcorr_packed_launches = depthwise_xcorr.packed_launches - before[1]

    def run(self, state: TrackState, frames: torch.Tensor):
        """Copy ``state`` in, replay once per frame, copy each frame's
        outputs into fresh (T, ...) stacks; the final state is returned as
        fresh tensors too, so the caller never holds a static buffer. Per
        frame the host issues a frame copy, the replay and one copy per
        output."""
        with trace.span("step_graph.run"):
            for static, value in zip(self.state, state):
                static.copy_(value)
            stacks = [torch.empty((frames.shape[0], *v.shape), dtype=v.dtype, device=v.device)
                      for v in self.out]
            for t in range(frames.shape[0]):
                with trace.span("step_graph.replay"):
                    self.frame.copy_(frames[t])
                    self.graph.replay()
                    for stack, value in zip(stacks, self.out):
                        stack[t].copy_(value)
            return TrackState(*(t.clone() for t in self.state)), type(self.out)(*stacks)


class Tracker:
    """Tracker for one model (already on ``device``, in eval mode) and one
    config. Frames are (H, W, 3) uint8 or float arrays or tensors; a tensor
    already on the device is used as it is. ``mask=True`` needs a mask
    family: with ``refine=True`` a ``SiamMaskSharp``, with ``refine=False``
    either (the 63x63 head, so ``p.out_size`` must be 63). Steps return a
    ``StepOutput``, or a ``BoxStepOutput`` with ``mask=False``.

    ``graphs`` holds the captured ``StepGraph`` of the ``MAX_GRAPHS`` most
    recently used (O, H, W, frame dtype) keys. Each graph keeps a private
    memory pool of one step's intermediates, which grows with O and the frame
    size, so a run over videos of many object counts and sizes drops the
    least recently used graph, and with it its pool, before it captures
    another."""

    def __init__(self, model, p: TrackerConfig, device: torch.device | str,
                 mask: bool = True, refine: bool = True):
        families = (SiamMaskSharp,) if refine else (SiamMaskBase, SiamMaskSharp)
        if mask and not isinstance(model, families):
            raise ValueError(f"mask={mask}, refine={refine} needs a "
                             f"{' or '.join(f.__name__ for f in families)}, "
                             f"not a {type(model).__name__}")
        if mask and not refine and p.out_size != 63:
            raise ValueError(f"refine=False reads the 63x63 mask head, "
                             f"but p.out_size is {p.out_size}")
        self.model = model
        self.p = p
        self.mask = mask
        self.refine = refine
        self.device = torch.device(device)
        self.anchor = torch.as_tensor(
            generate_score_map_anchors(p.anchor_config(), p.score_size), device=self.device)
        self.window = torch.as_tensor(make_window(p), device=self.device)
        self._bounds: dict[tuple[int, int], tuple[torch.Tensor, ...]] = {}
        self.graphs: dict[tuple, StepGraph] = {}
        self._side: torch.cuda.Stream | None = None   # every capture's stream
        # the video frame the next step takes (the init frame is 0): the
        # request id of the tracker's spans
        self.frame_index = 0

    def _frame(self, frame) -> torch.Tensor:
        host = not isinstance(frame, torch.Tensor) or (frame.device.type == "cpu"
                                                       and self.device.type != "cpu")
        frame = torch.as_tensor(frame, device=self.device)
        if host:
            trace.count("h2d_bytes", frame.nbytes)
        return frame

    def _clamps(self, im_h: int, im_w: int):
        """(0, 0), (10, 10) and (W, H) for the final clamp, per frame size."""
        key = (im_h, im_w)
        if key not in self._bounds:
            f32 = dict(dtype=torch.float32, device=self.device)
            self._bounds[key] = (torch.zeros(2, **f32), torch.full((2,), 10.0, **f32),
                                 torch.tensor([im_w, im_h], **f32))
        return self._bounds[key]

    # ---------------- init ----------------

    @torch.inference_mode()
    def init(self, frame, target_pos, target_sz) -> TrackState:
        """frame (H, W, 3); target_pos / target_sz: (2,) center and size."""
        pos = torch.as_tensor(target_pos, dtype=torch.float32, device=self.device)
        sz = torch.as_tensor(target_sz, dtype=torch.float32, device=self.device)
        return _unbatch(self.init_batched(frame, pos[None], sz[None]))

    @torch.inference_mode()
    def init_batched(self, frame, target_pos, target_sz) -> TrackState:
        """O objects on one frame: target_pos / target_sz (O, 2). One
        template pass at batch O; every leaf of the state has the O axis.
        The video's next frame is then frame 1."""
        with trace.span("tracker.init_batched", request=0):
            p = self.p
            frame = self._frame(frame)
            self._clamps(frame.shape[0], frame.shape[1])  # built here, not in a step
            target_pos = torch.as_tensor(target_pos, dtype=torch.float32, device=self.device)
            target_sz = torch.as_tensor(target_sz, dtype=torch.float32, device=self.device)
            o = target_pos.shape[0]
            self.frame_index = 1
            avg_chans = frame.mean(dim=(0, 1), dtype=torch.float32).expand(o, -1).contiguous()
            s_z = torch.round(_context_size(target_sz, p.context_amount))
            z_crop = subwindow_crop(frame, target_pos, s_z, p.exemplar_size, avg_chans)
            zf = self.model.template(model_input(z_crop.permute(0, 3, 1, 2)))
            return TrackState(target_pos, target_sz, zf, avg_chans,
                              torch.zeros(o, dtype=torch.float32, device=self.device))

    # ---------------- step ----------------

    def _search_window(self, state: TrackState):
        """Each stream's search crop side in frame pixels, s_x_full (O,), and
        its scale to the exemplar, scale_x (O,)."""
        p = self.p
        s_x = _context_size(state.target_sz, p.context_amount)
        scale_x = p.exemplar_size / s_x
        pad = (p.instance_size - p.exemplar_size) / 2 / scale_x
        return torch.round(s_x + 2 * pad), scale_x

    def _decode(self, state: TrackState, score_map: torch.Tensor, loc: torch.Tensor,
                scale_x: torch.Tensor, im_h: int, im_w: int):
        """The decode tail: anchor decode, scale/ratio penalty, cosine window,
        argmax over dim 1, EMA size update and the clamp into the frame.
        Returns best (O,), its score (O,), new_pos and new_sz (O, 2)."""
        p = self.p
        o, k, s = score_map.shape[0], p.anchor_num, p.score_size
        # NCHW channels are blocked (2, k) / (4, k), so a reshape gives the
        # anchor-major (O, C, k*S*S) layout of the anchor table
        logits = score_map.reshape(o, 2, k * s * s)
        score = torch.sigmoid(logits[:, 1] - logits[:, 0])  # 2-way softmax fg prob
        delta = loc.reshape(o, 4, k * s * s)
        dx = delta[:, 0] * self.anchor[:, 2] + self.anchor[:, 0]
        dy = delta[:, 1] * self.anchor[:, 3] + self.anchor[:, 1]
        # exp overflows fp32 past 88; |delta| <= 20 is identity for real boxes
        dw = torch.exp(delta[:, 2].clamp(-20.0, 20.0)) * self.anchor[:, 2]
        dh = torch.exp(delta[:, 3].clamp(-20.0, 20.0)) * self.anchor[:, 3]

        def change(r):
            return torch.maximum(r, 1.0 / r)

        def ssz(w, h):
            pad_ = (w + h) * 0.5
            return torch.sqrt((w + pad_) * (h + pad_))

        target_in_crop = state.target_sz * scale_x[:, None]
        tw, th = target_in_crop[:, :1], target_in_crop[:, 1:]
        s_c = change(ssz(dw, dh) / ssz(tw, th))
        r_c = change((tw / th) / (dw / dh))
        penalty = torch.exp(-(r_c * s_c - 1) * p.penalty_k)
        pscore = penalty * score * (1 - p.window_influence) + self.window * p.window_influence
        best = torch.argmax(pscore, dim=1)
        bi = best[:, None]

        def at(v):
            return v.gather(1, bi)[:, 0]

        lr = (at(penalty) * at(score) * p.lr)[:, None]
        new_pos = state.target_pos + torch.stack([at(dx), at(dy)], 1) / scale_x[:, None]
        pred_wh = torch.stack([at(dw), at(dh)], 1) / scale_x[:, None]
        new_sz = state.target_sz * (1 - lr) + pred_wh * lr
        zero, ten, wh = self._clamps(im_h, im_w)
        new_pos = torch.minimum(torch.maximum(new_pos, zero), wh)
        new_sz = torch.minimum(torch.maximum(new_sz, ten), wh)
        return best, at(score).to(torch.float32), new_pos, new_sz

    def _cells(self, best: torch.Tensor) -> torch.Tensor:
        """The (row, col) score-map cell (O, 2) of each flat argmax."""
        s = self.p.score_size
        cell = best % (s * s)
        return torch.stack([cell // s, cell % s], 1)

    def _back_box(self, target_pos: torch.Tensor, s_x_full: torch.Tensor, cells: torch.Tensor,
                  im_h: int, im_w: int) -> torch.Tensor:
        """(O, 4) [bx, by, bw, bh]: the frame in the out_size x out_size mask
        coordinates of each stream's best cell (the reference's sub-box
        geometry)."""
        p = self.p
        crop_xy = target_pos - s_x_full[:, None] / 2
        sc = s_x_full / p.instance_size
        sub_x = crop_xy[:, 0] + (cells[:, 1] - p.base_size / 2) * p.total_stride * sc
        sub_y = crop_xy[:, 1] + (cells[:, 0] - p.base_size / 2) * p.total_stride * sc
        s2 = p.out_size / (sc * p.exemplar_size)
        return torch.stack([-sub_x * s2, -sub_y * s2, im_w * s2, im_h * s2], 1)

    def _cell_mask(self, out, cells: torch.Tensor) -> torch.Tensor:
        """The sigmoid mask (O, out_size, out_size) at each stream's best
        cell: Refine's, or the raw 63*63 head's vector there. Base's head
        map (O, 63*63, S, S) is read by a gather at the cell on the device
        (``at_cells``, no copy of the map in either layout); sharp computes
        no head map, so its 1x1 head runs on the corr vector gathered at the
        cell."""
        p = self.p
        o = cells.shape[0]
        if self.refine:
            logits = self.model.track_refine(out.skips, out.corr, cells)
        elif isinstance(out, TrackOutputs):
            logits = self.model.mask_model.mask.head(at_cells(out.corr, cells)[..., None, None])
        else:
            logits = at_cells(out[2], cells)
        return torch.sigmoid(logits.reshape(o, p.out_size, p.out_size))

    def _step_body(self, state: TrackState, frame: torch.Tensor):
        """One frame for O streams (batched state, shared device frame)."""
        p = self.p
        im_h, im_w = frame.shape[0], frame.shape[1]
        s_x_full, scale_x = self._search_window(state)
        # the NHWC crop goes to the model as a channels_last view on a card
        x_crop = model_input(subwindow_crop(frame, state.target_pos, s_x_full,
                                            p.instance_size, state.avg_chans).permute(0, 3, 1, 2))
        if self.mask:
            out = self.model.track_mask(state.zf, x_crop)
            score_map, loc = out[0], out[1]
        else:
            score_map, loc = self.model.track(state.zf, x_crop)
        best, best_score, new_pos, new_sz = self._decode(state, score_map, loc, scale_x,
                                                         im_h, im_w)
        new_state = state._replace(target_pos=new_pos, target_sz=new_sz, score=best_score)
        if not self.mask:
            return new_state, BoxStepOutput(new_pos, new_sz, best_score, best)
        # the mask at each stream's best cell, warped back to the frame
        cells = self._cells(best)
        mask_cell = self._cell_mask(out, cells)
        back_box = self._back_box(state.target_pos, s_x_full, cells, im_h, im_w)
        mask_in_frame = warp_back_mask(mask_cell, back_box, (im_h, im_w))
        return new_state, StepOutput(new_pos, new_sz, best_score, best,
                                     mask_in_frame, mask_cell)

    @torch.inference_mode()
    def step(self, state: TrackState, frame):
        """One frame for one object: the O=1 case of ``step_batched``."""
        with trace.span("tracker.step", request=self.frame_index):
            self.frame_index += 1
            new_state, out = self._step_body(_batch(state), self._frame(frame))
            return _unbatch(new_state), type(out)(*(v[0] for v in out))

    @torch.inference_mode()
    def step_batched(self, states: TrackState, frame):
        """One frame for O objects at once: the crop, backbone, heads and
        Refine run at batch O; outputs have the leading O axis."""
        with trace.span("tracker.step_batched", request=self.frame_index):
            self.frame_index += 1
            return self._step_body(states, self._frame(frame))

    # ---------------- whole video ----------------

    @torch.inference_mode()
    def track_video_multi(self, states: TrackState, frames):
        """T frames (T, H, W, 3) for O objects: returns the final state and
        the step outputs stacked as (T, O, ...). The frames are uploaded once
        if they are not on the device. On a CUDA device each frame is a
        replay of the ``StepGraph`` for (O, H, W, frame dtype), captured at
        the first call with that key and kept while it is among the
        ``MAX_GRAPHS`` most recently used; capture or replay errors raise.
        Elsewhere it is a loop over ``step_batched``."""
        with trace.span("tracker.track_video_multi", request=self.frame_index,
                        frames=len(frames), objects=states.target_pos.shape[0]):
            frames = self._frame(frames)
            if self.device.type != "cuda":
                outs = []
                for frame in frames:
                    states, out = self.step_batched(states, frame)
                    outs.append(out)
                return states, type(out)(*(torch.stack(v) for v in zip(*outs)))
            self.frame_index += frames.shape[0]
            return self.step_graph(states, frames).run(states, frames)

    @torch.inference_mode()
    def step_graph(self, states: TrackState, frames: torch.Tensor) -> StepGraph:
        """The ``StepGraph`` for these states and device frames (T, H, W, 3),
        captured now if it is not kept, and now the most recently used."""
        _, h, w, _ = frames.shape
        key = (states.target_pos.shape[0], h, w, frames.dtype)
        graph = self.graphs.pop(key, None)
        if graph is None:
            with trace.span("step_graph.capture"):
                trace.count("step_graph.captures")
                while len(self.graphs) >= MAX_GRAPHS:   # drop the least recently used
                    self.graphs.pop(next(iter(self.graphs)))
                    trace.count("step_graph.evictions")
                self._clamps(h, w)      # a host-to-device copy: never under capture
                if self._side is None:
                    self._side = torch.cuda.Stream(self.device)
                with trace.paused():
                    graph = StepGraph(self, states, frames[0], self._side)
        self.graphs[key] = graph        # now the most recently used
        return graph

    @torch.inference_mode()
    def track_video(self, state: TrackState, frames):
        """T frames (T, H, W, 3) for one object: the final state and the
        outputs stacked as (T, ...); ``track_video_multi`` at O=1."""
        final, outs = self.track_video_multi(_batch(state), frames)
        return _unbatch(final), type(outs)(*(v[:, 0] for v in outs))
