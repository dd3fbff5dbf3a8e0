"""The SAM 2.1 video tracker on the device: O objects prompted by boxes on
one frame, then advanced together, frame by frame, through their memory
banks. It has the batched contract of ``Tracker`` that
``tracker/vos.py`` ``track_vos_batched`` drives: ``init_batched(frame,
pos, sz)``, ``step_batched(states, frame)`` and ``track_video_multi(states,
frames)``, whose outputs carry ``mask_in_frame`` (T, O, H, W).

Per frame, the image encoder runs once for all O objects; memory
attention, the mask decoder and the memory encoder run at batch O. The
published video predictor's rules (``sam2/modeling/sam2_base.py``, the
video predictor's overrides):

- the conditioning frame (the box's frame, 0) decodes its box prompt from
  ``no_mem_embed``-added features, takes mask 0 unless its stability score
  (``#(logits > 0.05) / #(logits > -0.05)``) is under 0.98, then the best
  of masks 1-3 by predicted IoU, and makes its pointer from mask token 0;
  its memory encodes the mask binarised at 0;
- a tracking frame attends the conditioning frame's memory, the last 6
  frames' memories and the pointers of the conditioning frame and of the
  last 15 frames (past only), takes the best of masks 1-3 by predicted
  IoU, and makes its pointer from that mask's token; its memory encodes the
  mask's sigmoid;
- where the object score logit is <= 0 the mask logits are -1024, the
  pointer is ``no_obj_ptr`` and the memory takes ``no_obj_embed_spatial``;
- every memory is scaled to 20 sigmoid - 10 before the memory encoder and
  stored in the memory dtype (bf16 for a bf16 model, as the published
  predictor stores it);
- ``mask_in_frame`` is the sigmoid of the 256x256 logits resized to the
  frame (bilinear). The published predictor's hole filling is left out.

The state (``Sam2State``) is fixed-shape device tensors: the conditioning
memory, a ring of 6 memory slots, 16 pointer slots (slot 0 the
conditioning frame's), the frame each slot holds and each object's frame
count ``t``. Frame t writes ring slot (t - 1) % 6 and pointer slot
1 + (t - 1) % 15, in place, by index on the device; each slot's temporal
encoding and offset follow from ``t`` on the device, and only how many
slots are filled from the host's frame count. From frame 16 on every frame
attends the full bank at one shape (7 x 4,096 memory tokens and 16 x 4
pointer tokens, 28,736 keys) and reads nothing back, so on a card those
frames replay one CUDA graph: the ``StepGraph`` that ``StepGraphs``
(``tracker/tracker.py``) captures and keeps, as it does the Siamese
trackers'. The frames before step eagerly, under ``torch.no_grad`` (not
``inference_mode``, under which autocast casts every weight again at each
call) in one autocast region a chunk. A replay records one
``step_graph.replay`` span; the layer spans record in eager frames.

Objects that start after frame 0 (YouTube-VOS) are not supported
(``late_starts`` False): ``track_vos_batched`` refuses such a video.

Counts (``utils/trace.py``): ``sam2.memory_keys`` (keys attended, summed
over object-frames), and, summed on the device, ``sam2.no_object``
(object-frames whose score logit was <= 0) and ``sam2.multimask_switch``
(conditioning-frame objects whose stability rule took masks 1-3).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F

from siammask_tpu_torch.models.sam2 import NO_OBJ_SCORE, Sam2, _wide
from siammask_tpu_torch.tracker.tracker import StepGraphs
from siammask_tpu_torch.utils import trace


class Sam2State(NamedTuple):
    cond_mem: torch.Tensor      # (O, N, mem_dim): the conditioning frame's memory
    ring_mem: torch.Tensor      # (O, R, N, mem_dim): the last R frames' memories
    mem_frame: torch.Tensor     # (O, R) float32: the frame in each slot, -1 empty
    ptrs: torch.Tensor          # (O, P, d): pointers, slot 0 the conditioning frame's
    ptr_frame: torch.Tensor     # (O, P) float32: the frame of each pointer, -1 empty
    t: torch.Tensor             # (O,) float32: the next frame, from the conditioning frame


class Sam2Output(NamedTuple):
    mask_in_frame: torch.Tensor     # (O, H, W) float32 (float64 in a float64 model) sigmoid
    iou: torch.Tensor               # (O, 4) predicted IoUs of the four masks
    best: torch.Tensor              # (O,) the mask taken, 0-3
    object_score: torch.Tensor      # (O,) the object score logit


class Sam2Tracker(StepGraphs):
    """The tracker of a ``Sam2`` model (on ``device``, in eval mode). ``p``
    is kept for ``tracker/vos.py`` (``seg_thr`` fuses masks). SAM 2 always
    makes its mask."""

    late_starts = False

    def __init__(self, model: Sam2, p, device: torch.device | str):
        super().__init__()
        self.model = model
        self.p = p
        self.mask = True
        self.device = torch.device(device)
        cfg = model.cfg
        self.ring = cfg.num_maskmem - 1
        self.slots = cfg.max_obj_ptrs
        f32 = dict(dtype=torch.float32, device=self.device)
        self.ring_index = torch.arange(self.ring, **f32)
        self.ptr_index = torch.arange(self.slots - 1, **f32)
        self.frame_index = 0

    def _autocast(self, cache: bool = True):
        dtype = self.model.dtype
        if dtype in (torch.bfloat16, torch.float16):
            return torch.autocast(self.device.type, dtype=dtype, cache_enabled=cache)
        return contextlib.nullcontext()

    def _capture_context(self):
        """Autocast without its weight-cast cache: a capture records the
        casts (and may not use casts made outside it)."""
        return self._autocast(cache=False)

    # ---------------- init

    @torch.no_grad()
    def init_batched(self, frame, target_pos, target_sz) -> Sam2State:
        """O boxes on one frame: target_pos / target_sz (O, 2) centres and
        sizes in frame pixels. The video's next frame is then frame 1."""
        with trace.span("tracker.init_batched", request=0), self._autocast():
            model, cfg = self.model, self.model.cfg
            frame = self._frame(frame)
            hw = frame.shape[:2]
            maps = self._encode(frame)
            dt = dict(dtype=_wide(maps["feat"]).dtype, device=self.device)
            pos = torch.as_tensor(target_pos, device=self.device).to(**dt)
            sz = torch.as_tensor(target_sz, device=self.device).to(**dt)
            o = pos.shape[0]
            scale = torch.tensor([cfg.image_size / hw[1], cfg.image_size / hw[0]] * 2, **dt)
            boxes = torch.cat([pos - sz / 2, pos + sz / 2], dim=1) * scale
            sparse = model.sam_prompt_encoder.box_tokens(boxes)
            with trace.span("sam2.mask_decoder"):
                masks, iou, tokens, score = model.decode(model.no_memory(maps["feat"], o), maps,
                                                         sparse)
                logits = masks[:, 0].flatten(1)
                area_i = (logits > cfg.stability_delta).sum(1)
                area_u = (logits > -cfg.stability_delta).sum(1)
                stability = torch.where(area_u > 0, area_i / area_u.clamp(min=1), 1.0)
                stable = stability >= cfg.stability_thresh
                best = torch.where(stable, 0, 1 + torch.argmax(iou[:, 1:], dim=1))
                trace.count_device("sam2.multimask_switch", (~stable).sum())
            out, mem, ptr = self._finish(maps, masks, iou, tokens[:, 0], score, best, hw,
                                         first=True)
            with trace.span("sam2.bank_update"):
                mem = mem.to(self.model.dtype or mem.dtype)     # bf16 in a bf16 model
                n, m = mem.shape[1:]
                ptrs = torch.zeros(o, self.slots, cfg.d_model, dtype=ptr.dtype, device=self.device)
                ptrs[:, 0] = ptr
                ptr_frame = torch.full((o, self.slots), -1.0, device=self.device)
                ptr_frame[:, 0] = 0.0
                state = Sam2State(mem, torch.zeros(o, self.ring, n, m, dtype=mem.dtype,
                                                   device=self.device),
                                  torch.full((o, self.ring), -1.0, device=self.device), ptrs,
                                  ptr_frame, torch.ones(o, device=self.device))
            self.frame_index = 1
            self.init_output = out      # the conditioning frame's outputs
            return state

    # ---------------- the pieces of a frame

    def _encode(self, frame: torch.Tensor) -> dict:
        with trace.span("sam2.image_encoder"):
            return self.model.encode_image(self.model.preprocess(frame))

    def _finish(self, maps, masks, iou, token, score, best, hw, first: bool):
        """The chosen mask, pointer and memory of a decoded frame."""
        model = self.model
        o = masks.shape[0]
        present = score > 0
        trace.count_device("sam2.no_object", (~present).sum())
        with trace.span("sam2.mask_decoder"):
            low = _wide(masks[torch.arange(o, device=masks.device), best])[:, None]
            low = torch.where(present[:, None, None, None], low, NO_OBJ_SCORE)
            ptr = model.object_pointer(token, present)
            in_frame = F.interpolate(low, size=tuple(hw), mode="bilinear", align_corners=False)
            out = Sam2Output(torch.sigmoid(in_frame[:, 0]), _wide(iou), best, _wide(score))
        with trace.span("sam2.memory_encoder"):
            size = model.cfg.image_size
            high = F.interpolate(low, size=(size, size), mode="bilinear", align_corners=False)
            mask = (high > 0).to(high.dtype) if first else torch.sigmoid(high)
            mem = model.encode_memory(maps["feat"], mask * 20.0 - 10.0, present)
        return out, mem, ptr

    def _memory(self, states: Sam2State, t: int, dtype: torch.dtype):
        """Frame t's keys: (O, M, mem_dim) memory, its position, and how
        many of its last tokens are pointers. Which slots are filled follows
        from the host's frame count; their ages from each object's ``t`` on
        the device (ring slot s holds frame t - 1 - (t - 2 - s) mod 6, which
        takes temporal encoding (t - 2 - s) mod 6; pointer slot 1 + j's
        offset is 1 + (t - 2 - j) mod 15)."""
        model, cfg = self.model, self.model.cfg
        o = states.t.shape[0]
        n_mem, n_ptr = min(t - 1, self.ring), min(t - 1, self.slots - 1)
        c = model.consts(self.device, dtype)
        now = states.t[:, None]
        age = torch.remainder(now - 2 - self.ring_index[:n_mem], self.ring).long()
        cond = torch.full((o, 1), cfg.num_maskmem - 1, dtype=age.dtype, device=age.device)
        tpos = model.maskmem_tpos_enc[:, 0, 0][torch.cat([cond, age], dim=1)]
        mem = torch.cat([states.cond_mem[:, None], states.ring_mem[:, :n_mem]], dim=1)
        mem_pos = (c["mem_pos"][None, None] + tpos[:, :, None]).flatten(1, 2)
        dt = torch.cat([now, 1 + torch.remainder(now - 2 - self.ptr_index[:n_ptr],
                                                 self.slots - 1)], dim=1)
        ptr_tokens = states.ptrs[:, :1 + n_ptr].reshape(o, -1, cfg.mem_dim)
        ptr_pos = model.pointer_pos(dt.to(dtype)).repeat_interleave(cfg.d_model // cfg.mem_dim,
                                                                    dim=1)
        memory = torch.cat([mem.flatten(1, 2).to(ptr_tokens.dtype), ptr_tokens], dim=1)
        memory_pos = torch.cat([mem_pos.to(ptr_pos.dtype), ptr_pos], dim=1)
        return memory, memory_pos, ptr_tokens.shape[1]

    def _keys(self, o: int, t: int) -> int:
        """Keys frame t's memory attention attends, over O objects."""
        cfg = self.model.cfg
        n_mem, n_ptr = min(t - 1, self.ring), min(t - 1, self.slots - 1)
        return o * ((1 + n_mem) * cfg.feat_side ** 2 + (1 + n_ptr) * cfg.d_model // cfg.mem_dim)

    def _slots(self, states: Sam2State) -> tuple:
        """(O,) ring slots and pointer slots that each object's frame t
        writes: (t - 1) mod 6 and 1 + (t - 1) mod 15."""
        return (torch.remainder(states.t - 1, self.ring).long(),
                1 + torch.remainder(states.t - 1, self.slots - 1).long())

    @staticmethod
    def _choose(iou: torch.Tensor) -> torch.Tensor:
        """(O,) a tracking frame's mask: the best of masks 1-3 by predicted IoU."""
        return 1 + torch.argmax(iou[:, 1:], dim=1)

    def _step_body(self, states: Sam2State, frame: torch.Tensor):
        model = self.model
        t = self.frame_index
        o = states.t.shape[0]
        maps = self._encode(frame)
        with trace.span("sam2.memory_attention"):
            memory, memory_pos, n_ptr = self._memory(states, t, _wide(maps["feat"]).dtype)
            pix = model.condition(maps["feat"], memory, memory_pos, n_ptr)
        with trace.span("sam2.mask_decoder"):
            masks, iou, tokens, score = model.decode(
                pix, maps, model.sam_prompt_encoder.empty_tokens(o))
            best = self._choose(iou)
            every = torch.arange(o, device=tokens.device)
            token = tokens[every, best]
        out, new_mem, ptr = self._finish(maps, masks, iou, token, score, best, frame.shape[:2],
                                         first=False)
        with trace.span("sam2.bank_update"):
            slot, pslot = self._slots(states)
            states.ring_mem[every, slot] = new_mem.to(states.ring_mem.dtype)
            states.mem_frame[every, slot] = states.t
            states.ptrs[every, pslot] = ptr.to(states.ptrs.dtype)
            states.ptr_frame[every, pslot] = states.t
            states.t.add_(1.0)
        return states, out

    # ---------------- steps

    @torch.no_grad()
    def step_batched(self, states: Sam2State, frame):
        """One frame for O objects; the state is updated in place and
        returned."""
        with trace.span("tracker.step_batched", request=self.frame_index), self._autocast():
            trace.count("sam2.memory_keys", self._keys(states.t.shape[0], self.frame_index))
            out = self._step_body(states, self._frame(frame))
            self.frame_index += 1
            return out

    @torch.no_grad()
    def track_video_multi(self, states: Sam2State, frames):
        """T frames (T, H, W, 3) for O objects: the final state and the
        outputs stacked as (T, O, ...). Frames before the bank is full step
        eagerly (``step_batched``); on a card the rest replay the
        ``StepGraph`` of (O, H, W, frame dtype), captured at its first use
        and kept while among the ``MAX_GRAPHS`` most recently used."""
        with trace.span("tracker.track_video_multi", request=self.frame_index,
                        frames=len(frames), objects=states.t.shape[0]), self._autocast():
            # one autocast region over the chunk: its eager weight casts are
            # made once, not once a frame
            frames = self._frame(frames)
            outs, k = [], 0
            while k < len(frames) and (self.device.type != "cuda"
                                       or self.frame_index < self.slots):
                states, out = self.step_batched(states, frames[k])
                outs.append(out)
                k += 1
            parts = [[torch.stack(v) for v in zip(*outs)]] if outs else []
            if k < len(frames):
                graph = self.step_graph(states, frames[k:])     # at this frame's shapes
                n = len(frames) - k
                trace.count("sam2.memory_keys", n * self._keys(states.t.shape[0],
                                                               self.frame_index))
                self.frame_index += n
                states, replayed = graph.run(states, frames[k:])
                parts.append(replayed)
            return states, Sam2Output(*(torch.cat(v) if len(v) > 1 else v[0]
                                        for v in zip(*parts)))
