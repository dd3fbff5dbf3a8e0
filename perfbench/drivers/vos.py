"""Many objects in one video through the batched graph path: the way the
program's batched VOS driver (``tracker/vos.py`` ``track_vos_batched``)
runs a DAVIS or YouTube-VOS video.

Traffic: ``objects`` objects in one ``frame_size`` video, initialised
together on frame 0 (``Tracker.init_batched``), then ``chunk``-frame
windows through ``Tracker.track_video_multi`` (on the card, a CUDA-graph
replay a frame). Each chunk's host uint8 frames are uploaded pinned and
non-blocking, and its float32 ``mask_in_frame`` (T, O, H, W) starts its copy
to pinned host memory before the host waits for the chunk before it (the
driver's ``_upload`` and ``_start_copy_to_host``): the host runs one chunk
behind the card. Objects' centres are drawn from U(``centre``) and their
sides from U(``size``) as the program bench's 16-stream row draws them, once
(``geometry_seed``); the seed deals the sides to the centres, so every seed
has the same set of objects. Each is a textured target moving on a closed
path of ``amplitude`` px; the video is an endless loop over a pool of
``pool_frames`` frames.

End to end: ``vos_fps``, object-frames whose masks reached the host over
the window's wall time.

Check (``check_frames`` frames drawn from the seed, every object): the plain
float32 tracker from the program's state before the frame (its previous
output boxes, and the templates it works out again from frame 0) at the
cells the program took, for each object: ``score_gap`` and ``box_err`` as in
the VOT cell, ``mask_err``, the largest difference of the soft mask in the
frame, ``mask_mae``, its mean difference over the warped cell (the pixels
either side puts inside it), and ``mask_margin``, the widest margin by which
the reference's soft mask lies beyond ``seg_thr`` where the program's lies
on the other side.
Each is the largest over the objects of the checked frames; ``.mean`` the
mean. Only the numbers that the traffic's ``limits`` name are held.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from perfbench import frames as F
from perfbench.drivers.tracking import (ReferenceTracker, Reservoir, held, mask_margin,
                                        program_model, scale, summarize, tracker_config,
                                        tracking_weights)
from perfbench.reference import tracker as ref
from perfbench.reference.model import Net, fp32_exact


class ProgramVOS:
    def __init__(self, ctx, p: dict):
        from siammask_tpu_torch.tracker import vos
        from siammask_tpu_torch.tracker.tracker import Tracker

        self.tracker = Tracker(program_model(ctx.config, p),
                               tracker_config(ctx.config, ctx.traffic["hp"]), ctx.device)
        self.upload, self.to_host = vos._upload, vos._start_copy_to_host
        self.device = ctx.device

    def init(self, frame: np.ndarray, pos, sz):
        self.states = self.tracker.init_batched(frame, pos, sz)

    def chunk(self, imgs: np.ndarray):
        """(T, H, W, 3) host frames -> (the masks' host copy and its event,
        (target_pos, target_sz, best_id) on the device)."""
        self.states, outs = self.tracker.track_video_multi(self.states,
                                                           self.upload(imgs, self.device))
        return self.to_host(outs.mask_in_frame), (outs.target_pos, outs.target_sz, outs.best_id)


class ControlVOS:
    """The plain tracker at fp8 in the program's place."""

    def __init__(self, ctx, p: dict):
        self.ref = ReferenceTracker(p, ctx.config, ctx.config["hp"][ctx.traffic["hp"]],
                                    ctx.device)
        self.device = ctx.device

    def init(self, frame, pos, sz):
        self.ref.init(torch.as_tensor(frame, device=self.device), pos, sz)

    def chunk(self, imgs):
        outs = [self.ref.step(torch.as_tensor(im, device=self.device)) for im in imgs]
        stack = {k: torch.stack([o[k] for o in outs]) for k in ("mask", "pos", "sz", "best")}
        return (stack["mask"].cpu(), None), (stack["pos"], stack["sz"], stack["best"])


class VOSCell:
    def __init__(self, ctx):
        t = ctx.traffic
        self.ctx = ctx
        self.hp = ctx.config["hp"][t["hp"]]
        h, w = t["frame_size"]
        r = F.rng(ctx.seed, 2)
        o = t["objects"]
        # the program bench's draw of centres and sides (one fixed draw); the
        # seed deals the sides to the centres: every seed the same set
        fixed = np.random.RandomState(t["geometry_seed"])
        centres = fixed.uniform(*t["centre"], (o, 2))
        sizes = fixed.uniform(*t["size"], (o, 2))[r.permutation(o)]
        self.boxes = F.paths(r, t["pool_frames"], centres, sizes, t["amplitude"])
        pool = F.render(F.device_generator(ctx.seed, 2, ctx.device), self.boxes, (h, w),
                        ctx.device)
        self.pool = pool.cpu().numpy()
        self.p = tracking_weights(ctx.config, ctx.seed, pool[0], self.boxes[0, 0],
                                  t.get("mask_logits"))
        del pool
        self.pos0 = self.boxes[0, :, :2].astype(np.float32)
        self.sz0 = self.boxes[0, :, 2:].astype(np.float32)
        self.system = (ControlVOS if ctx.system == "control" else ProgramVOS)(ctx, self.p)
        self.sample = Reservoir(t["check_frames"], F.rng(ctx.seed, 3))
        # warm-up: one chunk (the graph's capture), then the video starts over
        self.system.init(self.pool[0], self.pos0, self.sz0)
        (host, done), _ = self.system.chunk(self._imgs(0))
        if done is not None:
            done.synchronize()
        self.system.init(self.pool[0], self.pos0, self.sz0)
        self.chunks, self.small = 0, []

    def _imgs(self, c: int) -> np.ndarray:
        """Chunk c's host frames: video frames 1 + c T ... (c + 1) T."""
        n, size = len(self.pool), self.ctx.traffic["chunk"]
        return np.stack([self.pool[(1 + c * size + i) % n] for i in range(size)])

    def _materialize(self, c, host, done):
        if done is not None:
            done.synchronize()
        m = host.numpy()
        for i in range(m.shape[0]):
            slot = self.sample.offer()
            if slot is not None:
                self.sample.items[slot] = (c, i, m[i].copy())

    def _chunks(self, deadline: float | None, limit: int | None, spans) -> int:
        pending, done_chunks = None, 0
        chunk = self.system.chunk
        if spans is not None:
            chunk = spans.wrap("bench.chunk", chunk)
        while True:
            imgs = self._imgs(self.chunks)
            copy, small = chunk(imgs)
            self.small.append(small)
            if pending is not None:
                self._materialize(*pending)
            pending = (self.chunks, *copy)
            self.chunks += 1
            done_chunks += 1
            if (deadline is not None and time.perf_counter() >= deadline) or \
                    (limit is not None and done_chunks >= limit):
                break
        self._materialize(*pending)
        return done_chunks

    def window(self, seconds: float, spans) -> dict:
        t0 = time.perf_counter()
        n = self._chunks(t0 + seconds, None, spans)
        wall = time.perf_counter() - t0
        t = self.ctx.traffic
        frames = n * t["chunk"]
        return {"vos_fps": frames * t["objects"] / wall, "attempted": frames * t["objects"],
                "failed": 0, "frames": frames, "wall_s": wall}

    def stretch(self, spans) -> int:
        t = self.ctx.traffic
        return self._chunks(None, t["trace_chunks"], spans) * t["chunk"] * t["objects"]

    def free(self):
        self.system = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self) -> list:
        ctx, hp, size = self.ctx, self.hp, self.ctx.traffic["chunk"]
        dev = ctx.device
        pos = torch.cat([s[0] for s in self.small]).cpu().numpy()     # (frames, O, 2)
        sz = torch.cat([s[1] for s in self.small]).cpu().numpy()
        best = torch.cat([s[2] for s in self.small]).cpu().numpy()
        per = {"score_gap": [], "box_err": [], "mask_err": [], "mask_mae": [],
               "mask_margin": []}
        with fp32_exact():
            net = Net(self.p, ctx.config["width"])
            tmpl = ref.Template(net, torch.as_tensor(self.pool[0], device=dev),
                                torch.as_tensor(self.pos0, device=dev),
                                torch.as_tensor(self.sz0, device=dev))
            for c, i, mask in (it for it in self.sample.items if it is not None):
                k = c * size + i                   # index into the outputs; frame k + 1
                before = (self.pos0, self.sz0) if k == 0 else (pos[k - 1], sz[k - 1])
                frame = torch.as_tensor(self.pool[(1 + k) % len(self.pool)], device=dev)
                out = ref.step(net, hp, tmpl, frame, torch.as_tensor(before[0], device=dev),
                               torch.as_tensor(before[1], device=dev), best=best[k])
                bi = torch.as_tensor(best[k], device=dev).long()[:, None]
                per["score_gap"] += (out["pscore"].max(1).values
                                     - out["pscore"].gather(1, bi)[:, 0]).tolist()
                units = np.array([scale(s) for s in before[1]])
                err = np.maximum(np.abs(pos[k] - out["pos"].cpu().numpy()),
                                 np.abs(sz[k] - out["sz"].cpu().numpy())).max(1) / units
                per["box_err"] += err.tolist()
                soft = out["mask"].cpu().numpy()
                diff = np.abs(mask - soft)
                per["mask_err"] += diff.reshape(len(soft), -1).max(1).tolist()
                inside = (mask > -1) | (soft > -1)      # the warped cell, not the border
                per["mask_mae"] += [float(d[m].mean()) if m.any() else 0.0
                                    for d, m in zip(diff, inside)]
                per["mask_margin"] += [mask_margin(m > hp["seg_thr"], r, hp["seg_thr"])
                                       for m, r in zip(mask, soft)]
        self.readings = summarize(per)
        return held(self.readings, ctx.traffic["limits"], "vos")


def setup(ctx) -> VOSCell:
    return VOSCell(ctx)
