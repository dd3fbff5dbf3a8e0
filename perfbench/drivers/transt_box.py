"""TransT on many objects in one video, box only, through the program's
batched graph path: ``TransTTracker`` (the tracker ``TrackerRuntime`` builds
for a TransT model) over ``track_video_multi``.

Traffic: the SiamMask VOS cell's video and objects (``drivers/vos.py``):
``objects`` objects in one ``frame_size`` video, centres from U(``centre``)
and sides from U(``size``), one fixed draw (``geometry_seed``) dealt by the
seed, textured targets on closed paths of ``amplitude`` px over a pool of
``pool_frames`` frames. The templates are taken on frame 0 in set-up
(``init_batched``); then ``chunk``-frame windows through
``track_video_multi`` back to back, each chunk's host uint8 frames uploaded
pinned and non-blocking, and each frame's (O, 2) position, (O, 2) size and
(O,) score, float32, copied to pinned host memory as one (T, O, 5) block,
the host a chunk behind (the VOS driver's ``_upload`` and
``_start_copy_to_host``).

End to end: ``vos_fps``, object-frames whose boxes reached the host over
the window's wall time.

Weights: drawn from the seed (``reference.transt.init_weights``), then, on
frame 0's search crops of every object with the plain reference (``make_weights``):
each BatchNorm's running mean 0 and variance the mean square of its input,
one number a layer (``weights.py``'s way); the classifier's last layer
scaled and its bias set so that the foreground-minus-background logit has
mean 0 and spread ``cls_logit_std`` over the objects' cells; the box head's
last layer scaled so that each pre-sigmoid output spreads by
``box_logit_std`` over those cells, its biases set so that the centre's mean
is the crop's centre and the size's mean is a quarter of the crop (random
weights would move the box by its own size and double it every frame; a
square target of side a has a search crop of side 4 a, so a box keeps its
size on average and moves by a few percent a frame).

Check (in ``free``, after the window and the traced stretch): the program
goes on through ``check_frames`` frames, each after a gap of 0 to
``check_gap`` frames drawn from the seed, one ``track_video_multi`` call a
frame; the state before each (positions and sizes) is read, and the
program's foreground probabilities on that state and frame
(``TransTTracker.search``, the step's own crop and network, run once more).
The plain float32 reference takes the templates it works out again from
frame 0, the program's state and the frame, and steps at the cell the
program took, for each object:

- ``score_gap``: the reference's best windowed score less its windowed
  score at the program's cell;
- ``box_err``: the new centre and size against the reference's at that
  cell, in target sizes (the larger of the two);
- ``cls_mae``: the foreground probabilities of the search tokens, mean
  abs difference;
- ``score_err``: the carried score's difference; ``size_ratio``: the
  object's size against its first (the boxes' drift; not a fault).

Each is the largest over objects and frames; ``.mean`` the mean. Only the
numbers that the traffic's ``limits`` name are held.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import frames as F
from perfbench.drivers.tracking import held, scale, summarize
from perfbench.drivers.vos import VOSCell
from perfbench.reference import transt as R
from perfbench.reference.model import fp32_exact
from perfbench.reference.tracker import crop
from perfbench.weights import DTYPES, WEIGHTS_STREAM


def tracker_hp(config: dict) -> dict:
    return {**R.TRACKER, **config.get("hp", {})}


def _penultimate(net, hs, name: str):
    """The input of an MLP head's last layer."""
    return torch.relu(net.lin(torch.relu(net.lin(hs, f"{name}.layers.0")), f"{name}.layers.1"))


@torch.no_grad()
def make_weights(config: dict, seed: int, frame: torch.Tensor, pos, sz, cls_logit_std: float,
                 box_logit_std: float) -> dict:
    """The seed's weights, calibrated on frame 0's crops (module docstring)."""
    device = frame.device
    p = R.init_weights(config, F.device_generator(seed, WEIGHTS_STREAM, device), device)
    hp = tracker_hp(config)
    c = R.model_config(config)
    pos = torch.as_tensor(np.asarray(pos, np.float32), device=device)
    sz = torch.as_tensor(np.asarray(sz, np.float32), device=device)
    avg = frame.to(torch.float32).mean(dim=(0, 1)).expand(len(pos), -1).contiguous()
    with fp32_exact():
        net = R.TransTRef(p, config)
        net.calibrate = True
        xs = net.features(crop(frame, pos, R.crop_side(sz, hp["search_factor"]),
                               c["search_size"], avg))
        net.calibrate = False
        zt = net.template(crop(frame, pos, R.crop_side(sz, hp["template_factor"]),
                               c["template_size"], avg))
        hs = net.fuse(zt, xs)
        # the classifier: fg - bg logit of mean 0 and spread cls_logit_std
        w, b = p["class_embed.layers.2.weight"], p["class_embed.layers.2.bias"]
        diff = _penultimate(net, hs, "class_embed") @ (w[0] - w[1])
        a = cls_logit_std / float(diff.std())
        w.mul_(a)
        b.copy_(torch.tensor([-a * float(diff.mean()), 0.0], device=device))
        # the box head: damped about the crop's centre and a quarter of its side
        w, b = p["bbox_embed.layers.2.weight"], p["bbox_embed.layers.2.bias"]
        out = _penultimate(net, hs, "bbox_embed") @ w.t()
        a = box_logit_std / out.flatten(0, 1).std(dim=0)
        quarter = math.log(1.0 / (hp["search_factor"] - 1))     # logit(1 / factor)
        target = torch.tensor([0.0, 0.0, quarter, quarter], device=device)
        w.mul_(a[:, None])
        b.copy_(target - a * out.flatten(0, 1).mean(dim=0))
    return p


class ProgramTransT:
    """The program: ``TransTTracker`` over the configuration's model."""

    def __init__(self, ctx, p: dict):
        from siammask_tpu_torch.config import TrackerConfig
        from siammask_tpu_torch.models.transt import TransT, TransTConfig
        from siammask_tpu_torch.tracker import vos
        from siammask_tpu_torch.tracker.transt import TransTTracker

        with torch.device("meta"):
            model = TransT(TransTConfig(**R.model_config(ctx.config)),
                           DTYPES[ctx.config["dtype"]])
        model = model.to_empty(device=ctx.device)
        model.load_state_dict(p)
        self.tracker = TransTTracker(model.eval(), TrackerConfig().update(tracker_hp(ctx.config)),
                                     ctx.device)
        self.upload, self.to_host = vos._upload, vos._start_copy_to_host
        self.device = ctx.device

    def init(self, frame: np.ndarray, pos, sz):
        self.states = self.tracker.init_batched(frame, pos, sz)

    def chunk(self, imgs: np.ndarray):
        """(T, H, W, 3) host frames -> the (T, O, 5) boxes' host copy and
        its event."""
        self.states, outs = self.tracker.track_video_multi(self.states,
                                                           self.upload(imgs, self.device))
        boxes = torch.cat([outs.target_pos, outs.target_sz, outs.score[..., None]], dim=-1)
        return self.to_host(boxes), None

    def attn_calls(self, frame: np.ndarray) -> int:
        """Attention calls of one eager step's network (``transt.attn_calls``)."""
        from siammask_tpu_torch.utils import trace

        before = trace.counters().get("transt.attn_calls", 0)
        with torch.inference_mode():
            self.tracker.search(self.states, self.tracker._frame(frame))
        return trace.counters()["transt.attn_calls"] - before

    def snapshot(self) -> tuple:
        return self.states.target_pos, self.states.target_sz

    def one(self, frame: np.ndarray) -> dict:
        """One frame through ``track_video_multi``, and the step's foreground
        probabilities on the state before it."""
        with torch.inference_mode():
            fg = self.tracker.search(self.states, self.tracker._frame(frame))[0]
        self.states, outs = self.tracker.track_video_multi(
            self.states, self.upload(frame[None], self.device))
        return {"pos": outs.target_pos[0], "sz": outs.target_sz[0], "score": outs.score[0],
                "best": outs.best_id[0], "fg": fg}


class ControlTransT:
    """The plain reference at fp8 in the program's place."""

    def __init__(self, ctx, p: dict):
        self.net = R.TransTRef({k: v.clone() for k, v in p.items()}, ctx.config, "fp8")
        self.hp = tracker_hp(ctx.config)
        self.device = ctx.device

    def init(self, frame, pos, sz):
        with fp32_exact(), torch.no_grad():
            self.pos = torch.as_tensor(np.asarray(pos, np.float32), device=self.device)
            self.sz = torch.as_tensor(np.asarray(sz, np.float32), device=self.device)
            self.tmpl = R.Template(self.net, torch.as_tensor(frame, device=self.device),
                                   self.pos, self.sz, self.hp)

    def _step(self, frame) -> dict:
        with fp32_exact(), torch.no_grad():
            out = R.step(self.net, self.hp, self.tmpl, torch.as_tensor(frame, device=self.device),
                         self.pos, self.sz)
        self.pos, self.sz = out["pos"], out["sz"]
        return out

    def chunk(self, imgs):
        outs = [self._step(im) for im in imgs]
        boxes = torch.stack([torch.cat([o["pos"], o["sz"], o["score"][:, None]], 1)
                             for o in outs])
        return (boxes.cpu(), None), None

    def attn_calls(self, frame) -> None:
        return None

    def snapshot(self) -> tuple:
        return self.pos, self.sz

    def one(self, frame) -> dict:
        return self._step(frame)


class TransTBoxCell(VOSCell):
    """The VOS cell's loop (``_chunks``, ``window``, ``stretch``) over
    TransT's boxes, state and check."""

    def __init__(self, ctx):
        t = ctx.traffic
        self.ctx = ctx
        h, w = t["frame_size"]
        r = F.rng(ctx.seed, 2)
        o = t["objects"]
        fixed = np.random.RandomState(t["geometry_seed"])
        centres = fixed.uniform(*t["centre"], (o, 2))
        sizes = fixed.uniform(*t["size"], (o, 2))[r.permutation(o)]
        self.boxes = F.paths(r, t["pool_frames"], centres, sizes, t["amplitude"])
        pool = F.render(F.device_generator(ctx.seed, 2, ctx.device), self.boxes, (h, w),
                        ctx.device)
        self.pool = pool.cpu().numpy()
        self.pos0 = self.boxes[0, :, :2].astype(np.float32)
        self.sz0 = self.boxes[0, :, 2:].astype(np.float32)
        self.p = make_weights(ctx.config, ctx.seed, pool[0], self.pos0, self.sz0,
                              t["cls_logit_std"], t["box_logit_std"])
        del pool
        self.system = (ControlTransT if ctx.system == "control" else ProgramTransT)(ctx, self.p)
        # warm-up: one chunk (the graph's capture), then the video starts over
        self.system.init(self.pool[0], self.pos0, self.sz0)
        (host, done), _ = self.system.chunk(self._imgs(0))
        if done is not None:
            done.synchronize()
        self.attn_calls = self.system.attn_calls(self.pool[1])
        self.system.init(self.pool[0], self.pos0, self.sz0)
        self.chunks, self.small, self.checked = 0, [], []

    def _materialize(self, c, host, done):
        if done is not None:
            done.synchronize()

    def free(self):
        """Runs the check's frames on the system, then drops it."""
        t = self.ctx.traffic
        n, size = len(self.pool), t["chunk"]
        nxt = 1 + self.chunks * size           # the video's next frame
        gaps = F.rng(self.ctx.seed, 3).integers(0, t["check_gap"] + 1, t["check_frames"])
        for gap in gaps:
            if gap:
                imgs = np.stack([self.pool[(nxt + i) % n] for i in range(int(gap))])
                self._materialize(None, *self.system.chunk(imgs)[0])
                nxt += int(gap)
            frame = self.pool[nxt % n]
            nxt += 1
            before = self.system.snapshot()
            self.checked.append((frame, before, self.system.one(frame)))
        self.system = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self) -> list:
        ctx = self.ctx
        dev = ctx.device
        hp = tracker_hp(ctx.config)
        per = {k: [] for k in ("score_gap", "box_err", "cls_mae", "score_err", "size_ratio")}
        first = np.array([scale(s) for s in self.sz0])
        with fp32_exact():
            net = R.TransTRef(self.p, ctx.config)
            tmpl = R.Template(net, torch.as_tensor(self.pool[0], device=dev),
                              torch.as_tensor(self.pos0, device=dev),
                              torch.as_tensor(self.sz0, device=dev), hp)
            for frame, (pos, sz), out in self.checked:
                best = out["best"].to(dev).long()
                r = R.step(net, hp, tmpl, torch.as_tensor(frame, device=dev), pos.to(dev),
                           sz.to(dev), best=best)
                per["score_gap"] += (r["pscore"].max(1).values
                                     - r["pscore"].gather(1, best[:, None])[:, 0]).tolist()
                units = np.array([scale(s) for s in sz.cpu().numpy()])
                err = torch.maximum((out["pos"].to(dev) - r["pos"]).abs(),
                                    (out["sz"].to(dev) - r["sz"]).abs()).max(1).values
                per["box_err"] += (err.cpu().numpy() / units).tolist()
                per["cls_mae"] += (out["fg"].to(dev).float() - r["fg"]).abs().mean(1).tolist()
                per["score_err"] += (out["score"].to(dev).float() - r["score"]).abs().tolist()
                per["size_ratio"] += (units / first).tolist()
        self.readings = summarize(per)
        return held(self.readings, ctx.traffic["limits"], "transt_box")


def setup(ctx) -> TransTBoxCell:
    # the program's TransT first: a checkout without it fails before any work
    import siammask_tpu_torch.tracker.transt  # noqa: F401
    return TransTBoxCell(ctx)
