"""SAM 2.1 on many objects in one video, through the program's batched VOS
path: the way ``tracker/vos.py`` ``track_vos_batched`` runs a DAVIS video
with the tracker that ``TrackerRuntime`` builds for a SAM 2 model.

Traffic: ``objects`` box prompts on frame 0 of one ``frame_size`` video
(``Sam2Tracker.init_batched``), the first ``setup_frames`` frames tracked
in set-up so that every timed frame attends a full bank, then
``chunk``-frame windows through ``track_video_multi``, each chunk's host
uint8 frames uploaded pinned and non-blocking and its float32
``mask_in_frame`` (T, O, H, W) copied to pinned host memory, the host a
chunk behind (the VOS driver's ``_upload`` and ``_start_copy_to_host``).
The objects and the video are the SiamMask VOS cell's: centres from
U(``centre``) and sides from U(``size``), one fixed draw
(``geometry_seed``) dealt by the seed; textured targets on closed paths of
``amplitude`` px over a pool of ``pool_frames`` frames (``frames.py``).

End to end: ``vos_fps``, object-frames whose masks reached the host over
the window's wall time.

Weights: drawn from the seed (``reference.sam2.init_weights``), then, on
frame 0's box prompts with the plain reference: each mask token's
hypernetwork output scaled, and shifted along the direction whose response
over the boxes is most nearly constant, so that its logits inside the
boxes have the mean and spread of ``mask_logits`` (random weights give
logits of a few hundredths, all of one sign or none); memory attention's
query projections scaled so that its logits have the spread
``attn_logit_std`` on frame 0 over a full bank of frame 0's memory
(random projections give a spread of ~0.3, which spreads each query's
attention evenly over all 28,736 keys, so that no memory, pointer or
rotation would matter); and the object-score head's last bias set so that
the least object's logit is ``score_margin``, so every object is present.

Check (in ``free``, after the window and the traced stretch): the program
goes on through ``check_frames`` frames, each after a gap of 0 to
``check_gap`` frames drawn from the seed, one ``track_video_multi`` call a
frame; before each, its state is read. The plain float32 reference takes
that state (the bf16 bank upcast, the pointers and their offsets; the
published rules pick what the frame attends) and the frame, and takes the
mask the program took (as the SiamMask cells' check takes the program's
cell: near-ties of predicted IoU break either way under rounding), per
object:

- ``mask_mae``: the sigmoid mask in the frame, mean abs difference;
- ``mask_margin``: the widest margin by which the reference's mask lies
  beyond 0.5 where the program's lies on the other side;
- ``iou_gap``: the reference's best predicted IoU of masks 1-3 less its
  IoU of the mask the program took (infinite where the program took mask
  0, which a tracking frame never takes);
- ``obj_score_gap``: the object score logits' difference;
- ``memory_err`` / ``ptr_err``: the new memory and pointer as the
  program's bank holds them after the frame, relative L2 (infinite where
  the bank lacks the frame).

Each is the largest over objects and frames; ``.mean`` the mean. Only the
numbers that the traffic's ``limits`` name are held.
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench import frames as F
from perfbench.drivers.tracking import held, mask_margin, summarize
from perfbench.drivers.vos import VOSCell
from perfbench.reference import sam2 as R
from perfbench.reference.model import fp32_exact
from perfbench.weights import DTYPES, WEIGHTS_STREAM


@torch.no_grad()
def make_weights(config: dict, seed: int, frame: torch.Tensor, pos, sz,
                 mask_logits: dict, score_margin: float, attn_logit_std: float) -> dict:
    """The seed's weights, calibrated on frame 0's boxes (module docstring)."""
    device = frame.device
    p = R.init_weights(config, F.device_generator(seed, WEIGHTS_STREAM, device), device)
    c = R.model_config(config)
    md = "sam_mask_decoder"
    with fp32_exact():
        ref = R.Sam2Ref(p, config)
        maps = ref.image(frame)
        hw = frame.shape[:2]
        boxes = [(x - w / 2, y - h / 2, x + w / 2, y + h / 2)
                 for (x, y), (w, h) in zip(np.asarray(pos).tolist(), np.asarray(sz).tolist())]
        s = 4 * c["image_size"] // 16
        inside = torch.zeros(len(boxes), s, s, dtype=torch.bool, device=device)
        for i, (x0, y0, x1, y1) in enumerate(boxes):
            inside[i, int(y0 * s / hw[0]):int(np.ceil(y1 * s / hw[0])),
                   int(x0 * s / hw[1]):int(np.ceil(x1 * s / hw[1]))] = True
        outs = [ref.frame(maps, hw, box=b) for b in boxes]
        masks = torch.stack([o["masks"] for o in outs])
        up = torch.stack([o["up"] for o in outs]).permute(0, 2, 3, 1)[inside].double()
        # the bias direction whose response is most nearly constant: u =
        # C^-1 m / (m' C^-1 m) over the boxes' pixels (mean 1, least variance)
        m = up.mean(0)
        cov = torch.cov(up.t(), correction=0) + 1e-9 * torch.eye(len(m), dtype=up.dtype,
                                                                    device=up.device)
        u = torch.linalg.solve(cov, m)
        u = u / (m @ u)
        for k in range(4):
            a, b = _moments(masks[:, k][inside].double(), up @ u, mask_logits["mean"],
                            mask_logits["std"])
            name = f"{md}.output_hypernetworks_mlps.{k}.layers.2"
            p[f"{name}.weight"].mul_(a)
            p[f"{name}.bias"].mul_(a).add_((b * u).to(p[f"{name}.bias"].dtype))
        ref = R.Sam2Ref(p, config)
        outs = [ref.frame(maps, hw, box=b) for b in boxes]
        sharpen_attention(ref, maps, outs[0], attn_logit_std)
        scores = torch.stack([o["score"] for o in outs])
        p[f"{md}.pred_obj_score_head.layers.2.bias"] += score_margin - scores.min()
    return p


def frame0_bank(ref, maps, first: dict) -> tuple:
    """Frame 0's features and a full bank made of frame 0's own memory (7
    frames) and pointer (16): (feat, memory, position, pointer tokens)."""
    c, p = ref.c, ref.p
    d, m = c["d_model"], c["mem_dim"]
    s = c["image_size"] // 16
    tpos = p["maskmem_tpos_enc"][:, 0, 0]
    mem_pos = ref.sine2d(m, s, s).flatten(1).t()
    memory = torch.cat([first["mem"]] * c["num_maskmem"]
                       + [first["ptr"].reshape(-1, m)] * c["max_obj_ptrs"])
    pos = torch.cat([mem_pos + tpos[i] for i in range(c["num_maskmem"])]
                    + [ref.pointer_pos(dt).repeat(d // m, 1) for dt in range(c["max_obj_ptrs"])])
    return maps["feat"][0].flatten(1).t(), memory, pos, c["max_obj_ptrs"] * d // m


def sharpen_attention(ref, maps, first: dict, std: float) -> None:
    """Scale each memory-attention layer's query projections (self and
    cross), layer by layer, so that its attention logits have spread
    ``std`` over ``frame0_bank`` (``ref.p`` is changed in place)."""
    bank = frame0_bank(ref, maps, first)
    for layer in range(ref.c["memattn_layers"]):
        probe: list = []
        ref.memory_attention(*bank, probe)
        for k, name in enumerate(("self_attn", "cross_attn_image")):
            q = f"memory_attention.layers.{layer}.{name}.q_proj"
            for leaf in ("weight", "bias"):
                ref.p[f"{q}.{leaf}"].mul_(std / probe[layer][k])


def _moments(x: torch.Tensor, e: torch.Tensor, mean: float, std: float) -> tuple:
    """(a, b) with a > 0 such that a x + b e has ``mean`` and ``std`` (the
    population's) over the pixels: b fixes the mean for each a, and a
    solves the quadratic of the variance."""
    mx, me = float(x.mean()), float(e.mean())
    vx, ve = float(x.var(unbiased=False)), float(e.var(unbiased=False))
    cxe = float(((x - mx) * (e - me)).mean())
    b0, b1 = mean / me, -mx / me                    # b = b0 + b1 a
    qa = vx + 2 * b1 * cxe + b1 * b1 * ve
    qb = 2 * b0 * cxe + 2 * b0 * b1 * ve
    qc = b0 * b0 * ve - std * std
    disc = qb * qb - 4 * qa * qc
    if disc < 0 or qa <= 0:
        raise ValueError(f"no scale gives the logits a spread of {std} at mean {mean}")
    a = (-qb + disc ** 0.5) / (2 * qa)
    return a, b0 + b1 * a


class ProgramSam2:
    """The program: ``Sam2Tracker`` over the configuration's model."""

    def __init__(self, ctx, p: dict):
        from siammask_tpu_torch.models.sam2 import Sam2, Sam2Config
        from siammask_tpu_torch.tracker import vos
        from siammask_tpu_torch.tracker.sam2 import Sam2Tracker

        sizes = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in R.model_config(ctx.config).items()}
        with torch.device("meta"):
            model = Sam2(Sam2Config(**sizes), DTYPES[ctx.config["dtype"]])
        model = model.to_empty(device=ctx.device)
        model.load_state_dict(p)
        self.tracker = Sam2Tracker(model.eval(), None, ctx.device)
        self.upload, self.to_host = vos._upload, vos._start_copy_to_host
        self.device = ctx.device

    def init(self, frame: np.ndarray, pos, sz):
        self.states = self.tracker.init_batched(frame, pos, sz)

    def chunk(self, imgs: np.ndarray):
        self.states, outs = self.tracker.track_video_multi(self.states,
                                                           self.upload(imgs, self.device))
        return self.to_host(outs.mask_in_frame), None

    def snapshot(self) -> dict:
        """The state as the reference takes it: the next frame ``t`` and
        {frame: (memory or None, pointer or None)} per object, float32."""
        s, t = self.states, self.tracker.frame_index

        def copy(x):        # the state is updated in place: copies, never views
            return x.to(torch.float32, copy=True)

        banks = []
        for i in range(s.t.shape[0]):
            frames = {0: (copy(s.cond_mem[i]), copy(s.ptrs[i, 0]))}
            mems = {int(f): copy(s.ring_mem[i, k]) for k, f in
                    enumerate(s.mem_frame[i].tolist()) if f >= 1}
            ptrs = {int(f): copy(s.ptrs[i, k]) for k, f in
                    enumerate(s.ptr_frame[i].tolist()) if f >= 1}
            for f in set(mems) | set(ptrs):
                frames[f] = (mems.get(f), ptrs.get(f))
            banks.append(frames)
        return {"t": t, "banks": banks}

    def one(self, frame: np.ndarray) -> dict:
        """One frame through ``track_video_multi``: the per-object outputs."""
        self.states, outs = self.tracker.track_video_multi(
            self.states, self.upload(frame[None], self.device))
        return {"mask": outs.mask_in_frame[0].float(), "iou": outs.iou[0].float(),
                "best": outs.best[0], "score": outs.object_score[0].float()}


class ControlSam2:
    """The plain reference at fp8 in the program's place."""

    def __init__(self, ctx, p: dict):
        self.ref = R.Tracker(R.Sam2Ref({k: v.clone() for k, v in p.items()}, ctx.config, "fp8"))
        self.device = ctx.device

    def init(self, frame, pos, sz):
        with fp32_exact(), torch.no_grad():
            self.ref.init(torch.as_tensor(frame, device=self.device), pos, sz)

    def _step(self, frame) -> list:
        with fp32_exact(), torch.no_grad():
            return self.ref.step(torch.as_tensor(frame, device=self.device))

    def chunk(self, imgs):
        masks = [torch.stack([o["mask"] for o in self._step(im)]) for im in imgs]
        return (torch.stack(masks).cpu(), None), None

    def snapshot(self) -> dict:
        return {"t": self.ref.t, "banks": [dict(b) for b in self.ref.banks]}

    def one(self, frame) -> dict:
        outs = self._step(frame)
        return {"mask": torch.stack([o["mask"] for o in outs]),
                "iou": torch.stack([o["iou"] for o in outs]),
                "best": torch.tensor([o["choice"] for o in outs]),
                "score": torch.stack([o["score"] for o in outs])}


def _rel(a, b) -> float:
    if a is None:
        return float("inf")
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))


class Sam2VOSCell(VOSCell):
    """The VOS cell's loop (``_chunks``, ``window``, ``stretch``) over
    SAM 2's frames, state and check."""

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
                              t["mask_logits"], t["score_margin"], t["attn_logit_std"])
        del pool
        self.system = (ControlSam2 if ctx.system == "control" else ProgramSam2)(ctx, self.p)
        # set-up: frame 0's prompts, then frames 1 .. setup_frames (the bank fills)
        self.system.init(self.pool[0], self.pos0, self.sz0)
        self.next = 1
        host, done = self.system.chunk(self._frames(t["setup_frames"]))[0]
        if done is not None:
            done.synchronize()
        self.chunks, self.small, self.checked = 0, [], []

    def _frames(self, n: int) -> np.ndarray:
        """The video's next ``n`` host frames."""
        out = np.stack([self.pool[(self.next + i) % len(self.pool)] for i in range(n)])
        self.next += n
        return out

    def _imgs(self, c: int) -> np.ndarray:
        return self._frames(self.ctx.traffic["chunk"])

    def _materialize(self, c, host, done):
        if done is not None:
            done.synchronize()

    def free(self):
        """Runs the check's frames on the system, then drops it."""
        t = self.ctx.traffic
        gaps = F.rng(self.ctx.seed, 3).integers(0, t["check_gap"] + 1, t["check_frames"])
        for gap in gaps:
            if gap:
                self._materialize(None, *self.system.chunk(self._frames(int(gap)))[0])
            before = self.system.snapshot()
            frame = self._frames(1)[0]
            out = self.system.one(frame)
            after = self.system.snapshot()
            new = [b.get(before["t"], (None, None)) for b in after["banks"]]
            self.checked.append((frame, before, out, new))
        self.system = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self) -> list:
        ctx = self.ctx
        per = {k: [] for k in ("mask_mae", "mask_margin", "iou_gap", "obj_score_gap",
                               "memory_err", "ptr_err")}
        with fp32_exact():
            ref = R.Sam2Ref(self.p, ctx.config)
            for frame, before, out, new in self.checked:
                image = torch.as_tensor(frame, device=ctx.device)
                maps = ref.image(image)
                for i, bank in enumerate(before["banks"]):
                    best = int(out["best"][i])
                    r = ref.frame(maps, image.shape[:2],
                                  bank=R.select(before["t"], bank, ctx.config), choice=best)
                    mine, theirs = out["mask"][i].to(ctx.device), r["mask"]
                    per["mask_mae"].append(float((mine - theirs).abs().mean()))
                    per["mask_margin"].append(mask_margin(mine.cpu().numpy() > 0.5,
                                                          theirs.cpu().numpy(), 0.5))
                    per["iou_gap"].append(float(r["iou"][1:].max() - r["iou"][best])
                                          if best > 0 else float("inf"))
                    per["obj_score_gap"].append(abs(float(out["score"][i]) - float(r["score"])))
                    mem, ptr = new[i]
                    per["memory_err"].append(_rel(mem, r["mem"]))
                    per["ptr_err"].append(_rel(ptr, r["ptr"]))
        self.readings = summarize(per)
        return held(self.readings, ctx.traffic["limits"], "sam2_vos")


def setup(ctx) -> Sam2VOSCell:
    return Sam2VOSCell(ctx)
