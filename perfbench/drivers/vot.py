"""One object, frame by frame, closed loop: the per-frame path of the VOT
driver and the demo (``TrackerRuntime.init`` / ``track(im,
soft_mask=False)`` on host uint8 frames).

Traffic: videos of ``video_frames`` frames whose frame sizes cycle through
``frame_sizes``; each starts with ``init`` at the target's box, and is
initialised again at each frame of ``reinit_at`` (a fixed schedule, so the
work does not depend on how random weights track). Each frame size has its
own pool of ``pool_frames`` distinct frames (``frames.render``): one target
moving on a closed path of ``amplitude`` px. The targets' sides (from
``target_side``) and places are one fixed draw (``geometry_seed``) dealt to
the frame sizes in an order drawn from the seed, so every seed has the same
set of targets; the seed draws the order, the paths' phases, the pixels and
the weights. The window loops over videos until its time is up.

End to end: ``track_fps``, tracked frames (each ``track`` whose result is
on the host) over the window's wall time; ``frame_p95_ms``, the 95th
percentile over every frame of the window, init frames included (an init
ends at a device sync), of the time from handing the frame over to having
its result. Both follow the host's pace, which moves by tens of per cent
between runs on one machine, so the cell is defined by its traffic file
and is not in ``BENCHMARK.json``; standard error gives the window's
process CPU time and its frames in each 2 s.

Check (``check_frames`` tracked frames drawn from the seed): the plain
float32 tracker, from the program's state before the frame (its previous
output box, and the template it works out again from the segment's init
frame and box), at the cell the program took: ``score_gap``, the best
penalised score less the one at the program's cell; ``box_err``, the
program's new centre and size against the reference's at that cell, in
target sizes; ``mask_gap``, 1 - IoU of the program's binary mask and the
reference's (the sigmoid mask over ``seg_thr``); ``polygon_gap``, the
program's rotated box against the reference's rotated box of the program's
own binary mask (``reference.tracker.polygon_gap``). Each is the largest
over the frames; ``.mean`` the mean. ``mask_margin``: the widest margin by
which the reference's soft mask lies beyond ``seg_thr`` at a pixel where the
program's binary mask says otherwise. Only the numbers that the traffic's
``limits`` name are held; the others are printed.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from perfbench import frames as F
from perfbench.drivers.tracking import (ReferenceTracker, Reservoir, held, iou_gap,
                                        mask_margin, program_model, scale, summarize,
                                        tracker_config, tracking_weights)
from perfbench.reference import tracker as ref
from perfbench.reference.model import Net, fp32_exact


class ProgramVOT:
    """The program: ``TrackerRuntime`` over the configuration's model; the
    cell each ``Tracker.step`` took is kept (``best``), and, with spans,
    ``Tracker.step`` and ``mask_to_rotated_box`` are timed."""

    def __init__(self, ctx, p: dict):
        from siammask_tpu_torch.tracker import runtime

        self.runtime_module = runtime
        hp = tracker_config(ctx.config, ctx.traffic["hp"])
        self.rt = runtime.TrackerRuntime(program_model(ctx.config, p), hp, ctx.device)
        self.polygon = runtime.mask_to_rotated_box
        self.plain_step = self.step = self.rt.tracker.step
        self.best = None

        def capture(state, frame):
            new_state, out = self.step(state, frame)
            self.best, self.cell_mask = out.best_id, out.mask_logits
            return new_state, out

        self.rt.tracker.step = capture

    def timed(self, spans):
        self.step = spans.wrap("bench.Tracker.step", self.plain_step)
        self.runtime_module.mask_to_rotated_box = spans.wrap("bench.polygon", self.polygon)

    def untimed(self):
        self.step = self.plain_step
        self.runtime_module.mask_to_rotated_box = self.polygon

    def init(self, im, box):
        self.rt.init(im, box[:2], box[2:])

    def track(self, im) -> dict:
        return self.rt.track(im, soft_mask=False)


class ControlVOT:
    """The plain tracker at fp8 in the program's place, its rotated box
    rounded to bf16."""

    def __init__(self, ctx, p: dict):
        self.hp = ctx.config["hp"][ctx.traffic["hp"]]
        self.ref = ReferenceTracker(p, ctx.config, self.hp, ctx.device)
        self.device = ctx.device
        self.best = None

    def timed(self, spans):
        pass

    def untimed(self):
        pass

    def init(self, im, box):
        self.ref.init(torch.as_tensor(im, device=self.device), [box[:2]], [box[2:]])

    def track(self, im) -> dict:
        out = self.ref.step(torch.as_tensor(im, device=self.device))
        self.best, self.cell_mask = out["best"][0], out["cell_mask"][0]
        pos, sz = out["pos"][0].cpu().numpy(), out["sz"][0].cpu().numpy()
        mask = (out["mask"][0] > self.hp["seg_thr"]).to(torch.uint8).cpu().numpy()
        # the polygon, float32 in the program (cv2), one step lower: bf16
        polygon = torch.as_tensor(ref.rotated_box(mask, pos, sz)).to(torch.bfloat16)
        return {"target_pos": pos, "target_sz": sz, "score": float(out["score"][0]),
                "mask_bin": mask, "polygon": polygon.double().numpy()}


class VOTCell:
    def __init__(self, ctx):
        t = ctx.traffic
        self.ctx = ctx
        self.hp = ctx.config["hp"][t["hp"]]
        r = F.rng(ctx.seed, 2)
        gen = F.device_generator(ctx.seed, 2, ctx.device)
        # one fixed draw of the targets' sides and places, dealt to the frame
        # sizes in a seeded order: every seed tracks the same set of targets
        fixed = np.random.RandomState(t["geometry_seed"])
        n = len(t["frame_sizes"])
        sides = fixed.uniform(*t["target_side"], (n, 2))[r.permutation(n)]
        places = fixed.uniform(0, 1, (n, 2))[r.permutation(n)]
        self.pools, self.boxes = [], []
        amp = t["amplitude"]
        for (h, w), side, place in zip(t["frame_sizes"], sides, places):
            lo = side / 2 + amp
            centre = lo + place * (np.array([w, h]) - 2 * lo)
            boxes = F.paths(r, t["pool_frames"], [centre], [side], amp)[:, 0]
            pool = F.render(gen, boxes[:, None], (h, w), ctx.device)
            self.pools.append(pool.cpu().numpy())
            self.boxes.append(boxes)
            if len(self.pools) == 1:
                p = tracking_weights(ctx.config, ctx.seed, pool[0], boxes[0],
                                     t.get("mask_logits"))
            del pool
        self.p = p
        self.system = (ControlVOT if ctx.system == "control" else ProgramVOT)(ctx, p)
        self.sample = Reservoir(t["check_frames"], F.rng(ctx.seed, 3))
        # warm-up: an init and a few frames at every frame size
        for s in range(len(self.pools)):
            self.system.init(self.pools[s][0], self.boxes[s][0])
            for g in range(1, t["warmup_frames"] + 1):
                self.system.track(self.pools[s][g])
        self.video = 0

    def _frames(self, deadline: float | None, limit: int | None, latencies: list):
        """Frames of the videos in turn until ``deadline`` (host clock) or
        ``limit`` frames; returns the frames tracked."""
        t = self.ctx.traffic
        tracked = handled = 0
        cuda = self.ctx.device.type == "cuda"
        while True:
            s = self.video % len(self.pools)
            pool, boxes = self.pools[s], self.boxes[s]
            state = None
            for f in range(t["video_frames"]):
                g = f % len(pool)
                start = time.perf_counter()
                if f == 0 or f in t["reinit_at"]:
                    self.system.init(pool[g], boxes[g])
                    if cuda:
                        torch.cuda.synchronize()
                    latencies.append(time.perf_counter() - start)
                    seg = (s, g)
                    state = (boxes[g][:2], boxes[g][2:])
                else:
                    res = self.system.track(pool[g])
                    latencies.append(time.perf_counter() - start)
                    slot = self.sample.offer()
                    if slot is not None:
                        self.sample.items[slot] = {
                            "size": s, "g": g, "segment": seg, "pos_before": state[0],
                            "sz_before": state[1], "pos": res["target_pos"],
                            "sz": res["target_sz"], "best": self.system.best,
                            "cell_mask": self.system.cell_mask,
                            "mask_bin": res["mask_bin"], "polygon": res["polygon"]}
                    state = (res["target_pos"], res["target_sz"])
                    tracked += 1
                handled += 1
                done_time = deadline is not None and time.perf_counter() >= deadline
                if done_time or (limit is not None and handled >= limit):
                    self.video += 1
                    return tracked
            self.video += 1

    def window(self, seconds: float, spans) -> dict:
        if spans is not None:
            self.system.timed(spans)
        latencies = []
        c0, t0 = time.process_time(), time.perf_counter()
        tracked = self._frames(t0 + seconds, None, latencies)
        wall = time.perf_counter() - t0
        cpu = time.process_time() - c0
        self.system.untimed()
        # the host's pace through the window: frames in each 2 s of frame time
        ends = np.cumsum(latencies)
        pace = np.bincount((ends // 2.0).astype(int)).tolist()
        print(f"vot window: {tracked} frames, wall {wall:.3f} s, process cpu {cpu:.3f} s "
              f"({1e3 * cpu / max(tracked, 1):.3f} ms a frame), frames a 2 s {pace}",
              file=sys.stderr, flush=True)
        return {"track_fps": tracked / wall,
                "frame_p95_ms": 1e3 * float(np.percentile(latencies, 95)),
                "attempted": len(latencies), "failed": 0, "tracked": tracked, "wall_s": wall}

    def stretch(self, spans) -> int:
        self.system.timed(spans)
        with torch.profiler.record_function("bench.frames"):
            n = self._frames(None, self.ctx.traffic["trace_frames"], [])
        self.system.untimed()
        return n

    def free(self):
        self.system = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self) -> list:
        ctx, hp = self.ctx, self.hp
        items = [i for i in self.sample.items if i is not None]
        per = {"score_gap": [], "box_err": [], "cell_err": [], "mask_margin": [],
               "mask_gap": [], "polygon_gap": []}
        areas, parts = [], []
        with fp32_exact():
            net = Net(self.p, ctx.config["width"])
            templates = {}
            for it in items:
                if it["segment"] not in templates:
                    s, g = it["segment"]
                    frame = torch.as_tensor(self.pools[s][g], device=ctx.device)
                    box = torch.as_tensor(np.asarray(self.boxes[s][g], np.float32),
                                          device=ctx.device)
                    templates[it["segment"]] = ref.Template(net, frame, box[None, :2],
                                                            box[None, 2:])
                frame = torch.as_tensor(self.pools[it["size"]][it["g"]], device=ctx.device)
                pos = torch.tensor(np.asarray([it["pos_before"]], np.float32), device=ctx.device)
                sz = torch.tensor(np.asarray([it["sz_before"]], np.float32), device=ctx.device)
                best = int(it["best"])
                out = ref.step(net, hp, templates[it["segment"]], frame, pos, sz, best=[best])
                per["score_gap"].append(float(out["pscore"][0].max() - out["pscore"][0, best]))
                err = max(np.abs(np.asarray(it["pos"]) - out["pos"][0].cpu().numpy()).max(),
                          np.abs(np.asarray(it["sz"]) - out["sz"][0].cpu().numpy()).max())
                per["box_err"].append(float(err) / scale(it["sz_before"]))
                cell = (it["cell_mask"].float() - out["cell_mask"][0]).abs()
                per["cell_err"].append(float(cell.mean()))
                soft = out["mask"][0].cpu().numpy()
                per["mask_margin"].append(mask_margin(it["mask_bin"], soft, hp["seg_thr"]))
                per["mask_gap"].append(iou_gap(it["mask_bin"], soft > hp["seg_thr"]))
                poly = ref.rotated_box(it["mask_bin"], it["pos"], it["sz"])
                per["polygon_gap"].append(
                    ref.polygon_gap(np.asarray(it["polygon"], float), poly))
                areas.append(int(it["mask_bin"].sum()))
                parts.append(ref.count_components(it["mask_bin"]))
        if areas:
            print(f"vot: {len(items)} frames checked; mask area px median "
                  f"{int(np.median(areas))} (min {min(areas)}, max {max(areas)}); contours "
                  f"median {int(np.median(parts))} (max {max(parts)})", flush=True,
                  file=sys.stderr)
        self.readings = summarize(per)
        return held(self.readings, ctx.traffic["limits"], "vot")


def setup(ctx) -> VOTCell:
    return VOTCell(ctx)
