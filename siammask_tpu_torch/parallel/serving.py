"""Batched tracking of O object streams split over several devices.

Counterpart of ``siammask_tpu/parallel/serving.py``. The JAX package
shards the vmapped stream axis of one program over a device mesh; here each
device holds a replica ``Tracker`` (a deep copy of the model, in eval mode)
and a contiguous share of the streams, the rows ``local_rows`` gives it.
Streams are independent, so there are no collectives: each device gets the
frames once, steps its streams (through its own CUDA graph over a video on
a card), and the outputs are gathered on the first device in stream order.

The replicas run in one host thread each. A video on a card is a host loop
of copies and graph replays (``StepGraph.run``) whose calls release the
interpreter lock, so one device's issuing does not wait for another's whole
video. The graphs are captured one replica at a time, before the threads
start: a capture must not overlap other work on the card.

``devices`` may name one device more than once: two replicas on one card,
or on the CPU's one device.
"""
from __future__ import annotations

import contextlib
import copy
from concurrent.futures import ThreadPoolExecutor

import torch

from siammask_tpu_torch.parallel.dist import local_rows
from siammask_tpu_torch.tracker.tracker import Tracker, TrackState


class ShardedStreamServer:
    """Serve O streams split over ``devices`` (every visible card when
    None). ``tracker`` gives the model, the config and the path (``mask``,
    ``refine``); its model is copied to each device. O must be a multiple of
    the device count (pad with dummy streams). The states are a list of
    ``TrackState``, one per replica, on its device."""

    def __init__(self, tracker: Tracker, devices=None):
        if devices is None:
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if not devices:
            raise ValueError("ShardedStreamServer: no devices (no card is visible)")
        self.devices = [torch.device(d) for d in devices]
        self.replicas = [Tracker(copy.deepcopy(tracker.model).to(d).eval(), tracker.p, d,
                                 mask=tracker.mask, refine=tracker.refine)
                         for d in self.devices]

    def _on_devices(self, x) -> list[torch.Tensor]:
        """``x`` copied once to each device named; one tensor per replica."""
        placed = {}
        for d in self.devices:
            if d not in placed:
                placed[d] = torch.as_tensor(x, device=d)
        return [placed[d] for d in self.devices]

    def _in_threads(self, fn, *per_replica: list) -> list:
        """``fn(replica, *args)`` for each replica, each in its own thread
        (on its device, in inference mode); the results in replica order."""
        def call(replica, *args):
            on_card = replica.device.type == "cuda"
            with torch.cuda.device(replica.device) if on_card else contextlib.nullcontext(), \
                    torch.inference_mode():
                return fn(replica, *args)

        with ThreadPoolExecutor(len(self.replicas)) as pool:
            futures = [pool.submit(call, r, *args)
                       for r, *args in zip(self.replicas, *per_replica)]
            return [f.result() for f in futures]

    def _gather(self, outs: list, dim: int):
        first = self.devices[0]
        return type(outs[0])(*(torch.cat([v.to(first) for v in vs], dim) for vs in zip(*outs)))

    def init_batched(self, frame, target_pos, target_sz) -> list[TrackState]:
        """Init O streams on one frame, target_pos / target_sz (O, 2): each
        replica inits its contiguous share."""
        o, n = len(target_pos), len(self.replicas)
        if o % n:
            raise ValueError(f"streams ({o}) must be a multiple of the device count ({n}); "
                             "pad with dummy streams")
        frames = self._on_devices(frame)
        return [r.init_batched(f, target_pos[local_rows(o, i, n)], target_sz[local_rows(o, i, n)])
                for i, (r, f) in enumerate(zip(self.replicas, frames))]

    def step(self, states: list[TrackState], frame):
        """One frame for every stream: (the new states, the outputs (O, ...)
        on the first device, in stream order)."""
        results = self._in_threads(Tracker.step_batched, states, self._on_devices(frame))
        return [st for st, _ in results], self._gather([out for _, out in results], 0)

    def track_video(self, states: list[TrackState], frames):
        """T frames (T, H, W, 3) for every stream: (the final states, the
        outputs stacked (T, O, ...) on the first device, in stream order)."""
        frames = self._on_devices(frames)
        graphs = [r.step_graph(st, f) if r.device.type == "cuda" else None
                  for r, st, f in zip(self.replicas, states, frames)]

        def run(replica, graph, st, f):
            return replica.track_video_multi(st, f) if graph is None else graph.run(st, f)

        results = self._in_threads(run, graphs, states, frames)
        return [st for st, _ in results], self._gather([out for _, out in results], 1)
