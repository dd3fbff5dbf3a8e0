"""The stage-1 step on several cards: ``Trainer.step`` under
``distributed=True`` in the train CLI's default mode (sync-BN, the global
batch's loss counts, one summed gradient bucket; NCCL), the same global
batch as the one-card cell split over the ranks.

The harness process touches no card while the ranks run: it spawns one
process a card through the program's ``parallel/dist.py`` ``spawn`` and
hands each only the names and the seed. Each rank makes the pool of global
batches and the weights from the seed on its own card, takes rank 0's
weights (a broadcast), keeps its rows of each batch (``local_rows``), and
runs the one-card cell's set-up, checked steps and window
(``train.TrainCell``); rank 0's clock ends the window on every rank. A
traced run profiles the stretch on every rank.

End to end: ``train_sps``, global samples of the completed steps over rank
0's window. For per-layer readers, each rank returns the program's
``_all_reduce.calls`` over the window (``calls``) and, traced, its trace's
reading; rank 0's keeps every operation's device time (the all-reduce
kernels by name). The cell is defined by its traffic file
(``traffic/base_train_dp4.json``) and is not in ``BENCHMARK.json`` yet.

Check: as the one-card cell, rank 0's program against the plain float32
step over the whole global batch on one card, once the ranks have ended;
and ``cross_rank``, the largest difference of a trained parameter between
a rank and rank 0 after the checked steps (every rank steps alike: 0).
"""
from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from perfbench import harness, tracing
from perfbench.drivers import train
from perfbench.drivers.tracking import held


def rank_main(rank, world, device, name, seed, seconds, trace, overrides, system):
    """One rank's whole run; rank 0 also returns what the check reads."""
    from siammask_tpu_torch.parallel import dist as pdist

    if system == "no_exchange":         # a planted fault: the trainer's exchanges left out
        from siammask_tpu_torch.train import trainer
        trainer.all_reduce_tensors = lambda tensors, op="sum": None
        system = None
    ctx = harness.Context(name, harness.find_cell(name), seed, device, world, overrides, system)
    cell = train.TrainCell(ctx, rows=pdist.local_rows(ctx.traffic["batch"], rank, world),
                           distributed=True)
    cross = 0.0
    for v in cell.params3.values():
        first = v.clone()
        dist.broadcast(first, 0)
        cross = max(cross, float((v.float() - first.float()).abs().max()))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.barrier()
    out = {"window_start": time.time(), "cross_rank": cross}
    calls = pdist._all_reduce.calls
    out["result"] = cell.window(seconds, tracing.Spans() if trace else None)
    out["calls"] = pdist._all_reduce.calls - calls
    if trace:
        path = os.path.join(os.environ.get("TMPDIR", str(harness.ROOT / "build")),
                            f"perfbench_{name}_rank{rank}_{os.getpid()}.json")
        steps = tracing.profile(lambda: cell.stretch(tracing.Spans()), path,
                                "perfbench.stretch")
        try:
            out["trace"] = tracing.read_trace(path, "perfbench.stretch")
        finally:
            os.unlink(path)
        if rank:
            out["trace"].pop("ops")
        out["trace_steps"] = steps
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    if rank == 0:
        out.update(losses=cell.losses, grad1=cell.grad1, params3=cell.params3,
                   buffers3=cell.buffers3)
    return out


class TrainDPCell:
    spawns = True               # the harness leaves the cards to the ranks

    def __init__(self, ctx):
        self.ctx = ctx
        self.started = time.time() - harness.process_seconds()

    def window(self, seconds: float, spans) -> dict:
        from siammask_tpu_torch.parallel import dist as pdist

        ctx = self.ctx
        overrides = {"config": {k: v for k, v in ctx.config.items()},
                     "traffic": {k: v for k, v in ctx.traffic.items()}}
        self.ranks = pdist.spawn(rank_main, ctx.chips, ctx.device.type, ctx.name, ctx.seed,
                                 seconds, spans is not None, overrides, ctx.system,
                                 timeout=ctx.traffic["collective_timeout_s"])
        first = self.ranks[0]
        self.setup_s = first["window_start"] - self.started
        self.memory_peak = max(r["memory_peak_bytes"] for r in self.ranks)
        return first["result"]

    def traced(self):
        """Rank 0's trace of its stretch, busy and window averaged over the
        ranks; the steps in the stretch."""
        read = dict(self.ranks[0]["trace"])
        n = len(self.ranks)
        read["busy_s"] = sum(r["trace"]["busy_s"] for r in self.ranks) / n
        read["window_s"] = sum(r["trace"]["window_s"] for r in self.ranks) / n
        read["rank0"] = self.ranks[0]["trace"]
        return read, self.ranks[0]["trace_steps"]

    def free(self):
        pass

    @torch.no_grad()
    def check(self) -> list:
        first = self.ranks[0]
        ref_cell = train.TrainCell(self.ctx, drive=False)     # the global batches, on card 0
        with torch.enable_grad():
            ref = ref_cell.reference()
        on = {k: {n: v.to(self.ctx.device) for n, v in first[k].items()}
              for k in ("grad1", "params3", "buffers3")}
        self.readings = ref_cell.compare(first["losses"], on["grad1"], on["params3"],
                                         on["buffers3"], ref)
        self.readings["cross_rank"] = max(r["cross_rank"] for r in self.ranks)
        return held(self.readings, self.ctx.traffic["limits"], "train_dp")


def setup(ctx) -> TrainDPCell:
    return TrainDPCell(ctx)
