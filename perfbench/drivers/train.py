"""Stage-1 SiamMask-base training steps on one card: ``Trainer.step`` of the
unfrozen phase (layer2 and layer3 train) at the configuration's batch.

Traffic: a pool of ``pool_batches`` device-resident batches drawn from the
seed with the program bench's training-batch distributions (images uniform
in 0..255; cls labels -1 / 0 / 1 with probabilities 0.8 / 0.15 / 0.05; box
deltas normal with deviation 0.1 and weights 1 on 10% of anchors; the
search mask's signs at random and mask weights 1 on 5% of cells), cycled
step after step. The trainer's learning-rate schedule is the
configuration's, at ``epoch`` of ``epochs``.

Set-up builds the trainer and drives it through its first
``check_steps`` steps on the first batches, through the window's own call,
then ``warmup_steps`` more; the window continues from there.

End to end: ``train_sps``, samples of the steps completed over the
window's wall time (a step the NaN guard skips counts as failed).

Check: the plain float32 step (``reference/train.py``) from the same
weights on the same batches: ``loss_gap``, the largest relative gap of a
loss term (cls, loc, mask) over the checked steps; ``grad_gap``, the first
gradient as the optimizer took it (its momentum buffer after one step,
less the weight decay), the gap of norms of the worst leaf against the
larger of that leaf's norm and the median leaf's; ``change_gap``, the same
for each parameter's change after the checked steps; ``bn_gap``, the same
for the change of each training BatchNorm's running statistics. Leaves
whose reference gradient is under a thousandth of the median leaf's move by
round-off alone and are left out of the gradient and change gaps.
"""
from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch
import torch.distributed as dist

from perfbench import frames as F
from perfbench import weights
from perfbench.drivers.tracking import held
from perfbench.reference import train as rt
from perfbench.reference.model import Net, fp32_exact

TERMS = ("cls_loss", "loc_loss", "mask_loss")


def make_batch(gen: torch.Generator, b: int, cfg: dict, device) -> dict:
    t, s, g = cfg["template_size"], cfg["search_size"], cfg["score_size"]
    k = cfg["anchor_num"]

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=device)

    u = rand(b, k, g, g)
    return {"template": 255.0 * rand(b, 3, t, t), "search": 255.0 * rand(b, 3, s, s),
            "label_cls": torch.where(u < 0.8, -1, torch.where(u < 0.95, 0, 1)).long(),
            "label_loc": 0.1 * torch.randn((b, 4, k, g, g), generator=gen, device=device),
            "label_loc_weight": (rand(b, k, g, g) < 0.1).float(),
            "label_mask": torch.sign(torch.randn((b, s, s), generator=gen, device=device)),
            "label_mask_weight": (rand(b, g, g) < 0.05).float()}


def lr_at(lr: dict, epochs: int, epoch: int) -> float:
    """The published schedule (``utils/lr_helper.py``): a warm-up of
    ``warmup.epoch`` epochs, geometric from its start to its end LR a
    ``step`` of epochs, then a log space from ``start_lr`` to ``end_lr``."""
    warm = lr.get("warmup")
    if warm:
        n = min(warm["epoch"], epochs)
        if epoch < n:
            mult = (warm["end_lr"] / warm["start_lr"]) ** (1.0 / (n // warm.get("step", 1)))
            return warm["start_lr"] * mult ** (epoch // warm.get("step", 1))
        epoch, epochs = epoch - n, epochs - n
    return float(np.logspace(math.log10(lr["start_lr"]), math.log10(lr["end_lr"]),
                             epochs)[epoch])


class ProgramTrain:
    def __init__(self, ctx, p: dict, lr: float, distributed: bool = False):
        from siammask_tpu_torch.models.siammask import SiamMaskBase
        from siammask_tpu_torch.train.lr import build_lr_spaces
        from siammask_tpu_torch.train.trainer import OptimizerConfig, Trainer, TrainSettings

        cfg, t = ctx.config, ctx.traffic
        with torch.device("meta"):
            model = SiamMaskBase(cfg["anchor_num"], cfg["width"],
                                 weights.DTYPES[cfg["dtype"]])
        self.model = weights.load_into(model, p)
        settings = TrainSettings(task="base", loss_weight=tuple(cfg["loss_weight"]),
                                 mask_pad=cfg["mask_pad"])
        opt = cfg["optimizer"]
        self.trainer = Trainer(self.model, settings,
                               OptimizerConfig(momentum=opt["momentum"],
                                               weight_decay=opt["weight_decay"],
                                               clip=opt["clip"]),
                               build_lr_spaces(cfg["lr"], t["epochs"]), t["epochs"],
                               unfreeze_at=cfg["unfreeze_at"], distributed=distributed)
        self.epoch = t["epoch"]

    def step(self, batch: dict) -> dict:
        return self.trainer.step(batch, self.epoch)

    def params(self) -> dict:
        return {k: v for k, v in self.model.named_parameters() if v.requires_grad}

    def momentum(self) -> dict:
        # a parameter the optimizer never stepped has no buffer: nothing moved it
        state = self.trainer.optimizer.state
        return {k: state[v].get("momentum_buffer", torch.zeros_like(v))
                for k, v in self.params().items()}

    def buffers(self) -> dict:
        return dict(self.model.named_buffers())


class ControlTrain:
    """The plain step at fp8 in the program's place."""

    def __init__(self, ctx, p: dict, lr: float, distributed: bool = False):
        cfg = ctx.config
        self.net = Net({k: v.clone() for k, v in p.items()}, cfg["width"], "fp8", rt.trains)
        opt = cfg["optimizer"]
        self.sgd = rt.SGDStep(self.net, lr, opt["momentum"], opt["weight_decay"], opt["clip"],
                              tuple(cfg["loss_weight"]))

    def step(self, batch: dict) -> dict:
        with fp32_exact():
            terms, _ = self.sgd(batch)
        return {**dict(zip(TERMS, map(torch.tensor, terms))), "skipped": torch.tensor(0.0)}

    def params(self) -> dict:
        return {k: self.net.p[k] for k in self.sgd.names}

    def momentum(self) -> dict:
        return dict(self.sgd.buf)

    def buffers(self) -> dict:
        return self.net.p


def leaf_gaps(prog: dict, ref: dict, keep) -> list:
    """Each leaf's gap between its norm in ``prog`` and in ``ref``, over the
    larger of the leaf's reference norm and the median leaf's, for the
    leaves ``keep``."""
    norms = {k: float(ref[k].double().norm()) for k in keep}
    med = statistics.median(norms.values())
    return [abs(float(prog[k].double().norm()) - norms[k]) / max(norms[k], med, 1e-30)
            for k in keep]


class TrainCell:
    """The cell's inputs (the pool of global batches, the weights ``p0``, the
    LR) and, with ``drive``, the system set up and driven through the checked
    steps. ``rows``: the program's rows of each global batch (one rank's);
    ``distributed``: the program steps in the trainer's data-parallel
    default mode, the weights are rank 0's and rank 0 decides when the
    window ends."""

    def __init__(self, ctx, rows: slice | None = None, distributed: bool = False,
                 drive: bool = True):
        cfg, t = ctx.config, ctx.traffic
        self.ctx = ctx
        self.distributed = distributed
        gen = F.device_generator(ctx.seed, 4, ctx.device)
        self.batches = [make_batch(gen, t["batch"], cfg, ctx.device)
                        for _ in range(t["pool_batches"])]
        self.local = self.batches if rows is None else \
            [{k: v[rows] for k, v in b.items()} for b in self.batches]
        b0 = self.batches[0]
        self.p0 = weights.make(cfg["family"], cfg["width"], ctx.seed, ctx.device,
                               b0["template"][:1], b0["search"][:1], tracking=False)
        if distributed:
            for v in self.p0.values():
                dist.broadcast(v, 0)
        self.lr = lr_at(cfg["lr"], t["epochs"], t["epoch"])
        if not drive:
            return
        system = ControlTrain if ctx.system == "control" else ProgramTrain
        self.system = system(ctx, {k: v.clone() for k, v in self.p0.items()}, self.lr,
                             distributed)
        # the checked steps, through the window's own call
        self.losses = []
        for i in range(t["check_steps"]):
            m = self.system.step(self.local[i])
            self.losses.append([float(m[k]) for k in TERMS])
            if i == 0:
                wd = cfg["optimizer"]["weight_decay"]
                self.grad1 = {k: v.detach() - wd * self.p0[k]
                              for k, v in self.system.momentum().items()}
        self.params3 = {k: v.detach().clone() for k, v in self.system.params().items()}
        self.buffers3 = {k: v.detach().clone() for k, v in self.system.buffers().items()
                         if k.endswith(("running_mean", "running_var"))}
        self.i = t["check_steps"]
        for _ in range(t["warmup_steps"]):
            self._step()

    def _step(self) -> dict:
        m = self.system.step(self.local[self.i % len(self.local)])
        self.i += 1
        return m

    def _done(self, deadline) -> bool:
        done = deadline is not None and time.perf_counter() >= deadline
        if not self.distributed:
            return done
        flag = torch.tensor([float(done)], device=self.ctx.device)
        dist.broadcast(flag, 0)          # rank 0's clock ends every rank's window
        return bool(flag.item())

    def _steps(self, deadline, limit, spans):
        step = self._step if spans is None else spans.wrap("bench.Trainer.step", self._step)
        metrics = []
        while True:
            metrics.append(step())
            if self._done(deadline) or (limit is not None and len(metrics) >= limit):
                break
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
        return metrics

    def window(self, seconds: float, spans) -> dict:
        t0 = time.perf_counter()
        metrics = self._steps(t0 + seconds, None, spans)
        wall = time.perf_counter() - t0
        skipped = int(sum(float(m["skipped"]) for m in metrics))
        b = self.ctx.traffic["batch"]
        return {"train_sps": b * (len(metrics) - skipped) / wall, "attempted": len(metrics),
                "failed": skipped, "steps": len(metrics), "wall_s": wall}

    def stretch(self, spans) -> int:
        return len(self._steps(None, self.ctx.traffic["trace_steps"], spans))

    def free(self):
        self.system = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, rows: int | None = None, precision: str = "fp32",
                  dtype: torch.dtype = torch.float32):
        """The plain step over the checked batches (their first ``rows``
        rows when given), in ``dtype``: losses, first gradients, parameters
        and buffers after them."""
        cfg, t = self.ctx.config, self.ctx.traffic
        opt = cfg["optimizer"]

        def cast(v):       # a copy: the step updates BatchNorm buffers in place
            return v.to(dtype, copy=True) if v.is_floating_point() else v.clone()

        net = Net({k: cast(v) for k, v in self.p0.items()}, cfg["width"], precision,
                  rt.trains)
        sgd = rt.SGDStep(net, self.lr, opt["momentum"], opt["weight_decay"], opt["clip"],
                         tuple(cfg["loss_weight"]))
        losses, grad1 = [], None
        with fp32_exact():
            for i in range(t["check_steps"]):
                batch = {k: cast(v) for k, v in self.batches[i].items()}
                if rows is not None:
                    batch = {k: v[:rows] for k, v in batch.items()}
                terms, grads = sgd(batch)
                losses.append(list(terms))
                if i == 0:
                    grad1 = grads
        return losses, grad1, net.p

    def compare(self, losses, grad1, params3, buffers3, ref) -> dict:
        """Every reading of the program's first steps against the
        reference's: the worst leaf's gap (``grad_gap``, ``change_gap``,
        ``bn_gap``) and the median leaf's (``*.median``)."""
        r_losses, r_grad1, r_p = ref
        gaps = np.array([[abs(a - b) / max(abs(b), 1e-30) for a, b in zip(pa, pb)]
                         for pa, pb in zip(losses, r_losses)])      # (steps, terms)
        out = {"loss_gap": float(gaps.max())}
        for j, term in enumerate(TERMS):
            out[f"loss_gap.{term.split('_')[0]}"] = float(gaps[:, j].max())
            out[f"loss_gap.{term.split('_')[0]}.step1"] = float(gaps[0, j])
        norms = {k: float(v.double().norm()) for k, v in r_grad1.items()}
        med = statistics.median(norms.values())
        keep = [k for k in r_grad1 if norms[k] >= 1e-3 * med]
        bn = [k for k in buffers3 if rt.trains(k)]
        pairs = {"grad_gap": (grad1, r_grad1, keep),
                 "change_gap": ({k: params3[k].float() - self.p0[k] for k in keep},
                                {k: r_p[k] - self.p0[k] for k in keep}, keep),
                 "bn_gap": ({k: buffers3[k] - self.p0[k] for k in bn},
                            {k: r_p[k] - self.p0[k] for k in bn}, bn)}
        for name, (prog, ref_, leaves) in pairs.items():
            if name == "change_gap":
                whole = [float(torch.cat([d[k].double().reshape(-1) for k in leaves]).norm())
                         for d in (prog, ref_)]
                out[f"{name}.whole"] = abs(whole[0] - whole[1]) / max(whole[1], 1e-30)
            gaps = leaf_gaps(prog, ref_, leaves)
            out[name] = max(gaps)
            out[f"{name}.median"] = statistics.median(gaps)
            worst = sorted(zip(gaps, leaves), reverse=True)[:3]
            out[f"{name}.worst"] = " ".join(f"{k}:{g:.3g}" for g, k in worst)
        return out

    @torch.no_grad()
    def check(self) -> list:
        with torch.enable_grad():
            ref = self.reference()
        self.readings = self.compare(self.losses, self.grad1, self.params3, self.buffers3, ref)
        return held(self.readings, self.ctx.traffic["limits"], "train")


def setup(ctx) -> TrainCell:
    return TrainCell(ctx)
