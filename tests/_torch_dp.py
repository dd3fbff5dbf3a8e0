"""What the ranks of ``tests/test_torch_parallel.py`` run, in processes that
``siammask_tpu_torch.parallel.dist.spawn`` starts: this module imports the
port only (no jax), so a spawned child imports nothing else."""
import torch
import torch.distributed as dist

from siammask_tpu_torch.models.siammask import SiamMaskBase
from siammask_tpu_torch.parallel.dist import AllReduceSum, _all_reduce, local_rows
from siammask_tpu_torch.parallel.sync_bn import SyncBatchNorm2d
from siammask_tpu_torch.train.trainer import Trainer


class GlobalBNRecorder:
    """Per train-mode BN call, the running-variance excess of the port's
    unbiased update over flax's biased one, ``e <- 0.9 e + 0.1 b / (n - 1)``,
    with the biased variance b and the count n of the rows the BN normalizes
    over: the group's for a synced BN (one float64 all-reduce a call, on
    every rank alike), else this rank's."""

    def __init__(self, model):
        self.excess = {}
        self.handles = [m.register_forward_hook(self._hook(name))
                        for name, m in model.named_modules()
                        if isinstance(m, torch.nn.BatchNorm2d)]

    def _hook(self, name):
        def hook(mod, inputs, _):
            if not mod.training:
                return
            x = inputs[0].detach().double()
            stats = torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)),
                               x.new_full((1,), x.numel() // x.shape[1])])
            if isinstance(mod, SyncBatchNorm2d) and dist.get_world_size() > 1:
                dist.all_reduce(stats)
            c = x.shape[1]
            n = stats[2 * c]
            b = stats[c:2 * c] / n - (stats[:c] / n) ** 2
            self.excess[name] = 0.9 * self.excess.get(name, 0.0) + 0.1 * b / (n - 1)
        return hook


def _state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def run_cases(rank, world, device, state, batch, parts, cases):
    """Each case of ``cases`` (name, Trainer keyword arguments and the
    ``dtype``, epochs to step, the rank whose template gets a NaN or None)
    from the weights
    ``state`` on this rank's rows of ``batch``: per step the metrics, the
    state after it, the BN excess so far and the collectives issued; and
    an ``AllReduceSum`` of rank-made values with its gradient."""
    torch.set_num_threads(1)
    rows = local_rows(batch["template"].shape[0], rank, world)
    local = {k: v[rows] for k, v in batch.items()}
    out = {}
    for name, kwargs, epochs, nan_rank in cases:
        kwargs = dict(kwargs)
        dtype = kwargs.pop("dtype", torch.float32)
        model = SiamMaskBase(width=8)
        model.load_state_dict(state)
        model.to(dtype)
        trainer = Trainer(model, *parts, epochs=2, distributed=True, **kwargs)
        recorder = GlobalBNRecorder(model)
        # a copy: the batch's storage is shared with the parent process
        data = {k: v.to(dtype, copy=True) if v.is_floating_point() else v
                for k, v in local.items()}
        if nan_rank == rank:
            data["template"][0, 0, 0, 0] = float("nan")
        steps = []
        for epoch in epochs:
            calls = _all_reduce.calls
            metrics = trainer.step(data, epoch)
            steps.append({"metrics": {k: float(v) for k, v in metrics.items()},
                          "state": _state(model), "collectives": _all_reduce.calls - calls,
                          "excess": {k: v.numpy() for k, v in recorder.excess.items()}})
        out[name] = {"steps": steps, "labels": dict(trainer.labels)}

    x = torch.arange(6, dtype=torch.float64).reshape(2, 3) * (rank + 1)
    x.requires_grad_()
    y = AllReduceSum.apply(x)
    (y * (rank + 2)).sum().backward()
    out["all_reduce_sum"] = {"x": x.detach().numpy(), "y": y.detach().numpy(),
                             "grad": x.grad.numpy()}
    return out
