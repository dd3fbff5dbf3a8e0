"""What the ranks of ``tests/test_torch_parallel.py`` and
``tests/test_torch_train_cli_dp.py`` run, in processes that
``siammask_tpu_torch.parallel.dist.spawn`` starts: this module imports the
port only (no jax), so a spawned child imports nothing else."""
import json
from pathlib import Path

import torch
import torch.distributed as dist

from siammask_tpu_torch.data.dataset import PairDataset
from siammask_tpu_torch.models.siammask import SiamMaskBase
from siammask_tpu_torch.parallel.dist import AllReduceSum, _all_reduce, local_rows
from siammask_tpu_torch.parallel.sync_bn import SyncBatchNorm2d
from siammask_tpu_torch.tools import train as train_cli
from siammask_tpu_torch.train.trainer import Trainer


class BNRecorder:
    """Forward hooks that note, by name, each BN that ran in training mode
    (and so updated its running statistics)."""

    def __init__(self, model):
        self.updated = set()
        self.handles = [m.register_forward_hook(self._hook(name))
                        for name, m in model.named_modules()
                        if isinstance(m, torch.nn.BatchNorm2d)]

    def _hook(self, name):
        def hook(mod, inputs, _):
            if mod.training:
                self.updated.add(name)
        return hook


def _state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _recording_all_reduce(dtypes: list):
    """Wraps ``torch.distributed.all_reduce``, which every collective of
    ``parallel.dist`` calls, so that each call appends its tensor's dtype
    to ``dtypes``."""
    all_reduce = dist.all_reduce

    def recording(t, *args, **kwargs):
        dtypes.append(str(t.dtype).removeprefix("torch."))
        return all_reduce(t, *args, **kwargs)
    dist.all_reduce = recording


def run_cases(rank, world, device, states, batch, parts, cases, bn_input):
    """Each case of ``cases`` (name, Trainer keyword arguments with the
    ``dtype`` and the ``weights``, epochs to step, the rank whose template
    gets a NaN or None) on this rank's rows of ``batch``, from
    ``states[weights]`` (``"channel"`` by default): per step the metrics,
    the state after it, the BNs run in training mode so far and the
    collectives issued with their dtypes. A float32 or float64 case's model,
    data and parameters are in its dtype; a bfloat16 case's model computes
    in bf16 over float32 parameters and data (``SiamMaskBase(dtype=...)``).
    Then an ``AllReduceSum`` of rank-made values with its gradient, and a
    ``SyncBatchNorm2d`` in training mode on this rank's rows of
    ``bn_input``: its output, running statistics and gradients."""
    torch.set_num_threads(1)
    dtypes = []
    _recording_all_reduce(dtypes)
    rows = local_rows(batch["template"].shape[0], rank, world)
    local = {k: v[rows] for k, v in batch.items()}
    out = {}
    for name, kwargs, epochs, nan_rank in cases:
        kwargs = dict(kwargs)
        dtype = kwargs.pop("dtype", torch.float32)
        state = states[kwargs.pop("weights", "channel")]
        bf16 = dtype == torch.bfloat16
        model = SiamMaskBase(width=8, dtype=dtype if bf16 else None)
        model.load_state_dict(state)
        if not bf16:
            model.to(dtype)
        trainer = Trainer(model, *parts, epochs=2, distributed=True, **kwargs)
        recorder = BNRecorder(model)
        # a copy: the batch's storage is shared with the parent process
        data = {k: v.to(torch.float32 if bf16 else dtype, copy=True)
                if v.is_floating_point() else v for k, v in local.items()}
        if nan_rank == rank:
            data["template"][0, 0, 0, 0] = float("nan")
        steps = []
        for epoch in epochs:
            calls = _all_reduce.calls
            del dtypes[:]
            metrics = trainer.step(data, epoch)
            steps.append({"metrics": {k: float(v) for k, v in metrics.items()},
                          "state": _state(model), "collectives": _all_reduce.calls - calls,
                          "collective_dtypes": sorted(set(dtypes)),
                          "bn_updated": set(recorder.updated)})
        out[name] = {"steps": steps, "labels": dict(trainer.labels)}

    x = torch.arange(6, dtype=torch.float64).reshape(2, 3) * (rank + 1)
    x.requires_grad_()
    y = AllReduceSum.apply(x)
    (y * (rank + 2)).sum().backward()
    out["all_reduce_sum"] = {"x": x.detach().numpy(), "y": y.detach().numpy(),
                             "grad": x.grad.numpy()}
    out["sync_bn"] = sync_bn_rows(bn_input, local_rows(bn_input.shape[0], rank, world))
    return out


def sync_bn_rows(x, rows):
    """A fresh ``SyncBatchNorm2d`` in training mode (its affine terms set
    from a seed) on ``x[rows]``, made leaf: the output, the running mean and
    variance after the step, and the gradients of ``x[rows]``, the weight
    and the bias for the loss ``sum(out * w)`` (``w`` from a seed). Without
    a group of more than one rank it is the port's ``BatchNorm2d``."""
    c = x.shape[1]
    g = torch.Generator().manual_seed(1)
    bn = SyncBatchNorm2d(c).train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=g)
        bn.bias.normal_(0.0, 1.0, generator=g)
    w = torch.randn(x.shape, generator=g)[rows]
    x = x[rows].clone().requires_grad_()
    y = bn(x)
    (y.float() * w).sum().backward()
    return {"out": y.detach(), "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone(), "grad_x": x.grad,
            "grad_weight": bn.weight.grad, "grad_bias": bn.bias.grad}


def recording_shuffle(out_dir, rank: int):
    """A ``PairDataset.shuffle`` that also writes each generation's pick to
    ``out_dir/rank{rank}_{generation}.json``."""
    shuffle = PairDataset.shuffle

    def recording(self):
        shuffle(self)
        path = Path(out_dir) / f"rank{rank}_{self._generation:03d}.json"
        path.write_text(json.dumps({"generation": self._generation, "pick": self.pick}))
    return recording


def train_recording_picks(rank, world, device, args, out_dir):
    """The train CLI's rank, its dataset's picks written to ``out_dir``."""
    PairDataset.shuffle = recording_shuffle(out_dir, rank)
    return train_cli.train(rank, world, device, args)
