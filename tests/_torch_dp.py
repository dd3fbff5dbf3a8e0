"""What the ranks of ``tests/test_torch_parallel.py`` and
``tests/test_torch_train_cli_dp.py`` run, in processes that
``siammask_tpu_torch.parallel.dist.spawn`` starts: this module imports the
port only (no jax), so a spawned child imports nothing else."""
import json
from pathlib import Path

import torch

from siammask_tpu_torch.data.dataset import PairDataset
from siammask_tpu_torch.models.siammask import SiamMaskBase
from siammask_tpu_torch.parallel.dist import AllReduceSum, _all_reduce, local_rows
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


def run_cases(rank, world, device, state, batch, parts, cases):
    """Each case of ``cases`` (name, Trainer keyword arguments and the
    ``dtype``, epochs to step, the rank whose template gets a NaN or None)
    from the weights
    ``state`` on this rank's rows of ``batch``: per step the metrics, the
    state after it, the BNs run in training mode so far and the collectives
    issued; and
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
        recorder = BNRecorder(model)
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
                          "bn_updated": set(recorder.updated)})
        out[name] = {"steps": steps, "labels": dict(trainer.labels)}

    x = torch.arange(6, dtype=torch.float64).reshape(2, 3) * (rank + 1)
    x.requires_grad_()
    y = AllReduceSum.apply(x)
    (y * (rank + 2)).sum().backward()
    out["all_reduce_sum"] = {"x": x.detach().numpy(), "y": y.detach().numpy(),
                             "grad": x.grad.numpy()}
    return out


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
