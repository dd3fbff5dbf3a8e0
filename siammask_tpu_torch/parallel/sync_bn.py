"""Cross-replica BatchNorm: batch statistics over every rank's rows.

Counterpart of flax's ``nn.BatchNorm(axis_name=...)`` in the JAX package
(``models/resnet.py``, ``heads.py``; ``bn_axis``). ``torch.nn.SyncBatchNorm``
takes CUDA tensors only, so this one, whose collective is ``AllReduceSum``,
runs on the CPU's gloo groups too, where the tests hold it against JAX.

In training mode with a group of more than one rank, one all-reduce of
``[sum x, sum x^2, n]`` per channel gives the global mean and the biased
variance ``E[x^2] - E[x]^2`` (flax's fast variance); the output is
normalized with them, and the running variance takes the global biased
variance, as flax's does. In eval mode, or with no group or a group of
one, it is the port's ``BatchNorm2d``. Parameters, buffers and state-dict
keys are ``nn.BatchNorm2d``'s.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from siammask_tpu_torch.models.resnet import BatchNorm2d
from siammask_tpu_torch.parallel.dist import AllReduceSum


class SyncBatchNorm2d(BatchNorm2d):

    def forward(self, x):
        if not (self.training and dist.is_initialized() and dist.get_world_size() > 1):
            return super().forward(x)
        c = x.shape[1]
        stats = AllReduceSum.apply(torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3)),
                                              x.new_full((1,), float(x.numel() // c))]))
        n = stats[2 * c]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean.detach())
            self.running_var.mul_(1 - m).add_(m * var.detach())
            self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[None, :, None, None]) * scale[None, :, None, None] \
            + self.bias[None, :, None, None]


def convert_sync_bn(module: nn.Module) -> nn.Module:
    """Every ``BatchNorm2d`` under ``module`` replaced in place by a
    ``SyncBatchNorm2d`` that holds the same parameter and buffer tensors (an
    optimizer built before keeps stepping them) and the same mode; returns
    ``module``, or its replacement if it is itself a BatchNorm."""
    if type(module) is BatchNorm2d:
        sync = SyncBatchNorm2d(module.num_features, module.eps, module.momentum)
        sync.weight, sync.bias = module.weight, module.bias
        for name, buf in module.named_buffers(recurse=False):
            setattr(sync, name, buf)
        return sync.train(module.training)
    for name, child in module.named_children():
        setattr(module, name, convert_sync_bn(child))
    return module
