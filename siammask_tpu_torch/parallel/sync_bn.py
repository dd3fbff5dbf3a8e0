"""Cross-replica BatchNorm: batch statistics over every rank's rows.

Counterpart of flax's ``nn.BatchNorm(axis_name=...)`` in the JAX package
(``models/resnet.py``, ``heads.py``; ``bn_axis``). ``torch.nn.SyncBatchNorm``
takes CUDA tensors only, so this one, whose collective is ``AllReduceSum``,
runs on the CPU's gloo groups too, where the tests hold it against JAX.

In training mode with a group of more than one rank, one all-reduce of
``[sum x, sum x^2, n]`` per channel gives the global mean and the biased
variance ``E[x^2] - E[x]^2``, clamped at 0 (flax's fast variance); the
output is normalized with them, and the running variance takes the global
biased variance, as flax's does. As flax's ``_compute_stats``
(``force_float32_reductions``), the sums, the collective and its gradient
are in float32 at least whatever the maps' dtype: bf16 maps are summed,
normalized in float32 and returned in bf16 (bf16's 8 significant bits
would leave ``E[x^2] - E[x]^2`` nothing of the variance of a channel whose
mean is large against its spread). float32 and float64 maps compute in
their own dtype. In eval mode, or with no group or a group of one, it is
the port's ``BatchNorm2d``, which does the same through ``F.batch_norm`` or,
on a card's channels_last bf16 maps, its fused train-mode kernels.
Parameters, buffers and state-dict keys are ``nn.BatchNorm2d``'s.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from siammask_tpu_torch.models.resnet import BatchNorm2d
from siammask_tpu_torch.parallel.dist import AllReduceSum


class SyncBatchNorm2d(BatchNorm2d):

    def synced(self) -> bool:
        """Training mode in a group of more than one rank: the batch
        statistics are the group's (``BatchNorm2d``'s fused train-mode
        kernels do not take it)."""
        return self.training and dist.is_initialized() and dist.get_world_size() > 1

    def forward(self, x):
        if not self.synced():
            return super().forward(x)
        c = x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        stats = AllReduceSum.apply(torch.cat([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3)),
                                              xf.new_full((1,), float(x.numel() // c))]))
        n = stats[2 * c]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean * mean).clamp(min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean.detach())
            self.running_var.mul_(1 - m).add_(m * var.detach())
            self.num_batches_tracked.add_(1)
        scale = torch.rsqrt(var + self.eps) * self.weight
        out = (xf - mean[None, :, None, None]) * scale[None, :, None, None] \
            + self.bias[None, :, None, None]
        return out.to(x.dtype)


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
