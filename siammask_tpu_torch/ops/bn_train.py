"""Train-mode BatchNorm2d, with the residual add and the ReLU after it, as
hand-written kernels.

In a training step a ResNet block's conv -> BN (-> + residual) (-> ReLU)
cannot fold (``ops/bn_fold.py``): the BN normalises with the batch's own
statistics and every piece takes a gradient. ``bn_train`` runs the chain as
one ``torch.autograd.Function`` over four kernels (``csrc/bn_train.cu``, whose
note gives the design):

- forward: the batch statistics (one launch: per-block Welford partials,
  merged by the last block, which also updates the running statistics),
  then one pass of normalise, add and ReLU;
- backward: a reduction (sum g and sum g * xhat, g = dy masked by the
  ReLU) and one elementwise pass for dx, which also gives the residual's
  gradient; dgamma and dbeta are the reduction's sums.

The kernels take channels_last bf16 maps, seen as rows N*H*W of C
contiguous channels (``supports``), with float32 statistics, affine terms
and running buffers. The running variance takes the biased batch variance,
as the port's ``models.resnet.BatchNorm2d`` does (flax's rule). Which calls
take this path is ``models/resnet.py``'s ``trains_fused``.

- ``bn_train``: the entry. A CUDA tensor launches the kernels (or raises
  where ``supports`` is false); a CPU tensor runs ``bn_train_reference``.
- ``bn_train_reference``: the plain version, functional PyTorch, which the
  card tests hold the kernels to.
- ``batch_stats``, ``normalize``, ``backward_reduce``, ``backward_elemt``
  (``WRAPPERS``): a wrapper a kernel, each counting its launches in
  ``<wrapper>.launches`` (a CUDA-graph capture counts once, at capture, as
  ``ops/xcorr.py``'s).

The two reductions find their last block through an arrival counter a
channel tile, kept on each device (``_counters``), zero between launches:
kernels of this module must not run on two streams of one device at once.
The counters are made at the first call on a device, which must not be
inside a CUDA-graph capture (a trainer's graph warms up first).
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from siammask_tpu_torch.ops import _build

# where the kernels run: a card. Elsewhere the modules run (models/resnet.py).
DEVICES = ("cuda",)

# csrc/bn_train.cu: channels a thread's 16-byte load, channels a block, rows
# a block's threads cover at once
_VEC = 8
_TILE = 64
_GROUPS = 32
_MAX_TILES = 256            # C up to 16384
# the grids, from a sweep on an H100 at the step's shapes (PERF.md, PR 28):
# the reductions were fastest at about two blocks an SM and 500 rows or more
# a block (fewer blocks leave bandwidth unused, more make the last block's
# merge and the arrivals the longer part); the elementwise kernels at 256
# rows a block and no fewer blocks than SMs
_REDUCE_BLOCKS_PER_SM = 2
_MAX_SPLITS = 128           # runs of rows a reduction merges in its last block
_MIN_SPLIT_ROWS = 512       # 16 rows a thread
_BLOCK_ROWS = 256           # rows an elementwise block covers, at most

# the ReLU's decision in the backward (csrc/bn_train.cu kMask*)
_MASK_NONE, _MASK_RECOMPUTE, _MASK_FROM_Y = 0, 1, 2

_counters_of: dict = {}     # device -> int32 arrival counters, zero between launches


def bn_train_reference(x, weight, bias, running_mean, running_var, momentum: float, eps: float,
                       z=None, relu: bool = True):
    """The plain version: batch mean and biased variance over (N, H, W) in
    float32 (or x's wider dtype), the running statistics updated in place
    with that variance and ``momentum``, then ``(x - mean) * gamma * invstd
    + beta``, ``+ z`` where given, ReLU where ``relu``, rounded once to x's
    dtype."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
    with torch.no_grad():
        running_mean.mul_(1 - momentum).add_(momentum * mean.detach().to(running_mean.dtype))
        running_var.mul_(1 - momentum).add_(momentum * var.detach().to(running_var.dtype))
    scale = weight * torch.rsqrt(var + eps)
    out = (xf - mean[:, None, None]) * scale[:, None, None] + bias[:, None, None]
    if z is not None:
        out = out + z
    if relu:
        out = F.relu(out)
    return out.to(x.dtype)


def _map_ok(t: torch.Tensor) -> bool:
    return (t.dtype == torch.bfloat16 and t.dim() == 4
            and t.is_contiguous(memory_format=torch.channels_last) and t.data_ptr() % 16 == 0)


def supports(x: torch.Tensor, z: torch.Tensor | None, *stats: torch.Tensor) -> bool:
    """Whether the kernels take the map ``x`` (N, C, H, W), the residual
    ``z`` (or None) and the per-channel vectors ``stats`` (gamma, beta,
    running mean and variance): bf16 maps, channels_last and dense, 16-byte
    aligned, C a multiple of 8, more than one row, z of x's shape; float32
    contiguous vectors of C."""
    if not _map_ok(x):
        return False
    n, c, h, w = x.shape
    if c % _VEC or c > _TILE * _MAX_TILES or n * h * w < 2:
        return False
    if z is not None and (z.shape != x.shape or not _map_ok(z)):
        return False
    return all(s.dtype == torch.float32 and s.is_contiguous() and s.shape == (c,)
               and s.device == x.device for s in stats)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _grid(x: torch.Tensor) -> tuple[int, int, int]:
    """(rows, splits, chunks) of x, from its shape and the card's SMs: the
    reductions split the rows into at most ``splits`` runs, about
    ``_REDUCE_BLOCKS_PER_SM`` blocks an SM over the channel tiles, each of at
    least ``_MIN_SPLIT_ROWS`` rows; the elementwise kernels into ``chunks``
    runs of at most ``_BLOCK_ROWS`` rows, more (down to ``_GROUPS``) where
    that leaves SMs without a block."""
    n, c, h, w = x.shape
    rows, tiles = n * h * w, -(-c // _TILE)
    sms = _sm_count(x.device.index)
    splits = max(1, min(_MAX_SPLITS, _REDUCE_BLOCKS_PER_SM * sms // tiles,
                        rows // _MIN_SPLIT_ROWS))
    chunks = min(-(-rows // _GROUPS), max(-(-rows // _BLOCK_ROWS), -(-sms // tiles)))
    return rows, splits, chunks


def _counters(device: torch.device) -> torch.Tensor:
    t = _counters_of.get(device)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("bn_train's counters are made outside a CUDA-graph capture: "
                               "run the step once before capturing it")
        t = _counters_of[device] = torch.zeros(_MAX_TILES, dtype=torch.int32, device=device)
    return t


def _call(entry: str, device: torch.device, *args) -> None:
    """Launch the C entry ``entry`` on ``device``'s current stream; the
    pointers are tensors (or None), the other arguments ints and floats as
    ``_build.bind`` declares them. Raises on a non-zero CUDA code."""
    lib = _build.load_library()
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    code = getattr(lib, entry)(*args, device.index, ctypes.c_void_p(stream))
    _build.check(lib, code, f"{entry} launch")


def batch_stats(x, running_mean, running_var, momentum: float, eps: float):
    """(mean, invstd) of x's channels over its rows, float32; updates the
    running mean and the running variance (biased) in place, and moves
    their versions as an in-place op would."""
    rows, splits, _ = _grid(x)
    c = x.shape[1]
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    invstd = torch.empty_like(mean)
    part = torch.empty(2 * c * splits, dtype=torch.float32, device=x.device)
    _call("siammask_bn_train_stats", x.device, x, rows, c, splits, part, _counters(x.device),
          mean, invstd, running_mean, running_var, float(momentum), float(eps))
    batch_stats.launches += 1
    for t in (running_mean, running_var):
        torch.autograd.graph.increment_version(t)
    return mean, invstd


def normalize(x, mean, invstd, weight, bias, z=None, relu: bool = True):
    """bf16(relu((x - mean) * weight * invstd + bias (+ z))), x's layout."""
    rows, _, chunks = _grid(x)
    y = torch.empty_like(x)
    _call("siammask_bn_train_apply", x.device, x, z, y, rows, x.shape[1], chunks, mean, invstd,
          weight, bias, int(relu))
    normalize.launches += 1
    return y


def backward_reduce(dy, x, y, mean, invstd, weight, bias, mask: int):
    """(sums, g): sums (2, C) float32, the channels' sum of g (d bias) and
    of g * xhat (d weight), g = dy masked by the ReLU as ``mask`` says
    (``_MASK_*``); g is a new map only with ``_MASK_FROM_Y``, else dy."""
    rows, splits, _ = _grid(x)
    c = x.shape[1]
    sums = torch.empty(2, c, dtype=torch.float32, device=x.device)
    part = torch.empty(2 * c * splits, dtype=torch.float32, device=x.device)
    g_out = torch.empty_like(dy) if mask == _MASK_FROM_Y else None
    _call("siammask_bn_train_backward_reduce", x.device, dy, x, y, g_out, rows, c, splits, mean,
          invstd, weight, bias, mask, part, _counters(x.device), sums)
    backward_reduce.launches += 1
    return sums, dy if g_out is None else g_out


def backward_elemt(g, x, mean, invstd, weight, bias, sums, recompute: bool):
    """dx = weight * invstd * (g - sum g / R - xhat * sum g xhat / R), g
    masked first by the ReLU's decision worked out from x where
    ``recompute``."""
    rows, _, chunks = _grid(x)
    dx = torch.empty_like(x)
    _call("siammask_bn_train_backward_elemt", x.device, g, x, dx, rows, x.shape[1], chunks, mean,
          invstd, weight, bias, sums, int(recompute))
    backward_elemt.launches += 1
    return dx


class BatchNormTrain(torch.autograd.Function):
    """``bn_train`` on CUDA tensors: the forward and backward kernels. The
    backward reads the ReLU's decision from the saved output where there is
    a residual (which it then needs the masked gradient of anyway), else
    works it out again from x."""

    @staticmethod
    def forward(ctx, x, weight, bias, z, running_mean, running_var, momentum, eps, relu):
        mean, invstd = batch_stats(x, running_mean, running_var, momentum, eps)
        y = normalize(x, mean, invstd, weight, bias, z, relu)
        ctx.mask = (_MASK_FROM_Y if z is not None else _MASK_RECOMPUTE) if relu else _MASK_NONE
        ctx.save_for_backward(x, weight, bias, mean, invstd,
                              y if ctx.mask == _MASK_FROM_Y else None)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, bias, mean, invstd, y = ctx.saved_tensors
        dy = dy.contiguous(memory_format=torch.channels_last)
        sums, g = backward_reduce(dy, x, y, mean, invstd, weight, bias, ctx.mask)
        dx = None
        if ctx.needs_input_grad[0]:
            dx = backward_elemt(g, x, mean, invstd, weight, bias, sums,
                                ctx.mask == _MASK_RECOMPUTE)
        dz = g if ctx.needs_input_grad[3] else None
        return dx, sums[1], sums[0], dz, None, None, None, None, None


def bn_train(x, weight, bias, running_mean, running_var, momentum: float, eps: float, z=None,
             relu: bool = True):
    """Train-mode BatchNorm of x (N, C, H, W) with the batch's statistics,
    then ``+ z``, then ReLU where ``relu``; the running statistics updated
    in place (biased variance, ``momentum``). Differentiable in x, weight,
    bias and z. A CPU tensor runs the plain version; a CUDA tensor the
    kernels, or raises where they do not take it (``supports``)."""
    if x.device.type == "cpu":
        return bn_train_reference(x, weight, bias, running_mean, running_var, momentum, eps, z,
                                  relu)
    if not supports(x, z, weight, bias, running_mean, running_var):
        raise ValueError(
            f"bn_train: the kernels take channels_last bf16 maps with C a multiple of {_VEC} and "
            f"float32 vectors of C, not x {x.dtype} {tuple(x.shape)} stride {x.stride()}"
            + ("" if z is None else f", z {z.dtype} {tuple(z.shape)} stride {z.stride()}"))
    return BatchNormTrain.apply(x, weight, bias, z, running_mean, running_var, momentum, eps,
                                relu)


WRAPPERS = (batch_stats, normalize, backward_reduce, backward_elemt)
for _fn in WRAPPERS:
    _fn.launches = 0
