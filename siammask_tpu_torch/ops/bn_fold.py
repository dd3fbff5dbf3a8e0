"""Eval-mode BatchNorm folded into the conv before it, run as one cuDNN call.

A BatchNorm that normalises with its running statistics is an affine map of
each channel, so a bias-free conv followed by it is one conv with

    W' = W * s,    b' = beta - mean * s,    s = gamma / sqrt(var + eps),

worked out in float32 (float64 stays float64) and cast once to the compute
dtype. cuDNN runs that conv, its bias, a residual add and the ReLU after it
as one call with the epilogue inside the conv kernel, computed in float32
and rounded once: ``cudnn_convolution_relu`` and
``cudnn_convolution_add_relu``. The separate BN, add and ReLU passes over
the maps, and the conv's per-call weight cast, are gone. Which pairs fold
is ``models/resnet.py``'s ``folds``.

- ``fold``: (W', b') of one conv -> BN pair.
- ``conv_bias_relu``: conv + bias (+ z) (then ReLU): with the ReLU on a CUDA
  tensor the fused cuDNN call, else ``conv_bias_relu_reference``.
- ``conv_bias_relu_reference``: the plain version, ``F.conv2d`` + bias +
  add + ReLU, which the CPU tests call directly.
- ``FoldCache``: the folded tensors of a module, kept beside it (not
  parameters, not buffers, not in its ``state_dict``) and made again into
  the same storage when a source tensor changes in place, so a captured
  CUDA graph replays the new values. ``refresh(model)`` brings every cache
  of a model up to date: a graph replay runs no Python, so the tracker
  calls it where it fetches a graph (``tracker.Tracker.step_graph``).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

# where a folded pair runs: cuDNN's fused call. On the CPU the pairs run
# unfolded, as the tests against the JAX package hold them.
DEVICES = ("cuda",)


def fold(weight, gamma, beta, mean, var, eps: float):
    """(W', b') of a bias-free conv (``weight`` (O, I, kh, kw)) followed by
    an eval-mode BatchNorm, in float32 or the inputs' wider dtype."""
    dtype = torch.promote_types(weight.dtype, torch.float32)
    s = gamma.to(dtype) * torch.rsqrt(var.to(dtype) + eps)
    return weight.to(dtype) * s[:, None, None, None], beta.to(dtype) - mean.to(dtype) * s


def conv_bias_relu_reference(x, weight, bias, stride, padding, dilation, z=None,
                             relu: bool = True):
    """``conv2d(x, weight) + bias``, then ``+ z`` where given, then ReLU
    where ``relu``: the plain version of ``conv_bias_relu``."""
    out = F.conv2d(x, weight, bias, stride, padding, dilation)
    if z is not None:
        out = out + z
    return F.relu(out) if relu else out


def conv_bias_relu(x, weight, bias, stride, padding, dilation, z=None, relu: bool = True):
    """``conv_bias_relu_reference``'s function. On a CUDA tensor with ReLU it
    is one cuDNN call, the bias, ``z`` and the ReLU in the conv's float32
    epilogue; without ReLU there is no fused call, and the plain version
    runs (``F.conv2d`` with the bias). The fused call takes one dtype
    throughout: cuDNN reads a bias of another dtype than the maps' as
    garbage, unchecked, so such a call raises."""
    if not (x.is_cuda and relu):
        return conv_bias_relu_reference(x, weight, bias, stride, padding, dilation, z, relu)
    dtypes = {t.dtype for t in (x, weight, bias, z) if t is not None}
    if len(dtypes) > 1:
        raise ValueError(f"conv_bias_relu: the fused call takes one dtype, not {dtypes}")
    if z is None:
        return torch.cudnn_convolution_relu(x, weight, bias, stride, padding, dilation, 1)
    return torch.cudnn_convolution_add_relu(x, weight, z, 1.0, bias, stride, padding, dilation,
                                            1)


def _stamp(sources) -> tuple:
    """What identifies the state of each source: the tensor itself, its
    storage, its in-place version and its dtype. An optimizer step,
    ``load_state_dict``, a BN calibration and ``BatchNorm2d``'s own training
    update (its ``running_var``, written with every ``running_mean`` update:
    the native kernel's write to ``running_mean`` leaves its version as it
    was) all move the version; ``model.to`` moves the storage."""
    return tuple((t, t.data_ptr(), t._version, t.dtype) for t in sources)


def _same(stamp: tuple, sources) -> bool:
    return len(stamp) == len(sources) and all(
        s[0] is t and s[1:] == (t.data_ptr(), t._version, t.dtype)
        for s, t in zip(stamp, sources))


class FoldCache:
    """Tensors made from a module's parameters and buffers, one set a key,
    kept until a source changes and then made again into the same tensors
    (sources made under inference mode track no version: their tensors are
    made anew at each call). Built under ``no_grad`` outside inference mode:
    the tracker (in
    inference mode) and the trainer share them, and an inference tensor
    could not be written in place outside that mode. A cache is not state:
    a copy or a pickle of the module gets an empty one."""

    def __init__(self):
        # key -> [stamp, values, sources, make]
        self._entries: dict = {}

    def __reduce__(self):
        return FoldCache, ()

    def get(self, key, sources: Callable[[], tuple], make: Callable[..., tuple]) -> tuple:
        """``make(*sources())``, kept under ``key``: made again, into the
        kept tensors, when a source has changed since. ``sources`` and
        ``make`` stay with the entry for ``refresh``: they must not hold a
        map of the forward."""
        src = sources()
        if any(t.is_inference() for t in src):
            # made under inference mode: no version to watch, so made anew
            return tuple(make(*src))
        entry = self._entries.get(key)
        if entry is None:
            _no_capture(src)
            with torch.inference_mode(False), torch.no_grad():
                values = tuple(make(*src))
            self._entries[key] = [_stamp(src), values, sources, make]
            return values
        if not _same(entry[0], src):
            _remake(entry, src)
        return entry[1]

    def refresh(self) -> None:
        """Make again every entry whose sources changed since it was made."""
        for entry in self._entries.values():
            src = entry[2]()
            if not any(t.is_inference() for t in src) and not _same(entry[0], src):
                _remake(entry, src)


def _no_capture(sources) -> None:
    """A graph capture records kernels without running them: folded tensors
    made or remade under one would hold their old or no values until a
    replay. The caller makes them before it captures."""
    if sources[0].is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("folded BatchNorm weights are made outside a CUDA-graph capture: "
                           "run the step once before capturing it")


def _remake(entry: list, src) -> None:
    _no_capture(src)
    with torch.inference_mode(False), torch.no_grad():
        for kept, new in zip(entry[1], entry[3](*src)):
            kept.copy_(new)
    entry[0] = _stamp(src)


def refresh(model: torch.nn.Module) -> None:
    """``FoldCache.refresh`` of every cache in ``model``."""
    for m in model.modules():
        cache = getattr(m, "bn_folds", None)
        if cache is not None:
            cache.refresh()
