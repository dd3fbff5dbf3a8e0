"""Weights from the JAX package into the port, and reference checkpoints in.

``state_dict_from_jax`` maps the JAX package's flax variables
``{'params', 'batch_stats'}`` (trees of numpy arrays) onto the port's module
tree, which carries the reference checkpoint names. It is the same mapping as
``invert_variables`` in ``siammask_tpu/utils/torch_convert.py``:

- conv kernels go from (kh, kw, I, O) to (O, I, kh, kw);
- the Refine deconv kernel is already torch's (in, out, kh, kw) and is copied;
- BatchNorm scale/bias/mean/var become weight/bias/running_mean/running_var,
  with ``num_batches_tracked = 0``.

``load_reference_state_dict`` loads such a mapping, or a reference ``.pth``
state_dict, into a model, skipping the ``anchors`` and
``num_batches_tracked`` entries as the JAX package's importer does.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_BN_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
            "var": "running_var"}
_BN = r"(scale|bias|mean|var)"


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _depthcorr_name(rest: str) -> tuple[str, bool]:
    """Flax path under a DepthCorr -> (torch sub-name, is a conv kernel)."""
    m = re.match(r"^(conv_kernel|conv_search)\.conv\.kernel$", rest)
    if m:
        return f"{m.group(1)}.0.weight", True
    m = re.match(rf"^(conv_kernel|conv_search)\.bn\.{_BN}$", rest)
    if m:
        return f"{m.group(1)}.1.{_BN_LEAF[m.group(2)]}", False
    if rest == "head_conv1.conv.kernel":
        return "head.0.weight", True
    m = re.match(rf"^head_conv1\.bn\.{_BN}$", rest)
    if m:
        return f"head.1.{_BN_LEAF[m.group(1)]}", False
    if rest == "head_conv2.kernel":
        return "head.3.weight", True
    if rest == "head_conv2.bias":
        return "head.3.bias", False
    raise KeyError(f"unmapped DepthCorr path: {rest}")


def _torch_name(path: str) -> tuple[str, bool]:
    """Flax dotted path (collection stripped) -> (state_dict name, is a conv
    kernel that needs the (kh,kw,I,O) -> (O,I,kh,kw) transpose)."""
    if path == "backbone.conv1.kernel":
        return "features.features.conv1.weight", True
    m = re.match(rf"^backbone\.bn1\.{_BN}$", path)
    if m:
        return f"features.features.bn1.{_BN_LEAF[m.group(1)]}", False
    m = re.match(r"^backbone\.layer(\d)\.block(\d+)\.(.+)$", path)
    if m:
        lnum, bnum, rest = m.groups()
        prefix = f"features.features.layer{lnum}.{bnum}"
        m2 = re.match(r"^conv(\d)\.kernel$", rest)
        if m2:
            return f"{prefix}.conv{m2.group(1)}.weight", True
        m2 = re.match(rf"^bn(\d)\.{_BN}$", rest)
        if m2:
            return f"{prefix}.bn{m2.group(1)}.{_BN_LEAF[m2.group(2)]}", False
        if rest == "downsample_conv.kernel":
            return f"{prefix}.downsample.0.weight", True
        m2 = re.match(rf"^downsample_bn\.{_BN}$", rest)
        if m2:
            return f"{prefix}.downsample.1.{_BN_LEAF[m2.group(1)]}", False
    if path == "neck.conv.kernel":
        return "features.downsample.downsample.0.weight", True
    m = re.match(rf"^neck\.bn\.{_BN}$", path)
    if m:
        return f"features.downsample.downsample.1.{_BN_LEAF[m.group(1)]}", False
    m = re.match(r"^rpn\.(cls|loc)\.(.+)$", path)
    if m:
        sub, t = _depthcorr_name(m.group(2))
        return f"rpn_model.{m.group(1)}.{sub}", t
    m = re.match(r"^mask_corr\.mask\.(.+)$", path)
    if m:
        sub, t = _depthcorr_name(m.group(1))
        return f"mask_model.mask.{sub}", t
    m = re.match(r"^refine\.(v0|v1|v2|h0|h1|h2)\.conv([01])\.(kernel|bias)$", path)
    if m:
        block, idx, leaf = m.groups()
        tidx = "0" if idx == "0" else "2"
        return f"refine_model.{block}.{tidx}.{'weight' if leaf == 'kernel' else 'bias'}", \
            leaf == "kernel"
    m = re.match(r"^refine\.deconv\.(kernel|bias)$", path)
    if m:
        return f"refine_model.deconv.{'weight' if m.group(1) == 'kernel' else 'bias'}", False
    m = re.match(r"^refine\.post([012])\.(kernel|bias)$", path)
    if m:
        idx, leaf = m.groups()
        return f"refine_model.post{idx}.{'weight' if leaf == 'kernel' else 'bias'}", \
            leaf == "kernel"
    raise KeyError(f"unmapped flax path: {path}")


def state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax variables -> the port's state_dict (CPU tensors)."""
    state: dict[str, np.ndarray] = {}
    for path, value in _flatten(variables["params"]).items():
        name, conv = _torch_name(path)
        state[name] = np.transpose(value, (3, 2, 0, 1)) if conv else value
    for path, value in _flatten(variables.get("batch_stats", {})).items():
        name, _ = _torch_name(path)
        state[name] = value
        if name.endswith("running_var"):
            state[name.replace("running_var", "num_batches_tracked")] = np.asarray(0, np.int64)
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


def _skipped(name: str) -> bool:
    return name == "anchors" or name.endswith("num_batches_tracked")


def load_reference_state_dict(model: torch.nn.Module, state: Mapping) -> None:
    """Load a reference-named state_dict (e.g. a released ``.pth``'s, with or
    without the ``module.`` prefix) strictly, apart from the ``anchors`` and
    ``num_batches_tracked`` entries, which are skipped."""
    state = {k.removeprefix("module."): v for k, v in state.items()}
    state = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
             for k, v in state.items() if not _skipped(k)}
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not _skipped(k)]
    if missing or unexpected:
        raise KeyError(f"state_dict mismatch: missing {missing}, unexpected {unexpected}")
