"""Checkpoints: save, load, and the non-strict warm start.

Counterpart of ``siammask_tpu/train/checkpoint.py``, in the reference's
``.pth`` layout (``tools/train_siammask.py``'s ``save_checkpoint``):
``{epoch, arch, state_dict, optimizer, anchor_cfg}``, the state_dict with
the reference module names and the optimizer's ``state_dict()``. Every
tensor is saved on the CPU, and the file holds only tensors, dicts, lists,
numbers, strings and None, so ``torch.load(..., weights_only=True)`` reads
it.

The state_dict holds no bf16 tensor: a loader that calls ``.numpy()`` on
every entry (the JAX package's ``load_torch_checkpoint``) could not read
one, since numpy has no bf16. A bf16 entry (the deconv of a bf16 SiamMask-
sharp built from scratch) is saved as float32, which is exact, and its name
goes into a top-level ``dtypes`` entry; ``load_checkpoint`` and
``read_state_dict`` cast it back, so a bf16 model resumes in bf16.

- ``save_checkpoint`` writes a temp file beside the target, fsyncs it and
  renames it into place: a crash mid-write never leaves half a checkpoint
  at the published path.
- ``load_checkpoint`` reads one back (the CPU copy).
- ``read_state_dict`` takes a full checkpoint or a bare state_dict, such as
  a released reference ``.pth``, and drops a ``module.`` prefix.
- ``merge_state_dict`` overlays a state_dict onto a model where names and
  shapes match (the reference's non-strict ``load_pretrain``): how stage-2
  refine training starts from a stage-1 SiamMask-base checkpoint.
"""
from __future__ import annotations

import os
from typing import Mapping

import torch
from torch import nn


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_cpu(v) for v in obj]
    return obj


def _widen_bf16(state: dict) -> tuple[dict, dict]:
    """The state_dict with each bf16 tensor as float32, and those names."""
    dtypes = {k: "bfloat16" for k, v in state.items()
              if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16}
    return {k: v.float() if k in dtypes else v for k, v in state.items()}, dtypes


def _narrow(state: dict, dtypes: Mapping[str, str] | None) -> dict:
    """The saved state_dict with the names in ``dtypes`` cast back."""
    dtypes = dtypes or {}
    return {k: v.to(getattr(torch, dtypes[k])) if k in dtypes else v for k, v in state.items()}


def save_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                    optimizer: dict | None = None, epoch: int = 0, arch: str = "Custom",
                    anchor_cfg: dict | None = None) -> None:
    """Write ``{epoch, arch, state_dict, optimizer, anchor_cfg}`` to ``path``
    atomically; ``optimizer`` is an optimizer's ``state_dict()`` or None.
    bf16 entries of the state_dict are written as float32 and named in
    ``dtypes`` (the module docstring)."""
    state, dtypes = _widen_bf16(_to_cpu(dict(state_dict)))
    data = {"epoch": int(epoch), "arch": arch, "state_dict": state,
            "optimizer": _to_cpu(optimizer), "anchor_cfg": dict(anchor_cfg or {})}
    if dtypes:
        data["dtypes"] = dtypes
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            torch.save(data, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str) -> dict:
    """``{epoch, arch, state_dict, optimizer, anchor_cfg}``, on the CPU, the
    state_dict in the dtypes it was saved from."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    return {"epoch": int(ck["epoch"]), "arch": ck.get("arch", "Custom"),
            "state_dict": _narrow(ck["state_dict"], ck.get("dtypes")),
            "optimizer": ck.get("optimizer"),
            "anchor_cfg": ck.get("anchor_cfg") or {}}


def read_state_dict(path: str) -> dict[str, torch.Tensor]:
    """The state_dict of a full checkpoint or of a bare state_dict file,
    without the ``module.`` prefix of a DataParallel save, in the dtypes it
    was saved from."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    state = _narrow(ck["state_dict"], ck.get("dtypes")) if "state_dict" in ck else ck
    return {k.removeprefix("module."): v for k, v in state.items()}


def merge_state_dict(model: nn.Module, state: Mapping[str, torch.Tensor]):
    """Load ``state`` into ``model`` where names and shapes match; the rest
    of the model keeps its values. Returns (missing, unused): the model's
    entries kept as they were (absent, or of another shape, noted), and the
    entries of ``state`` the model has no place for."""
    state = {k.removeprefix("module."): v for k, v in state.items()}
    own = model.state_dict()
    merged, missing = {}, []
    for name, value in own.items():
        if name not in state:
            missing.append(name)
        elif tuple(state[name].shape) != tuple(value.shape):
            missing.append(f"{name} (shape {tuple(value.shape)} != checkpoint "
                           f"{tuple(state[name].shape)})")
        else:
            merged[name] = state[name]
    model.load_state_dict(merged, strict=False)
    return missing, [k for k in state if k not in own]
