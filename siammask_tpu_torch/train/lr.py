"""Epoch-indexed LR schedules as precomputed arrays.

Counterpart of ``siammask_tpu/train/lr.py`` (the reference's
``utils/lr_helper.py``): a schedule is a numpy array of per-epoch LRs; each
optimizer group takes ``lr_spaces[epoch] * group_mult``. A ``warmup`` entry
is concatenated in front, truncated when the run is shorter than the warm-up.
"""
from __future__ import annotations

import math

import numpy as np


def log_space(start_lr=0.03, end_lr=5e-4, epochs=50, **_):
    return np.logspace(math.log10(start_lr), math.log10(end_lr), epochs)


def step_space(start_lr=0.01, end_lr=None, step=10, mult=0.1, epochs=50, **_):
    if end_lr is not None:
        if start_lr is None:
            start_lr = end_lr / (mult ** (epochs // step))
        else:  # warm-up style
            mult = math.pow(end_lr / start_lr, 1.0 / (epochs // step))
    return start_lr * (mult ** (np.arange(epochs) // step))


def multi_step_space(start_lr=0.01, end_lr=None, steps=(10, 20, 30, 40), mult=0.5,
                     epochs=50, **_):
    steps = list(steps)
    if end_lr is not None:
        if start_lr is None:
            start_lr = end_lr / (mult ** len(steps))
        else:
            mult = math.pow(end_lr / start_lr, 1.0 / len(steps))
    lr = np.empty(epochs, dtype=np.float64)
    if epochs == 0:  # reachable through warm-up truncation
        return lr
    lr[0] = start_lr
    for i in range(1, epochs):
        lr[i] = lr[i - 1] * (mult if i in steps else 1.0)
    return lr


def linear_space(start_lr=0.01, end_lr=0.005, epochs=50, **_):
    return np.linspace(start_lr, end_lr, epochs)


def cos_space(start_lr=0.01, end_lr=0.005, epochs=50, **_):
    index = np.arange(epochs).astype(np.float64)
    return end_lr + (start_lr - end_lr) * (1.0 + np.cos(index * np.pi / epochs)) * 0.5


_SPACES = {
    "log": log_space,
    "step": step_space,
    "multi-step": multi_step_space,
    "linear": linear_space,
    "cos": cos_space,
}


def build_lr_spaces(cfg: dict, epochs: int = 50) -> np.ndarray:
    """Config -> per-epoch LR array, with the reference's warm-up concat."""
    cfg = dict(cfg)
    if "warmup" in cfg:
        warm_cfg = dict(cfg.pop("warmup"))
        # a run shorter than the warm-up truncates it instead of asking for a
        # negative-length space after it
        warm_epochs = min(warm_cfg.pop("epoch"), epochs)
        warm = _space_from(warm_cfg, warm_epochs)
        normal = _space_from(cfg, epochs - warm_epochs)
        return np.concatenate([warm, normal])
    return _space_from(cfg, epochs)


def _space_from(cfg: dict, epochs: int) -> np.ndarray:
    kind = cfg.get("type", "log")
    if kind not in _SPACES:
        raise ValueError(f"unknown LR schedule type {kind!r}")
    kwargs = {k: v for k, v in cfg.items() if k != "type"}
    return np.asarray(_SPACES[kind](epochs=epochs, **kwargs), dtype=np.float64)
