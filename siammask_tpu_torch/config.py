"""Experiment config (JSON) and derived tracker hyper-parameters.

Counterpart of ``siammask_tpu/config.py``, with json and the standard library
only. The reference experiment configs (``experiments/*/config*.json``) load
unchanged: ``network.arch``, ``hp``, ``lr``, ``loss.weight``, ``clip``,
``anchors``, ``train_datasets``/``val_datasets``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

from siammask_tpu_torch.tracker.anchors import AnchorConfig

LOSS_WEIGHT_DEFAULT = (1.0, 1.0, 36.0)  # cls, loc, mask

LR_DEFAULTS = {
    "feature_lr_mult": 1.0,
    "rpn_lr_mult": 1.0,
    "mask_lr_mult": 1.0,
    "type": "log",
    "start_lr": 0.03,
}


@dataclass
class TrackerConfig:
    """Inference hyper-parameters; defaults match the reference tracker
    config. ``update`` merges a JSON ``hp`` dict and the anchor config."""
    penalty_k: float = 0.09
    window_influence: float = 0.39
    lr: float = 0.38
    seg_thr: float = 0.3
    windowing: str = "cosine"
    exemplar_size: int = 127
    instance_size: int = 255
    total_stride: int = 8
    out_size: int = 63
    base_size: int = 8
    context_amount: float = 0.5
    ratios: tuple = (0.33, 0.5, 1, 2, 3)
    scales: tuple = (8,)
    round_digit: int = 0

    @property
    def score_size(self) -> int:
        return (self.instance_size - self.exemplar_size) // self.total_stride + 1 + self.base_size

    @property
    def anchor_num(self) -> int:
        return len(self.ratios) * len(self.scales)

    def update(self, hp: dict | None = None, anchors: AnchorConfig | dict | None = None):
        for k, v in (hp or {}).items():
            setattr(self, "round_digit" if k == "round_dight" else k, v)
        if anchors is not None:
            if isinstance(anchors, dict):
                anchors = AnchorConfig.from_dict(anchors)
            self.total_stride = anchors.stride
            self.ratios = tuple(anchors.ratios)
            self.scales = tuple(anchors.scales)
            self.round_digit = anchors.round_digit
        return self

    def anchor_config(self) -> AnchorConfig:
        return AnchorConfig(stride=self.total_stride, ratios=tuple(self.ratios),
                            scales=tuple(self.scales), round_digit=self.round_digit)


@dataclass
class Config:
    """Parsed experiment config."""
    arch: str = "Custom"
    hp: dict = field(default_factory=dict)
    lr: dict = field(default_factory=lambda: dict(LR_DEFAULTS))
    loss_weight: tuple = LOSS_WEIGHT_DEFAULT
    loss: dict = field(default_factory=dict)
    clip: dict = field(default_factory=dict)
    anchors: AnchorConfig = field(default_factory=AnchorConfig)
    train_datasets: dict = field(default_factory=dict)
    val_datasets: dict = field(default_factory=dict)
    raw: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, cfg: dict, clip: float | None = None) -> "Config":
        lr_cfg = dict(LR_DEFAULTS)
        lr_cfg.update(cfg.get("lr", {}))

        loss_cfg = dict(cfg.get("loss", {}))
        loss_cfg.setdefault("reg", {"loss": "L1Loss"})
        loss_cfg["reg"].setdefault("loss", "L1Loss")
        loss_cfg.setdefault("cls", {"split": True})
        weight = tuple(loss_cfg.get("weight", LOSS_WEIGHT_DEFAULT))

        clip_cfg = dict(cfg.get("clip", {}))
        if clip_cfg or clip is not None:
            clip_cfg.setdefault("feature", clip)
            clip_cfg.setdefault("rpn", clip)
            # the reference reads clip.mask only in split mode, with no
            # default: fall back to the feature clip
            clip_cfg.setdefault("mask", clip_cfg["feature"])
            clip_cfg.setdefault("split", clip_cfg["feature"] != clip_cfg["rpn"])

        return cls(
            arch=cfg.get("network", {}).get("arch", "Custom"),
            hp=dict(cfg.get("hp", {})),
            lr=lr_cfg,
            loss_weight=weight,
            loss=loss_cfg,
            clip=clip_cfg,
            anchors=AnchorConfig.from_dict(cfg.get("anchors")),
            train_datasets=dict(cfg.get("train_datasets", {})),
            val_datasets=dict(cfg.get("val_datasets", {})),
            raw=cfg,
        )

    @classmethod
    def load(cls, path: str, clip: float | None = None) -> "Config":
        with open(path) as f:
            return cls.from_dict(json.load(f), clip=clip)

    def tracker_config(self) -> TrackerConfig:
        return TrackerConfig().update(self.hp, self.anchors)
