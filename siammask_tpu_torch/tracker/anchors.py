"""Anchor generation for the RPN score map (host-side numpy, run once).

Counterpart of ``siammask_tpu/tracker/anchors.py``, reproducing the reference
semantics exactly, including the integer truncation ``int(sqrt(size / r))`` of
the anchor widths when ``round_digit == 0``.

- Score-map anchors (the tracker's decode) are (K*S*S, 4) rows of
  (cx, cy, w, h), anchor-major: row = k*S*S + y*S + x.
- ``generate_all_anchors`` / ``Anchors`` tile the anchors over the search
  image for ``AnchorTarget`` (training targets), as (4, K, S, S) corner
  and center arrays.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from siammask_tpu_torch.utils.bbox import center2corner, corner2center


@dataclass
class AnchorConfig:
    stride: int = 8
    ratios: tuple = (0.33, 0.5, 1, 2, 3)
    scales: tuple = (8,)
    round_digit: int = 0
    anchor_density: int = 1

    @property
    def anchor_num(self) -> int:
        return len(self.ratios) * len(self.scales) * self.anchor_density ** 2

    @classmethod
    def from_dict(cls, d: dict | None) -> "AnchorConfig":
        d = dict(d or {})
        d.pop("anchor_num", None)
        if "round_dight" in d:  # the reference JSON's spelling
            d["round_digit"] = d.pop("round_dight")
        cfg = cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})
        cfg.ratios = tuple(cfg.ratios)
        cfg.scales = tuple(cfg.scales)
        return cfg

    def to_dict(self) -> dict:
        """The reference JSON's ``anchors`` entry (``round_dight`` spelling),
        as a checkpoint's ``anchor_cfg`` carries it."""
        return {"stride": self.stride, "ratios": list(self.ratios),
                "scales": list(self.scales), "round_dight": self.round_digit,
                "anchor_density": self.anchor_density}


def generate_anchors(cfg: AnchorConfig) -> np.ndarray:
    """Per-position anchor set, corner format, (anchor_num, 4) float32."""
    anchors = np.zeros((cfg.anchor_num, 4), dtype=np.float32)
    size = cfg.stride * cfg.stride
    offsets = np.arange(cfg.anchor_density) * (cfg.stride / cfg.anchor_density)
    offsets = offsets - np.mean(offsets)
    x_offsets, y_offsets = np.meshgrid(offsets, offsets)

    count = 0
    for x_off, y_off in zip(x_offsets.flatten(), y_offsets.flatten()):
        for r in cfg.ratios:
            if cfg.round_digit > 0:
                ws = round(math.sqrt(size * 1.0 / r), cfg.round_digit)
                hs = round(ws * r, cfg.round_digit)
            else:
                ws = int(math.sqrt(size * 1.0 / r))
                hs = int(ws * r)
            for s in cfg.scales:
                w, h = ws * s, hs * s
                anchors[count] = [-w * 0.5 + x_off, -h * 0.5 + y_off,
                                  w * 0.5 + x_off, h * 0.5 + y_off]
                count += 1
    return anchors


def generate_all_anchors(cfg: AnchorConfig, im_c: int, size: int):
    """Anchors tiled over an image-coordinate grid centred at ``im_c``.

    Returns (corner, center): each a float32 array of shape (4, K, size, size),
    the layout ``AnchorTarget`` consumes."""
    anchors = generate_anchors(cfg)
    a0x = im_c - size // 2 * cfg.stride
    zero_anchors = anchors + np.array([a0x] * 4, dtype=np.float32)

    x1, y1, x2, y2 = (zero_anchors[:, i].reshape(cfg.anchor_num, 1, 1) for i in range(4))
    cx, cy, w, h = corner2center((x1, y1, x2, y2))
    cx = cx + np.arange(0, size).reshape(1, 1, -1) * cfg.stride
    cy = cy + np.arange(0, size).reshape(1, -1, 1) * cfg.stride

    zero = np.zeros((cfg.anchor_num, size, size), dtype=np.float32)
    cx, cy, w, h = (v + zero for v in (cx, cy, w, h))
    x1, y1, x2, y2 = center2corner((cx, cy, w, h))
    return (np.stack([x1, y1, x2, y2]).astype(np.float32),
            np.stack([cx, cy, w, h]).astype(np.float32))


def generate_score_map_anchors(cfg: AnchorConfig, score_size: int) -> np.ndarray:
    """Decode-time anchor table (anchor_num * score_size**2, 4) in
    (cx, cy, w, h), centers on a stride grid centered at 0."""
    anchor = generate_anchors(cfg)
    x1, y1, x2, y2 = anchor[:, 0], anchor[:, 1], anchor[:, 2], anchor[:, 3]
    anchor = np.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], 1)

    anchor_num = anchor.shape[0]
    anchor = np.tile(anchor, score_size * score_size).reshape((-1, 4))
    ori = -(score_size // 2) * cfg.stride
    xx, yy = np.meshgrid([ori + cfg.stride * dx for dx in range(score_size)],
                         [ori + cfg.stride * dy for dy in range(score_size)])
    xx = np.tile(xx.flatten(), (anchor_num, 1)).flatten()
    yy = np.tile(yy.flatten(), (anchor_num, 1)).flatten()
    anchor[:, 0] = xx.astype(np.float32)
    anchor[:, 1] = yy.astype(np.float32)
    return anchor.astype(np.float32)


@dataclass
class Anchors:
    """The reference ``Anchors`` object: the per-position set and, after
    ``generate_all_anchors(im_c, size)``, the tiled ``all_anchors``."""
    cfg: AnchorConfig = field(default_factory=AnchorConfig)

    def __post_init__(self):
        self.anchors = generate_anchors(self.cfg)
        self.all_anchors = None
        self._cached_key = None

    def generate_all_anchors(self, im_c: int, size: int) -> None:
        """Tile for (im_c, size), unless that tiling is already there."""
        key = (im_c, size)
        if self._cached_key != key:
            self._cached_key = key
            self.all_anchors = generate_all_anchors(self.cfg, im_c, size)
