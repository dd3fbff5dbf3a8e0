"""The port's host-side training inputs against the JAX package's: tiled
anchors, anchor targets, box helpers and LR schedules. All numpy on both
sides with the same formulas, so every comparison is exact."""
import json
from pathlib import Path

import numpy as np
import pytest

from siammask_tpu.data.anchor_target import AnchorTarget as JaxAnchorTarget
from siammask_tpu.tracker import anchors as janchors
from siammask_tpu.train.lr import build_lr_spaces as jax_build_lr_spaces
from siammask_tpu.utils import bbox as jbbox
from siammask_tpu_torch.data.anchor_target import AnchorTarget, AnchorTargetConfig
from siammask_tpu_torch.tracker import anchors
from siammask_tpu_torch.train.lr import build_lr_spaces
from siammask_tpu_torch.utils import bbox

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted(REPO.glob("experiments/*/config.json"))

ANCHOR_CFGS = [{"stride": 8, "ratios": [0.33, 0.5, 1, 2, 3], "scales": [8]},
               {"stride": 8, "ratios": [0.5, 1, 2], "scales": [8, 10], "round_dight": 2}]


@pytest.mark.parametrize("cfg", ANCHOR_CFGS)
@pytest.mark.parametrize("im_c,size", [(127, 25), (71, 17)])
def test_all_anchors_match_jax(cfg, im_c, size):
    ours = anchors.generate_all_anchors(anchors.AnchorConfig.from_dict(cfg), im_c, size)
    ref = janchors.generate_all_anchors(janchors.AnchorConfig.from_dict(cfg), im_c, size)
    for o, r in zip(ours, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        np.testing.assert_array_equal(o, r)


def test_anchors_object_caches_its_tiling():
    a = anchors.Anchors(anchors.AnchorConfig())
    assert a.all_anchors is None and a.anchors.shape == (5, 4)
    a.generate_all_anchors(127, 25)
    first = a.all_anchors
    a.generate_all_anchors(127, 25)
    assert a.all_anchors is first
    a.generate_all_anchors(71, 17)
    assert a.all_anchors is not first and a.all_anchors[0].shape == (4, 5, 17, 17)


def _anchor_pair():
    ours = anchors.Anchors(anchors.AnchorConfig())
    ref = janchors.Anchors(janchors.AnchorConfig())
    ours.generate_all_anchors(127, 25)
    ref.generate_all_anchors(127, 25)
    return ours, ref


@pytest.mark.parametrize("box", [
    (95.0, 100.0, 160.0, 150.0),    # ~64 px: positives capped at 16
    (30.0, 40.0, 230.0, 220.0),     # large: few or no positives
    (120.5, 118.25, 133.0, 140.0),  # small
])
@pytest.mark.parametrize("neg", [False, True])
def test_anchor_target_matches_jax(box, neg):
    ours_a, ref_a = _anchor_pair()
    ours = AnchorTarget(np.random.RandomState(3))(ours_a, box, 25, neg=neg)
    ref = JaxAnchorTarget(rng=np.random.RandomState(3))(ref_a, box, 25, neg=neg)
    for o, r in zip(ours, ref):
        assert o.dtype == r.dtype
        np.testing.assert_array_equal(o, r)
    cls = ours[0]
    assert (cls == 1).sum() <= 16 and (cls >= 0).sum() <= (16 if neg else 64)


def test_anchor_target_config_matches_jax():
    """A non-default config, and one generator drawn from over two calls."""
    ours_a, ref_a = _anchor_pair()
    box = (95.0, 100.0, 160.0, 150.0)
    cfg = {"thr_high": 0.5, "thr_low": 0.2, "negative": 8, "rpn_batch": 32, "positive": 8}
    ours = AnchorTarget(np.random.RandomState(9), AnchorTargetConfig(**cfg))
    ref = JaxAnchorTarget(cfg, rng=np.random.RandomState(9))
    for _ in range(2):
        for o, r in zip(ours(ours_a, box, 25), ref(ref_a, box, 25)):
            np.testing.assert_array_equal(o, r)
    assert AnchorTarget(np.random.RandomState(0)).cfg == AnchorTargetConfig()


def test_box_helpers_match_jax():
    rng = np.random.RandomState(4)
    boxes = rng.uniform(0, 200, (4, 3, 7)).astype(np.float32)
    boxes[2:] += boxes[:2]
    np.testing.assert_array_equal(np.stack(bbox.corner2center(boxes)),
                                  np.stack(jbbox.corner2center(boxes)))
    np.testing.assert_array_equal(np.stack(bbox.center2corner(boxes)),
                                  np.stack(jbbox.center2corner(boxes)))
    target = np.array([50.0, 60.0, 150.0, 130.0])
    np.testing.assert_array_equal(bbox.bbox_iou(boxes, target), jbbox.bbox_iou(boxes, target))
    c = bbox.corner2center(bbox.Corner(1.0, 2.0, 5.0, 10.0))
    assert c == jbbox.corner2center(jbbox.Corner(1.0, 2.0, 5.0, 10.0))
    assert isinstance(c, bbox.Center)
    assert isinstance(bbox.center2corner(c), bbox.Corner)


@pytest.mark.parametrize("epochs", [1, 2, 5, 6, 20, 50])
@pytest.mark.parametrize("config", CONFIGS, ids=lambda p: p.parent.name)
def test_lr_spaces_match_jax(config, epochs):
    lr = json.loads(config.read_text())["lr"]
    ours = build_lr_spaces(lr, epochs)
    ref = jax_build_lr_spaces(lr, epochs)
    assert ours.shape == ref.shape == (epochs,)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("cfg", [
    {"type": "step", "start_lr": 0.01, "step": 10, "mult": 0.1},
    {"type": "multi-step", "start_lr": 0.01, "mult": 0.1, "steps": [10, 15, 20]},
    {"type": "linear", "start_lr": 0.01, "end_lr": 0.005},
    {"type": "cos", "start_lr": 0.01, "end_lr": 0.0005},
    {"type": "log", "start_lr": 0.005, "end_lr": 0.0005,
     "warmup": {"type": "multi-step", "start_lr": 0.001, "end_lr": 0.005, "steps": [1, 2],
                "epoch": 3}},
])
@pytest.mark.parametrize("epochs", [2, 3, 30])
def test_lr_schedule_types_match_jax(cfg, epochs):
    np.testing.assert_array_equal(build_lr_spaces(cfg, epochs), jax_build_lr_spaces(cfg, epochs))


def test_lr_rejects_an_unknown_type():
    with pytest.raises(ValueError):
        build_lr_spaces({"type": "exp"}, 5)
