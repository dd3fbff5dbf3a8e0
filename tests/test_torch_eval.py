"""The port's VOT eval toolkit against the JAX package's: ``eval/statistics.py``
(failures, accuracy with burn-in, the expected-overlap curve, the OTB curves
and F1), ``eval/datasets.py``'s ``VOTDataset`` family and ``eval/
benchmarks.py`` (A/R and EAO), bit-identical on seeded random trajectories
with failures; ``tools/tune.py``'s ``score_vot_cell`` through each package
at width 8 on the same weights, each result tree scored by both toolkits;
and one open-loop track step at ``instance_size`` 271, the tune grid's
other search region.
"""
import importlib.util
import json
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siammask_tpu.config import Config as JaxConfig
from siammask_tpu.eval import benchmarks as jbenchmarks
from siammask_tpu.eval import datasets as jdatasets
from siammask_tpu.eval import statistics as jstatistics
from siammask_tpu.models import siammask as jsiammask
from siammask_tpu.tracker.runtime import TrackerRuntime as JaxTrackerRuntime
from siammask_tpu.tracker.tracker import Tracker as JaxTracker
from siammask_tpu.utils.torch_convert import convert_state_dict
from siammask_tpu_torch.config import Config
from siammask_tpu_torch.data.gen_json import create_vot_json
from siammask_tpu_torch.eval import benchmarks, datasets, statistics
from siammask_tpu_torch.eval.datasets import load_dataset
from siammask_tpu_torch.models.siammask import SiamMaskSharp
from siammask_tpu_torch.tools import tune
from siammask_tpu_torch.tracker.runtime import TrackerRuntime
from siammask_tpu_torch.tracker.tracker import Tracker
from siammask_tpu_torch.utils import bbox

from _torch_weights import damp_box_head
from test_torch_families import calibrated
from test_torch_tracker import CONFIG, POS, SZ, _frames, _to_port
from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)
from test_torch_vot import FRAMES, _make_jump_dataset

REPO = Path(__file__).resolve().parents[1]
VOT_CONFIG = REPO / "experiments" / "siammask_sharp" / "config_vot.json"
TAGS = ("camera_motion", "illum_change", "motion_change", "size_change", "occlusion")
# one tune cell: tools/tune.py's hp over config_vot.json
CELL = {"penalty_k": 0.04, "window_influence": 0.42, "lr": 0.3, "instance_size": 255}
TAG = "pk0.04_wi0.42_lr0.3_in255"


def jax_tune():
    """The JAX package's ``tools/tune.py`` as a module."""
    spec = importlib.util.spec_from_file_location("jax_tune", str(REPO / "tools" / "tune.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------- seeded random trajectories ----------------

def random_gt(rng, n: int, w: int = 640, h: int = 360) -> list[list[float]]:
    """An 8-point rotated-box gt track drifting inside a w x h frame."""
    c = rng.uniform([150, 100], [w - 150, h - 100])
    size = rng.uniform(30, 80, 2)
    out = []
    for _ in range(n):
        c = np.clip(c + rng.normal(0, 2, 2), 100, [w - 100, h - 100])
        a = rng.uniform(-0.3, 0.3)
        r = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        corners = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]]) * size / 2
        out.append((c + corners @ r.T).ravel().round(2).tolist())
    return out


def random_trajectory(rng, gt, mask: bool, fail_p: float = 0.04) -> list[list[float]]:
    """A reset-protocol trajectory over ``gt``: 1 at init and re-init, 2 at a
    failure followed by 4 skipped 0s, otherwise a region near the gt (8-point
    polygons with ``mask``, else xywh rects; a few of them off the target)."""
    traj, start = [], 0
    for f in range(len(gt)):
        if f == start:
            traj.append([1])
        elif f < start:
            traj.append([0])
        elif rng.rand() < fail_p:
            traj.append([2])
            start = f + 5
        else:
            g = np.asarray(gt[f]).reshape(4, 2)
            shift = rng.normal(0, 4, 2) + (rng.rand() < 0.05) * 200
            poly = g + shift + rng.normal(0, 2, (4, 2))
            if mask:
                traj.append(poly.ravel().round(4).tolist())
            else:
                x0, y0 = poly.min(0)
                x1, y1 = poly.max(0)
                traj.append([round(x0, 4), round(y0, 4), round(x1 - x0, 4), round(y1 - y0, 4)])
    return traj


def write_random_vot_tree(root: Path, seed: int, n_videos: int = 3,
                          trackers=(("boxes", False, 1), ("masks", True, 1),
                                    ("repeats", True, 15))) -> None:
    """A VOT2018 toolkit json ``root/VOT2018.json`` of ``n_videos`` videos of
    150-300 frames with random per-frame tags, and under
    ``root/results/VOT2018/<tracker>/baseline/`` each tracker's trajectories
    (box or mask regions, one run or 15 repeats)."""
    rng = np.random.RandomState(seed)
    meta = {}
    for v in range(n_videos):
        name = f"video{v}"
        n = int(rng.randint(150, 300))
        gt = random_gt(rng, n)
        meta[name] = {"video_dir": name, "init_rect": gt[0],
                      "img_names": [f"{name}/color/{i + 1:08d}.jpg" for i in range(n)],
                      "gt_rect": gt, "width": 640, "height": 360,
                      **{t: (rng.rand(n) < 0.3).astype(int).tolist() for t in TAGS[:3]},
                      "occlusion": [], "size_change": []}
        for tracker, mask, runs in trackers:
            d = root / "results" / "VOT2018" / tracker / "baseline" / name
            d.mkdir(parents=True)
            for r in range(runs):
                lines = [",".join(str(x) for x in region)
                         for region in random_trajectory(rng, gt, mask)]
                (d / f"{name}_{r + 1:03d}.txt").write_text("\n".join(lines) + "\n")
    (root / "VOT2018.json").write_text(json.dumps(meta))


# ---------------- statistics ----------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_failures_and_accuracy_are_bit_identical_to_jax(seed):
    rng = np.random.RandomState(seed)
    gt = random_gt(rng, 200)
    for mask in (False, True):
        traj = random_trajectory(rng, gt, mask, fail_p=0.08)
        assert statistics.calculate_failures(traj) == jstatistics.calculate_failures(traj)
        assert statistics.calculate_failures(traj)[0] > 0
        for burnin, bound in ((0, None), (10, (640, 360)), (10, (639, 359))):
            acc, overlaps = statistics.calculate_accuracy(traj, gt, burnin=burnin, bound=bound)
            ref_acc, ref_overlaps = jstatistics.calculate_accuracy(traj, gt, burnin=burnin,
                                                                   bound=bound)
            assert acc == ref_acc
            np.testing.assert_array_equal(overlaps, ref_overlaps)


@pytest.mark.parametrize("seed", [0, 1])
def test_expected_overlap_curve_is_bit_identical_to_jax(seed):
    rng = np.random.RandomState(seed)
    fragments = rng.rand(40, 120)
    for i, end in enumerate(rng.randint(2, 121, 40)):
        fragments[i, end:] = np.nan
    weights = rng.rand(40)
    ours = statistics.calculate_expected_overlap(fragments, weights)
    ref = jstatistics.calculate_expected_overlap(fragments, weights)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


def test_otb_curves_and_f1_are_bit_identical_to_jax():
    rng = np.random.RandomState(3)
    gt = rng.uniform(0, 100, (60, 4))
    gt[::7] = 0                                     # frames with no gt
    res = gt + rng.normal(0, 5, (60, 4))
    np.testing.assert_array_equal(statistics.overlap_ratio(gt[1:], res[1:]),
                                  jstatistics.overlap_ratio(gt[1:], res[1:]))
    np.testing.assert_array_equal(statistics.success_overlap(gt, res, 60),
                                  jstatistics.success_overlap(gt, res, 60))
    thresholds = np.arange(0, 51, 1)
    np.testing.assert_array_equal(statistics.success_error(gt[:, :2], res[:, :2], thresholds, 60),
                                  jstatistics.success_error(gt[:, :2], res[:, :2], thresholds, 60))
    scores = rng.rand(300)
    scores[::11] = np.nan
    th = statistics.determine_thresholds(scores)
    np.testing.assert_array_equal(th, jstatistics.determine_thresholds(scores))
    overlaps = rng.rand(300)
    for a, b in zip(statistics.calculate_f1(overlaps, scores, None, th, 250),
                    jstatistics.calculate_f1(overlaps, scores, None, th, 250)):
        np.testing.assert_array_equal(a, b)


# ---------------- datasets and benchmarks ----------------

@pytest.fixture(scope="module")
def random_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("vot_tree")
    write_random_vot_tree(root, seed=4)
    return root


def test_vot_dataset_matches_jax(random_tree):
    ours = datasets.VOTDataset("VOT2018", str(random_tree))
    ref = jdatasets.VOTDataset("VOT2018", str(random_tree))
    assert len(ours) == len(ref) == 3 and ours.tags == ref.tags
    for a, b in zip(ours, ref):
        assert (a.name, a.width, a.height, a.gt_traj, a.img_names) == \
            (b.name, b.width, b.height, b.gt_traj, b.img_names)
        assert a.tags == b.tags and a.tag_names == b.tag_names
        assert a.select_tag("empty") == b.select_tag("empty")
        assert a.select_tag("camera_motion", 5, 60) == b.select_tag("camera_motion", 5, 60)
        path = str(random_tree / "results" / "VOT2018")
        for tracker, runs in (("boxes", 1), ("repeats", 15)):
            trajs = a.load_tracker(path, tracker, store=False)
            assert len(trajs) == runs and trajs == b.load_tracker(path, tracker, store=False)
    assert ours["video1"].name == ours[1].name == "video1"
    assert datasets.dataset_zoo(str(random_tree)) == jdatasets.dataset_zoo(str(random_tree))


@pytest.mark.parametrize("tags", [("all",), ("all", "camera_motion", "occlusion", "empty")])
def test_ar_and_eao_benchmarks_are_bit_identical_to_jax(random_tree, tags):
    trackers = ["boxes", "masks", "repeats"]
    results = []
    for mod, dsmod in ((benchmarks, datasets), (jbenchmarks, jdatasets)):
        ds = dsmod.VOTDataset("VOT2018", str(random_tree))
        ds.set_tracker(str(random_tree / "results" / "VOT2018"), trackers)
        ar = mod.AccuracyRobustnessBenchmark(ds)
        ar_res = ar.eval(trackers)
        results.append((ar_res, mod.AccuracyRobustnessBenchmark.summarize(ar_res),
                        mod.EAOBenchmark(ds, tags=tags).eval(trackers)))
    (ar_res, summary, eao), (ref_ar, ref_summary, ref_eao) = results
    assert summary == ref_summary
    np.testing.assert_equal(eao, ref_eao)           # NaN where a tag is never set
    for t in trackers:
        assert ar_res[t]["failures"] == ref_ar[t]["failures"]
        for v in ar_res[t]["overlaps"]:
            np.testing.assert_array_equal(ar_res[t]["overlaps"][v], ref_ar[t]["overlaps"][v])
        assert summary[t]["lost_number"] > 0 and 0 < eao[t]["all"] < 1


# ---------------- a tune cell through each package ----------------

@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """One VOT tune cell (``CELL``) scored by ``score_vot_cell`` through the
    port on a seeded, BN-calibrated width-8 SiamMask-sharp with its box head
    damped, and through the JAX package on the same weights (Pallas xcorr,
    interpret mode), on ``test_torch_vot.py``'s two videos with the forced
    jump. Returns the data dir and {package: (score, out dir)}."""
    root = tmp_path_factory.mktemp("tune_cell")
    data_dir = root / "data"
    _make_jump_dataset(data_dir / "VOT2018")
    create_vot_json(str(data_dir / "VOT2018"), "VOT2018", out_file=str(data_dir / "VOT2018.json"))
    dataset = load_dataset("VOT2018", str(data_dir))
    video = dataset["vid0"]
    cx, cy, _, _ = bbox.get_axis_aligned_bbox(video["gt"][0])
    model = calibrated(SiamMaskSharp, cv2.imread(video["image_files"][0]),
                       np.array([cx, cy], np.float32))
    damp_box_head(model)
    variables = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    p = Config.load(str(VOT_CONFIG)).tracker_config().update(CELL)
    p_jax = JaxConfig.load(str(VOT_CONFIG)).tracker_config().update(CELL)
    runtimes = {
        "port": (tune, datasets, TrackerRuntime(model, p, "cpu")),
        "jax": (jax_tune(), jdatasets, JaxTrackerRuntime(
            jsiammask.SiamMaskSharp(width=model.width, xcorr_impl="pallas"), variables, p_jax,
            latency_lowerings=False)),
    }
    out = {}
    for name, (mod, dsmod, runtime) in runtimes.items():
        vot_ds = dsmod.VOTDataset("VOT2018", str(data_dir))
        score = mod.score_vot_cell(runtime, dataset, vot_ds, TAG, str(root / name), "VOT2018",
                                   eao_interval=(1, FRAMES), log=lambda *_: None)
        out[name] = (score, root / name)
    return data_dir, out


def test_score_vot_cell_matches_jax(cells):
    """EAO within 1e-3 (the regions agree to 1e-2 px, as ``test_torch_vot.py``
    holds them), the same markers line for line, and the forced loss."""
    _, out = cells
    (score, ours), (ref_score, ref) = out["port"], out["jax"]
    assert 0 < score <= 1 and abs(score - ref_score) <= 1e-3
    for vid in ("vid0", "vid1"):
        path = Path("results", "VOT2018", TAG, "baseline", vid, f"{vid}_001.txt")
        lines, ref_lines = ((d / path).read_text().splitlines() for d in (ours, ref))
        assert len(lines) == len(ref_lines) == FRAMES
        assert [x for x in lines if "," not in x] == [x for x in ref_lines if "," not in x]
        assert ("2" in lines) == (vid == "vid1")


@pytest.mark.parametrize("tree", ["port", "jax"])
def test_both_toolkits_score_each_tree_identically(cells, tree):
    """The tree the port's driver wrote and the one JAX's wrote, each scored
    by the port's and the JAX package's A/R and EAO: bit-identical; the EAO
    is the one ``score_vot_cell`` returned."""
    data_dir, out = cells
    score, root = out[tree]
    scored = []
    for mod, dsmod in ((benchmarks, datasets), (jbenchmarks, jdatasets)):
        ds = dsmod.VOTDataset("VOT2018", str(data_dir))
        ds.set_tracker(str(root / "results" / "VOT2018"), [TAG])
        eao = mod.EAOBenchmark(ds)
        eao.low, eao.high = 1, FRAMES
        # the default 10-frame burn-in covers these 10-frame videos (accuracy
        # NaN); a 2-frame one leaves frames to score
        scored.append([mod.AccuracyRobustnessBenchmark.summarize(
            mod.AccuracyRobustnessBenchmark(ds, burnin=b).eval(TAG)) for b in (10, 2)]
            + [eao.eval(TAG)])
    np.testing.assert_equal(scored[0], scored[1])
    (_, ar, eao), tag = scored[0], TAG
    assert eao[tag]["all"] == score
    assert ar[tag]["lost_number"] >= 1 and 0 < ar[tag]["accuracy"] <= 1


# ---------------- the other search region ----------------

def test_open_loop_step_at_instance_size_271():
    """A 271 search region (27x27 score map, larger p0-p2 for Refine's skip
    windows): two open-loop steps of the port's sharp tracker against JAX's."""
    p = Config.load(str(CONFIG)).tracker_config().update({"instance_size": 271})
    p_jax = JaxConfig.load(str(CONFIG)).tracker_config().update({"instance_size": 271})
    assert p.score_size == p_jax.score_size == 27
    frames = _frames()
    model = calibrated(SiamMaskSharp, frames[0], np.asarray(POS, np.float32))
    variables = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    tracker = Tracker(model, p, "cpu")
    jtracker = JaxTracker(jsiammask.SiamMaskSharp(width=model.width), p_jax,
                          latency_lowerings=False)
    state = jtracker.init(variables, jnp.asarray(frames[0]), np.asarray(POS, np.float32),
                          np.asarray(SZ, np.float32))
    for frame in frames[1:3]:
        _, ours = tracker.step(_to_port(state), torch.from_numpy(frame))
        state, ref = jtracker.step(variables, state, jnp.asarray(frame))
        assert int(ours.best_id) == int(ref.best_id)
        np.testing.assert_allclose(ours.target_pos.numpy(), np.asarray(ref.target_pos), atol=1e-3)
        np.testing.assert_allclose(ours.target_sz.numpy(), np.asarray(ref.target_sz), atol=1e-3)
        np.testing.assert_allclose(ours.score.numpy(), np.asarray(ref.score), atol=1e-5)
        np.testing.assert_allclose(ours.mask_logits.numpy(), np.asarray(ref.mask_logits),
                                   atol=1e-5)
        np.testing.assert_allclose(ours.mask_in_frame.numpy(), np.asarray(ref.mask_in_frame),
                                   atol=1e-4)
