"""The port's overfit tool (``siammask_tpu_torch/tools/overfit.py``) against
the JAX package's ``tools/overfit.py``, loaded from its file as
``test_overfit_slow.py`` loads it, on the synthetic clip of
``overfit.write_overfit_clip`` at 480x480 (the smallest square the
keyframe boxes fit in):

- the pseudo-gt: ``interpolate_boxes`` and ``grabcut_mask`` equal (cv2's
  RNG, which GrabCut's k-means draws from, seeded alike before each);
- ``prepare_multi`` (which runs ``prepare`` first): every JSON file equal
  once the work dirs' paths are named alike, every crop, mask and inverted
  frame byte-identical. GrabCut takes ~0.6 s a 480x480 frame on one x86 core
  and ``prepare_multi`` segments 112 frames, so here both tools segment
  with one stand-in (the ellipse inscribed in the box); the real
  ``grabcut_mask`` is compared on its own above;
- the LR schedules the port's train CLI builds from the prepared configs
  (with ``build_lr_spaces``) equal to the JAX CLI's;
- ``evaluate_train_fit`` (task ``sharp_refine``) on the JAX tool's width-8
  init carried into the port by ``utils/convert.py``: every metric within
  rtol 1e-4 (float32 convolutions in two libraries); the model's
  ``state_dict()`` bit-identical after the call;
- ``evaluate_tracking`` on a seeded, BN-calibrated width-8 sharp model
  (box head damped) carried into the JAX model by the JAX package's
  importer: the first held-out frame's IoU within 1e-3; after it the closed
  loops are compared by their lost count (the JAX runtime runs its
  latency-lowered clone);
- the CLI flow for each task (``--device cpu --width 8``, 16 pairs an
  epoch, one or two epochs): the report's keys those of the JAX run's
  committed reports, finite metrics, and for ``mask`` the trained total
  and mask loss under init's / 2 (``test_overfit_slow.py``'s bar). At
  batch 8 stage 2 would take 4 steps, which moved the port's width-8 init
  (mask loss ~4.1; the JAX init's is ~42) to ~2.8; the flows run at batch
  2, 8 steps an epoch;
- ``chip_smoke.train_log_runs``, which ``[overfit]`` reads its rates and
  its backbone gate from, on a written log;
- ``[overfit]``'s schedule gate: its pinned schedules are the JAX tool's
  stage configs and default epochs (and the port tool's); on the train
  CLI's log of two stage-2 epochs at width 8 (``sharp_refine``, 16 pairs,
  batch 2) it passes the recipe's config and fails a copy whose warmup is
  10x.
"""
import datetime
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from siammask_tpu.config import Config as JaxConfig
from siammask_tpu.models import siammask as jsiammask
from siammask_tpu.train.lr import build_lr_spaces as jax_build_lr_spaces
from siammask_tpu.utils.torch_convert import convert_state_dict
from siammask_tpu_torch.config import Config
from siammask_tpu_torch.models.siammask import SiamMaskSharp
from siammask_tpu_torch.tools import overfit
from siammask_tpu_torch.train.lr import build_lr_spaces
from siammask_tpu_torch.utils.convert import state_dict_from_jax

from chip_smoke import OVERFIT_SCHEDULES, schedule_mismatches, train_log_runs
from _torch_weights import damp_box_head
from test_torch_families import calibrated
from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
ARTIFACTS = REPO / "experiments" / "overfit_tennis"
WIDTH = 8
CLIP_HW = (480, 480)
CONFIGS = ("config_stage1.json", "config_stage2.json", "config_rpn.json", "config_multi.json")
# task -> (the JAX run's committed report, the epoch flags of the flow)
FLOWS = {"mask": ("report.json", ["--epochs1", "1", "--epochs2", "2"]),
         "siamrpn": ("report_rpn.json", ["--epochs-rpn", "2"]),
         "multi": ("report_multi.json", ["--epochs-multi", "1"])}


def _quiet(*_):
    pass


def _ellipse_mask(im: np.ndarray, box) -> np.ndarray:
    """The stand-in segmentation: the ellipse inscribed in the box."""
    x0, y0, x1, y1 = (int(round(v)) for v in box)
    mask = np.zeros(im.shape[:2], np.uint8)
    cv2.ellipse(mask, ((x0 + x1) // 2, (y0 + y1) // 2), ((x1 - x0) // 2, (y1 - y0) // 2),
                0, 0, 360, 1, -1)
    return mask


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("overfit_jax", str(REPO / "tools" /
                                                                      "overfit.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def clip(tmp_path_factory) -> str:
    root = tmp_path_factory.mktemp("clip")
    overfit.write_overfit_clip(root, CLIP_HW)
    return str(root)


@pytest.fixture(scope="module")
def prepared(tmp_path_factory, clip, jax_tool) -> tuple[Path, Path]:
    """(the JAX tool's work dir, the port's) after ``prepare_multi``, both
    segmenting with the stand-in."""
    dirs = tuple(tmp_path_factory.mktemp(name) / "work" for name in ("jax", "port"))
    with pytest.MonkeyPatch.context() as mp:
        for tool, work in zip((jax_tool, overfit), dirs):
            mp.setattr(tool, "grabcut_mask", _ellipse_mask)
            tool.prepare_multi(str(work), clip, log=_quiet)
    return dirs


def test_pseudo_gt_boxes_match_jax(jax_tool):
    assert (overfit.N_FRAMES, overfit.HELD_OUT_START) == (jax_tool.N_FRAMES,
                                                          jax_tool.HELD_OUT_START)
    assert overfit.KEYFRAME_BOXES == jax_tool.KEYFRAME_BOXES
    np.testing.assert_array_equal(overfit.interpolate_boxes(), jax_tool.interpolate_boxes())


@pytest.mark.parametrize("frame,flip", [(0, False), (33, False), (55, True)])
def test_grabcut_mask_matches_jax(jax_tool, clip, frame, flip):
    im = cv2.imread(str(Path(clip) / f"{frame:05d}.jpg"))
    box = overfit.interpolate_boxes()[frame]
    if flip:     # prepare_multi's second clip: the mirrored frame and box
        im = im[:, ::-1].copy()
        box = np.array([im.shape[1] - box[2], box[1], im.shape[1] - box[0], box[3]])
    masks = []
    for tool in (overfit, jax_tool):
        cv2.setRNGSeed(frame)    # GrabCut's k-means draws from cv2's global RNG
        masks.append(tool.grabcut_mask(im, box))
    mask = masks[0]
    np.testing.assert_array_equal(mask, masks[1])
    # the segmentation found the ellipse: most of the box's inscribed area
    assert 0.8 < mask.sum() / _ellipse_mask(im, box).sum() < 1.2


def _files(work: Path) -> list[str]:
    return sorted(str(p.relative_to(work)) for p in work.rglob("*") if p.is_file())


@pytest.mark.parametrize("tree", ["json", "crop511", "crop511_inv", "frames_inv"])
def test_prepare_matches_jax(prepared, tree):
    jax_work, work = prepared
    assert _files(work) == _files(jax_work)
    if tree == "json":
        names = [n for n in _files(work) if n.endswith(".json")]
        assert set(CONFIGS) | {"gt.json", "gt_inv.json", "train.json",
                               "train_inv.json"} == set(names)
        for name in names:
            ours = (work / name).read_text().replace(str(work), "<work>")
            ref = (jax_work / name).read_text().replace(str(jax_work), "<work>")
            assert json.loads(ours) == json.loads(ref), name
        return
    names = [n for n in _files(work) if n.startswith(tree + "/")]
    assert len(names) == (70 if tree == "frames_inv" else 2 * overfit.HELD_OUT_START)
    for name in names:
        assert (work / name).read_bytes() == (jax_work / name).read_bytes(), name


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("epochs", [1, 2, 16, 24])
def test_lr_schedule_matches_jax(prepared, config, epochs):
    path = str(prepared[1] / config)
    np.testing.assert_allclose(build_lr_spaces(Config.load(path).lr, epochs),
                               jax_build_lr_spaces(JaxConfig.load(path).lr, epochs),
                               rtol=1e-12, atol=0)


def test_evaluate_train_fit_matches_jax(jax_tool, prepared):
    jax_work, work = prepared
    jmodel = jsiammask.SiamMaskSharp(width=WIDTH, xcorr_impl="shift")
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 127, 127, 3)),
                            jnp.zeros((1, 143, 143, 3)))
    ref = jax_tool.evaluate_train_fit(variables, jmodel, str(jax_work))
    model = SiamMaskSharp(width=WIDTH)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, variables)))
    model.eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ours = overfit.evaluate_train_fit(model, str(work))
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        assert math.isclose(ours[k], v, rel_tol=1e-4, abs_tol=1e-6), (k, ours[k], v)
    assert 0 < ours["iou_mean"] and ours["skipped"] == 0
    after = model.state_dict()
    assert after.keys() == before.keys()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert not model.training


def test_evaluate_tracking_matches_jax(jax_tool, clip):
    boxes = overfit.interpolate_boxes()
    start = overfit.HELD_OUT_START
    first = cv2.imread(str(Path(clip) / f"{start:05d}.jpg"))
    b = boxes[start]
    model = calibrated(SiamMaskSharp, first, pos=((b[0] + b[2]) / 2, (b[1] + b[3]) / 2))
    damp_box_head(model)
    variables = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    jmodel = jsiammask.SiamMaskSharp(width=WIDTH, xcorr_impl="shift")
    ref = jax_tool.evaluate_tracking(variables, jmodel, overfit.TRACK_HP, boxes, clip)
    ours = overfit.evaluate_tracking(model, overfit.TRACK_HP, boxes, clip)
    assert ours.keys() == ref.keys()
    assert len(ours["per_frame_iou"]) == overfit.N_FRAMES - start - 1
    assert ours["per_frame_iou"][0] > 0
    assert abs(ours["per_frame_iou"][0] - ref["per_frame_iou"][0]) <= 1e-3
    assert ours["lost"] == ref["lost"]


def _keys(tree, depth: int = 4):
    """The nested key structure of a report, lists left out."""
    if not isinstance(tree, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in tree.items()}


@pytest.mark.parametrize("task", sorted(FLOWS))
def test_cli_flow(prepared, clip, tmp_path, monkeypatch, task):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # the train CLI's subprocesses
    work = tmp_path / "work"
    shutil.copytree(prepared[1], work)
    for name in CONFIGS:      # the configs name the prepared tree's paths
        text = (work / name).read_text().replace(str(prepared[1]), str(work))
        cfg = json.loads(text)
        td = cfg["train_datasets"]
        td["num"] = 16
        for d in td["datasets"].values():
            d["num_use"] = 16 // len(td["datasets"])
        (work / name).write_text(json.dumps(cfg))
    report_name, epochs = FLOWS[task]
    lines = []
    report = overfit.main(["--train", "--evaluate", "--task", task, "--device", "cpu",
                           "--width", str(WIDTH), "--batch", "2", "--work-dir", str(work),
                           "--frames-dir", clip, *epochs], log=lines.append)
    assert json.loads((work / report_name).read_text()) == report
    ref = json.loads((ARTIFACTS / report_name).read_text())
    assert _keys(report) == _keys(ref)
    assert report["task"] == task and report["held_out_start"] == 56
    fit = report["train_fit"]
    for split in ("init", "trained"):
        assert all(math.isfinite(v) for v in fit[split].values())
    assert fit["trained"]["total_loss"] < fit["init"]["total_loss"]
    if task == "mask":
        assert fit["trained"]["total_loss"] < fit["init"]["total_loss"] / 2
        assert fit["trained"]["mask_loss"] < fit["init"]["mask_loss"] / 2
    held = report["held_out_tracking"]
    for clip_report in (held.values() if task == "multi" else [held]):
        for split in ("init", "trained"):
            assert 0.0 <= clip_report[split]["mean_iou"] <= 1.0
            assert len(clip_report[split]["per_frame_iou"]) == 13
    stages = {"mask": ["stage 1", "stage 2"], "siamrpn": ["siamrpn"], "multi": ["multi"]}[task]
    assert [ln.split(":")[0] for ln in lines if ln.endswith(" s wall")] == [*stages, "evaluate"]


def test_train_log_runs_reads_the_log_clock_and_groups(tmp_path):
    """Seconds an iteration from the step lines' millisecond timestamps (not
    their rounded ``(x.xxs/it)``), over each run and the halves of its
    epochs; the optimizer groups with an LR over 0 in each half."""
    start = datetime.datetime(2026, 1, 1)
    lines, t = [], 0.0

    def line(text: str) -> None:
        at = start + datetime.timedelta(seconds=t)
        lines.append(f"{at:%Y-%m-%d %H:%M:%S},{at.microsecond // 1000:03d} INFO {text}")

    line("torch 2 device cpu")
    for step in range(2, 17, 2):           # 4 epochs of 4 steps, one line in 2
        epoch = (step - 1) // 4
        t += 2 * (0.05 if epoch < 2 else 0.09)
        line(f"epoch {epoch} step {step} lr 0.001 total_loss=1.0 lr/neck=0.001 "
             f"lr/resnet={0.0001 if epoch >= 2 else 0.0} (9.99s/it)")
    t += 5.0
    line("torch 2 device cpu")
    for step in (4, 8, 12):
        t += 4 * 0.07
        line(f"epoch {(step - 1) // 4} step {step} lr 0.001 lr/refine=0.001 (0.07s/it)")
    (tmp_path / "train.log").write_text("\n".join(lines) + "\n")
    first, second = train_log_runs(tmp_path / "train.log")
    assert first["steps"] == 16 and second["steps"] == 12
    np.testing.assert_allclose(first["s_it_halves"], [0.05, 0.09], atol=1e-3)
    np.testing.assert_allclose(first["s_it"], (6 * 0.05 + 8 * 0.09) / 14, atol=1e-3)
    np.testing.assert_allclose([second["s_it"], *second["s_it_halves"]], 0.07, atol=1e-3)
    assert first["lr_groups_halves"] == [["neck"], ["neck", "resnet"]]
    assert second["lr_groups_halves"] == [["refine"], ["refine"]]


def test_overfit_schedules_are_the_tool_recipes(prepared):
    """``chip_smoke.OVERFIT_SCHEDULES``: each stage's ``lr`` in the JAX
    tool's and the port tool's prepared configs, and their default
    ``--epochs1`` / ``--epochs2``."""
    jax_work, work = prepared
    source = (REPO / "tools" / "overfit.py").read_text()
    args = overfit.parse_args([])
    for label, config, flag in (("stage 1", "config_stage1.json", "epochs1"),
                                ("stage 2", "config_stage2.json", "epochs2")):
        lr_cfg, epochs = OVERFIT_SCHEDULES[label]
        for w in (jax_work, work):
            assert json.loads((w / config).read_text())["lr"] == lr_cfg, (w, config)
        assert re.search(rf'"--{flag}", type=int, default={epochs}\)', source), flag
        assert getattr(args, flag) == epochs


@pytest.fixture(scope="module")
def stage2_logs(prepared, tmp_path_factory) -> dict:
    """The train CLI's logs of two ``sharp_refine`` epochs at width 8 on the
    prepared crops (16 pairs, batch 2, a line a step), under the prepared
    stage-2 config and under a copy whose warmup rates are 10x; both runs at
    once, a subprocess each."""
    root = tmp_path_factory.mktemp("gate")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    procs = {}
    for name, scale in (("recipe", 1), ("warmup_10x", 10)):
        cfg = json.loads((prepared[1] / "config_stage2.json").read_text())
        td = cfg["train_datasets"]
        td["num"] = 16
        for d in td["datasets"].values():
            d["num_use"] = 16
        cfg["lr"]["warmup"]["start_lr"] *= scale
        cfg["lr"]["warmup"]["end_lr"] *= scale
        (root / f"{name}.json").write_text(json.dumps(cfg))
        log = root / f"{name}.log"
        with open(log, "w") as err:
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", "siammask_tpu_torch.tools.train", "--config",
                 str(root / f"{name}.json"), "--task", "sharp_refine", "--epochs", "2",
                 "--batch", "2", "--workers", "0", "--log-interval", "1", "--width", str(WIDTH),
                 "--device", "cpu", "--seed", "0", "--save-dir", str(root / name)],
                stdout=subprocess.DEVNULL, stderr=err, env=env), log)
    for name, (proc, log) in procs.items():
        assert proc.wait(timeout=600) == 0, log.read_text()[-3000:]
    return {name: train_log_runs(log) for name, (_, log) in procs.items()}


@pytest.mark.parametrize("config,caught", [("recipe", False), ("warmup_10x", True)])
def test_overfit_schedule_gate_catches_a_10x_stage2_warmup(stage2_logs, config, caught):
    """``schedule_mismatches`` holds each logged ``lr/<group>`` to the
    recipe's stage-2 schedule over the run's two epochs (its warmup) times
    the group's multiplier."""
    (run,) = stage2_logs[config]
    assert len(run["rates"]) == 16 and [e for e, _ in run["rates"]] == [0] * 8 + [1] * 8
    assert {g for _, rates in run["rates"] for g in rates} == {"mask", "refine"}
    bad = schedule_mismatches(run, OVERFIT_SCHEDULES["stage 2"][0], 2)
    assert bool(bad) == caught, bad
    if caught:
        assert bad[0].startswith("epoch 0 lr/")
