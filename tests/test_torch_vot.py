"""The port's VOT path against the JAX package's: the region-overlap binding
(``eval/region.py``, bit-identical to ``siammask_tpu.eval.region`` on the
same C++ source), the VOT bbox helpers, the reset-on-failure driver
``track_vot`` for the three families, the batched VOS driver on
SiamMask-base, and the test and demo CLIs on the CPU.

The VOT data is ``test_vot_e2e.py``'s synthetic layout on wider frames, with
the second video's target and gt jumping far outside the search region at
frame ``JUMP``: every family must lose it there, skip 5 frames and re-init.
The models are seeded, BN-calibrated width-8 port models, carried into the
JAX models (Pallas xcorr, interpret mode) by the JAX package's importer; the
JAX runtimes run with ``latency_lowerings=False``.
"""
import shutil
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from siammask_tpu.config import Config as JaxConfig
from siammask_tpu.config import TrackerConfig as JaxTrackerConfig
from siammask_tpu.eval import region as jregion
from siammask_tpu.models import siammask as jsiammask
from siammask_tpu.tracker import vos as jvos
from siammask_tpu.tracker.runtime import TrackerRuntime as JaxTrackerRuntime
from siammask_tpu.tracker.vot import track_vot as jax_track_vot
from siammask_tpu.utils import bbox as jbbox
from siammask_tpu.utils.torch_convert import convert_state_dict
from siammask_tpu_torch.config import Config, TrackerConfig
from siammask_tpu_torch.eval import region
from siammask_tpu_torch.eval.datasets import load_dataset
from siammask_tpu_torch.models.siammask import SiamMaskBase, SiamMaskSharp, SiamRPN
from siammask_tpu_torch.ops import _build
from siammask_tpu_torch.tools import demo
from siammask_tpu_torch.tools import test as cli
from siammask_tpu_torch.tracker.runtime import TrackerRuntime
from siammask_tpu_torch.tracker.vos import track_vos_batched
from siammask_tpu_torch.tracker.vot import track_vot
from siammask_tpu_torch.utils import bbox

from _torch_weights import damp_box_head
from test_torch_families import calibrated
from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)
from test_torch_vos import _against_jax
from test_vos_e2e import HP, _make_davis
from test_vot_e2e import _make_vot_dataset

EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"
FRAMES, H, W = 10, 120, 320
JUMP, DX = 4, 200          # vid1's target moves DX px right at frame JUMP
# the jump's markers: lost, four skipped frames, the re-init
FORCED = ["2", "0", "0", "0", "0", "1"]
# family -> (port class, JAX class, config, mask, refine)
FAMILIES = {
    "sharp": (SiamMaskSharp, jsiammask.SiamMaskSharp, "siammask_sharp/config_vot.json", True,
              True),
    "base": (SiamMaskBase, jsiammask.SiamMaskBase, "siammask_base/config.json", True, False),
    "rpn": (SiamRPN, jsiammask.SiamRPN, "siamrpn_resnet/config.json", False, False),
}


def _quiet(*_):
    pass


def _make_jump_dataset(root: Path) -> None:
    """``_make_vot_dataset``'s two videos, with vid1's target and gt moved
    DX px right from frame JUMP on."""
    _make_vot_dataset(root, n_videos=2, n_frames=FRAMES, h=H, w=W)
    vdir = root / "vid1"
    gt = np.loadtxt(vdir / "groundtruth.txt", delimiter=",")
    rng = np.random.RandomState(5)
    for f in range(JUMP, FRAMES):
        path = str(vdir / f"{f + 1:08d}.jpg")
        im = cv2.imread(path)
        x0, y0 = int(gt[f, 0]), int(gt[f, 1])
        im[y0:y0 + 40, x0:x0 + 30] = rng.randint(0, 60, (40, 30, 3))
        im[y0:y0 + 40, x0 + DX:x0 + DX + 30] = 220
        cv2.imwrite(path, im)
        gt[f, 0::2] += DX
    np.savetxt(vdir / "groundtruth.txt", gt, delimiter=",", fmt="%.4f")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("vot_data")
    _make_jump_dataset(root / "VOT2018")
    return root


@pytest.fixture(scope="module")
def families(data_dir):
    """family -> (port model, its config, JAX model, variables, JAX config),
    BN calibrated on vid0's first frame around its target, the box head
    damped (on this data only the jump then loses the target, as
    ``test_track_vot_matches_jax`` asserts)."""
    video = load_dataset("VOT2018", str(data_dir))["vid0"]
    frame = cv2.imread(video["image_files"][0])
    cx, cy, _, _ = bbox.get_axis_aligned_bbox(video["gt"][0])
    out = {}
    for name, (cls, jcls, config, _, _) in FAMILIES.items():
        model = calibrated(cls, frame, np.array([cx, cy], np.float32))
        damp_box_head(model)
        variables = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
        path = str(EXPERIMENTS / config)
        out[name] = (model, Config.load(path).tracker_config(),
                     jcls(width=model.width, xcorr_impl="pallas"), variables,
                     JaxConfig.load(path).tracker_config())
    return out


# ---------------- region overlap ----------------

def _polygon(rng, n):
    c = rng.uniform(20, 140, 2)
    angles = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(5, 60, n)
    return np.stack([c[0] + r * np.cos(angles), c[1] + r * np.sin(angles)], 1)


def _regions(rng):
    """A flat polygon, an xywh rect or a list of point pairs."""
    kind = rng.randint(3)
    if kind == 0:
        return list(_polygon(rng, rng.randint(3, 9)).ravel())
    if kind == 1:
        return list(np.concatenate([rng.uniform(0, 150, 2), rng.uniform(1, 80, 2)]))
    return [tuple(p) for p in _polygon(rng, 4)]


@pytest.mark.parametrize("bounds", [None, (160, 120), (10.0, 100.0, 5.0, 150.0)])
def test_vot_overlap_is_bit_identical_to_jax(bounds):
    rng = np.random.RandomState(0)
    pairs = [(_regions(rng), _regions(rng)) for _ in range(200)]
    ours = [region.vot_overlap(a, b, bounds) for a, b in pairs]
    ref = [jregion.vot_overlap(a, b, bounds) for a, b in pairs]
    assert ours == ref
    assert 0 < sum(v > 0 for v in ours) < len(ours)     # both overlapping and disjoint pairs
    traj = region.vot_overlap_traj([a for a, _ in pairs], [b for _, b in pairs], bounds)
    assert traj == ref == jregion.vot_overlap_traj([a for a, _ in pairs],
                                                   [b for _, b in pairs], bounds)


def test_special_regions_and_formatting_match_jax():
    poly = [10.0, 20.0, 40.0, 20.0, 40.0, 60.0, 10.0, 60.0]
    for a, b in (([1.0], poly), (poly, [2.0]), ([0.0], [0.0])):
        assert np.isnan(region.vot_overlap(a, b)) and np.isnan(jregion.vot_overlap(a, b))
    assert region.vot_overlap([10.0, 20.0, 30.0, 40.0], poly) == 1.0
    with pytest.raises(ValueError):
        region.vot_overlap_traj([poly], [poly, poly])
    for v in (1.23456, -0.00005, 1e6 / 3):
        assert region.vot_float2str("%.4f", v) == jregion.vot_float2str("%.4f", v)


def test_rasterize_polygon_is_bit_identical_to_jax():
    rng = np.random.RandomState(2)
    for _ in range(20):
        r = _regions(rng)
        ours = region.rasterize_polygon(r, 160, 120)
        assert ours.dtype == np.uint8 and ours.shape == (120, 160)
        np.testing.assert_array_equal(ours, jregion.rasterize_polygon(r, 160, 120))
    assert region.rasterize_polygon([0, 0, 10, 0, 10, 10, 0, 10], 20, 20).sum() == 11 * 11


def test_region_library_builds_into_the_build_dir():
    region.vot_overlap([0, 0, 4, 4], [1, 1, 4, 4])
    lib = _build.library_path("region_overlap", region.FLAGS, (region.SOURCE,))
    assert lib.exists() and lib.parent == _build.BUILD_DIR
    package = Path(region.__file__).resolve().parents[1]
    assert not list(package.rglob("*.so"))


def test_vot_bbox_helpers_match_jax():
    rng = np.random.RandomState(4)
    for _ in range(20):
        poly = _polygon(rng, 4).ravel()
        rect = rng.uniform(1, 100, 4)
        for r in (poly, rect):
            np.testing.assert_array_equal(bbox.get_axis_aligned_bbox(r),
                                          jbbox.get_axis_aligned_bbox(r))
        for a, b in zip(bbox.rect_2_cxy_wh(rect), jbbox.rect_2_cxy_wh(rect)):
            np.testing.assert_array_equal(a, b)


# ---------------- the VOT driver ----------------

def _result_lines(result_dir: Path, tracker: str, video: str) -> list[str]:
    path = result_dir / "VOT2018" / tracker / "baseline" / video / f"{video}_001.txt"
    return path.read_text().splitlines()


def _check_grammar(lines: list[str], numbers: int) -> None:
    """1 first; each 2 is followed by four 0s and a 1 (within the video);
    every other line is a region of ``numbers`` numbers."""
    assert lines[0] == "1"
    i = 1
    while i < len(lines):
        if lines[i] == "2":
            assert lines[i + 1:i + 6] == FORCED[1:len(lines[i + 1:i + 6]) + 1]
            i += 6
        else:
            assert len(lines[i].split(",")) == numbers, lines[i]
            i += 1


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_track_vot_matches_jax(name, families, data_dir, tmp_path):
    """The same markers line for line and the same regions within 1e-2 px,
    and the jump's forced lost / skip / re-init, for each family."""
    model, p, jmodel, variables, p_jax = families[name]
    mask, refine = FAMILIES[name][3:]
    runtime = TrackerRuntime(model, p, "cpu", mask=mask, refine=refine)
    jruntime = JaxTrackerRuntime(jmodel, variables, p_jax, mask=mask, refine=refine,
                                 latency_lowerings=False)
    dataset = load_dataset("VOT2018", str(data_dir))
    for vname, video in dataset.items():
        lost, fps = track_vot(runtime, video, mask_enable=mask, result_dir=str(tmp_path / "ours"),
                              tracker_name=name, log=_quiet)
        ref_lost, _ = jax_track_vot(jruntime, video, mask_enable=mask,
                                    result_dir=str(tmp_path / "jax"), tracker_name=name,
                                    log=_quiet)
        assert lost == ref_lost and fps > 0
        lines = _result_lines(tmp_path / "ours", name, vname)
        ref = _result_lines(tmp_path / "jax", name, vname)
        assert len(lines) == len(ref) == FRAMES
        for a, b in zip(lines, ref):
            if b in ("0", "1", "2"):
                assert a == b
            else:
                np.testing.assert_allclose(np.array(a.split(","), float),
                                           np.array(b.split(","), float), rtol=0, atol=1e-2)
        _check_grammar(lines, 8 if mask else 4)
        assert lost == (vname == "vid1")
        if vname == "vid1":
            assert lines[JUMP:JUMP + 6] == FORCED


# ---------------- VOS with SiamMask-base ----------------

def test_vos_batched_base_matches_jax(families, tmp_path):
    """``track_vos_batched`` with ``TrackerRuntime(..., refine=False)`` on
    SiamMask-base (63² masks) gives the JAX driver's IoU arrays and PNGs."""
    model, _, jmodel, variables, _ = families["base"]
    _make_davis(tmp_path / "DAVIS")
    video = load_dataset("DAVIS2017", str(tmp_path))["synth"]
    hp = {**HP, "out_size": 63}
    runtime = TrackerRuntime(model, TrackerConfig().update(hp), "cpu", refine=False)
    jruntime = JaxTrackerRuntime(jmodel, variables, JaxTrackerConfig().update(hp),
                                 refine=False, latency_lowerings=False)
    iou, _, fused = _against_jax(track_vos_batched, jvos.track_vos_batched, runtime, jruntime,
                                 video, tmp_path, "DAVIS2017", mot_enable=True)
    assert iou.shape == (2, 4) and np.all((iou >= 0) & (iou <= 1))
    assert fused[1].shape == (120, 160)


# ---------------- the CLI ----------------

def test_cli_main_runs_a_vot_video_on_the_cpu(data_dir, tmp_path):
    """``main`` with a reference-style ``.pth`` (a training checkpoint's
    ``module.``-prefixed state_dict) for SiamRPN at the published width, on
    one video: it returns the totals and writes the VOT result file with the
    jump's markers."""
    video = load_dataset("VOT2018", str(data_dir))["vid1"]
    cx, cy, _, _ = bbox.get_axis_aligned_bbox(video["gt"][0])
    frame = cv2.imread(video["image_files"][0])
    model = calibrated(SiamRPN, frame, np.array([cx, cy], np.float32), width=64)
    damp_box_head(model)
    ckpt = tmp_path / "rpn_ckpt.pth"
    torch.save({"epoch": 1, "state_dict": {f"module.{k}": v for k, v in
                                           model.state_dict().items()}}, ckpt)
    totals = cli.main(["--config", str(EXPERIMENTS / "siamrpn_resnet" / "config.json"),
                       "--resume", str(ckpt), "--dataset", "VOT2018", "--data-dir",
                       str(data_dir), "--video", "vid1", "--result-dir", str(tmp_path / "res"),
                       "--device", "cpu"])
    assert totals["videos"] == 1 and totals["lost"] == 1 and totals["fps"] > 0
    lines = _result_lines(tmp_path / "res", "SiamRPN_rpn_ckpt", "vid1")
    assert len(lines) == FRAMES and lines[JUMP:JUMP + 6] == FORCED
    _check_grammar(lines, 4)


def test_cli_takes_arch_and_ignores_it(monkeypatch):
    """``--arch`` is accepted and ignored, as the JAX package's CLI does: the
    config's arch picks the model."""
    assert cli.parse_args(["--config", "c.json", "--arch", "SiamMaskBase"]).arch == "SiamMaskBase"
    picked = []

    class Built(Exception):
        pass

    def load_model(arch, *args, **kwargs):
        picked.append(arch)
        raise Built

    monkeypatch.setattr(cli, "load_model", load_model)
    with pytest.raises(Built):
        cli.main(["--config", str(EXPERIMENTS / "siamrpn_resnet" / "config.json"), "--arch",
                  "SiamMaskBase", "--device", "cpu"])
    assert picked == ["SiamRPN"]


@pytest.mark.parametrize("config,flags", [("siammask_base/config.json", []),
                                          ("siammask_sharp/config_davis.json", ["--box-only"])])
def test_demo_main_draws_every_tracked_frame(data_dir, tmp_path, config, flags):
    """The demo on vid0's first four frames at the published width on the
    CPU: the 63² mask path of a SiamMask-base config, and a sharp config's
    box path."""
    video = load_dataset("VOT2018", str(data_dir))["vid0"]
    x, y, w, h = (int(v) for v in video["gt"][0][[0, 1, 2, 5]])
    frames = tmp_path / "frames"
    frames.mkdir()
    for f in video["image_files"][:4]:
        shutil.copy(f, frames)
    out = tmp_path / "drawn"
    summary = demo.main(["--config", str(EXPERIMENTS / config), "--base-path", str(frames),
                         "--box", f"{x},{y},{w - x},{h - y}", "--out-dir", str(out),
                         "--device", "cpu", *flags])
    assert summary["frames"] == 4 and summary["fps"] > 0
    drawn = sorted(out.glob("*.jpg"))
    assert len(drawn) == 3
    assert cv2.imread(str(drawn[0])).shape == (H, W, 3)
