"""The port's VOS drivers and dataset loaders against the JAX package's:
the cases of ``test_vos_e2e.py`` (sequential, batched, ``scan_chunk``
invariance, ranged ytb_vos objects with a late start, ``save_mask``) run
through ``siammask_tpu_torch.tracker.vos`` and ``siammask_tpu.tracker.vos``
at width 8 on the CPU, from the same weights (carried across with
``convert_state_dict``; the JAX side with ``latency_lowerings=False``): the
same IoU arrays within 1e-4 and the same fused PNGs. The numpy helpers are
held against JAX's on the same inputs."""
import numpy as np
import pytest
import torch
from PIL import Image

from siammask_tpu.config import TrackerConfig as JaxTrackerConfig
from siammask_tpu.eval import datasets as jdatasets
from siammask_tpu.models.siammask import SiamMaskSharp as JaxSiamMaskSharp
from siammask_tpu.tracker import vos as jvos
from siammask_tpu.tracker.runtime import TrackerRuntime as JaxTrackerRuntime
from siammask_tpu.utils.torch_convert import convert_state_dict
from siammask_tpu_torch.config import TrackerConfig
from siammask_tpu_torch.eval.datasets import load_dataset
from siammask_tpu_torch.models.siammask import SiamMaskSharp
from siammask_tpu_torch.ops.sample import subwindow_crop
from siammask_tpu_torch.tracker.runtime import TrackerRuntime
from siammask_tpu_torch.tracker.vos import THRS, multi_batch_iou, track_vos, track_vos_batched

from chip_smoke import calibrate_bn
from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)
from test_vos_e2e import HP, _make_davis, _make_ytb_vos_valid

WIDTH = 8


def _quiet(*_):
    pass


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The synthetic DAVIS video, and the port's and the JAX package's
    runtimes on the same seeded weights (BN calibrated on crops of a frame)."""
    data_dir = tmp_path_factory.mktemp("davis_data")
    _make_davis(data_dir / "DAVIS")
    model = SiamMaskSharp(width=WIDTH).init_weights(torch.Generator().manual_seed(0)).eval()
    frame = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (120, 160, 3),
                                                               dtype=np.uint8))
    avg = frame.mean(dim=(0, 1), dtype=torch.float32)
    crops = [subwindow_crop(frame, torch.tensor([[60.0, 50.0]]), torch.tensor([float(s)]), m,
                            avg[None]) for s, m in ((64, 127), (128, 255))]
    calibrate_bn(model, *(c.permute(0, 3, 1, 2).contiguous() for c in crops))
    variables = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    jruntime = JaxTrackerRuntime(JaxSiamMaskSharp(width=WIDTH), variables,
                                 JaxTrackerConfig().update(HP), latency_lowerings=False)
    return data_dir, TrackerRuntime(model, TrackerConfig().update(HP), "cpu"), jruntime


def _fused(result_dir, dataset, name):
    """The fused argmax PNGs a driver wrote, in frame order."""
    files = sorted((result_dir / dataset / "SiamMask" / name).glob("*.png"))
    return [np.array(Image.open(f)) for f in files]


def _against_jax(ours_driver, ref_driver, runtime, jruntime, video, out, dataset, **kw):
    """Run the port's driver and the JAX one on the same video, each saving
    its fused PNGs; assert the same IoU arrays (1e-4) and PNGs (exact).
    Returns the port's IoU array, its fps and its PNGs."""
    iou, fps = ours_driver(runtime, video, result_dir=str(out / "ours"), dataset=dataset,
                           save_mask=True, log=_quiet, **kw)
    ref, _ = ref_driver(jruntime, video, result_dir=str(out / "jax"), dataset=dataset,
                        save_mask=True, log=_quiet, **kw)
    iou = np.asarray(iou)
    np.testing.assert_allclose(iou, np.asarray(ref), rtol=0, atol=1e-4)
    fused, ref_fused = (_fused(out / d, dataset, video["name"]) for d in ("ours", "jax"))
    assert len(fused) == len(ref_fused) == len(video["image_files"])
    for i, (a, b) in enumerate(zip(fused, ref_fused)):
        np.testing.assert_array_equal(a, b, err_msg=f"fused PNG of frame {i}")
    return iou, fps, fused


def test_thresholds_match_jax():
    np.testing.assert_array_equal(THRS, jvos.THRS)


@pytest.mark.parametrize("ranged", [False, True])
def test_multi_batch_iou_matches_jax(ranged):
    rng = np.random.RandomState(4)
    outputs = rng.uniform(-1, 1, size=(2, 7, 20, 30)).astype(np.float32)
    targets = rng.randint(0, 3, size=(7, 20, 30)).astype(np.uint8)
    kw = {}
    if ranged:
        kw = {"start": {"1": 0, "2": 2}, "end": {"1": 6, "2": 5}}
    ours = multi_batch_iou(THRS, outputs, targets, **kw)
    ref = jvos.multi_batch_iou(jvos.THRS, outputs, targets, **kw)
    assert ours.shape == (2, 4)
    np.testing.assert_array_equal(ours, ref)


def _make_vot(root):
    base = root / "VOT2018"
    for video, cols in (("ball", 4), ("car", 8)):
        (base / video / "color").mkdir(parents=True)
        for f in range(3):
            (base / video / "color" / f"{f:08d}.jpg").write_bytes(b"")
        gt = np.random.RandomState(len(video)).uniform(10, 90, size=(3, cols))
        np.savetxt(base / video / "groundtruth.txt", gt, delimiter=",", fmt="%.4f")
    (base / "list.txt").write_text("ball\ncar\n")


def _assert_same(ours, ref):
    if isinstance(ref, dict):
        assert list(ours) == list(ref)
        for k in ref:
            _assert_same(ours[k], ref[k])
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(ours, ref)
    else:
        assert ours == ref


@pytest.mark.parametrize("dataset", ["DAVIS2016", "DAVIS2017", "ytb_vos", "VOT2018"])
def test_load_dataset_matches_jax(tmp_path, dataset):
    if dataset.startswith("DAVIS"):
        _make_davis(tmp_path / "DAVIS")
    elif dataset == "ytb_vos":
        _make_ytb_vos_valid(tmp_path)
    else:
        _make_vot(tmp_path)
    ours = load_dataset(dataset, str(tmp_path))
    ref = jdatasets.load_dataset(dataset, str(tmp_path))
    assert ours and len(ours) == len(ref)
    _assert_same(ours, ref)


def test_vos_sequential(setup, tmp_path):
    data_dir, runtime, jruntime = setup
    video = load_dataset("DAVIS2017", str(data_dir))["synth"]
    assert len(video["image_files"]) == 4 and len(video["anno_files"]) == 4
    iou, fps, fused = _against_jax(track_vos, jvos.track_vos, runtime, jruntime, video,
                                   tmp_path, "DAVIS2017", mot_enable=True)
    assert iou.shape == (2, 4)  # 2 objects x 4 thresholds
    assert np.all((iou >= 0) & (iou <= 1)) and fps > 0
    assert all((f == k).any() for f in fused[1:] for k in (1, 2))  # both objects tracked


def test_vos_batched_matches_protocol(setup, tmp_path):
    data_dir, runtime, jruntime = setup
    video = load_dataset("DAVIS2017", str(data_dir))["synth"]
    lines = []
    # per-frame driver (ragged tail: 3 frames < the default scan_chunk)
    iou_b, _, _ = _against_jax(track_vos_batched, jvos.track_vos_batched, runtime, jruntime,
                               video, tmp_path, "DAVIS2017", mot_enable=True)
    assert iou_b.shape == (2, 4)
    assert np.all((iou_b >= 0) & (iou_b <= 1))
    track_vos_batched(runtime, video, mot_enable=True, log=lines.append)
    assert len(lines) == 2 * 4 + 1 and "(batched x2)" in lines[-1]
    # a full 3-frame window through track_video_multi agrees
    iou_s, _ = track_vos_batched(runtime, video, mot_enable=True, log=_quiet, scan_chunk=3)
    np.testing.assert_allclose(np.asarray(iou_s), iou_b, rtol=1e-4, atol=1e-5)


def test_vos_save_mask(setup, tmp_path):
    data_dir, runtime, jruntime = setup
    video = load_dataset("DAVIS2016", str(data_dir))["synth"]
    _, _, fused = _against_jax(track_vos, jvos.track_vos, runtime, jruntime, video, tmp_path,
                               "DAVIS2016", mot_enable=False)
    assert len(fused) == 4
    assert fused[0].shape == (120, 160)


def test_vos_batched_ranged_objects(setup, tmp_path):
    """Streams are masked before their start, re-initialised from the
    annotation at their start frame, and the scan-window placement does not
    change the result; the sequential and batched drivers each match JAX's."""
    _, runtime, jruntime = setup
    _make_ytb_vos_valid(tmp_path)
    video = load_dataset("ytb_vos", str(tmp_path))["vid"]
    assert video["start_frame"] == {"1": 0, "2": 2}

    iou_seq, _, _ = _against_jax(track_vos, jvos.track_vos, runtime, jruntime, video,
                                 tmp_path / "seq", "ytb_vos", mot_enable=True)
    iou_b, _, fused = _against_jax(track_vos_batched, jvos.track_vos_batched, runtime,
                                   jruntime, video, tmp_path / "batched", "ytb_vos",
                                   mot_enable=True)
    assert iou_b.shape == iou_seq.shape == (2, 4)
    assert np.all((iou_b >= 0) & (iou_b <= 1))

    # a 2-frame scan chunk puts the windows across the segment cuts differently
    iou_b2, _ = track_vos_batched(runtime, video, mot_enable=True, log=_quiet, scan_chunk=2)
    np.testing.assert_allclose(np.asarray(iou_b2), iou_b, rtol=1e-4, atol=1e-5)

    # object 2 is absent before its start frame and exactly its annotation there
    assert not (fused[0] == 2).any() and not (fused[1] == 2).any()
    gt2 = np.array(Image.open(tmp_path / "ytb_vos" / "valid" / "Annotations" / "vid"
                              / "00010.png")) == 2
    assert (fused[2][gt2] == 2).all()
