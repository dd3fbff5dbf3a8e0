"""The port's tune and eval CLIs (``tools/tune.py``, ``tools/eval.py``) on the
CPU: ``run_grid``'s claim protocol as ``test_tune_protocol.py`` checks the
JAX one (two processes sharing a grid, the finish.flag poison pill); the
eval CLI's VOT, DAVIS and ytb_vos tables against the JAX CLI's, in one
process and through its pool; ``tune.main`` over a VOT grid (two cells at
255 and one at 271) whose recorded EAOs the eval CLI reproduces, a re-run
that scores nothing, and a VOS grid held to the JAX driver's IoUs. The
models are seeded, BN-calibrated width-8 SiamMask-sharp models, handed to
``tune.main`` in place of the published-width model it loads.
"""
import importlib.util
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from siammask_tpu.config import Config as JaxConfig
from siammask_tpu.models.siammask import SiamMaskSharp as JaxSiamMaskSharp
from siammask_tpu.tracker import vos as jvos
from siammask_tpu.tracker.runtime import TrackerRuntime as JaxTrackerRuntime
from siammask_tpu.utils.torch_convert import convert_state_dict
from siammask_tpu_torch.eval.datasets import load_dataset
from siammask_tpu_torch.models.siammask import SiamMaskSharp
from siammask_tpu_torch.tools import eval as eval_cli
from siammask_tpu_torch.tools import tune
from siammask_tpu_torch.utils import bbox

from _torch_weights import damp_box_head
from test_torch_eval import VOT_CONFIG, write_random_vot_tree
from test_torch_families import calibrated
from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)
from test_torch_vot import FRAMES, _make_jump_dataset
from test_vos_e2e import _make_davis, _make_ytb_vos_valid
from test_ytb_vos_eval import _make_ytb_vos

REPO = Path(__file__).resolve().parents[1]
DAVIS_CONFIG = REPO / "experiments" / "siammask_sharp" / "config_davis.json"


def _quiet(*_):
    pass


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", str(REPO / "tools" / f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------- the claim protocol ----------------

def test_two_processes_share_one_grid(tmp_path):
    grid = list(range(10))
    scored = []

    def score(cell):
        scored.append(cell)
        return cell * 2

    # "process" A scores the even cells only (the odd ones claimed by B)
    for c in grid[1::2]:
        (tmp_path / f"{c}.txt").write_text("Occ")
    assert tune.run_grid(grid, str(tmp_path), str, score, log=_quiet) == 5
    assert scored == grid[0::2]
    scored.clear()
    assert tune.run_grid(grid, str(tmp_path), str, score, log=_quiet) == 0 and scored == []
    assert (tmp_path / "0.txt").read_text() == "0 score 0\n"
    assert (tmp_path / "1.txt").read_text() == "Occ"
    # the JAX tool writes the same files over the same claims
    ref = tmp_path / "jax"
    ref.mkdir()
    for c in grid[1::2]:
        (ref / f"{c}.txt").write_text("Occ")
    assert _jax_tool("tune").run_grid(grid, str(ref), str, lambda c: c * 2, log=_quiet) == 5
    for c in grid:
        assert (tmp_path / f"{c}.txt").read_text() == (ref / f"{c}.txt").read_text()


def test_finish_flag_poison_pill(tmp_path):
    (tmp_path / "finish.flag").write_text("")
    lines = []
    assert tune.run_grid([1, 2, 3], str(tmp_path), str, lambda c: c, log=lines.append) == 0
    assert lines == ["finish.flag present — stopping"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["finish.flag"]


# ---------------- the eval CLI against JAX's ----------------

def _jax_eval(monkeypatch, capsys, args):
    monkeypatch.setattr(sys, "argv", ["eval.py", *args])
    _jax_tool("eval").main()
    return capsys.readouterr().out


def _layout(kind, root):
    """A dataset of ``kind`` under ``root/data`` and two trackers' results
    under ``root/test``; returns the CLI's common arguments."""
    data, res = root / "data", root / "test"
    if kind == "VOT2018":
        write_random_vot_tree(root / "vot", seed=7, trackers=(("boxes", False, 1),
                                                              ("masks", True, 1),
                                                              ("repeats", True, 15)))
        return ["--dataset", "VOT2018", "--dataset-dir", str(root / "vot"),
                "--result-dir", str(root / "vot" / "results")]
    if kind == "DAVIS2017":
        _make_davis(data / "DAVIS", n_frames=6)
        video = load_dataset(kind, str(data))["synth"]
        annos = [np.array(Image.open(f)) for f in video["anno_files"]]
    else:
        _make_ytb_vos(data)
        video = load_dataset(kind, str(data))["vidA"]
        annos = [np.array(Image.open(f)) for f in video["anno_files"]]
    for tracker, shift in (("perfect", 0), ("shifted", 6)):
        out = res / kind / tracker / video["name"]
        out.mkdir(parents=True)
        for f, a in zip(video["anno_files"], annos):
            Image.fromarray(np.roll(a, shift, axis=1)).save(out / Path(f).name)
    return ["--dataset", kind, "--dataset-dir", str(data), "--result-dir", str(res)]


@pytest.mark.parametrize("kind", ["VOT2018", "DAVIS2017", "ytb_vos"])
def test_eval_cli_tables_match_jax(kind, tmp_path, monkeypatch, capsys):
    """The same table as the JAX CLI, one process and a pool of two; the
    returned summary is the table's."""
    args = _layout(kind, tmp_path)
    ref = _jax_eval(monkeypatch, capsys, [*args, "--num", "1"])
    summaries = []
    for num in ("1", "2"):
        summaries.append(eval_cli.main([*args, "--num", num]))
        assert capsys.readouterr().out == ref
    assert summaries[0] == summaries[1] and len(summaries[0]) in (2, 3)
    if kind == "VOT2018":
        assert all(0 < s["eao"] < 1 and s["lost_number"] > 0 for s in summaries[0].values())
    else:
        key = "J_mean" if kind.startswith("DAVIS") else "J_seen"
        assert summaries[0]["perfect"][key] == 1.0 > summaries[0]["shifted"][key]
    assert eval_cli.main([*args, "--tracker-prefix", "none"]) == {}


# ---------------- tune.main ----------------

@pytest.fixture(scope="module")
def vot_model(tmp_path_factory):
    """The two forced-jump videos of ``test_torch_vot.py`` and a seeded
    width-8 sharp model calibrated on the first, its box head damped."""
    data_dir = tmp_path_factory.mktemp("tune_vot")
    _make_jump_dataset(data_dir / "VOT2018")
    video = load_dataset("VOT2018", str(data_dir))["vid0"]
    cx, cy, _, _ = bbox.get_axis_aligned_bbox(video["gt"][0])
    model = calibrated(SiamMaskSharp, cv2.imread(video["image_files"][0]),
                       np.array([cx, cy], np.float32))
    damp_box_head(model)
    return data_dir, model


def _use_model(monkeypatch, model):
    monkeypatch.setattr(tune, "load_model", lambda arch, anchor_num, resume, device: model)


def test_tune_vot_grid_scored_by_the_eval_cli(vot_model, tmp_path, monkeypatch, capsys):
    data_dir, model = vot_model
    _use_model(monkeypatch, model)
    out = tmp_path / "tune"
    common = ["--config", str(VOT_CONFIG), "--dataset", "VOT2018", "--data-dir", str(data_dir),
              "--out-dir", str(out), "--window-influence", "0.42,0.425,0.01",
              "--eao-interval", f"1,{FRAMES}", "--device", "cpu"]
    grid = ["--penalty-k", "0.04,0.13,0.08", "--lr", "0.30,0.31,0.15"]
    first = tune.main([*common, *grid])
    wide = tune.main([*common, "--penalty-k", "0.04,0.05,0.08", "--lr", "0.30,0.31,0.15",
                      "--search-region", "271,272,16"])
    again = tune.main([*common, *grid])
    assert (first["scored"], wide["scored"], again["scored"]) == (2, 1, 0)
    cells = first["cells"] + wide["cells"]
    assert sorted(c["tag"] for c in cells) == ["pk0.04_wi0.42_lr0.3_in255",
                                              "pk0.04_wi0.42_lr0.3_in271",
                                              "pk0.12_wi0.42_lr0.3_in255"]
    for c in cells:
        assert 0 < c["score"] <= 1 and c["seconds"] > 0 and c["fps"] > 0
        assert (out / f"{c['tag']}.txt").read_text() == f"{c['tag']} score {c['score']}\n"
    capsys.readouterr()
    summary = eval_cli.main(["--dataset", "VOT2018", "--dataset-dir", str(data_dir),
                             "--result-dir", str(out / "results"), "--eao-interval",
                             f"1,{FRAMES}", "--num", "1"])
    assert {t: s["eao"] for t, s in summary.items()} == {c["tag"]: c["score"] for c in cells}
    assert all(s["lost_number"] >= 1 for s in summary.values())    # vid1's forced jump
    assert "pk0.12_wi0.42_lr0.3_in255" in capsys.readouterr().out


def test_tune_vos_grid_matches_the_jax_driver(tmp_path, monkeypatch):
    """Two seg_thr cells over a ytb_vos layout: each score is the mean over
    videos of the video's mean IoU, as JAX's tune takes it from its driver
    (``track_vos``) on the same weights and hp."""
    _make_ytb_vos_valid(tmp_path / "data")
    video = load_dataset("ytb_vos", str(tmp_path / "data"))["vid"]
    frame = cv2.imread(video["image_files"][0])
    model = calibrated(SiamMaskSharp, frame, np.array([42.0, 40.0], np.float32))
    _use_model(monkeypatch, model)
    result = tune.main(["--config", str(DAVIS_CONFIG), "--dataset", "ytb_vos", "--data-dir",
                        str(tmp_path / "data"), "--out-dir", str(tmp_path / "tune"),
                        "--penalty-k", "0.04,0.05,0.08", "--window-influence", "0.42,0.425,0.01",
                        "--lr", "0.30,0.31,0.15", "--seg-thr", "0.30,0.41,0.10",
                        "--device", "cpu"])
    assert result["scored"] == 2
    variables = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    cfg = JaxConfig.load(str(DAVIS_CONFIG))
    for cell in result["cells"]:
        thr = float(cell["tag"].split("_thr")[1])
        hp = {**cfg.hp, "penalty_k": 0.04, "window_influence": 0.42, "lr": 0.3,
              "instance_size": 255, "seg_thr": thr}
        runtime = JaxTrackerRuntime(JaxSiamMaskSharp(width=model.width), variables,
                                    cfg.tracker_config().update(hp), latency_lowerings=False)
        iou, _ = jvos.track_vos(runtime, video, mot_enable=True, log=_quiet)
        assert abs(cell["score"] - float(np.mean(iou))) <= 1e-4, cell
        assert 0 <= cell["score"] <= 1


def test_tune_on_cuda_without_a_card_raises(vot_model, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-only behaviour cannot show")
    data_dir, _ = vot_model
    with pytest.raises((RuntimeError, AssertionError)):
        tune.main(["--config", str(VOT_CONFIG), "--dataset", "VOT2018", "--data-dir",
                   str(data_dir), "--out-dir", str(tmp_path / "tune")])
    assert not (tmp_path / "tune").exists()
