"""The port's training-data tools against the JAX package's: ``tools/
curves.py`` reads the log of the port's own train CLI (a two-epoch CPU run
on the synthetic crop511 set) into one row per epoch with the JAX tool's
metric keys, and still gives exactly the committed
``stage2_e24_curve.json`` on ``stage2_e24.log``; ``tools/visualize.py``
draws the same overlays as the JAX tool. The train CLI's ``--tb-dir``
writes each log line's scalars to a TensorBoard event file, and without
``tensorboardX`` raises before it trains.
"""
import importlib.util
import json
import logging
import struct
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from siammask_tpu_torch.tools import curves, train, visualize

from test_checkpoint_prep import _make_crop_dataset
from test_torch_checkpoint import WIDTH, _cli_config
from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
LOGS = REPO / "experiments" / "overfit_tennis" / "logs"


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", str(REPO / "tools" / f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_curves_read_the_port_train_log(tmp_path):
    """Two epochs of 2 steps, a line a step, written to a file as the CLI
    logs them: one row per epoch, the JAX tool's rows and keys."""
    path = tmp_path / "train.log"
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger = logging.getLogger("train")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        train.main(["--config", _cli_config(tmp_path, "siammask_base/config.json", 255),
                    "--task", "base", "--epochs", "2", "--batch", "2", "--workers", "0",
                    "--width", str(WIDTH), "--log-interval", "1", "--seed", "3",
                    "--save-dir", str(tmp_path / "snap"), "--device", "cpu"])
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
        handler.close()
    assert " lr/" in path.read_text()
    rows = curves.parse(str(path))
    assert [r["epoch"] for r in rows] == [0, 1]
    assert [r["steps_logged"] for r in rows] == [2, 2]
    committed = json.loads((LOGS / "stage2_e24_curve.json").read_text())
    assert all(set(r) == set(committed[0]) for r in rows)
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert rows == _jax_tool("curves").parse(str(path))
    assert curves.main([str(path), "--json", str(tmp_path / "rows.json")]) == rows
    assert json.loads((tmp_path / "rows.json").read_text()) == rows


def test_curves_reproduce_the_committed_artifact():
    rows = curves.parse(str(LOGS / "stage2_e24.log"))
    assert len(rows) == 24
    assert rows == json.loads((LOGS / "stage2_e24_curve.json").read_text())


def test_visualize_draws_the_jax_overlays(tmp_path, monkeypatch, capsys):
    root, anno = _make_crop_dataset(tmp_path, n_videos=2, n_frames=2)
    args = ["--root", root, "--anno", anno, "--num", "5", "--seed", "1"]
    assert visualize.main([*args, "--out-dir", str(tmp_path / "ours")]) == 5
    monkeypatch.setattr(sys, "argv", ["visualize.py", *args, "--out-dir", str(tmp_path / "jax")])
    _jax_tool("visualize").main()
    assert capsys.readouterr().out.count("wrote") == 10
    ours = sorted((tmp_path / "ours").iterdir())
    assert [p.name for p in ours] == sorted(p.name for p in (tmp_path / "jax").iterdir())
    for p in ours:
        np.testing.assert_array_equal(cv2.imread(str(p)), cv2.imread(str(tmp_path / "jax" / p.name)))


def _event_scalars(path: Path) -> dict:
    """{tag: [(step, value)]} of the scalars in a TensorBoard event file
    (TFRecord framing: length, its CRC, the ``Event`` proto, its CRC)."""
    from tensorboardX.proto.event_pb2 import Event

    data, out, at = path.read_bytes(), {}, 0
    while at < len(data):
        (n,) = struct.unpack_from("<Q", data, at)
        event = Event.FromString(data[at + 12:at + 12 + n])
        at += 12 + n + 4
        for v in event.summary.value:
            out.setdefault(v.tag, []).append((event.step, v.simple_value))
    return out


def test_train_cli_tb_dir_writes_the_log_lines_scalars(tmp_path):
    """One epoch of 2 steps, a line a step, with ``--tb-dir``: one event
    file whose scalars are each line's metrics, ``lr`` and the groups'
    rates, at steps 1 and 2, equal to the returned last step's."""
    metrics = train.main(["--config", _cli_config(tmp_path, "siammask_base/config.json", 255),
                          "--task", "base", "--epochs", "1", "--batch", "2", "--workers", "0",
                          "--width", str(WIDTH), "--log-interval", "1", "--seed", "3",
                          "--save-dir", str(tmp_path / "snap"), "--device", "cpu",
                          "--tb-dir", str(tmp_path / "board")])
    files = list((tmp_path / "board").glob("events.out.tfevents.*"))
    assert len(files) == 1
    scalars = _event_scalars(files[0])
    assert set(scalars) == {*metrics, "lr", "lr/neck", "lr/rpn", "lr/mask"}
    assert all([s for s, _ in v] == [1, 2] for v in scalars.values())
    for k, v in metrics.items():
        assert scalars[k][-1][1] == pytest.approx(v, rel=1e-6), k


def test_train_cli_tb_dir_without_tensorboardx_raises_first(tmp_path, monkeypatch):
    """Without the package, ``--tb-dir`` raises ImportError before anything
    else: the config (here a missing file) is not read, nothing trains."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    with pytest.raises(ImportError, match="--tb-dir needs the tensorboardX package"):
        train.main(["--config", str(tmp_path / "missing.json"), "--device", "cpu",
                    "--save-dir", str(tmp_path / "snap"), "--tb-dir", str(tmp_path / "board")])
    assert not (tmp_path / "snap").exists() and not (tmp_path / "board").exists()
