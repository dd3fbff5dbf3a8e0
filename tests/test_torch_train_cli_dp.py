"""The port's train CLI on the CPU at width 8 (SiamMask-base, a global
batch of 2 on the synthetic crop dataset, 2 steps an epoch), alone and on
two gloo ranks (``--num-devices 2 --device cpu``): one checkpoint an epoch,
written by rank 0, and a run resumed from the first epoch's checkpoint
(across the unfreeze boundary) that draws the JAX CLI's pairs: its epoch's
pick is the JAX package's ``PairDataset`` pick after the JAX CLI's first
shuffle on the same seed (the data's shuffle starts anew on resume, as the
JAX CLI's does), and two resumes of one checkpoint end bit-identical. The
lone run stands inside a one-task SLURM job with no MASTER_ADDR /
MASTER_PORT, which trains as it does outside one. ``--num-devices`` beyond
the visible cards raises."""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from siammask_tpu.config import Config as JaxConfig
from siammask_tpu.data.dataset import PairDataset as JaxPairDataset
from siammask_tpu_torch.data.dataset import PairDataset
from siammask_tpu_torch.parallel import dist as port_dist
from siammask_tpu_torch.tools import train as train_cli
from siammask_tpu_torch.train.checkpoint import load_checkpoint

import _torch_dp
from test_torch_checkpoint import WIDTH, _cli_config
from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)


def _run(config, save_dir, epochs, devices, *extra):
    return train_cli.main(["--config", config, "--task", "base", "--epochs", str(epochs),
                           "--save-dir", str(save_dir), "--batch", "2", "--workers", "0",
                           "--width", str(WIDTH), "--log-interval", "1", "--seed", "3",
                           "--device", "cpu", "--num-devices", str(devices), *extra])


def _record_picks(monkeypatch, devices, out_dir):
    """Every rank writes each pick its dataset shuffles to ``out_dir``
    (``_torch_dp.recording_shuffle``): in this process, or in the spawned
    ranks."""
    if devices == 1:
        monkeypatch.setattr(PairDataset, "shuffle", _torch_dp.recording_shuffle(out_dir, 0))
        return
    spawn = port_dist.spawn
    monkeypatch.setattr(train_cli, "spawn", lambda fn, world, device_type, *args: spawn(
        _torch_dp.train_recording_picks, world, device_type, *args, str(out_dir)))


def _environment(monkeypatch, devices):
    """No torchrun group; one process inside a one-task SLURM job, or
    ``devices`` ranks spawned outside one."""
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    if devices == 1:
        monkeypatch.setenv("SLURM_NTASKS", "1")
        monkeypatch.setenv("SLURM_PROCID", "0")
    else:
        monkeypatch.delenv("SLURM_NTASKS", raising=False)


@pytest.mark.parametrize("devices", [1, 2], ids=["one_process_in_slurm", "two_ranks"])
def test_resume_bit_identical(tmp_path, monkeypatch, devices):
    _environment(monkeypatch, devices)
    config = _cli_config(tmp_path, "siammask_base/config.json", 255)
    first = _run(config, tmp_path / "cut", 1, devices)
    assert not dist.is_initialized()
    assert sorted(p.name for p in (tmp_path / "cut").iterdir()) == ["checkpoint_e1.pth"]
    assert all(np.isfinite(v) for v in first.values()) and first["skipped"] == 0.0

    runs = []
    for name in ("resumed", "again"):
        shutil.copytree(tmp_path / "cut", tmp_path / name)
        picks = tmp_path / f"picks_{name}"
        picks.mkdir()
        monkeypatch.undo()
        _environment(monkeypatch, devices)
        _record_picks(monkeypatch, devices, picks)
        metrics = _run(config, tmp_path / name, 2, devices, "--resume",
                       str(tmp_path / name / "checkpoint_e1.pth"))
        assert all(np.isfinite(v) for v in metrics.values()) and metrics["skipped"] == 0.0
        ck = load_checkpoint(str(tmp_path / name / "checkpoint_e2.pth"))
        assert ck["epoch"] == 2
        runs.append((metrics, ck["state_dict"], picks))

    # the JAX CLI's dataset on the same seed: built (its first shuffle),
    # then shuffled once more as the CLI's epoch loop starts
    jax_cfg = JaxConfig.load(config, clip=10.0)
    jax_ds = JaxPairDataset(jax_cfg.train_datasets, jax_cfg.anchors, num_epoch=1, seed=3)
    jax_ds.shuffle()
    for _, _, picks in runs:
        for rank in range(devices):
            drawn = [json.loads(p.read_text()) for p in
                     sorted(Path(picks).glob(f"rank{rank}_*.json"))]
            assert [d["generation"] for d in drawn] == [1, 2]
            assert drawn[-1]["pick"] == jax_ds.pick
    (ours, state, _), (again, state_again, _) = runs
    assert ours == again
    for k, v in state.items():
        assert torch.equal(state_again[k], v), k


def test_more_devices_than_cards_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    config = _cli_config(tmp_path, "siammask_base/config.json", 255)
    with pytest.raises(RuntimeError, match="cards are visible"):
        train_cli.main(["--config", config, "--num-devices", "2", "--device", "cuda",
                        "--save-dir", str(tmp_path)])
