"""The port's train CLI on the CPU at width 8 (SiamMask-base, a global
batch of 2 on the synthetic crop dataset, 2 steps an epoch), alone and on
two gloo ranks (``--num-devices 2 --device cpu``): one checkpoint an epoch,
written by rank 0, and a run resumed from the first epoch's checkpoint
(across the unfreeze boundary) ends bit-identical to the uninterrupted
two-epoch run, the data's shuffle fast-forwarded. The lone run stands
inside a one-task SLURM job with no MASTER_ADDR / MASTER_PORT, which trains
as it does outside one. ``--num-devices`` beyond the visible cards
raises."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from siammask_tpu_torch.tools import train as train_cli
from siammask_tpu_torch.train.checkpoint import load_checkpoint

from test_torch_checkpoint import WIDTH, _cli_config
from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)


def _run(config, save_dir, epochs, devices, *extra):
    return train_cli.main(["--config", config, "--task", "base", "--epochs", str(epochs),
                           "--save-dir", str(save_dir), "--batch", "2", "--workers", "0",
                           "--width", str(WIDTH), "--log-interval", "1", "--seed", "3",
                           "--device", "cpu", "--num-devices", str(devices), *extra])


@pytest.mark.parametrize("devices", [1, 2], ids=["one_process_in_slurm", "two_ranks"])
def test_resume_bit_identical(tmp_path, monkeypatch, devices):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    if devices == 1:
        monkeypatch.setenv("SLURM_NTASKS", "1")
        monkeypatch.setenv("SLURM_PROCID", "0")
    else:
        monkeypatch.delenv("SLURM_NTASKS", raising=False)
    config = _cli_config(tmp_path, "siammask_base/config.json", 255)
    whole = _run(config, tmp_path / "whole", 2, devices)
    assert not dist.is_initialized()
    assert all(np.isfinite(v) for v in whole.values()) and whole["skipped"] == 0.0
    assert sorted(p.name for p in (tmp_path / "whole").iterdir()) == [
        "checkpoint_e1.pth", "checkpoint_e2.pth"]

    first = _run(config, tmp_path / "cut", 1, devices)
    assert sorted(p.name for p in (tmp_path / "cut").iterdir()) == ["checkpoint_e1.pth"]
    assert all(np.isfinite(v) for v in first.values())
    resumed = _run(config, tmp_path / "cut", 2, devices, "--resume",
                   str(tmp_path / "cut" / "checkpoint_e1.pth"))
    assert resumed == whole
    ours = load_checkpoint(str(tmp_path / "cut" / "checkpoint_e2.pth"))
    ref = load_checkpoint(str(tmp_path / "whole" / "checkpoint_e2.pth"))
    assert ours["epoch"] == ref["epoch"] == 2
    for k, v in ref["state_dict"].items():
        assert torch.equal(ours["state_dict"][k], v), k


def test_more_devices_than_cards_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    config = _cli_config(tmp_path, "siammask_base/config.json", 255)
    with pytest.raises(RuntimeError, match="cards are visible"):
        train_cli.main(["--config", config, "--num-devices", "2", "--device", "cuda",
                        "--save-dir", str(tmp_path)])
