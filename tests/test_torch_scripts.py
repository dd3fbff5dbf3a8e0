"""``scripts/*_torch.sh``, the PyTorch port's orchestration scripts, run
from a copy of the repo's layout with a stand-in ``python`` on ``PATH``
that records each call: the port's CLIs (``python -m
siammask_tpu_torch.tools.*``) with the JAX scripts' arguments, the caller's
flags passed on, and ``test_all_torch.sh`` looping over the
``checkpoint_e{N}.pth`` files there are. The JAX scripts are not touched."""
import os
import shutil
import subprocess
from pathlib import Path

import pytest

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


def _run(tmp_path: Path, script: str, *args: str, env: dict | None = None) -> list[str]:
    """The calls of ``python`` that ``script`` makes, one line each."""
    (tmp_path / "scripts").mkdir(exist_ok=True)
    shutil.copy(SCRIPTS / script, tmp_path / "scripts" / script)
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    log = tmp_path / "calls.log"
    (bin_dir / "python").write_text(f'#!/bin/sh\necho "$*" >> {log}\n')
    (bin_dir / "python").chmod(0o755)
    run_env = {**os.environ, "PATH": f"{bin_dir}:{os.environ['PATH']}", **(env or {})}
    subprocess.run(["bash", str(tmp_path / "scripts" / script), *args], check=True,
                   env=run_env, timeout=60)
    return log.read_text().splitlines()


@pytest.mark.parametrize("script, args, expected", [
    ("train_base_torch.sh", ["--device", "cpu"],
     "-m siammask_tpu_torch.tools.train --config experiments/siammask_base/config.json --task "
     "base --epochs 20 --batch 64 --save-dir snapshot --tb-dir board --device cpu"),
    ("train_refine_torch.sh", ["snapshot/checkpoint_e20.pth", "--device", "cpu"],
     "-m siammask_tpu_torch.tools.train --config experiments/siammask_sharp/config.json --task "
     "sharp_refine --epochs 20 --batch 64 --save-dir snapshot_refine --pretrained "
     "snapshot/checkpoint_e20.pth --tb-dir board --device cpu"),
    ("tune_torch.sh", ["--resume", "a.pth", "--device", "cpu"],
     "-m siammask_tpu_torch.tools.tune --config experiments/siammask_sharp/config_vot18.json "
     "--dataset VOT2018 --resume a.pth --device cpu"),
])
def test_script_calls_the_port_cli(tmp_path, script, args, expected):
    assert _run(tmp_path, script, *args) == [expected]


def test_test_all_loops_over_the_pth_checkpoints(tmp_path):
    """Only the epochs with a ``.pth`` are tested (a ``.msgpack`` of the JAX
    package is not), each with the caller's flags; then one eval."""
    (tmp_path / "snapshot").mkdir()
    for name in ("checkpoint_e1.pth", "checkpoint_e3.pth", "checkpoint_e2.msgpack"):
        (tmp_path / "snapshot" / name).write_bytes(b"")
    calls = _run(tmp_path, "test_all_torch.sh", "--device", "cpu", env={"DATASET": "VOT2016"})
    test = ("-m siammask_tpu_torch.tools.test --config experiments/siammask_sharp/"
            "config_vot18.json --resume snapshot/checkpoint_e{0}.pth --mask --refine --dataset "
            "VOT2016 --tracker-name ckpt_e{0} --device cpu")
    assert calls == [test.format(1), test.format(3),
                     "-m siammask_tpu_torch.tools.eval --dataset VOT2016 --result-dir test "
                     "--tracker-prefix ckpt_"]
