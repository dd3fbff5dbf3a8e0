"""The port's meters and logging helpers (``utils/meters.py``,
``utils/log.py``) against the JAX package's: ``AverageMeter`` and
``IouMeter`` give the same values on seeded inputs; the logger prints the
same progress line once per call site; the rank comes from
``torch.distributed`` once a process group is up, else ``SLURM_PROCID``,
and a non-zero rank drops INFO but keeps WARNING.
"""
import logging
import socket

import numpy as np
import pytest
import torch.distributed as dist

from siammask_tpu.utils import log as jlog
from siammask_tpu.utils import meters as jmeters
from siammask_tpu_torch.utils import log, meters

from test_torch_tracker import one_torch_thread  # noqa: F401  (autouse)


def test_average_meter_matches_jax():
    rng = np.random.RandomState(0)
    ours, ref = meters.AverageMeter(), jmeters.AverageMeter()
    for _ in range(20):
        batch, values = int(rng.randint(1, 9)), {"loss": rng.rand(), "acc": rng.rand()}
        ours.update(batch=batch, **values)
        ref.update(batch=batch, **values)
    for k in ("loss", "acc"):
        a, b = getattr(ours, k), getattr(ref, k)
        assert (a.val, a.avg, a.sum) == (b.val, b.avg, b.sum)
        assert f"{a:.3f}" == f"{b:.3f}"
    assert repr(ours) == repr(ref)
    with pytest.raises(AttributeError):
        ours.missing


@pytest.mark.parametrize("stat", ["mean", "median", "@0.5", "@0.8"])
def test_iou_meter_matches_jax(stat):
    rng = np.random.RandomState(1)
    thrs = [0.3, 0.5, 0.7]
    ours, ref = meters.IouMeter(thrs, sz=8), jmeters.IouMeter(thrs, sz=8)
    for i in range(10):                       # two past the size are dropped
        output = rng.rand(24, 32)
        target = (rng.rand(24, 32) > 0.5) if i % 4 else np.zeros((24, 32))
        ours.add(output, target)
        ref.add(output, target)
    assert ours.n == ref.n == 8
    np.testing.assert_array_equal(ours.value(stat), ref.value(stat))
    with pytest.raises(ValueError):
        ours.value("max")


def test_log_helpers_match_jax(capsys):
    printed = []
    for name, mod in (("torch_logger_a", log), ("jax_logger_a", jlog)):
        logger = mod.init_log(name)
        assert mod.init_log(name) is logger       # one handler, however often
        logger.info("hello")
        mod.print_speed(10, 0.5, 100, name)
        for _ in range(3):
            mod.log_once("only once", name)
        printed.append([line.split("] ", 1)[1] for line in capsys.readouterr().out.splitlines()])
    assert printed[0] == printed[1] == [
        "hello", "Progress: 10 / 100 [10.0%], Speed: 0.500 s/iter, ETA 0:00:00 (D:H:M)",
        "only once"]


def test_rank_from_slurm_and_the_rank_filter(monkeypatch, capsys):
    monkeypatch.setenv("SLURM_PROCID", "3")
    assert log.get_rank() == 3
    logger = log.init_log("torch_logger_rank")
    logger.info("dropped on rank 3")
    logger.warning("kept on rank 3")
    out = capsys.readouterr().out
    assert "dropped" not in out and "kept on rank 3" in out and "-rk3-" in out
    monkeypatch.delenv("SLURM_PROCID")
    assert log.get_rank() == 0


def test_rank_from_torch_distributed(monkeypatch):
    monkeypatch.setenv("SLURM_PROCID", "5")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        assert log.get_rank() == 0
    finally:
        dist.destroy_process_group()
    assert log.get_rank() == 5


def test_file_handler(tmp_path):
    path = tmp_path / "run.log"
    log.add_file_handler("torch_logger_file", str(path))
    logger = logging.getLogger("torch_logger_file")
    logger.setLevel(logging.DEBUG)
    logger.debug("to the file")
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    assert "to the file" in path.read_text()
