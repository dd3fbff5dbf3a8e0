"""Logging: a named logger with rank-aware filtering and a progress ETA
(reference `utils/log_helper.py`).

Counterpart of ``siammask_tpu/utils/log.py``. The rank is
``torch.distributed.get_rank()`` once a process group is initialised, else
``SLURM_PROCID`` (the reference's filter); non-zero ranks drop INFO. torch is
imported inside ``get_rank``, so the module imports without it.
"""
from __future__ import annotations

import logging
import math
import os
import sys

_logged_once: set = set()


def get_rank() -> int:
    try:
        import torch.distributed as dist
    except ImportError:
        dist = None
    if dist is not None and dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("SLURM_PROCID", 0))


class _RankFilter(logging.Filter):
    def filter(self, record):
        return get_rank() == 0 or record.levelno >= logging.WARNING


def init_log(name: str = "siammask_tpu_torch", level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(
        f"[%(asctime)s-rk{get_rank()}-%(filename)s#%(lineno)3d] %(message)s"))
    handler.addFilter(_RankFilter())
    logger.addHandler(handler)
    return logger


def add_file_handler(name: str, path: str, level=logging.DEBUG):
    logger = logging.getLogger(name)
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(
        f"[%(asctime)s-rk{get_rank()}-%(filename)s#%(lineno)3d] %(message)s"))
    logger.addHandler(handler)


def print_speed(i: int, i_time: float, n: int, logger_name: str = "siammask_tpu_torch"):
    """Progress + ETA line (log_helper.py:89-97)."""
    logger = logging.getLogger(logger_name)
    average_time = i_time
    remaining_time = (n - i) * average_time
    remaining_day = math.floor(remaining_time / 86400)
    remaining_hour = math.floor((remaining_time - remaining_day * 86400) / 3600)
    remaining_min = math.floor((remaining_time - remaining_day * 86400
                                - remaining_hour * 3600) / 60)
    logger.info(f"Progress: {i} / {n} [{i / n * 100:.1f}%], "
                f"Speed: {average_time:.3f} s/iter, ETA {remaining_day:d}:"
                f"{remaining_hour:02d}:{remaining_min:02d} (D:H:M)")


def log_once(msg: str, logger_name: str = "siammask_tpu_torch"):
    """Log a message only once per call site (log_helper.py:124-143)."""
    import inspect
    frame = inspect.currentframe().f_back
    site = (frame.f_code.co_filename, frame.f_lineno)
    if site not in _logged_once:
        _logged_once.add(site)
        logging.getLogger(logger_name).info(msg)
