"""The whole tracking step's share of the card's bf16 peak: the
configuration's dense FLOPs an object-frame, counted from shapes
(``perfbench/flops.py``), times the window's object-frames a second."""
from perfbench import flops


def read(run):
    if run.cell.ctx.device.type != "cuda":
        return None
    per = flops.track_flops(run.cell.ctx.config["width"])
    return 100.0 * per * run.result["track_fps"] / flops.PEAK_BF16_FLOPS
