"""The whole SAM 2 step's share of the card's bf16 peak: the dense FLOPs of
an object-frame at a full bank, counted from the published shapes
(``perfbench/flops_sam2.py``: the image encoder's divided among the
objects, memory attention, the mask decoder and the memory encoder), times
the cell's object-frames a second."""
from perfbench import flops, flops_sam2


def read(run):
    ctx = run.cell.ctx
    if ctx.device.type != "cuda" or "vos_fps" not in run.result:
        return None
    per = flops_sam2.step_flops(ctx.config, ctx.traffic["objects"])
    return 100.0 * per * run.result["vos_fps"] / flops.PEAK_BF16_FLOPS
