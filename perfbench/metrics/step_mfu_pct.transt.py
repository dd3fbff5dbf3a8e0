"""The whole TransT step's share of the card's bf16 peak: the dense FLOPs
of an object-frame, counted from the published shapes
(``perfbench/flops_transt.py``: the search backbone and projection, the
fusion network, the decoder and the heads), times the cell's object-frames
a second."""
from perfbench import flops, flops_transt


def read(run):
    ctx = run.cell.ctx
    if ctx.device.type != "cuda" or "vos_fps" not in run.result:
        return None
    return 100.0 * flops_transt.step_flops(ctx.config) * run.result["vos_fps"] \
        / flops.PEAK_BF16_FLOPS
