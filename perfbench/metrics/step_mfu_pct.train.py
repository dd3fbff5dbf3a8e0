"""The whole training step's share of the cards' bf16 peak: the
configuration's dense FLOPs a sample, counted from shapes
(``perfbench/flops.py``), times the window's samples a second, over the
peak of every card used."""
from perfbench import flops


def read(run):
    ctx = run.cell.ctx
    if ctx.device.type != "cuda":
        return None
    per = flops.train_flops(ctx.config["width"])
    return 100.0 * per * run.result["train_sps"] / (flops.PEAK_BF16_FLOPS * ctx.chips)
