"""The xcorr's share of its roofline in the profiled training steps: the
least time of the work (every head's forward, grad-input and grad-kernel,
its bytes from the shapes read and written once at the HBM rate,
``flops.xcorr_train_least_s``) over the device time of the kernels that do
it (by name, ``depthwise_xcorr``)."""
from perfbench import flops


def read(run):
    if run.trace is None or not run.units:
        return None
    spent = run.trace["categories"].get("xcorr")
    if not spent:
        return None
    ctx = run.cell.ctx
    batch = ctx.traffic["batch"] // ctx.chips
    least = flops.xcorr_train_least_s(batch, ctx.config["width"]) * run.units
    return 100.0 * least / spent
