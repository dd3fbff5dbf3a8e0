"""Memory attention's share of its roofline in the profiled stretch: the
least time of its QK and PV products (every layer's self- and
cross-attention over a full bank, ``flops_sam2.memattn_flops``, at the
card's bf16 peak) over the device time of the kernels that run them:
cuDNN's fused attention kernels (``cudnn_generated_fort_native_sdpa_...
fprop...``), which ``ops/attention.py`` launches for head width 256, a
width only memory attention has. None where the stretch has none."""
from perfbench import flops, flops_sam2


def read(run):
    if run.trace is None or not run.units:
        return None
    spent = flops_sam2.attention_seconds(run.trace["ops"])
    if not spent:
        return None
    least = flops_sam2.memattn_flops(run.cell.ctx.config)["qkpv"] * run.units
    return 100.0 * least / flops.PEAK_BF16_FLOPS / spent
