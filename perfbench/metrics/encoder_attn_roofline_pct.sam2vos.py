"""Hiera's attention's share of its roofline in the profiled stretch: the
least time of its QK and PV products (windowed and global,
``flops_sam2.encoder_flops``, once a frame, at the card's bf16 peak) over
the device time of the kernels that run them: the FlashAttention kernels of
head width 64 (Hiera's 56, rounded up by the kernel) that
``ops/attention.py`` launches, ``Flash_fwd_kernel_traits<64, ...``. None
where the stretch has none."""
from perfbench import flops, flops_sam2


def read(run):
    if run.trace is None or not run.units:
        return None
    spent = flops_sam2.attention_seconds(run.trace["ops"], 64)
    if not spent:
        return None
    ctx = run.cell.ctx
    frames = run.units / ctx.traffic["objects"]
    least = flops_sam2.encoder_flops(ctx.config)["attn"] * frames
    return 100.0 * least / flops.PEAK_BF16_FLOPS / spent
