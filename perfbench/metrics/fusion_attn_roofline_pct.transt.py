"""TransT's attention's share of its roofline in the profiled stretch: the
least time of the QK and PV products of a step's 17 attentions (the four
of each fusion layer and the decoder's, ``flops_transt.fusion_flops``, an
object-frame, at the card's bf16 peak) over the device time of the kernels
that run them: FlashAttention-2's of head width 32, which
``ops/attention.py`` launches for TransT's heads, ``Flash_fwd_kernel_traits<
32, ...``. None where the stretch has none, or where the program's step
does not run the attentions the count assumes (``transt.attn_calls`` of one
eager step, read in set-up)."""
from perfbench import flops, flops_transt


def read(run):
    if run.trace is None or not run.units:
        return None
    cfg = run.cell.ctx.config
    if getattr(run.cell, "attn_calls", None) != flops_transt.attn_calls(cfg):
        return None
    spent = flops_transt.attention_seconds(run.trace["ops"], flops_transt.head_width(cfg))
    if not spent:
        return None
    least = flops_transt.fusion_flops(cfg)["attn"] * run.units
    return 100.0 * least / flops.PEAK_BF16_FLOPS / spent
