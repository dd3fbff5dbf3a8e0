"""FLOPs of TransT tracking, from the published shapes alone
(``perfbench/reference/transt.py`` holds the same network as code; the
configuration's keys, ``reference.transt.model_config``): 2 per
multiply-add, dense products and convolutions only (no softmax, norms,
pooling, sigmoid).

An object-frame is one search crop through the backbone (ResNet-50 to
layer3, torchvision's padding) and the input projection, the fusion
network over the template's tokens (kept from init) and the search's, the
decoder and the two heads. The template's backbone runs once, at init, and
is not in it. The counts do not depend on what the program runs, so a
change to the program cannot move its own yardstick.
"""
from __future__ import annotations

import re

from perfbench.flops import _out
from perfbench.reference.transt import model_config

# FlashAttention-2's forward kernels of a head width, split-KV or not
FLASH_TRAITS = re.compile(r"flash_fwd\w*kernel.*?Flash_fwd_kernel_traits<\s*(\d+)\s*,")


def attention_seconds(ops: dict, head_width: int) -> float:
    """Device seconds among a trace's ``ops`` {name: s} of FlashAttention-2's
    forward kernels of ``head_width``."""
    total = 0.0
    for name, s in ops.items():
        m = FLASH_TRAITS.search(name)
        if m and int(m.group(1)) == head_width:
            total += s
    return total


def head_width(cfg: dict) -> int:
    c = model_config(cfg)
    return c["d_model"] // c["heads"]


def attn_calls(cfg: dict) -> int:
    """Attentions of a step: four a fusion layer, one in the decoder."""
    return 4 * model_config(cfg)["fusion_layers"] + 1


def backbone_flops(cfg: dict, size: int) -> int:
    """ResNet-50 to layer3 at stride 8 on a ``size`` x ``size`` image."""
    w = model_config(cfg)["width"]
    n = _out(size, 7, 2, 3)
    flops = 2 * n * n * 3 * w * 49
    n = _out(n, 3, 2, 1)                        # the max pool
    cin = w
    for planes, blocks, stride, dil in ((w, 3, 1, 1), (2 * w, 4, 2, 1), (4 * w, 6, 1, 2)):
        for i in range(blocks):
            s = stride if i == 0 else 1
            m = _out(n, 3, s, dil, dil)
            flops += 2 * n * n * cin * planes              # conv1
            flops += 2 * m * m * planes * planes * 9       # conv2
            flops += 2 * m * m * planes * 4 * planes       # conv3
            if i == 0:
                flops += 2 * m * m * cin * 4 * planes      # downsample
            cin, n = 4 * planes, m
    return flops


def fusion_flops(cfg: dict) -> dict:
    """The fusion network and decoder of one object-frame: {"total",
    "attn"} ("attn": the attentions' QK and PV products alone)."""
    c = model_config(cfg)
    d, ffn = c["d_model"], c["ffn"]
    nt, ns = (c["template_size"] // 8) ** 2, (c["search_size"] // 8) ** 2

    def attention(nq, nk):          # projections, QK and PV
        proj = 2 * 2 * nq * d * d + 2 * 2 * nk * d * d
        return proj, 2 * 2 * nq * nk * d

    def ffn_(n):
        return 2 * 2 * n * d * ffn

    dense = attn = 0
    for nq, nk in [(nt, nt), (ns, ns), (nt, ns), (ns, nt)] * c["fusion_layers"] + [(ns, nt)]:
        proj, qkpv = attention(nq, nk)
        dense, attn = dense + proj, attn + qkpv
    dense += c["fusion_layers"] * (ffn_(nt) + ffn_(ns)) + ffn_(ns)
    return {"total": dense + attn, "attn": attn}


def step_flops(cfg: dict) -> int:
    """Dense FLOPs of one object-frame (module docstring)."""
    c = model_config(cfg)
    d, ns = c["d_model"], (c["search_size"] // 8) ** 2
    proj = 2 * ns * 16 * c["width"] * d
    heads = 2 * ns * (2 * d * d + 2 * d) + 2 * ns * (2 * d * d + 4 * d)
    return backbone_flops(cfg, c["search_size"]) + proj + fusion_flops(cfg)["total"] + heads
