"""FLOPs of SAM 2.1 video tracking, from the published shapes alone
(``perfbench/reference/sam2.py`` holds the same network as code; the
configuration's keys, ``reference.sam2.model_config``): 2 per multiply-add,
dense products and convolutions only (no softmax, norms, resizes).

A frame is one pass of the image encoder (Hiera, the FPN laterals and the
decoder's two skip convs, shared by every object) and, per object, memory
attention over a full bank, the mask decoder and the memory encoder (its
projection of the image features, the same for every object, counted once
a frame). Windowed attention counts its zero-padded windows, as they are
computed. The counts do not depend on what the program runs, so a change
to the program cannot move its own yardstick.
"""
from __future__ import annotations

import re

from perfbench.reference.sam2 import model_config

# the attention kernels the program's ``ops/attention.py`` pins on the card:
# FlashAttention-2's forward kernels, named with their head width, and
# cuDNN's fused SDPA forward kernels (memory attention's, head width 256)
FLASH_TRAITS = re.compile(r"flash_fwd\w*kernel.*?Flash_fwd_kernel_traits<\s*(\d+)\s*,")
CUDNN_SDPA = re.compile(r"cudnn\w*_sdpa_\w*fprop")


def attention_seconds(ops: dict, head_width: int | None = None) -> float:
    """Device seconds among a trace's ``ops`` {name: s} of the
    FlashAttention forward kernels of ``head_width``, or, with None, of
    cuDNN's fused attention kernels."""
    total = 0.0
    for name, s in ops.items():
        if head_width is None:
            total += s if CUDNN_SDPA.search(name) else 0.0
            continue
        m = FLASH_TRAITS.search(name)
        if m and int(m.group(1)) == head_width:
            total += s
    return total


def _hiera(c: dict) -> dict:
    """{"dense", "attn"} FLOPs of the trunk on one image; "attn" is the
    attention's QK and PV alone."""
    side = c["image_size"] // 4
    e = c["embed_dim"]
    dense = 2 * side * side * 3 * 49 * e               # patch embed
    attn = 0
    stages = c["stages"]
    ends = [sum(stages[:i]) - 1 for i in range(1, len(stages) + 1)]
    pools = [x + 1 for x in ends[:-1]]
    dim, stage = e, 0
    for i in range(sum(stages)):
        window = 0 if i in c["global_att_blocks"] else c["window_spec"][stage]
        out = dim
        if i - 1 in ends:
            out, stage = 2 * dim, stage + 1
        pool = i in pools
        if window:
            padded = -(-side // window) * window
            windows = (padded // window) ** 2
            keys = window * window
            queries = keys // 4 if pool else keys
        else:
            windows, keys = 1, side * side
            queries = keys // 4 if pool else keys
        tokens = windows * keys                        # the qkv input, padded
        after = side // 2 if pool else side
        dense += 2 * tokens * dim * 3 * out            # qkv
        dense += 2 * windows * queries * out * out     # proj
        if out != dim:
            dense += 2 * side * side * dim * out       # the shortcut's proj
        dense += 2 * 2 * after * after * out * 4 * out     # MLP
        attn += 2 * 2 * windows * queries * keys * out     # QK and PV, all heads
        dim, side = out, after
    return {"dense": dense + attn, "attn": attn}


def encoder_flops(cfg: dict) -> dict:
    """One frame's image encoder: {"total", "attn"} (Hiera's attention QK
    and PV)."""
    c = model_config(cfg)
    h = _hiera(c)
    d, s = c["d_model"], c["image_size"] // 4
    neck = sum(2 * (s >> k) ** 2 * c["embed_dim"] * 2 ** k * d for k in range(4))
    skips = 2 * s * s * d * d // 8 + 2 * (s // 2) ** 2 * d * d // 4
    shared = 2 * (s // 4) ** 2 * d * d            # the memory encoder's pix_feat_proj
    return {"total": h["dense"] + neck + skips + shared, "attn": h["attn"]}


def bank_keys(cfg: dict) -> int:
    """Keys of a full bank: the memory frames' tokens and the pointers'."""
    c = model_config(cfg)
    n = (c["image_size"] // 16) ** 2
    return c["num_maskmem"] * n + c["max_obj_ptrs"] * c["d_model"] // c["mem_dim"]


def memattn_flops(cfg: dict) -> dict:
    """One object-frame's memory attention over a full bank: {"total",
    "qkpv"} (the self- and cross-attention's QK and PV alone)."""
    c = model_config(cfg)
    d, m, ffn = c["d_model"], c["mem_dim"], c["memattn_ffn"]
    n, k = (c["image_size"] // 16) ** 2, bank_keys(cfg)
    qkpv = 2 * 2 * n * n * d + 2 * 2 * n * k * d
    per_layer = (4 * 2 * n * d * d          # self q, k, v, out
                 + 2 * 2 * n * d * d        # cross q, out
                 + 2 * 2 * k * m * d        # cross k, v from the memory's width
                 + 2 * 2 * n * d * ffn)     # FFN
    layers = c["memattn_layers"]
    ptr_pos = 2 * c["max_obj_ptrs"] * d * m
    return {"total": layers * (per_layer + qkpv) + ptr_pos, "qkpv": layers * qkpv}


def object_flops(cfg: dict) -> int:
    """One object-frame's mask decoder, pointer and memory encoder."""
    c = model_config(cfg)
    d, s = c["d_model"], c["image_size"] // 16
    n, tokens, half, mlp = s * s, 8, c["d_model"] // 2, c["decoder_mlp"]
    t2i = 2 * (tokens * d * half + 2 * n * d * half + tokens * half * d) \
        + 2 * 2 * tokens * n * half
    i2t = 2 * (n * d * half + 2 * tokens * d * half + n * half * d) \
        + 2 * 2 * n * tokens * half
    self_attn = 2 * 4 * tokens * d * d + 2 * 2 * tokens * tokens * d
    decoder = 2 * (self_attn + t2i + 2 * tokens * d * mlp * 2 + i2t) + t2i
    decoder += 2 * n * d * (d // 4) * 4 + 2 * (2 * s) ** 2 * (d // 4) * (d // 8) * 4
    decoder += 2 * 4 * (d // 8) * (4 * s) ** 2                       # masks
    decoder += 2 * 4 * (2 * d * d + d * d // 8) + 2 * (2 * d * d + d * 4) \
        + 2 * (2 * d * d + d) + 2 * 3 * d * d                       # MLP heads, pointer
    memory = 0
    side, ch = c["image_size"], 1
    for _ in range(4):
        side //= 2
        memory += 2 * side * side * ch * 4 * ch * 9
        ch *= 4
    memory += 2 * n * ch * d
    memory += 2 * (2 * n * d * 49 + 2 * 2 * n * d * 4 * d)         # two CXBlocks
    memory += 2 * n * d * c["mem_dim"]
    return decoder + memory


def step_flops(cfg: dict, objects: int) -> float:
    """Dense FLOPs of one object-frame at a full bank, the encoder's share
    divided among ``objects``."""
    return encoder_flops(cfg)["total"] / objects + memattn_flops(cfg)["total"] \
        + object_flops(cfg)
