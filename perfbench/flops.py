"""Operations and bytes of the benchmark's configurations, from shapes alone.

``track_flops`` and ``train_flops`` count the dense conv and matrix-product
FLOPs (2 per multiply-add) of one tracking frame of SiamMask-sharp and of one
stage-1 training sample of SiamMask-base, walking the published layer list
(``perfbench/reference/model.py`` holds the same network as code). The
depthwise cross-correlation is not in them (it is a grouped conv of 1 channel
a group, a few MFLOP); ``xcorr_bytes`` gives its least traffic instead. The
counts do not depend on what the program runs, so a change to the program
cannot move its own yardstick.

Training counts, per conv, the forward; the weight gradient where the
weight trains; the input gradient where anything before it trains.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def _out(n, k, stride, pad, dil=1):
    return (n + 2 * pad - dil * (k - 1) - 1) // stride + 1


class Walk:
    """Convs as (cin, cout, k, output side, batch, trains, needs input grad)."""

    def __init__(self):
        self.convs: list[tuple] = []

    def conv(self, cin, cout, k, n, stride=1, pad=0, dil=1, batch=1, trains=False,
             dgrad=False):
        m = _out(n, k, stride, pad, dil)
        self.convs.append((cin, cout, k, m * m, batch, trains, dgrad))
        return m

    def matmul(self, rows, inner, cols, trains=False, dgrad=False):
        self.convs.append((inner, cols, 1, 1, rows, trains, dgrad))

    def forward(self) -> int:
        return sum(2 * cin * cout * k * k * hw * b for cin, cout, k, hw, b, _, _ in self.convs)

    def training(self) -> int:
        total = 0
        for cin, cout, k, hw, b, trains, dgrad in self.convs:
            one = 2 * cin * cout * k * k * hw * b
            total += one * (1 + int(trains) + int(dgrad))
        return total


def backbone(walk: Walk, n: int, width: int, batch: int = 1, train: bool = False) -> int:
    """ResNet-50 layers 1-3 of the tracking variant on an n x n input;
    returns the side of p3. ``train``: the unfrozen phase (layer2/3 train)."""
    w = width
    n = walk.conv(3, w, 7, n, 2, 0, batch=batch)
    n = _out(n, 3, 2, 1)
    cin = w
    for layer, planes, blocks, stride, dil in ((1, w, 3, 1, 1), (2, 2 * w, 4, 2, 1),
                                               (3, 4 * w, 6, 1, 2)):
        trains = train and layer > 1
        for i in range(blocks):
            first = i == 0
            s = stride if first else 1
            d = 1 if (first and layer == 3) else dil
            pad = d if d > 1 else 2 - s
            # the input gradient of a block's first convs: only past layer2's first block
            din = trains and not (layer == 2 and first)
            m = walk.conv(cin, planes, 1, n, batch=batch, trains=trains, dgrad=din)
            m = walk.conv(planes, planes, 3, m, s, pad, d, batch=batch, trains=trains,
                          dgrad=trains)
            walk.conv(planes, 4 * planes, 1, m, batch=batch, trains=trains, dgrad=trains)
            if first:
                dk, dpad = ((1, 0) if layer == 1 else (3, 0) if layer == 2 else (3, 1))
                walk.conv(cin, 4 * planes, dk, n, s, dpad, batch=batch, trains=trains,
                          dgrad=din)
            n, cin = m, 4 * planes
    return n


def neck(walk: Walk, n: int, width: int, batch: int = 1, train: bool = False) -> int:
    walk.conv(16 * width, 4 * width, 1, n, batch=batch, trains=train, dgrad=train)
    return n - 8 if n < 20 else n


def depthcorr(walk: Walk, zn: int, xn: int, c: int, out: int | None, batch: int = 1,
              train: bool = False) -> None:
    """The kernel and search convs, and the head (``out`` channels) unless
    None; the xcorr between them is not counted."""
    kz = walk.conv(c, c, 3, zn, batch=batch, trains=train, dgrad=train)
    kx = walk.conv(c, c, 3, xn, batch=batch, trains=train, dgrad=train)
    if out is not None:
        m = kx - kz + 1
        walk.conv(c, c, 1, m, batch=batch, trains=train, dgrad=train)
        walk.conv(c, out, 1, m, batch=batch, trains=train, dgrad=train)


def refine(walk: Walk, width: int, batch: int = 1) -> None:
    """Refine at one cell per sample: the deconv's product, the v/h blocks
    and the three post convs."""
    w = width
    walk.matmul(batch, 4 * w, 32 * 15 * 15)
    for cin, mid, out, n in ((32, 32, 32, 15), (8 * w, 128, 32, 15),      # h2, v2
                             (16, 16, 16, 31), (4 * w, 64, 16, 31),       # h1, v1
                             (4, 4, 4, 61), (w, 16, 4, 61)):              # h0, v0
        walk.conv(cin, mid, 3, n, 1, 1, batch=batch)
        walk.conv(mid, out, 3, n, 1, 1, batch=batch)
    for cin, cout, n in ((32, 16, 31), (16, 4, 61), (4, 1, 127)):
        walk.conv(cin, cout, 3, n, 1, 1, batch=batch)


def track_walk(width: int = 64, anchor_num: int = 5) -> Walk:
    """One SiamMask-sharp frame: the search pass (255), the neck, the cls and
    loc heads, the mask branch's corr, Refine at the chosen cell. The
    template's 7x7 features are the state; its kernel convs run each frame."""
    walk = Walk()
    xn = neck(walk, backbone(walk, 255, width), width)
    c = 4 * width
    depthcorr(walk, 7, xn, c, 2 * anchor_num)
    depthcorr(walk, 7, xn, c, 4 * anchor_num)
    depthcorr(walk, 7, xn, c, None)
    refine(walk, width)
    return walk


def train_walk(width: int = 64, batch: int = 1, anchor_num: int = 5) -> Walk:
    """One SiamMask-base stage-1 step of the unfrozen phase at ``batch``:
    template (127) and search (255) through the backbone and neck, the three
    heads (the mask head to 63*63 channels)."""
    walk = Walk()
    zn = neck(walk, backbone(walk, 127, width, batch, True), width, batch, True)
    xn = neck(walk, backbone(walk, 255, width, batch, True), width, batch, True)
    c = 4 * width
    for out in (2 * anchor_num, 4 * anchor_num, 63 * 63):
        depthcorr(walk, zn, xn, c, out, batch, True)
    return walk


def track_flops(width: int = 64) -> int:
    """Dense FLOPs of one tracked object-frame."""
    return track_walk(width).forward()


def train_flops(width: int = 64) -> int:
    """Dense FLOPs of one training sample (the step at batch B is B times it)."""
    return train_walk(width, 1).training()


def xcorr_bytes(batch: int, c: int, search: int = 29, template: int = 5,
                elem: int = 2) -> dict:
    """Least bytes of the three xcorr passes of one head at ``batch``: each
    input read once and the output written once (bf16 by default)."""
    out = search - template + 1
    x = batch * search * search * c * elem
    k = batch * template * template * c * elem
    o = batch * out * out * c * elem
    return {"forward": x + k + o, "grad_input": o + k + x, "grad_kernel": x + o + k}


def xcorr_train_least_s(batch: int, width: int = 64, heads: int = 3) -> float:
    """Least seconds of a training step's xcorr work on the card: every
    head's forward, grad-input and grad-kernel at the HBM rate (the FLOPs,
    2 B C 25^2 5^2 a pass, take ~0.5 us at the bf16 peak and do not bind)."""
    per_head = sum(xcorr_bytes(batch, 4 * width).values())
    flops = 3 * 2 * batch * 4 * width * 25 * 25 * 25
    return heads * max(per_head / PEAK_HBM_BYTES, flops / PEAK_BF16_FLOPS)

