"""Plain TransT-N4 for tracking: the ResNet-50 backbone cut after layer3
(torchvision's padding, layer3 at stride 1 with dilation-2 3x3s), the input
projection, DETR's sine positions, four feature-fusion layers (ECA on each
stream, CFA both ways, the FFNs; post-norm), the decoder's CFA and norm, the
classifier and box heads, and one step of the published tracker
(chenxin-dlut/TransT ``ltr/models/tracking/transt.py``,
``featurefusion_network.py``, ``pysot_toolkit/trackers/tracker.py``), as
functions of a flat dict of tensors under the published checkpoint's names.

Only ``torch`` is used, and nothing of the program under test. Every
attention is written out (the scores, their softmax and the weighted sum);
``nn.MultiheadAttention``'s packed ``in_proj_weight`` is sliced into q, k
and v. The crop is the SiamMask reference's (``tracker.crop``): the same
``get_subwindow`` with the frame's channel means as the border.

``TransTRef(p, cfg, precision)``: ``precision`` "fp32" computes in the
weights' dtype (float32 with TF32 off, ``model.fp32_exact``; float64 in the
CPU tests); "fp8" holds every map that the program holds in bf16 in float8
e4m3, one scale a tensor: each conv's and linear's operands and result,
each attention's output, each LayerNorm's output. ``calibrate``: while set,
the first call of each BatchNorm sets its running mean to 0 and its running
variance to the mean square of its input, one number a layer (the harness's
weight recipe).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.model import BN_EPS, _RoundFp8
from perfbench.reference.tracker import crop

# TransT-N4 (``TransTConfig`` of the program holds the same keys)
DEFAULTS = {"width": 64, "d_model": 256, "heads": 8, "ffn": 2048, "fusion_layers": 4,
            "template_size": 128, "search_size": 256}
# the published tracker's settings (the program reads them from ``hp``)
TRACKER = {"template_factor": 2.0, "search_factor": 4.0, "window_influence": 0.49}
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
MIN_SIDE = 10.0
LN_EPS = 1e-5


def model_config(cfg: dict) -> dict:
    """The model's keys of a configuration, the published values where it
    names none."""
    return {k: cfg.get(k, v) for k, v in DEFAULTS.items()}


# ------------------------------------------------------------------ names


def _bn(s, prefix, c):
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        s[f"{prefix}.{leaf}"] = (c,)
    s[f"{prefix}.num_batches_tracked"] = ()


def spec(cfg: dict) -> dict:
    """name -> shape of every parameter and buffer, in the program's
    ``state_dict`` order."""
    c = model_config(cfg)
    w, d, ffn = c["width"], c["d_model"], c["ffn"]
    s: dict = {}
    b = "backbone.0.body"
    s[f"{b}.conv1.weight"] = (w, 3, 7, 7)
    _bn(s, f"{b}.bn1", w)
    cin = w
    for layer, planes, blocks in ((1, w, 3), (2, 2 * w, 4), (3, 4 * w, 6)):
        for i in range(blocks):
            n = f"{b}.layer{layer}.{i}"
            s[f"{n}.conv1.weight"] = (planes, cin, 1, 1)
            _bn(s, f"{n}.bn1", planes)
            s[f"{n}.conv2.weight"] = (planes, planes, 3, 3)
            _bn(s, f"{n}.bn2", planes)
            s[f"{n}.conv3.weight"] = (4 * planes, planes, 1, 1)
            _bn(s, f"{n}.bn3", 4 * planes)
            if i == 0:
                s[f"{n}.downsample.0.weight"] = (4 * planes, cin, 1, 1)
                _bn(s, f"{n}.downsample.1", 4 * planes)
            cin = 4 * planes
    s["input_proj.weight"] = (d, cin, 1, 1)
    s["input_proj.bias"] = (d,)

    def attn(name):
        s[f"{name}.in_proj_weight"] = (3 * d, d)
        s[f"{name}.in_proj_bias"] = (3 * d,)
        s[f"{name}.out_proj.weight"] = (d, d)
        s[f"{name}.out_proj.bias"] = (d,)

    def lin(name, din, dout):
        s[f"{name}.weight"] = (dout, din)
        s[f"{name}.bias"] = (dout,)

    def norm(name):
        s[f"{name}.weight"] = (d,)
        s[f"{name}.bias"] = (d,)

    f = "featurefusion_network"
    for i in range(c["fusion_layers"]):
        n = f"{f}.encoder.layers.{i}"
        for a in ("self_attn1", "self_attn2", "multihead_attn1", "multihead_attn2"):
            attn(f"{n}.{a}")
        for k in (1, 2):
            lin(f"{n}.linear{k}1", d, ffn)
            lin(f"{n}.linear{k}2", ffn, d)
            for j in (1, 2, 3):
                norm(f"{n}.norm{k}{j}")
    n = f"{f}.decoder.layers.0"
    attn(f"{n}.multihead_attn")
    lin(f"{n}.linear1", d, ffn)
    lin(f"{n}.linear2", ffn, d)
    norm(f"{n}.norm1")
    norm(f"{n}.norm2")
    norm(f"{f}.decoder.norm")
    for head, out in (("class_embed", 2), ("bbox_embed", 4)):
        lin(f"{head}.layers.0", d, d)
        lin(f"{head}.layers.1", d, d)
        lin(f"{head}.layers.2", d, out)
    return s


@torch.no_grad()
def init_weights(cfg: dict, generator: torch.Generator, device,
                 dtype=torch.float32) -> dict:
    """Seeded weights, drawn tensor by tensor in ``spec`` order: convs
    normal with variance 1/fan_in, BatchNorm the identity, the fusion
    network's matrices Xavier-uniform (the published ``_reset_parameters``),
    the heads' uniform in +-1/sqrt(fan_in), every bias 0, LayerNorms 1 and
    0."""
    p = {}
    for name, shape in spec(cfg).items():
        t = torch.zeros(shape, device=device, dtype=dtype)
        leaf = name.rsplit(".", 1)[1]
        if len(shape) == 4:
            t.normal_(0.0, 1.0 / math.sqrt(math.prod(shape[1:])), generator=generator)
        elif len(shape) == 2 and name.startswith("featurefusion_network"):
            bound = math.sqrt(6.0 / (shape[0] + shape[1]))
            t.uniform_(-bound, bound, generator=generator)
        elif len(shape) == 2:
            bound = 1.0 / math.sqrt(shape[1])
            t.uniform_(-bound, bound, generator=generator)
        elif name.endswith("num_batches_tracked"):
            t = torch.zeros((), dtype=torch.int64, device=device)
        elif leaf in ("running_var", "weight"):
            t.fill_(1.0)
        p[name] = t
    return p


def sine_positions(d: int, side: int, device, dtype) -> torch.Tensor:
    """DETR's ``PositionEmbeddingSine(d / 2, normalize=True)`` on a side x
    side grid with no padding: (side * side, d), row-major tokens, the y
    half first, each half's features (sin, cos) interleaved."""
    half = d // 2
    steps = torch.arange(1, side + 1, device=device, dtype=dtype) / (side + 1e-6) * (2 * math.pi)
    dim_t = 10000.0 ** (2 * (torch.arange(half, device=device, dtype=dtype) // 2) / half)
    e = steps[:, None] / dim_t                                   # (side, half)
    e = torch.stack((e[:, 0::2].sin(), e[:, 1::2].cos()), dim=2).flatten(1)
    y = e[:, None, :].expand(side, side, half)
    x = e[None, :, :].expand(side, side, half)
    return torch.cat((y, x), dim=2).reshape(side * side, d)


# ------------------------------------------------------------ the model


class TransTRef:
    """The weights ``p`` and how to compute (module docstring)."""

    def __init__(self, p: dict, cfg: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.p = p
        self.c = model_config(cfg)
        self.precision = precision
        self.dtype = p["input_proj.weight"].dtype
        self.device = p["input_proj.weight"].device
        self.calibrate = False
        self._calibrated: set = set()

    def q(self, x):
        return _RoundFp8.apply(x) if self.precision == "fp8" else x

    # -- primitives

    def conv(self, x, name, stride=1, padding=0, dilation=1, bias=False):
        b = self.p[f"{name}.bias"] if bias else None
        return self.q(F.conv2d(self.q(x), self.q(self.p[f"{name}.weight"]), b, stride, padding,
                               dilation))

    def bn(self, x, name):
        p = self.p
        rm, rv = p[f"{name}.running_mean"], p[f"{name}.running_var"]
        if self.calibrate and name not in self._calibrated:
            self._calibrated.add(name)
            rm.zero_()
            rv.fill_(x.pow(2).mean())
        scale = torch.rsqrt(rv + BN_EPS) * p[f"{name}.weight"]
        return (x - rm[:, None, None]) * scale[:, None, None] + p[f"{name}.bias"][:, None, None]

    def lin(self, x, name, weight=None, bias=None):
        w = self.p[f"{name}.weight"] if weight is None else weight
        b = self.p[f"{name}.bias"] if bias is None else bias
        return self.q(F.linear(self.q(x), self.q(w), b))

    def ln(self, x, name):
        return self.q(F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"],
                                   self.p[f"{name}.bias"], LN_EPS))

    def mlp(self, x, name):
        for i in range(3):
            x = self.lin(x, f"{name}.layers.{i}")
            if i < 2:
                x = F.relu(x)
        return x

    # -- backbone

    def bottleneck(self, x, name, stride, dilation, downsample):
        residual = x
        if downsample:
            residual = self.bn(self.conv(x, f"{name}.downsample.0", stride),
                               f"{name}.downsample.1")
        out = F.relu(self.bn(self.conv(x, f"{name}.conv1"), f"{name}.bn1"))
        out = F.relu(self.bn(self.conv(out, f"{name}.conv2", stride, dilation, dilation),
                             f"{name}.bn2"))
        out = self.bn(self.conv(out, f"{name}.conv3"), f"{name}.bn3")
        return F.relu(out + residual)

    def backbone(self, x):
        """Normalised images (B, 3, H, W) -> layer3's map (B, 16 w, H/8, W/8)."""
        b = "backbone.0.body"
        x = F.relu(self.bn(self.conv(x, f"{b}.conv1", 2, 3), f"{b}.bn1"))
        x = F.max_pool2d(x, 3, 2, 1)
        for layer, blocks, stride, dilation in ((1, 3, 1, 1), (2, 4, 2, 1), (3, 6, 1, 2)):
            for i in range(blocks):
                x = self.bottleneck(x, f"{b}.layer{layer}.{i}", stride if i == 0 else 1,
                                    dilation, i == 0)
        return x

    @staticmethod
    def preprocess(crops):
        """(B, 3, S, S) float32 crops of 0..255 pixels -> ``/ 255``, less the
        ImageNet mean, over its std, in float32."""
        mean = torch.tensor(MEAN, device=crops.device)[:, None, None]
        std = torch.tensor(STD, device=crops.device)[:, None, None]
        return (crops * (1.0 / 255.0) - mean) / std

    def features(self, crops):
        """(B, 3, S, S) crops -> projected tokens (B, N, d)."""
        x = self.preprocess(crops).to(self.dtype)
        f = self.conv(self.backbone(x), "input_proj", bias=True)
        return f.flatten(2).transpose(1, 2)

    def positions(self, side: int):
        return sine_positions(self.c["d_model"], side, self.device, self.dtype)

    # -- fusion

    def attend(self, q, k, v):
        """softmax(q k^T / sqrt(d)) v over (..., N, d), written out."""
        a = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1]), dim=-1)
        return self.q(a @ v)

    def mha(self, name, x, px, m, pm, probe: list | None = None):
        """``nn.MultiheadAttention`` over queries ``x + px``, keys ``m + pm``,
        values ``m``; ``probe`` gets the attention logits' spread."""
        d, h = self.c["d_model"], self.c["heads"]
        w, b = self.p[f"{name}.in_proj_weight"], self.p[f"{name}.in_proj_bias"]

        def split(t):
            return t.reshape(*t.shape[:-1], h, d // h).transpose(-2, -3)

        q = split(self.lin(x + px, name, w[:d], b[:d]))
        k = split(self.lin(m + pm, name, w[d:2 * d], b[d:2 * d]))
        v = split(self.lin(m, name, w[2 * d:], b[2 * d:]))
        if probe is not None:
            probe.append(float(((q @ k.transpose(-1, -2)) / math.sqrt(d // h)).std()))
        o = self.attend(q, k, v).transpose(-2, -3)
        return self.lin(o.reshape(*o.shape[:-2], d), f"{name}.out_proj")

    def ffn(self, x, first, second, norm):
        return self.ln(x + self.lin(F.relu(self.lin(x, first)), second), norm)

    def fusion_layer(self, i, t, s, pt, ps, probe: list | None = None):
        n = f"featurefusion_network.encoder.layers.{i}"
        t = self.ln(t + self.mha(f"{n}.self_attn1", t, pt, t, pt, probe), f"{n}.norm11")
        s = self.ln(s + self.mha(f"{n}.self_attn2", s, ps, s, ps, probe), f"{n}.norm21")
        t2 = self.mha(f"{n}.multihead_attn1", t, pt, s, ps, probe)
        s2 = self.mha(f"{n}.multihead_attn2", s, ps, t, pt, probe)
        t = self.ffn(self.ln(t + t2, f"{n}.norm12"), f"{n}.linear11", f"{n}.linear12",
                     f"{n}.norm13")
        s = self.ffn(self.ln(s + s2, f"{n}.norm22"), f"{n}.linear21", f"{n}.linear22",
                     f"{n}.norm23")
        return t, s

    def decoder(self, s, t, ps, pt, probe: list | None = None):
        n = "featurefusion_network.decoder"
        s = self.ln(s + self.mha(f"{n}.layers.0.multihead_attn", s, ps, t, pt, probe),
                    f"{n}.layers.0.norm1")
        s = self.ffn(s, f"{n}.layers.0.linear1", f"{n}.layers.0.linear2", f"{n}.layers.0.norm2")
        return self.ln(s, f"{n}.norm")

    def fuse(self, zt, xs, probe: list | None = None):
        """Template tokens (B, Nt, d) and search tokens (B, Ns, d) -> the
        decoded search tokens (B, Ns, d)."""
        c = self.c
        pt, ps = self.positions(c["template_size"] // 8), self.positions(c["search_size"] // 8)
        t, s = zt, xs
        for i in range(c["fusion_layers"]):
            t, s = self.fusion_layer(i, t, s, pt, ps, probe)
        return self.decoder(s, t, ps, pt, probe)

    def heads(self, hs):
        """(class logits (B, Ns, 2), boxes (B, Ns, 4) after the sigmoid)."""
        return self.mlp(hs, "class_embed"), torch.sigmoid(self.mlp(hs, "bbox_embed"))

    def template(self, z_crops):
        return self.features(z_crops)

    def track(self, zt, x_crops):
        return self.heads(self.fuse(zt, self.features(x_crops)))


# ---------------------------------------------------------------- tracking


def crop_side(sz: torch.Tensor, factor: float) -> torch.Tensor:
    """(O,) the published ``ceil(sqrt(w_c h_c))``, ``w_c = w + (factor - 1)
    (w + h) / 2``."""
    extra = (factor - 1) * (sz[:, 0] + sz[:, 1]) / 2
    return torch.ceil(torch.sqrt((sz[:, 0] + extra) * (sz[:, 1] + extra)))


def hann_window(side: int) -> np.ndarray:
    return np.outer(np.hanning(side), np.hanning(side)).ravel().astype(np.float32)


class Template:
    """What ``initialize`` keeps of O objects: the template tokens and the
    frame's channel means."""

    def __init__(self, net: TransTRef, frame: torch.Tensor, pos, sz, hp: dict):
        o = pos.shape[0]
        self.avg = frame.to(torch.float32).mean(dim=(0, 1)).expand(o, -1).contiguous()
        z = crop(frame, pos, crop_side(sz, hp["template_factor"]), net.c["template_size"],
                 self.avg)
        self.tokens = net.template(z)


def step(net: TransTRef, hp: dict, tmpl: Template, frame: torch.Tensor, pos, sz,
         best=None) -> dict:
    """One frame for O objects from positions and sizes (O, 2): ``fg`` (O,
    N) foreground probabilities, ``boxes`` (O, N, 4), ``pscore`` (O, N)
    windowed, ``best`` (O,) its argmax or the given cells, and at those
    cells the new ``pos`` and ``sz`` (clipped to the frame) and ``score``."""
    h, w = frame.shape[:2]
    s_x = crop_side(sz, hp["search_factor"])
    x = crop(frame, pos, s_x, net.c["search_size"], tmpl.avg)
    logits, boxes = net.track(tmpl.tokens, x)
    logits, boxes = logits.to(torch.float32), boxes.to(torch.float32)
    fg = torch.softmax(logits, dim=-1)[..., 0]
    window = torch.as_tensor(hann_window(net.c["search_size"] // 8), device=fg.device)
    wi = hp["window_influence"]
    pscore = fg * (1 - wi) + window * wi
    if best is None:
        best = torch.argmax(pscore, dim=1)
    best = torch.as_tensor(best, device=fg.device).long()
    box = boxes[torch.arange(len(best), device=fg.device), best] * s_x[:, None]
    cx = (pos[:, 0] + box[:, 0] - s_x / 2).clamp(0, w)
    cy = (pos[:, 1] + box[:, 1] - s_x / 2).clamp(0, h)
    bw = box[:, 2].clamp(max=w).clamp(min=MIN_SIDE)
    bh = box[:, 3].clamp(max=h).clamp(min=MIN_SIDE)
    return {"fg": fg, "boxes": boxes, "pscore": pscore, "best": best,
            "pos": torch.stack([cx, cy], 1), "sz": torch.stack([bw, bh], 1),
            "score": fg.gather(1, best[:, None])[:, 0]}
