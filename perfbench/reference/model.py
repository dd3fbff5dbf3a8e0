"""Plain float32 SiamMask: ResNet-50 tracking backbone, ResDownS neck,
DepthCorr heads and Refine, as functions of a flat dict of tensors.

The module tree and the parameter names are those of the published SiamMask
checkpoints (foolwood/SiamMask ``models/siammask_sharp.py``): a weights dict
made here loads into any implementation that keeps those names. Only
``torch.nn.functional`` is used; the depthwise cross-correlation is a grouped
conv with groups = B*C. Layout is NCHW throughout.

``Net`` carries the weights and how to compute:

- ``precision`` "fp32" computes every conv and product in float32 (the
  caller turns TF32 off, ``fp32_exact``); "fp8" holds every map that the
  program under test holds in bf16 in float8 e4m3 instead, one scale a
  tensor (amax to 448): each conv's and product's operands and result, and
  the tracker's sigmoid scores and masks (``q``) -- the control of the
  benchmark's comparison (straight through in the backward);
- ``train_bn(name)``: which BatchNorms normalise with the batch's
  statistics and update their running ones (biased variance, momentum 0.1);
  the others use their running statistics;
- ``calibrate``: while set, the first call of each BatchNorm sets its
  running mean to 0 and its running variance to the mean square of its
  input, one number a layer (the harness's weight recipe).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
FP8_MAX = 448.0


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for cuDNN and cuBLAS while open; the flags are restored."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


# ---------------------------------------------------------------- the names


def _conv_bn(spec, prefix, cin, cout, k, bias=False):
    spec[f"{prefix}.0.weight"] = (cout, cin, k, k)
    if bias:
        spec[f"{prefix}.0.bias"] = (cout,)
    _bn(spec, f"{prefix}.1", cout)


def _bn(spec, prefix, c):
    for name in ("weight", "bias", "running_mean", "running_var"):
        spec[f"{prefix}.{name}"] = (c,)
    spec[f"{prefix}.num_batches_tracked"] = ()


def _bottleneck(spec, prefix, cin, planes, downsample_k):
    spec[f"{prefix}.conv1.weight"] = (planes, cin, 1, 1)
    _bn(spec, f"{prefix}.bn1", planes)
    spec[f"{prefix}.conv2.weight"] = (planes, planes, 3, 3)
    _bn(spec, f"{prefix}.bn2", planes)
    spec[f"{prefix}.conv3.weight"] = (4 * planes, planes, 1, 1)
    _bn(spec, f"{prefix}.bn3", 4 * planes)
    if downsample_k:
        spec[f"{prefix}.downsample.0.weight"] = (4 * planes, cin, downsample_k, downsample_k)
        _bn(spec, f"{prefix}.downsample.1", 4 * planes)


def _depthcorr(spec, prefix, c, out):
    _conv_bn(spec, f"{prefix}.conv_kernel", c, c, 3)
    _conv_bn(spec, f"{prefix}.conv_search", c, c, 3)
    spec[f"{prefix}.head.0.weight"] = (c, c, 1, 1)
    _bn(spec, f"{prefix}.head.1", c)
    spec[f"{prefix}.head.3.weight"] = (out, c, 1, 1)
    spec[f"{prefix}.head.3.bias"] = (out,)


REFINE_BLOCKS = {"v0": (1, 16, 4), "v1": (4, 64, 16), "v2": (8, 128, 32),
                 "h2": (0, 32, 32), "h1": (0, 16, 16), "h0": (0, 4, 4)}
REFINE_POST = {"post0": (32, 16), "post1": (16, 4), "post2": (4, 1)}


def spec(family: str, width: int = 64, anchor_num: int = 5) -> dict:
    """name -> shape of every parameter and buffer of ``family``
    ("sharp" or "base"), in the checkpoint's order."""
    w, s = width, {}
    f = "features.features"
    s[f"{f}.conv1.weight"] = (w, 3, 7, 7)
    _bn(s, f"{f}.bn1", w)
    for layer, planes, blocks, cin, dk in ((1, w, 3, w, 1), (2, 2 * w, 4, 4 * w, 3),
                                           (3, 4 * w, 6, 8 * w, 3)):
        for i in range(blocks):
            _bottleneck(s, f"{f}.layer{layer}.{i}", cin if i == 0 else 4 * planes, planes,
                        dk if i == 0 else 0)
    s["features.downsample.downsample.0.weight"] = (4 * w, 16 * w, 1, 1)
    _bn(s, "features.downsample.downsample.1", 4 * w)
    _depthcorr(s, "rpn_model.cls", 4 * w, 2 * anchor_num)
    _depthcorr(s, "rpn_model.loc", 4 * w, 4 * anchor_num)
    _depthcorr(s, "mask_model.mask", 4 * w, 63 * 63)
    if family == "sharp":
        r = "refine_model"
        for name, (mult, mid, out) in REFINE_BLOCKS.items():
            cin = mult * w if mult else out
            s[f"{r}.{name}.0.weight"] = (mid, cin, 3, 3)
            s[f"{r}.{name}.0.bias"] = (mid,)
            s[f"{r}.{name}.2.weight"] = (out, mid, 3, 3)
            s[f"{r}.{name}.2.bias"] = (out,)
        s[f"{r}.deconv.weight"] = (4 * w, 32, 15, 15)
        s[f"{r}.deconv.bias"] = (32,)
        for name, (cin, cout) in REFINE_POST.items():
            s[f"{r}.{name}.weight"] = (cout, cin, 3, 3)
            s[f"{r}.{name}.bias"] = (cout,)
    elif family != "base":
        raise ValueError(f"unknown family {family!r}")
    return s


# ---------------------------------------------------------------- the maths


class Net:
    """The weights ``p`` (name -> tensor) and how to compute (module docstring)."""

    def __init__(self, p: dict, width: int, precision: str = "fp32", train_bn=None):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.p = p
        self.width = width
        self.precision = precision
        self.train_bn = train_bn or (lambda name: False)
        self.calibrate = False
        self._calibrated: set = set()

    def q(self, x):
        return _RoundFp8.apply(x) if self.precision == "fp8" else x

    def conv(self, x, name, stride=1, padding=0, dilation=1, bias=False):
        w = self.p[f"{name}.weight"]
        b = self.p[f"{name}.bias"] if bias else None
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride, padding, dilation))

    def bn(self, x, name):
        p = self.p
        rm, rv = p[f"{name}.running_mean"], p[f"{name}.running_var"]
        if self.calibrate and name not in self._calibrated:
            self._calibrated.add(name)
            with torch.no_grad():
                rm.zero_()
                rv.fill_(x.detach().pow(2).mean())
        wt, b = p[f"{name}.weight"], p[f"{name}.bias"]
        if not self.train_bn(name):
            return (x - rm[:, None, None]) * torch.rsqrt(rv + BN_EPS)[:, None, None] \
                * wt[:, None, None] + b[:, None, None]
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        with torch.no_grad():
            rm.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean.detach())
            rv.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var.detach())
            p[f"{name}.num_batches_tracked"].add_(1)
        return (x - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None, None] \
            * wt[:, None, None] + b[:, None, None]

    # -- backbone (stride 8, dilated layer3, pad-0 stem), neck

    def bottleneck(self, x, name, stride, dilation, downsample):
        padding = dilation if dilation > 1 else 2 - stride
        if downsample is None:
            residual = x
        else:
            k_stride, k_pad, k_dil = downsample
            residual = self.bn(self.conv(x, f"{name}.downsample.0", k_stride, k_pad, k_dil),
                               f"{name}.downsample.1")
        out = F.relu(self.bn(self.conv(x, f"{name}.conv1"), f"{name}.bn1"))
        out = F.relu(self.bn(self.conv(out, f"{name}.conv2", stride, padding, dilation),
                             f"{name}.bn2"))
        out = self.bn(self.conv(out, f"{name}.conv3"), f"{name}.bn3")
        return F.relu(out + residual)

    def backbone(self, x):
        """Raw 0..255 pixels (B, 3, H, W) -> (p0, p1, p2, p3)."""
        f = "features.features"
        p0 = F.relu(self.bn(self.conv(x, f"{f}.conv1", 2, 0), f"{f}.bn1"))
        x = F.max_pool2d(p0, 3, 2, 1)
        for i in range(3):
            x = self.bottleneck(x, f"{f}.layer1.{i}", 1, 1, (1, 0, 1) if i == 0 else None)
        p1 = x
        for i in range(4):
            x = self.bottleneck(x, f"{f}.layer2.{i}", 2 if i == 0 else 1, 1,
                                (2, 0, 1) if i == 0 else None)
        p2 = x
        for i in range(6):
            # the first block runs at dilation 1 with a 3x3 pad-1 downsample
            x = self.bottleneck(x, f"{f}.layer3.{i}", 1, 1 if i == 0 else 2,
                                (1, 1, 1) if i == 0 else None)
        return p0, p1, p2, x

    def neck(self, x):
        x = self.bn(self.conv(x, "features.downsample.downsample.0"),
                    "features.downsample.downsample.1")
        return x[:, :, 4:-4, 4:-4] if x.shape[3] < 20 else x

    def template(self, z):
        return self.neck(self.backbone(z)[3])

    # -- heads

    def conv_bn_relu(self, x, name):
        return F.relu(self.bn(self.conv(x, f"{name}.0"), f"{name}.1"))

    def xcorr(self, x, k):
        """Depthwise valid cross-correlation, NCHW: groups = B*C."""
        b, c, h, w = x.shape
        out = F.conv2d(self.q(x).reshape(1, b * c, h, w),
                       self.q(k).reshape(b * c, 1, k.shape[2], k.shape[3]), groups=b * c)
        return self.q(out.reshape(b, c, out.shape[2], out.shape[3]))

    def corr(self, name, zf, xf):
        return self.xcorr(self.conv_bn_relu(xf, f"{name}.conv_search"),
                          self.conv_bn_relu(zf, f"{name}.conv_kernel"))

    def head(self, name, corr):
        x = F.relu(self.bn(self.conv(corr, f"{name}.head.0"), f"{name}.head.1"))
        return self.conv(x, f"{name}.head.3", bias=True)

    def rpn(self, zf, xf):
        return (self.head("rpn_model.cls", self.corr("rpn_model.cls", zf, xf)),
                self.head("rpn_model.loc", self.corr("rpn_model.loc", zf, xf)))

    # -- Refine

    def refine(self, p0, p1, p2, cvec):
        """Skip windows (B, w, 61, 61), (B, 4w, 31, 31), (B, 8w, 15, 15) and
        the cell's corr vector (B, 4w) -> (B, 127*127) mask logits."""
        r = "refine_model"

        def block(x, name):
            x = F.relu(self.conv(x, f"{r}.{name}.0", padding=1, bias=True))
            return F.relu(self.conv(x, f"{r}.{name}.2", padding=1, bias=True))

        def up(x, size):
            return F.interpolate(x, size=(size, size), mode="nearest")

        w = self.p[f"{r}.deconv.weight"]
        i, o, h, k = w.shape
        out = self.q((self.q(cvec) @ self.q(w).reshape(i, o * h * k)).reshape(-1, o, h, k)
                     + self.p[f"{r}.deconv.bias"][:, None, None])
        out = self.conv(up(block(out, "h2") + block(p2, "v2"), 31), f"{r}.post0", padding=1,
                        bias=True)
        out = self.conv(up(block(out, "h1") + block(p1, "v1"), 61), f"{r}.post1", padding=1,
                        bias=True)
        out = self.conv(up(block(out, "h0") + block(p0, "v0"), 127), f"{r}.post2", padding=1,
                        bias=True)
        return out.reshape(out.shape[0], 127 * 127)


def skip_windows(p0, p1, p2, rows, cols):
    """The Refine skip windows at score-map cell (rows[b], cols[b]) of each
    sample (host ints): windows of (61, 31, 15) at strides (4, 2, 1) from
    the cell of the maps zero-padded by (16, 8, 4), as the published
    tracker slices them."""
    out = []
    for f, pad, scale, win in ((p0, 16, 4, 61), (p1, 8, 2, 31), (p2, 4, 1, 15)):
        fp = F.pad(f, (pad, pad, pad, pad))
        out.append(torch.stack([fp[b, :, scale * r:scale * r + win, scale * c:scale * c + win]
                                for b, (r, c) in enumerate(zip(rows, cols))]))
    return out


def init_weights(shapes: dict, generator: torch.Generator, device) -> dict:
    """Seeded weights in a few large draws: every conv weight and the deconv
    normal with variance 1/fan_in, biases 0, BatchNorm the identity
    (weight 1, bias 0, running mean 0, running variance 1)."""
    weights = [(k, v) for k, v in shapes.items()
               if k.endswith(".weight") and len(v) == 4]
    total = sum(math.prod(v) for _, v in weights)
    draw = torch.randn(total, generator=generator, device=device)
    p, at = {}, 0
    for k, v in weights:
        n = math.prod(v)
        # the deconv on a 1x1 input is a product over its input channels
        fan_in = v[0] if k.endswith("deconv.weight") else math.prod(v[1:])
        p[k] = draw[at:at + n].view(v).mul_(1.0 / math.sqrt(fan_in))
        at += n
    for k, v in shapes.items():
        if k in p:
            continue
        if k.endswith("num_batches_tracked"):
            p[k] = torch.zeros((), dtype=torch.int64, device=device)
        elif k.endswith(("running_var", ".weight")):
            p[k] = torch.ones(v, device=device)
        else:
            p[k] = torch.zeros(v, device=device)
    return {k: p[k] for k in shapes}
