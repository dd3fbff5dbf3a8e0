"""TransT (Chen et al., "Transformer Tracking", CVPR 2021; chenxin-dlut/TransT)
at the widths of ``TransTConfig``: the flagship TransT-N4.

- Backbone: ResNet-50 through its fourth stage (``layer3``) at stride 8,
  torchvision's padding, layer3 at stride 1 with dilation-2 3x3s
  (``resnet.ResNet50Stride8``); a 128 template gives 16x16 tokens, a 256
  search crop 32x32, of 1024 channels, each projected to d = 256 by a 1x1
  conv (``input_proj``).
- Positions: DETR's normalised sine encoding (``sam2.sine_pos_2d``), d / 2
  features an axis, on each grid, added to queries and keys, never to
  values.
- Feature fusion, ``fusion_layers`` layers over template tokens ``t`` and
  search tokens ``s`` (``FeatureFusionLayer``): ECA on each stream, ``x =
  LN(x + SelfAttn(x + px, x + px, x))``; CFA both ways, both reading the
  streams as the ECAs left them, ``t' = LN(t + CrossAttn(t + pt, s + ps,
  s))`` and ``s' = LN(s + CrossAttn(s + ps, t + pt, t))``; then ``x = LN(x
  + W2 relu(W1 x))`` on each, FFN width ``ffn``. Post-norm.
- Decoder: one more CFA, search queries over the template, and its FFN
  (``DecoderCFALayer``), then the decoder's own LayerNorm.
- Heads on each search token: two 3-layer MLPs of hidden d, the classifier
  (2 logits, foreground index 0) and the box (4 sigmoid outputs, cx, cy, w,
  h as fractions of the search crop).

Every attention is ``nn.MultiheadAttention``'s (``heads`` heads, q/k/v and
output projections with bias, parameters ``in_proj_weight``,
``in_proj_bias``, ``out_proj``) and runs through ``ops/attention.attention``
(FlashAttention-2 at head width 32 on a card in bf16), counted in the trace
counter ``transt.attn_calls`` (17 a step at the published depth; a captured
graph counts at capture). Spans ``transt.backbone``, ``transt.fusion.<i>``,
``transt.decoder`` and ``transt.heads``.

The module tree and the parameter names are the published repository's
(DETR's ``Joiner``: ``backbone.0.body.layer3.5.conv2.weight``,
``featurefusion_network.encoder.layers.0.self_attn1.in_proj_weight``,
``class_embed.layers.2.bias``, ...). Tokens are batch-first (B, N, d), in
the row-major order of DETR's ``flatten(2)``.

``dtype`` is the compute dtype: with ``torch.bfloat16`` every conv and
linear casts its input and weight (``resnet.Conv2d``, ``Linear``), the
tokens and the residual streams are bf16 over float32 parameters, and each
LayerNorm normalises bf16 tokens with float32 statistics. ``None`` computes
in the parameters' dtype; a float32 model switches TF32 off for the process,
as the SiamMask families do. The ImageNet normalisation is an affine step of
its own (``preprocess``): folded into the stem it would be wrong at the
stem's zero padding.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from siammask_tpu_torch.models.resnet import Conv2d, ResNet50Stride8
from siammask_tpu_torch.models.sam2 import sine_pos_2d
from siammask_tpu_torch.ops.attention import attention
from siammask_tpu_torch.ops.layout import model_input
from siammask_tpu_torch.utils import trace

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class TransTConfig:
    """TransT-N4; the tests build smaller ones."""
    width: int = 64             # the backbone's stem width (ResNet-50)
    d_model: int = 256
    heads: int = 8
    ffn: int = 2048
    fusion_layers: int = 4
    template_size: int = 128
    search_size: int = 256

    @property
    def template_side(self) -> int:     # tokens a side: stride 8
        return self.template_size // 8

    @property
    def search_side(self) -> int:
        return self.search_size // 8


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (input, weight and bias cast to
    it), its parameters in their own dtype; ``None`` casts nothing."""

    def __init__(self, din: int, dout: int, dtype: torch.dtype | None = None):
        super().__init__(din, dout)
        self.dtype = dtype

    def forward(self, x):
        if self.dtype is None:
            return super().forward(x)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), self.bias.to(self.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` returning its input's dtype: bf16 tokens are
    normalised with float32 statistics, the affine terms cast to them."""

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention`` (batch-first, no dropout) with the position
    encodings its callers add: ``forward(x, px, m, pm)`` attends queries ``x
    + px`` over keys ``m + pm`` and values ``m``."""

    def __init__(self, d: int, heads: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.heads = heads
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = Linear(d, d, dtype)

    def _project(self, x, rows: slice):
        w, b = self.in_proj_weight[rows], self.in_proj_bias[rows]
        if self.dtype is not None:
            x, w, b = x.to(self.dtype), w.to(self.dtype), b.to(self.dtype)
        return F.linear(x, w, b)

    def _split(self, x):
        b, n, d = x.shape
        return x.view(b, n, self.heads, d // self.heads).transpose(1, 2)

    def forward(self, x, px, m, pm):
        trace.count("transt.attn_calls")
        d = self.in_proj_weight.shape[1]
        if m is x and pm is px:             # self-attention: q and k in one product
            q, k = self._project(x + px, slice(0, 2 * d)).chunk(2, dim=-1)
        else:
            q = self._project(x + px, slice(0, d))
            k = self._project(m + pm, slice(d, 2 * d))
        v = self._project(m, slice(2 * d, 3 * d))
        o = attention(self._split(q), self._split(k), self._split(v))
        b, _, n, _ = o.shape
        return self.out_proj(o.transpose(1, 2).reshape(b, n, d))


def _ffn(x, first: Linear, second: Linear, norm: LayerNorm):
    return norm(x + second(F.relu(first(x))))


class FeatureFusionLayer(nn.Module):
    """One fusion layer: ECA on each stream, CFA both ways, the FFNs
    (the module docstring). Stream 1 is the template, 2 the search."""

    def __init__(self, d: int, heads: int, ffn: int, dtype: torch.dtype | None = None):
        super().__init__()
        for name in ("self_attn1", "self_attn2", "multihead_attn1", "multihead_attn2"):
            setattr(self, name, MultiheadAttention(d, heads, dtype))
        for k in (1, 2):
            setattr(self, f"linear{k}1", Linear(d, ffn, dtype))
            setattr(self, f"linear{k}2", Linear(ffn, d, dtype))
            for j in (1, 2, 3):
                setattr(self, f"norm{k}{j}", LayerNorm(d))

    def forward(self, t, s, pt, ps):
        t = self.norm11(t + self.self_attn1(t, pt, t, pt))
        s = self.norm21(s + self.self_attn2(s, ps, s, ps))
        t2 = self.multihead_attn1(t, pt, s, ps)
        s2 = self.multihead_attn2(s, ps, t, pt)
        t = _ffn(self.norm12(t + t2), self.linear11, self.linear12, self.norm13)
        s = _ffn(self.norm22(s + s2), self.linear21, self.linear22, self.norm23)
        return t, s


class DecoderCFALayer(nn.Module):
    """The decoder's CFA: search queries over the template, then its FFN."""

    def __init__(self, d: int, heads: int, ffn: int, dtype: torch.dtype | None = None):
        super().__init__()
        self.multihead_attn = MultiheadAttention(d, heads, dtype)
        self.linear1 = Linear(d, ffn, dtype)
        self.linear2 = Linear(ffn, d, dtype)
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)

    def forward(self, s, t, ps, pt):
        s = self.norm1(s + self.multihead_attn(s, ps, t, pt))
        return _ffn(s, self.linear1, self.linear2, self.norm2)


class _Layers(nn.Module):
    def __init__(self, layers, norm: LayerNorm | None = None):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        if norm is not None:
            self.norm = norm


class FeatureFusionNetwork(nn.Module):
    def __init__(self, cfg: TransTConfig, dtype: torch.dtype | None = None):
        super().__init__()
        d, h, f = cfg.d_model, cfg.heads, cfg.ffn
        self.encoder = _Layers(FeatureFusionLayer(d, h, f, dtype)
                               for _ in range(cfg.fusion_layers))
        self.decoder = _Layers([DecoderCFALayer(d, h, f, dtype)], LayerNorm(d))

    def forward(self, t, s, pt, ps):
        """Template tokens (B, Nt, d), search tokens (B, Ns, d), their
        positions (Nt, d), (Ns, d) -> the decoded search tokens (B, Ns, d)."""
        for i, layer in enumerate(self.encoder.layers):
            with trace.span(f"transt.fusion.{i}"):
                t, s = layer(t, s, pt, ps)
        with trace.span("transt.decoder"):
            for layer in self.decoder.layers:
                s = layer(s, t, ps, pt)
            return self.decoder.norm(s)


class MLP(nn.Module):
    def __init__(self, din: int, hidden: int, dout: int, num_layers: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        dims = [din] + [hidden] * (num_layers - 1)
        self.layers = nn.ModuleList(Linear(a, b, dtype)
                                    for a, b in zip(dims, dims[1:] + [dout]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class _Body(nn.Module):
    def __init__(self, width: int, dtype: torch.dtype | None):
        super().__init__()
        self.body = ResNet50Stride8(width, dtype)


class TransT(nn.Module):
    """TransT for tracking (the module docstring). Entry points:
    ``preprocess(crop)`` (NHWC pixels -> the normalised model input),
    ``template(z)`` -> template tokens (B, Nt, d) and ``track(zt, x)`` ->
    (class logits (B, Ns, 2), boxes (B, Ns, 4) after the sigmoid)."""

    family = "transt"       # the tracker that ``TrackerRuntime`` builds for it

    def __init__(self, cfg: TransTConfig = TransTConfig(), dtype: torch.dtype | None = None):
        super().__init__()
        if dtype in (None, torch.float32):   # the float32 reference mode
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            dtype = None
        self.cfg = cfg
        self.dtype = dtype
        d = cfg.d_model
        self.backbone = nn.Sequential(_Body(cfg.width, dtype))
        self.input_proj = Conv2d(16 * cfg.width, d, 1, dtype=dtype)
        self.featurefusion_network = FeatureFusionNetwork(cfg, dtype)
        self.class_embed = MLP(d, d, 2, 3, dtype)
        self.bbox_embed = MLP(d, d, 4, 3, dtype)
        self._consts: dict = {}

    def consts(self, device) -> dict:
        """Made once per device: the template's and the search's positions
        (Nt, d), (Ns, d) in the compute dtype, the ImageNet mean and std in
        float32."""
        key = torch.device(device)
        if key not in self._consts:
            cfg = self.cfg
            dtype = self.dtype or self.input_proj.weight.dtype
            wide = torch.promote_types(dtype, torch.float32)

            def pos(side):
                return sine_pos_2d(cfg.d_model, side, side, device, wide).flatten(1).t().to(dtype)

            f32 = dict(device=device, dtype=torch.float32)
            self._consts[key] = {
                "pos_t": pos(cfg.template_side), "pos_s": pos(cfg.search_side),
                "mean": torch.tensor(IMAGENET_MEAN, **f32),
                "std": torch.tensor(IMAGENET_STD, **f32)}
        return self._consts[key]

    def preprocess(self, crop: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) float32 crops of 0..255 pixels -> (B, 3, S, S) ``/
        255``, less the ImageNet mean, over its std, in float32 (in the
        parameters' dtype when they are wider); a channels_last view on a
        card."""
        c = self.consts(crop.device)
        x = (crop * (1.0 / 255.0) - c["mean"]) / c["std"]
        if self.dtype is None:
            x = x.to(self.input_proj.weight.dtype)
        return model_input(x.permute(0, 3, 1, 2))

    def features(self, x) -> torch.Tensor:
        """Normalised images -> projected tokens (B, N, d)."""
        with trace.span("transt.backbone"):
            f = self.input_proj(self.backbone[0].body(x))
            return f.flatten(2).transpose(1, 2)

    def template(self, z) -> torch.Tensor:
        return self.features(z)

    def track(self, zt, x):
        c = self.consts(x.device)
        hs = self.featurefusion_network(zt, self.features(x), c["pos_t"], c["pos_s"])
        with trace.span("transt.heads"):
            return self.class_embed(hs), torch.sigmoid(self.bbox_embed(hs))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded random weights from one generator: convs normal with
        variance 1/fan_in, BN the identity, the fusion network's matrices
        Xavier-uniform (as the published ``_reset_parameters``), every other
        linear weight uniform in +-1/sqrt(fan_in), biases 0, LayerNorms 1
        and 0."""
        fusion = set(self.featurefusion_network.modules())
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, MultiheadAttention):
                nn.init.xavier_uniform_(m.in_proj_weight, generator=generator)
                m.in_proj_bias.zero_()
            elif isinstance(m, nn.Linear):
                if m in fusion:
                    nn.init.xavier_uniform_(m.weight, generator=generator)
                else:
                    bound = 1.0 / math.sqrt(m.weight.shape[1])
                    m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
        return self
