"""SAM 2.1 (Ravi et al., "SAM 2: Segment Anything in Images and Videos",
2024; facebookresearch/sam2, ``sam2/configs/sam2.1/sam2.1_hiera_b+.yaml``
and ``sam2/modeling/``) at the widths of ``Sam2Config``: the Hiera-B+ image
encoder with its FPN neck, the prompt encoder, the two-way-transformer mask
decoder, memory attention and the memory encoder, and the parameters of
``SAM2Base`` around them.

The module tree and the parameter names are the published checkpoint's
(``image_encoder.trunk.blocks.0.attn.qkv.weight``, ...), so its state_dict
loads as it is; every module of the published model is built, including
those the video path leaves unused (the prompt encoder's
``mask_downscaling``, ``mask_downsample``): 80.8 M parameters at the
published widths.

Maps are NCHW where the published code's are, and tokens batch-first
(B, N, C) where it keeps (N, B, C). ``dtype`` is the compute dtype: with
``torch.bfloat16`` the tracker runs the model under ``torch.autocast``
over float32 parameters, as the published video predictor does; ``None``
computes in the parameters' dtype (float32, or float64 after
``model.double()``).

The video bookkeeping (which memories and pointers a frame attends, the
mask choice, the bank) is the tracker's (``tracker/sam2.py``); this module
gives the per-frame pieces: ``encode_image``, ``condition`` (memory
attention), ``decode`` (prompt tokens and mask decoder), ``encode_memory``,
``object_pointer`` and ``pointer_pos``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from siammask_tpu_torch.ops.attention import (apply_rope, attention, axial_rope,
                                              window_partition, window_unpartition)

NO_OBJ_SCORE = -1024.0


@dataclass(frozen=True)
class Sam2Config:
    """sam2.1_hiera_b+ with the video predictor's settings; the tests build
    smaller ones."""
    embed_dim: int = 112                      # Hiera stage 1
    num_heads: int = 2
    stages: tuple = (2, 3, 16, 3)
    window_spec: tuple = (8, 4, 14, 7)
    global_att_blocks: tuple = (12, 16, 20)
    pos_embed_size: tuple = (14, 14)          # window_pos_embed_bkg_spatial_size
    d_model: int = 256                        # neck, decoder, memory attention
    mem_dim: int = 64
    image_size: int = 1024
    num_maskmem: int = 7                      # the conditioning frame and 6 recent
    max_obj_ptrs: int = 16
    memattn_layers: int = 4
    memattn_ffn: int = 2048
    decoder_heads: int = 8
    decoder_mlp: int = 2048
    mask_in_chans: int = 16
    rope_theta: float = 10000.0
    stability_delta: float = 0.05
    stability_thresh: float = 0.98

    @property
    def feat_side(self) -> int:               # the 64x64 level
        return self.image_size // 16


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or float64 where it is float64 (the published
    code's ``.float()`` / ``.to(torch.float32)``)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class MLP(nn.Module):
    def __init__(self, din, hidden, dout, num_layers, activation=nn.ReLU, sigmoid_output=False):
        super().__init__()
        h = [hidden] * (num_layers - 1)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip([din] + h, h + [dout]))
        self.act = activation()
        self.sigmoid_output = sigmoid_output

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = self.act(layer(x)) if i < len(self.layers) - 1 else layer(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class LayerNorm2d(nn.Module):
    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


def sine_pos_2d(channels: int, h: int, w: int, device, dtype=torch.float32) -> torch.Tensor:
    """DETR's normalised sine position (``PositionEmbeddingSine``,
    temperature 10000, scale 2 pi): (channels, h, w), y's half first."""
    half = channels // 2
    y = torch.arange(1, h + 1, device=device, dtype=dtype)[:, None].expand(h, w)
    x = torch.arange(1, w + 1, device=device, dtype=dtype)[None, :].expand(h, w)
    eps, scale = 1e-6, 2 * math.pi
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim_t = torch.arange(half, device=device, dtype=dtype)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / half)
    px, py = x[..., None] / dim_t, y[..., None] / dim_t
    px = torch.stack((px[..., 0::2].sin(), px[..., 1::2].cos()), dim=3).flatten(2)
    py = torch.stack((py[..., 0::2].sin(), py[..., 1::2].cos()), dim=3).flatten(2)
    return torch.cat((py, px), dim=2).permute(2, 0, 1)


def sine_pos_1d(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """``get_1d_sine_pe``: (..., dim), sines then cosines."""
    half = dim // 2
    dim_t = torch.arange(half, dtype=torch.float32, device=pos.device).to(_wide(pos).dtype)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / half)
    e = pos[..., None] / dim_t
    return torch.cat([e.sin(), e.cos()], dim=-1)


# ----------------------------------------------------------------- Hiera


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, kernel_size=7, stride=4, padding=3)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


def _pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool of (B, H, W, C)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class MultiScaleAttention(nn.Module):
    def __init__(self, dim, dim_out, num_heads, q_pool: bool):
        super().__init__()
        self.num_heads = num_heads
        self.q_pool = q_pool
        self.qkv = nn.Linear(dim, dim_out * 3)
        self.proj = nn.Linear(dim_out, dim_out)

    def forward(self, x):
        b, h, w, _ = x.shape
        q, k, v = self.qkv(x).reshape(b, h * w, 3, self.num_heads, -1).unbind(2)
        if self.q_pool:
            q = _pool(q.reshape(b, h, w, -1))
            h, w = q.shape[1:3]
            q = q.reshape(b, h * w, self.num_heads, -1)
        x = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)).transpose(1, 2)
        return self.proj(x.reshape(b, h, w, -1))


class MultiScaleBlock(nn.Module):
    def __init__(self, dim, dim_out, num_heads, q_pool: bool, window_size: int):
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.window_size = window_size
        self.q_pool = q_pool
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, q_pool)
        self.norm2 = nn.LayerNorm(dim_out, eps=1e-6)
        self.mlp = MLP(dim_out, 4 * dim_out, dim_out, 2, activation=nn.GELU)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.dim != self.dim_out:
            shortcut = _pool(self.proj(x))
        ws = self.window_size
        if ws > 0:
            h, w = x.shape[1:3]
            x, pad_hw = window_partition(x, ws)
        x = self.attn(x)
        if self.q_pool:                   # unpartition at half the window
            ws = self.window_size // 2
            h, w = shortcut.shape[1:3]
            pad_hw = (h + (ws - h % ws) % ws, w + (ws - w % ws) % ws)
        if self.window_size > 0:
            x = window_unpartition(x, ws, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class Hiera(nn.Module):
    def __init__(self, cfg: Sam2Config):
        super().__init__()
        stages = cfg.stages
        self.stage_ends = [sum(stages[:i]) - 1 for i in range(1, len(stages) + 1)]
        q_pool_blocks = [e + 1 for e in self.stage_ends[:-1]]
        dim, heads = cfg.embed_dim, cfg.num_heads
        self.patch_embed = PatchEmbed(dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, dim, *cfg.pos_embed_size))
        w0 = cfg.window_spec[0]
        self.pos_embed_window = nn.Parameter(torch.zeros(1, dim, w0, w0))
        self.blocks = nn.ModuleList()
        stage = 1
        for i in range(sum(stages)):
            dim_out = dim
            # a stage's first block keeps the previous stage's window
            window = 0 if i in cfg.global_att_blocks else cfg.window_spec[stage - 1]
            if i - 1 in self.stage_ends:
                dim_out, heads, stage = 2 * dim, 2 * heads, stage + 1
            self.blocks.append(MultiScaleBlock(dim, dim_out, heads, i in q_pool_blocks, window))
            dim = dim_out

    def pos(self, h: int, w: int) -> torch.Tensor:
        pe = F.interpolate(self.pos_embed, size=(h, w), mode="bicubic")
        win = self.pos_embed_window
        pe = pe + win.tile([1, 1, h // win.shape[2], w // win.shape[3]])
        return pe.permute(0, 2, 3, 1)

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + self.pos(*x.shape[1:3])
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.stage_ends:
                outs.append(x.permute(0, 3, 1, 2))
        return outs


class _Lateral(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)


class FpnNeck(nn.Module):
    """1x1 laterals to ``d_model``; nearest x2 top-down at the two coarsest
    levels only (``fpn_top_down_levels`` [2, 3])."""

    def __init__(self, channels: list, d_model: int):
        super().__init__()
        self.convs = nn.ModuleList(_Lateral(c, d_model) for c in channels)   # coarsest first

    def forward(self, xs: list) -> list:
        n = len(xs) - 1
        out, prev = [None] * len(xs), None
        for i in range(n, -1, -1):
            lateral = self.convs[n - i].conv(xs[i])
            if i >= n - 1 and prev is not None:
                prev = lateral + F.interpolate(_wide(prev), scale_factor=2.0, mode="nearest")
            else:
                prev = lateral
            out[i] = prev
        return out


class ImageEncoder(nn.Module):
    def __init__(self, cfg: Sam2Config):
        super().__init__()
        self.trunk = Hiera(cfg)
        dims = [cfg.embed_dim * 2 ** i for i in range(len(cfg.stages))]
        self.neck = FpnNeck(dims[::-1], cfg.d_model)

    def forward(self, x) -> list:
        """The three finest levels (scalp 1): 256^2, 128^2, 64^2 at 1024."""
        return self.neck(self.trunk(x))[:-1]


# ------------------------------------------------ prompt encoder and decoder


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn((2, num_pos_feats)))

    def encode(self, coords: torch.Tensor) -> torch.Tensor:
        """coords in [0, 1] (..., 2) -> (..., 2 * num_pos_feats)."""
        g = self.positional_encoding_gaussian_matrix
        c = 2 * math.pi * ((2 * coords - 1).to(g.dtype) @ g)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def dense(self, h: int, w: int) -> torch.Tensor:
        """(C, h, w): the encoding at the cell centres."""
        g = self.positional_encoding_gaussian_matrix
        y = (torch.arange(h, device=g.device, dtype=g.dtype) + 0.5) / h
        x = (torch.arange(w, device=g.device, dtype=g.dtype) + 0.5) / w
        grid = torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)], dim=-1)
        return self.encode(grid).permute(2, 0, 1)


class PromptEncoder(nn.Module):
    def __init__(self, cfg: Sam2Config):
        super().__init__()
        d, c = cfg.d_model, cfg.mask_in_chans
        self.image_size = cfg.image_size
        self.side = cfg.feat_side
        self.pe_layer = PositionEmbeddingRandom(d // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, c // 4, 2, 2), LayerNorm2d(c // 4), nn.GELU(),
            nn.Conv2d(c // 4, c, 2, 2), LayerNorm2d(c), nn.GELU(), nn.Conv2d(c, d, 1))
        self.no_mask_embed = nn.Embedding(1, d)

    def box_tokens(self, boxes: torch.Tensor) -> torch.Tensor:
        """(O, 4) boxes x0, y0, x1, y1 in the model's input pixels -> (O, 3,
        d): the corners labelled 2 and 3, and the padding point (-1)."""
        corners = (boxes.reshape(-1, 2, 2) + 0.5) / self.image_size
        pe = self.pe_layer.encode(corners)
        pe = pe + torch.stack([self.point_embeddings[2].weight[0],
                               self.point_embeddings[3].weight[0]])
        pad = self.not_a_point_embed.weight.expand(len(boxes), 1, -1)
        return torch.cat([pe, pad.to(pe.dtype)], dim=1)

    def empty_tokens(self, o: int) -> torch.Tensor:
        """(O, 2, d): a tracking frame's prompt, no point and its padding."""
        return self.not_a_point_embed.weight.expand(o, 2, -1)

    def dense_pe(self) -> torch.Tensor:
        return self.pe_layer.dense(self.side, self.side)[None]


class Attention(nn.Module):
    def __init__(self, dim, num_heads, downsample_rate=1, kv_in_dim=None):
        super().__init__()
        internal = dim // downsample_rate
        kv = kv_in_dim or dim
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, internal)
        self.k_proj = nn.Linear(kv, internal)
        self.v_proj = nn.Linear(kv, internal)
        self.out_proj = nn.Linear(internal, dim)

    def heads(self, x):
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    def merge(self, x):
        b, h, n, c = x.shape
        return self.out_proj(x.transpose(1, 2).reshape(b, n, h * c))

    def forward(self, q, k, v):
        q, k, v = self.heads(self.q_proj(q)), self.heads(self.k_proj(k)), self.heads(self.v_proj(v))
        return self.merge(attention(q, k, v))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, d, heads, mlp_dim, skip_first_layer_pe):
        super().__init__()
        self.self_attn = Attention(d, heads)
        self.norm1 = nn.LayerNorm(d)
        self.cross_attn_token_to_image = Attention(d, heads, downsample_rate=2)
        self.norm2 = nn.LayerNorm(d)
        self.mlp = MLP(d, mlp_dim, d, 2)
        self.norm3 = nn.LayerNorm(d)
        self.norm4 = nn.LayerNorm(d)
        self.cross_attn_image_to_token = Attention(d, heads, downsample_rate=2)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, d, heads, mlp_dim, depth=2):
        super().__init__()
        self.layers = nn.ModuleList(TwoWayAttentionBlock(d, heads, mlp_dim, i == 0)
                                    for i in range(depth))
        self.final_attn_token_to_image = Attention(d, heads, downsample_rate=2)
        self.norm_final_attn = nn.LayerNorm(d)

    def forward(self, image, image_pe, tokens):
        keys = image.flatten(2).transpose(1, 2)
        key_pe = image_pe.flatten(2).transpose(1, 2)
        queries = tokens
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        q, k = queries + tokens, keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MaskDecoder(nn.Module):
    def __init__(self, cfg: Sam2Config):
        super().__init__()
        d = cfg.d_model
        self.transformer = TwoWayTransformer(d, cfg.decoder_heads, cfg.decoder_mlp)
        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(4, d)
        self.obj_score_token = nn.Embedding(1, d)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, 2), LayerNorm2d(d // 4), nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, 2, 2), nn.GELU())
        self.conv_s0 = nn.Conv2d(d, d // 8, 1)
        self.conv_s1 = nn.Conv2d(d, d // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(MLP(d, d, d // 8, 3) for _ in range(4))
        self.iou_prediction_head = MLP(d, 256, 4, 3, sigmoid_output=True)
        self.pred_obj_score_head = MLP(d, d, 1, 3)

    def forward(self, image, image_pe, dense, sparse, s0, s1):
        """image (O, d, h, w), sparse (O, n, d), s0 / s1 the high-resolution
        maps (1 or O, ...) -> all four masks (O, 4, 4h, 4w), their IoUs
        (O, 4), the mask tokens (O, 4, d) and the object score (O, 1)."""
        o = sparse.shape[0]
        out = torch.cat([self.obj_score_token.weight, self.iou_token.weight,
                         self.mask_tokens.weight]).expand(o, -1, -1)
        tokens = torch.cat([out.to(sparse.dtype), sparse], dim=1)
        hs, src = self.transformer(image + dense, image_pe.expand(o, -1, -1, -1), tokens)
        mask_tokens = hs[:, 2:6]
        b, c, h, w = image.shape
        src = src.transpose(1, 2).reshape(b, c, h, w)
        dc1, ln1, act1, dc2, act2 = self.output_upscaling
        up = act1(ln1(dc1(src) + s1))
        up = act2(dc2(up) + s0)
        hyper = torch.stack([mlp(mask_tokens[:, i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], dim=1)
        b, c, h, w = up.shape
        masks = (hyper @ up.reshape(b, c, h * w)).reshape(b, -1, h, w)
        return masks, self.iou_prediction_head(hs[:, 1]), mask_tokens, \
            self.pred_obj_score_head(hs[:, 0])


# ------------------------------------------------------------ memory


class RoPEAttention(Attention):
    """One head of width ``d``; RoPE on q by the query grid's phases and on
    k by the keys' (``Sam2.key_phases`` for a bank: its pointers' keys
    unrotated)."""

    def __init__(self, d, kv_in_dim=None):
        super().__init__(d, 1, 1, kv_in_dim)

    def forward(self, q, k, v, rope, key_rope):
        q = apply_rope(self.heads(self.q_proj(q)), rope)
        k = apply_rope(self.heads(self.k_proj(k)), key_rope)
        return self.merge(attention(q, k, self.heads(self.v_proj(v))))


class MemoryAttentionLayer(nn.Module):
    def __init__(self, d, ffn, mem_dim):
        super().__init__()
        self.self_attn = RoPEAttention(d)
        self.cross_attn_image = RoPEAttention(d, kv_in_dim=mem_dim)
        self.linear1 = nn.Linear(d, ffn)
        self.linear2 = nn.Linear(ffn, d)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)
        self.norm3 = nn.LayerNorm(d)

    def forward(self, x, memory, memory_k, rope, key_rope):
        t = self.norm1(x)
        x = x + self.self_attn(t, t, t, rope, rope)
        x = x + self.cross_attn_image(self.norm2(x), memory_k, memory, rope, key_rope)
        return x + self.linear2(F.relu(self.linear1(self.norm3(x))))


class MemoryAttention(nn.Module):
    def __init__(self, cfg: Sam2Config):
        super().__init__()
        self.layers = nn.ModuleList(MemoryAttentionLayer(cfg.d_model, cfg.memattn_ffn,
                                                         cfg.mem_dim)
                                    for _ in range(cfg.memattn_layers))
        self.norm = nn.LayerNorm(cfg.d_model)

    def forward(self, curr, curr_pos, memory, memory_pos, rope, key_rope):
        """curr (O, N, d) with its position (1, N, d); memory (O, M, mem_dim)
        with its position; ``rope`` and ``key_rope`` the queries' and the
        keys' RoPE phases."""
        x = curr + 0.1 * curr_pos
        memory_k = memory + memory_pos
        device = memory.device.type
        if torch.is_autocast_enabled(device):       # cast once, not in each layer
            dtype = torch.get_autocast_dtype(device)
            memory, memory_k = memory.to(dtype), memory_k.to(dtype)
        for layer in self.layers:
            x = layer(x, memory, memory_k, rope, key_rope)
        return self.norm(x)


class CXBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm2d(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(1e-6 * torch.ones(dim))

    def forward(self, x):
        y = self.norm(self.dwconv(x)).permute(0, 2, 3, 1)
        y = self.gamma * self.pwconv2(F.gelu(self.pwconv1(y)))
        return x + y.permute(0, 3, 1, 2)


class _Fuser(nn.Module):
    def __init__(self, dim, n=2):
        super().__init__()
        self.layers = nn.ModuleList(CXBlock(dim) for _ in range(n))


class _MaskDownSampler(nn.Module):
    """Four 3x3 stride-2 convs (1 -> 4 -> 16 -> 64 -> 256), each LN2d and
    GELU, then a 1x1 conv to ``d``."""

    def __init__(self, d):
        super().__init__()
        layers, c = [], 1
        for _ in range(4):
            layers += [nn.Conv2d(c, 4 * c, 3, 2, 1), LayerNorm2d(4 * c), nn.GELU()]
            c *= 4
        layers.append(nn.Conv2d(c, d, 1))
        self.encoder = nn.Sequential(*layers)


class MemoryEncoder(nn.Module):
    def __init__(self, cfg: Sam2Config):
        super().__init__()
        d = cfg.d_model
        self.mask_downsampler = _MaskDownSampler(d)
        self.pix_feat_proj = nn.Conv2d(d, d, 1)
        self.fuser = _Fuser(d)
        self.out_proj = nn.Conv2d(d, cfg.mem_dim, 1)

    def forward(self, feat, mask):
        """feat (1 or O, d, h, w) image features; mask (O, 1, 16h, 16w) the
        scaled mask -> (O, mem_dim, h, w)."""
        x = self.pix_feat_proj(feat) + self.mask_downsampler.encoder(mask)
        for block in self.fuser.layers:
            x = block(x)
        return self.out_proj(x)


class Sam2(nn.Module):
    """SAM 2.1 for video: the modules and ``SAM2Base``'s parameters."""

    family = "sam2"

    def __init__(self, cfg: Sam2Config = Sam2Config(), dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        d, m = cfg.d_model, cfg.mem_dim
        self.image_encoder = ImageEncoder(cfg)
        self.mask_downsample = nn.Conv2d(1, 1, 4, 4)
        self.memory_attention = MemoryAttention(cfg)
        self.memory_encoder = MemoryEncoder(cfg)
        self.maskmem_tpos_enc = nn.Parameter(torch.zeros(cfg.num_maskmem, 1, 1, m))
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, d))
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, d))
        self.sam_prompt_encoder = PromptEncoder(cfg)
        self.sam_mask_decoder = MaskDecoder(cfg)
        self.obj_ptr_proj = MLP(d, d, d, 3)
        self.obj_ptr_tpos_proj = nn.Linear(d, m)
        self.no_obj_ptr = nn.Parameter(torch.zeros(1, d))
        self.no_obj_embed_spatial = nn.Parameter(torch.zeros(1, m))
        self._consts: dict = {}

    # ---------------- constants of a device and dtype

    def consts(self, device, dtype) -> dict:
        """Position encodings and RoPE tables, made once per device and
        dtype: ``pos`` (1, N, d) of the 64x64 level, ``mem_pos`` (N,
        mem_dim) of the memories, ``rope`` (N, d / 2) complex phases."""
        key = (torch.device(device), dtype)
        if key not in self._consts:
            cfg, s = self.cfg, self.cfg.feat_side
            pos = sine_pos_2d(cfg.d_model, s, s, device, dtype)
            self._consts[key] = {
                "pos": pos.flatten(1).t()[None],
                "mem_pos": sine_pos_2d(cfg.mem_dim, s, s, device, dtype).flatten(1).t(),
                "rope": axial_rope(cfg.d_model, s, cfg.rope_theta, device, dtype),
                "mean": torch.tensor([0.485, 0.456, 0.406], device=device,
                                     dtype=dtype)[:, None, None],
                "std": torch.tensor([0.229, 0.224, 0.225], device=device,
                                    dtype=dtype)[:, None, None],
            }
        return self._consts[key]

    def key_phases(self, device, dtype, frames: int, ptr_tokens: int) -> torch.Tensor:
        """The RoPE phases of a bank's keys: the grid's phases once for each
        of ``frames`` memory frames, then 1 (no rotation) for each pointer
        token; made once per shape."""
        c = self.consts(device, dtype)
        key = ("keys", frames, ptr_tokens)
        if key not in c:
            rope = c["rope"]
            c[key] = torch.cat([rope.repeat(frames, 1),
                                torch.ones(ptr_tokens, rope.shape[1], dtype=rope.dtype,
                                           device=rope.device)])
        return c[key]

    # ---------------- the per-frame pieces

    def preprocess(self, frame: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) BGR uint8 frame -> (1, 3, S, S) normalised RGB: bilinear
        resize to the model's side (aspect not kept), [0, 1], ImageNet mean
        and std."""
        dtype = torch.float64 if self.dtype is None and \
            next(self.parameters()).dtype == torch.float64 else torch.float32
        c = self.consts(frame.device, dtype)        # no host-to-device copy a frame
        x = frame.flip(-1).permute(2, 0, 1)[None].to(dtype)
        s = self.cfg.image_size
        x = F.interpolate(x, size=(s, s), mode="bilinear", align_corners=False) / 255.0
        return (x - c["mean"]) / c["std"]

    def encode_image(self, image: torch.Tensor) -> dict:
        """(1, 3, S, S) -> ``feat`` (1, d, s, s) the 64x64 level, ``s0`` (1,
        d/8, 4s, 4s) and ``s1`` (1, d/4, 2s, 2s) the decoder's skips."""
        f0, f1, f2 = self.image_encoder(image)
        dec = self.sam_mask_decoder
        return {"feat": f2, "s0": dec.conv_s0(f0), "s1": dec.conv_s1(f1)}

    def condition(self, feat: torch.Tensor, memory: torch.Tensor, memory_pos: torch.Tensor,
                  ptr_tokens: int) -> torch.Tensor:
        """Memory attention: feat (1, d, s, s) for O objects whose memory is
        (O, M, mem_dim) -> (O, d, s, s)."""
        dtype = _wide(feat).dtype
        c = self.consts(feat.device, dtype)
        o, (_, d, s, _) = memory.shape[0], feat.shape
        frames = (memory.shape[1] - ptr_tokens) // (s * s)
        key_rope = self.key_phases(feat.device, dtype, frames, ptr_tokens)
        curr = feat.flatten(2).transpose(1, 2).expand(o, -1, -1)
        x = self.memory_attention(curr, c["pos"], memory, memory_pos, c["rope"], key_rope)
        return x.transpose(1, 2).reshape(o, d, s, s)

    def no_memory(self, feat: torch.Tensor, o: int) -> torch.Tensor:
        """The conditioning frame's features: ``no_mem_embed`` added."""
        return (feat + self.no_mem_embed[0, 0][:, None, None]).expand(o, -1, -1, -1)

    def decode(self, pix: torch.Tensor, maps: dict, sparse: torch.Tensor):
        """Masks (O, 4, 4s, 4s), IoUs (O, 4), mask tokens (O, 4, d), object
        score (O,) of the (O, d, s, s) features and (O, n, d) prompt."""
        pe = self.sam_prompt_encoder
        dense = pe.no_mask_embed.weight[0][None, :, None, None]
        masks, iou, tokens, score = self.sam_mask_decoder(
            pix, pe.dense_pe(), dense, sparse, maps["s0"], maps["s1"])
        return masks, iou, tokens, score[:, 0]

    def object_pointer(self, token: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
        """(O, d) pointer of the chosen mask token; ``no_obj_ptr`` where the
        object is absent (``fixed_no_obj_ptr``)."""
        p = present[:, None].to(_wide(token).dtype)
        return p * self.obj_ptr_proj(token) + (1 - p) * self.no_obj_ptr

    def encode_memory(self, feat: torch.Tensor, mask: torch.Tensor,
                      present: torch.Tensor) -> torch.Tensor:
        """(1, d, s, s) features and (O, 1, S, S) mask for the memory ->
        (O, s * s, mem_dim)."""
        mem = self.memory_encoder(feat, mask)
        p = present[:, None, None, None].to(_wide(mem).dtype)
        mem = mem + (1 - p) * self.no_obj_embed_spatial[0][:, None, None]
        return mem.flatten(2).transpose(1, 2)

    def pointer_pos(self, dt: torch.Tensor) -> torch.Tensor:
        """(O, P) signed frame offsets -> (O, P, mem_dim) positions."""
        t_max = self.cfg.max_obj_ptrs - 1
        return self.obj_ptr_tpos_proj(sine_pos_1d(dt / t_max, self.cfg.d_model))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Seeded random weights, module by module from one generator:
        Linear and conv weights and biases uniform in +-1/sqrt(fan_in)
        (PyTorch's default), LayerNorms 1 and 0, embeddings and the Fourier
        matrix N(0, 1), the layer scales 1e-6, and ``SAM2Base``'s embeddings
        and Hiera's position truncated normal (std 0.02)."""
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                bound = 1.0 / math.sqrt(nn.init._calculate_fan_in_and_fan_out(mod.weight)[0])
                for t in (mod.weight, mod.bias):
                    t.uniform_(-bound, bound, generator=generator)
            elif isinstance(mod, (nn.LayerNorm, LayerNorm2d)):
                mod.weight.fill_(1.0)
                mod.bias.fill_(0.0)
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(generator=generator)
            elif isinstance(mod, PositionEmbeddingRandom):
                mod.positional_encoding_gaussian_matrix.normal_(generator=generator)
            elif isinstance(mod, CXBlock):
                mod.gamma.fill_(1e-6)
        trunk = self.image_encoder.trunk
        for t in (self.maskmem_tpos_enc, self.no_mem_embed, self.no_mem_pos_enc, self.no_obj_ptr,
                  self.no_obj_embed_spatial, trunk.pos_embed, trunk.pos_embed_window):
            nn.init.trunc_normal_(t, std=0.02, generator=generator)
        return self
