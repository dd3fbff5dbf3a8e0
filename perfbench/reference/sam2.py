"""Plain SAM 2.1 for video, one object at a time: the Hiera image encoder
and FPN neck, the prompt encoder, the two-way-transformer mask decoder,
memory attention with axial RoPE, the memory encoder, and the published
video predictor's rules for the memory bank, the object pointers and the
mask choice (facebookresearch/sam2 ``sam2/modeling/sam2_base.py``,
``sam2.1_hiera_b+.yaml``, the video predictor's overrides), as functions of
a flat dict of tensors under the published checkpoint's names.

Only ``torch`` is used. Every attention is written out: the scores, their
softmax and the weighted sum, in blocks of queries so that a bank of 28,736
keys fits. RoPE is a complex product, as the published code computes it.
The bank of each object is a Python dict from frame index to (memory
features, object pointer); ``select`` picks what a frame attends by the
published loops: the conditioning frame, frames t-6 .. t-1, and pointers of
the conditioning frame and of frames t-15 .. t-1, past only.

``Sam2Ref(p, cfg, precision)``: ``precision`` "fp32" computes in the
weights' dtype (float32 with TF32 off, ``model.fp32_exact``; float64 in the
CPU tests); "fp8" holds every map that the program holds in bf16 in float8
e4m3 (one scale a tensor: each linear's and conv's operands and result,
each attention's output, the stored memories): the control of the
benchmark's comparison.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.model import _RoundFp8

NO_OBJ_SCORE = -1024.0
QUERY_BLOCK = 2048

# sam2.1_hiera_b+ (``Sam2Config`` of the program holds the same keys)
DEFAULTS = {"embed_dim": 112, "num_heads": 2, "stages": [2, 3, 16, 3],
            "window_spec": [8, 4, 14, 7], "global_att_blocks": [12, 16, 20],
            "pos_embed_size": [14, 14], "d_model": 256, "mem_dim": 64, "image_size": 1024,
            "num_maskmem": 7, "max_obj_ptrs": 16, "memattn_layers": 4, "memattn_ffn": 2048,
            "decoder_heads": 8, "decoder_mlp": 2048, "mask_in_chans": 16,
            "rope_theta": 10000.0, "stability_delta": 0.05, "stability_thresh": 0.98}


def model_config(cfg: dict) -> dict:
    """The model's keys of a configuration, the published values where it
    names none."""
    return {k: cfg.get(k, v) for k, v in DEFAULTS.items()}


# ------------------------------------------------------------------ names


def spec(cfg: dict) -> dict:
    """name -> (shape, init), in the order the weights are drawn. ``init``:
    "uniform" (PyTorch's default for Linear and conv weights and biases,
    +-1/sqrt(fan_in), with the fan-in given), "one", "zero", "normal",
    "trunc" (truncated normal, std 0.02) or "scale" (layer scale, 1e-6)."""
    c = model_config(cfg)
    s: dict = {}

    def lin(name, din, dout):
        s[f"{name}.weight"] = ((dout, din), ("uniform", din))
        s[f"{name}.bias"] = ((dout,), ("uniform", din))

    def conv(name, cin, cout, k, groups=1):
        fan = cin // groups * k * k
        s[f"{name}.weight"] = ((cout, cin // groups, k, k), ("uniform", fan))
        s[f"{name}.bias"] = ((cout,), ("uniform", fan))

    def deconv(name, cin, cout, k):
        s[f"{name}.weight"] = ((cin, cout, k, k), ("uniform", cout * k * k))
        s[f"{name}.bias"] = ((cout,), ("uniform", cout * k * k))

    def norm(name, d):
        s[f"{name}.weight"] = ((d,), "one")
        s[f"{name}.bias"] = ((d,), "zero")

    def mlp(name, dims):
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            lin(f"{name}.layers.{i}", a, b)

    d, m, e = c["d_model"], c["mem_dim"], c["embed_dim"]
    t = "image_encoder.trunk"
    s[f"{t}.pos_embed"] = ((1, e, *c["pos_embed_size"]), "trunc")
    w0 = c["window_spec"][0]
    s[f"{t}.pos_embed_window"] = ((1, e, w0, w0), "trunc")
    conv(f"{t}.patch_embed.proj", 3, e, 7)
    dim, ends = e, _stage_ends(c["stages"])
    for i in range(sum(c["stages"])):
        out = 2 * dim if i - 1 in ends else dim
        b = f"{t}.blocks.{i}"
        norm(f"{b}.norm1", dim)
        lin(f"{b}.attn.qkv", dim, 3 * out)
        lin(f"{b}.attn.proj", out, out)
        norm(f"{b}.norm2", out)
        mlp(f"{b}.mlp", [out, 4 * out, out])
        if out != dim:
            lin(f"{b}.proj", dim, out)
        dim = out
    for j, cin in enumerate(e * 2 ** k for k in (3, 2, 1, 0)):
        conv(f"image_encoder.neck.convs.{j}.conv", cin, d, 1)
    conv("mask_downsample", 1, 1, 4)
    for i in range(c["memattn_layers"]):
        la = f"memory_attention.layers.{i}"
        for a, kv in (("self_attn", d), ("cross_attn_image", m)):
            lin(f"{la}.{a}.q_proj", d, d)
            lin(f"{la}.{a}.k_proj", kv, d)
            lin(f"{la}.{a}.v_proj", kv, d)
            lin(f"{la}.{a}.out_proj", d, d)
        lin(f"{la}.linear1", d, c["memattn_ffn"])
        lin(f"{la}.linear2", c["memattn_ffn"], d)
        for n in (1, 2, 3):
            norm(f"{la}.norm{n}", d)
    norm("memory_attention.norm", d)
    me, ch = "memory_encoder", 1
    for k in range(4):
        conv(f"{me}.mask_downsampler.encoder.{3 * k}", ch, 4 * ch, 3)
        norm(f"{me}.mask_downsampler.encoder.{3 * k + 1}", 4 * ch)
        ch *= 4
    conv(f"{me}.mask_downsampler.encoder.12", ch, d, 1)
    conv(f"{me}.pix_feat_proj", d, d, 1)
    for k in range(2):
        f = f"{me}.fuser.layers.{k}"
        conv(f"{f}.dwconv", d, d, 7, groups=d)
        norm(f"{f}.norm", d)
        lin(f"{f}.pwconv1", d, 4 * d)
        lin(f"{f}.pwconv2", 4 * d, d)
        s[f"{f}.gamma"] = ((d,), "scale")
    conv(f"{me}.out_proj", d, m, 1)
    s["maskmem_tpos_enc"] = ((c["num_maskmem"], 1, 1, m), "trunc")
    s["no_mem_embed"] = ((1, 1, d), "trunc")
    s["no_mem_pos_enc"] = ((1, 1, d), "trunc")
    pe, mc = "sam_prompt_encoder", c["mask_in_chans"]
    s[f"{pe}.pe_layer.positional_encoding_gaussian_matrix"] = ((2, d // 2), "normal")
    for k in range(4):
        s[f"{pe}.point_embeddings.{k}.weight"] = ((1, d), "normal")
    s[f"{pe}.not_a_point_embed.weight"] = ((1, d), "normal")
    conv(f"{pe}.mask_downscaling.0", 1, mc // 4, 2)
    norm(f"{pe}.mask_downscaling.1", mc // 4)
    conv(f"{pe}.mask_downscaling.3", mc // 4, mc, 2)
    norm(f"{pe}.mask_downscaling.4", mc)
    conv(f"{pe}.mask_downscaling.6", mc, d, 1)
    s[f"{pe}.no_mask_embed.weight"] = ((1, d), "normal")
    md = "sam_mask_decoder"
    for i in range(2):
        la = f"{md}.transformer.layers.{i}"
        _attn(lin, f"{la}.self_attn", d, d)
        norm(f"{la}.norm1", d)
        _attn(lin, f"{la}.cross_attn_token_to_image", d, d // 2)
        norm(f"{la}.norm2", d)
        mlp(f"{la}.mlp", [d, c["decoder_mlp"], d])
        norm(f"{la}.norm3", d)
        norm(f"{la}.norm4", d)
        _attn(lin, f"{la}.cross_attn_image_to_token", d, d // 2)
    _attn(lin, f"{md}.transformer.final_attn_token_to_image", d, d // 2)
    norm(f"{md}.transformer.norm_final_attn", d)
    s[f"{md}.iou_token.weight"] = ((1, d), "normal")
    s[f"{md}.mask_tokens.weight"] = ((4, d), "normal")
    s[f"{md}.obj_score_token.weight"] = ((1, d), "normal")
    deconv(f"{md}.output_upscaling.0", d, d // 4, 2)
    norm(f"{md}.output_upscaling.1", d // 4)
    deconv(f"{md}.output_upscaling.3", d // 4, d // 8, 2)
    conv(f"{md}.conv_s0", d, d // 8, 1)
    conv(f"{md}.conv_s1", d, d // 4, 1)
    for k in range(4):
        mlp(f"{md}.output_hypernetworks_mlps.{k}", [d, d, d, d // 8])
    mlp(f"{md}.iou_prediction_head", [d, 256, 256, 4])
    mlp(f"{md}.pred_obj_score_head", [d, d, d, 1])
    mlp("obj_ptr_proj", [d, d, d, d])
    lin("obj_ptr_tpos_proj", d, m)
    s["no_obj_ptr"] = ((1, d), "trunc")
    s["no_obj_embed_spatial"] = ((1, m), "trunc")
    return s


def _attn(lin, name, d, internal):
    lin(f"{name}.q_proj", d, internal)
    lin(f"{name}.k_proj", d, internal)
    lin(f"{name}.v_proj", d, internal)
    lin(f"{name}.out_proj", internal, d)


def _stage_ends(stages) -> list:
    return [sum(stages[:i]) - 1 for i in range(1, len(stages) + 1)]


def shapes(cfg: dict) -> dict:
    return {k: v[0] for k, v in spec(cfg).items()}


@torch.no_grad()
def init_weights(cfg: dict, generator: torch.Generator, device,
                 dtype=torch.float32) -> dict:
    """Seeded weights, drawn tensor by tensor in ``spec`` order."""
    p = {}
    for name, (shape, how) in spec(cfg).items():
        t = torch.empty(shape, device=device, dtype=dtype)
        if isinstance(how, tuple):
            bound = 1.0 / math.sqrt(how[1])
            t.uniform_(-bound, bound, generator=generator)
        elif how == "trunc":
            torch.nn.init.trunc_normal_(t, std=0.02, generator=generator)
        elif how == "normal":
            t.normal_(generator=generator)
        else:
            t.fill_({"one": 1.0, "zero": 0.0, "scale": 1e-6}[how])
        p[name] = t
    return p


# ------------------------------------------------------------ the model


class Sam2Ref:
    """The weights ``p`` and how to compute (module docstring)."""

    def __init__(self, p: dict, cfg: dict, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.p = p
        self.c = model_config(cfg)
        self.precision = precision
        self.dtype = next(iter(p.values())).dtype
        self.device = next(iter(p.values())).device

    def q(self, x):
        return _RoundFp8.apply(x) if self.precision == "fp8" else x

    # -- primitives

    def lin(self, x, name):
        return self.q(F.linear(self.q(x), self.q(self.p[f"{name}.weight"]),
                               self.p[f"{name}.bias"]))

    def conv(self, x, name, stride=1, padding=0, groups=1):
        return self.q(F.conv2d(self.q(x), self.q(self.p[f"{name}.weight"]),
                               self.p[f"{name}.bias"], stride, padding, 1, groups))

    def deconv(self, x, name):
        return self.q(F.conv_transpose2d(self.q(x), self.q(self.p[f"{name}.weight"]),
                                         self.p[f"{name}.bias"], stride=2))

    def ln(self, x, name, eps=1e-5):
        return F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"], self.p[f"{name}.bias"],
                            eps)

    def ln2d(self, x, name, eps=1e-6):
        u = x.mean(1, keepdim=True)
        v = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(v + eps)
        return self.p[f"{name}.weight"][:, None, None] * x + self.p[f"{name}.bias"][:, None, None]

    def mlp(self, x, name, n, act=F.relu):
        for i in range(n):
            x = self.lin(x, f"{name}.layers.{i}")
            if i < n - 1:
                x = act(x)
        return x

    def attend(self, q, k, v):
        """softmax(q k^T / sqrt(d)) v, written out, over (..., N, d); the
        queries in blocks."""
        scale = 1.0 / math.sqrt(q.shape[-1])
        kt = k.transpose(-1, -2)
        out = [torch.softmax((q[..., i:i + QUERY_BLOCK, :] @ kt) * scale, dim=-1) @ v
               for i in range(0, q.shape[-2], QUERY_BLOCK)]
        return self.q(torch.cat(out, dim=-2))

    def attention(self, name, q, k, v, heads):
        """The published ``Attention``: projections, ``heads`` heads, out."""
        def split(x):
            return x.reshape(*x.shape[:-1], heads, -1).transpose(-2, -3)

        o = self.attend(split(self.lin(q, f"{name}.q_proj")), split(self.lin(k, f"{name}.k_proj")),
                        split(self.lin(v, f"{name}.v_proj")))
        o = o.transpose(-2, -3)
        return self.lin(o.reshape(*o.shape[:-2], -1), f"{name}.out_proj")

    # -- the image encoder

    def preprocess(self, frame: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) BGR uint8 -> (1, 3, S, S) normalised RGB."""
        s = self.c["image_size"]
        x = frame[..., [2, 1, 0]].permute(2, 0, 1)[None].to(self.dtype)
        x = F.interpolate(x, size=(s, s), mode="bilinear", align_corners=False) / 255.0
        mean = torch.tensor([0.485, 0.456, 0.406], dtype=self.dtype, device=x.device)
        std = torch.tensor([0.229, 0.224, 0.225], dtype=self.dtype, device=x.device)
        return (x - mean[:, None, None]) / std[:, None, None]

    def hiera(self, x) -> list:
        c, t = self.c, "image_encoder.trunk"
        x = self.conv(x, f"{t}.patch_embed.proj", 4, 3).permute(0, 2, 3, 1)
        h, w = x.shape[1:3]
        pe = F.interpolate(self.p[f"{t}.pos_embed"], size=(h, w), mode="bicubic")
        win = self.p[f"{t}.pos_embed_window"]
        pe = pe + win.repeat(1, 1, h // win.shape[2], w // win.shape[3])
        x = x + pe.permute(0, 2, 3, 1)
        ends = _stage_ends(c["stages"])
        pools = [e + 1 for e in ends[:-1]]
        dim, heads, stage, outs = c["embed_dim"], c["num_heads"], 0, []
        for i in range(sum(c["stages"])):
            window = 0 if i in c["global_att_blocks"] else c["window_spec"][stage]
            out = dim
            if i - 1 in ends:
                out, heads, stage = 2 * dim, 2 * heads, stage + 1
            x = self.hiera_block(x, f"{t}.blocks.{i}", dim, out, heads, window, i in pools)
            dim = out
            if i in ends:
                outs.append(x.permute(0, 3, 1, 2))
        return outs

    def hiera_block(self, x, name, dim, out, heads, window, pool):
        shortcut = x
        x = self.ln(x, f"{name}.norm1", 1e-6)
        if out != dim:
            shortcut = _maxpool(self.lin(x, f"{name}.proj"))
        h, w = x.shape[1:3]
        if window:
            x, hp, wp = _windows(x, window)
        b, wh, ww, _ = x.shape
        qkv = self.lin(x, f"{name}.attn.qkv").reshape(b, wh * ww, 3, heads, out // heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if pool:
            q = _maxpool(q.reshape(b, wh, ww, out))
            wh, ww = q.shape[1:3]
            q = q.reshape(b, wh * ww, heads, out // heads)
        o = self.attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        o = self.lin(o.transpose(1, 2).reshape(b, wh, ww, out), f"{name}.attn.proj")
        if window:
            if pool:
                window //= 2
                h, w = shortcut.shape[1:3]
                hp, wp = -(-h // window) * window, -(-w // window) * window
            o = _unwindows(o, window, hp, wp)[:, :h, :w]
        x = shortcut + o
        return x + self.mlp(self.ln(x, f"{name}.norm2", 1e-6), f"{name}.mlp", 2, F.gelu)

    def image(self, frame: torch.Tensor) -> dict:
        """One frame's maps: ``feat`` (1, d, s, s), ``s0`` and ``s1`` (the
        decoder's ``conv_s0`` / ``conv_s1`` of the two finer levels)."""
        xs = self.hiera(self.preprocess(frame))
        n = len(xs) - 1
        out, prev = [None] * len(xs), None
        for i in range(n, -1, -1):
            lat = self.conv(xs[i], f"image_encoder.neck.convs.{n - i}.conv")
            if i in (n - 1, n) and prev is not None:
                lat = lat + F.interpolate(prev, scale_factor=2.0, mode="nearest")
            out[i] = prev = lat
        md = "sam_mask_decoder"
        return {"feat": out[2], "s0": self.conv(out[0], f"{md}.conv_s0"),
                "s1": self.conv(out[1], f"{md}.conv_s1")}

    # -- positions

    def sine2d(self, ch: int, h: int, w: int) -> torch.Tensor:
        """(ch, h, w) normalised sine position, y's half first."""
        half, dt = ch // 2, self.dtype
        y = torch.arange(1, h + 1, dtype=dt, device=self.device)[:, None].repeat(1, w)
        x = torch.arange(1, w + 1, dtype=dt, device=self.device)[None, :].repeat(h, 1)
        y = y / (y[-1:, :] + 1e-6) * 2 * math.pi
        x = x / (x[:, -1:] + 1e-6) * 2 * math.pi
        dim_t = 10000.0 ** (2 * (torch.arange(half, dtype=dt, device=self.device) // 2) / half)
        px, py = x[..., None] / dim_t, y[..., None] / dim_t
        px = torch.stack((px[..., 0::2].sin(), px[..., 1::2].cos()), dim=3).flatten(2)
        py = torch.stack((py[..., 0::2].sin(), py[..., 1::2].cos()), dim=3).flatten(2)
        return torch.cat((py, px), dim=2).permute(2, 0, 1)

    def fourier(self, coords):
        g = self.p["sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
        c = 2 * math.pi * ((2 * coords - 1) @ g)
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def rope(self) -> torch.Tensor:
        """(N, d / 2) complex phases of the axial RoPE over the s x s grid."""
        d, s, theta = self.c["d_model"], self.c["image_size"] // 16, self.c["rope_theta"]
        freqs = 1.0 / theta ** (torch.arange(0, d, 4, device=self.device)[: d // 4].to(self.dtype)
                                / d)
        t = torch.arange(s * s, device=self.device).to(self.dtype)
        ax = torch.outer(t % s, freqs)
        ay = torch.outer(torch.div(t, s, rounding_mode="floor"), freqs)
        angles = torch.cat([ax, ay], dim=-1)
        return torch.polar(torch.ones_like(angles), angles)

    @staticmethod
    def rotate(x, phases):
        """x (N', d) with N' a multiple of N: the published complex product."""
        r = x.shape[0] // phases.shape[0]
        z = torch.view_as_complex(x.reshape(x.shape[0], -1, 2).contiguous())
        return torch.view_as_real(z * phases.repeat(r, 1)).flatten(1).to(x.dtype)

    # -- one object's frame

    def memory_attention(self, feat, memory, memory_pos, ptr_tokens, probe=None):
        """feat (N, d) of the 64x64 level; memory (M, mem_dim) -> (N, d).
        ``probe``, a list, receives each layer's (self, cross) spread of the
        attention logits q k / sqrt(d) (over the first queries)."""
        s = self.c["image_size"] // 16
        pos = self.sine2d(self.c["d_model"], s, s).flatten(1).t()
        phases = self.rope()
        x = feat + 0.1 * pos
        k_in = memory + memory_pos
        n = memory.shape[0] - ptr_tokens
        for i in range(self.c["memattn_layers"]):
            la = f"memory_attention.layers.{i}"
            t = self.ln(x, f"{la}.norm1")
            qs = self.rotate(self.lin(t, f"{la}.self_attn.q_proj"), phases)
            ks = self.rotate(self.lin(t, f"{la}.self_attn.k_proj"), phases)
            o = self.attend(qs, ks, self.lin(t, f"{la}.self_attn.v_proj"))
            x = x + self.lin(o, f"{la}.self_attn.out_proj")
            t = self.ln(x, f"{la}.norm2")
            ca = f"{la}.cross_attn_image"
            qc = self.rotate(self.lin(t, f"{ca}.q_proj"), phases)
            kc = self.lin(k_in, f"{ca}.k_proj")
            kc = torch.cat([self.rotate(kc[:n], phases), kc[n:]]) if n else kc
            o = self.attend(qc, kc, self.lin(memory, f"{ca}.v_proj"))
            if probe is not None:
                scale = 1.0 / math.sqrt(qs.shape[-1])
                probe.append((float((qs[:QUERY_BLOCK] @ ks.t()).std() * scale),
                              float((qc[:QUERY_BLOCK] @ kc.t()).std() * scale)))
            x = x + self.lin(o, f"{ca}.out_proj")
            t = self.ln(x, f"{la}.norm3")
            x = x + self.lin(F.relu(self.lin(t, f"{la}.linear1")), f"{la}.linear2")
        return self.ln(x, "memory_attention.norm")

    def decoder(self, pix, maps, sparse):
        """pix (d, s, s), sparse (n, d) -> masks (4, 4s, 4s), IoUs (4,),
        mask tokens (4, d), the object score logit, and the upscaled map
        (d / 8, 4s, 4s) that the hypernetworks' outputs weigh."""
        md, pe = "sam_mask_decoder", "sam_prompt_encoder"
        d, s = self.c["d_model"], pix.shape[-1]
        heads = self.c["decoder_heads"]
        g = (torch.arange(s, dtype=self.dtype, device=self.device) + 0.5) / s
        grid = torch.stack([g[None, :].repeat(s, 1), g[:, None].repeat(1, s)], dim=-1)
        key_pe = self.fourier(grid).reshape(s * s, d)
        keys = (pix + self.p[f"{pe}.no_mask_embed.weight"][0][:, None, None]).flatten(1).t()
        tokens = torch.cat([self.p[f"{md}.obj_score_token.weight"], self.p[f"{md}.iou_token.weight"],
                            self.p[f"{md}.mask_tokens.weight"], sparse])
        queries, tr = tokens, f"{md}.transformer"
        for i in range(2):
            la = f"{tr}.layers.{i}"
            if i == 0:
                queries = self.attention(f"{la}.self_attn", queries, queries, queries, heads)
            else:
                qq = queries + tokens
                queries = queries + self.attention(f"{la}.self_attn", qq, qq, queries, heads)
            queries = self.ln(queries, f"{la}.norm1")
            queries = self.ln(queries + self.attention(f"{la}.cross_attn_token_to_image",
                                                       queries + tokens, keys + key_pe, keys,
                                                       heads), f"{la}.norm2")
            queries = self.ln(queries + self.mlp(queries, f"{la}.mlp", 2), f"{la}.norm3")
            keys = self.ln(keys + self.attention(f"{la}.cross_attn_image_to_token",
                                                 keys + key_pe, queries + tokens, queries, heads),
                           f"{la}.norm4")
        queries = self.ln(queries + self.attention(f"{tr}.final_attn_token_to_image",
                                                   queries + tokens, keys + key_pe, keys, heads),
                          f"{tr}.norm_final_attn")
        src = keys.t().reshape(1, d, s, s)
        up = self.deconv(src, f"{md}.output_upscaling.0") + maps["s1"]
        up = F.gelu(self.ln2d(up, f"{md}.output_upscaling.1"))
        up = F.gelu(self.deconv(up, f"{md}.output_upscaling.3") + maps["s0"])[0]
        hyper = torch.stack([self.mlp(queries[2 + k], f"{md}.output_hypernetworks_mlps.{k}", 3)
                             for k in range(4)])
        masks = self.q((hyper @ up.flatten(1)).reshape(4, *up.shape[1:]))
        iou = torch.sigmoid(self.mlp(queries[1], f"{md}.iou_prediction_head", 3))
        score = self.mlp(queries[0], f"{md}.pred_obj_score_head", 3)[0]
        return masks, iou, queries[2:6], score, up

    def memory_encoder(self, feat, mask):
        """feat (1, d, s, s), mask (S, S) scaled -> (s * s, mem_dim)."""
        me = "memory_encoder"
        x = mask[None, None]
        for k in range(4):
            x = self.conv(x, f"{me}.mask_downsampler.encoder.{3 * k}", 2, 1)
            x = F.gelu(self.ln2d(x, f"{me}.mask_downsampler.encoder.{3 * k + 1}"))
        x = self.conv(x, f"{me}.mask_downsampler.encoder.12")
        x = self.conv(feat, f"{me}.pix_feat_proj") + x
        for k in range(2):
            f = f"{me}.fuser.layers.{k}"
            y = self.ln2d(self.conv(x, f"{f}.dwconv", padding=3, groups=x.shape[1]), f"{f}.norm")
            y = self.lin(F.gelu(self.lin(y.permute(0, 2, 3, 1), f"{f}.pwconv1")), f"{f}.pwconv2")
            x = x + (self.p[f"{f}.gamma"] * y).permute(0, 3, 1, 2)
        return self.conv(x, f"{me}.out_proj")[0].flatten(1).t()

    def pointer_pos(self, dt: float) -> torch.Tensor:
        d = self.c["d_model"]
        pos = torch.tensor(dt / (self.c["max_obj_ptrs"] - 1), dtype=self.dtype, device=self.device)
        dim_t = 10000.0 ** (2 * (torch.arange(d // 2, dtype=self.dtype, device=self.device) // 2)
                            / (d // 2))
        e = pos / dim_t
        return self.lin(torch.cat([e.sin(), e.cos()]), "obj_ptr_tpos_proj")

    def frame(self, maps, hw, box=None, bank=None, choice=None) -> dict:
        """One object on one frame. The conditioning frame takes ``box``
        (x0, y0, x1, y1 in frame pixels); a tracking frame takes ``bank``
        (``select``'s memories and pointers) and takes the best of masks 1-3
        by predicted IoU, or mask ``choice`` where it is given (a check
        following the choice of the system under test, whose near-ties
        rounding can break either way). Returns ``masks`` (4, 4s, 4s) and
        ``up`` (the decoder's upscaled map), ``iou`` (4,), ``score``,
        ``choice`` (the mask taken), ``switched`` (frame 0: the stability
        rule took masks 1-3), ``mask`` (H, W) the sigmoid in the frame,
        ``ptr`` (d,), ``mem`` (s * s, mem_dim)."""
        c, pe = self.c, "sam_prompt_encoder"
        d, m, size = c["d_model"], c["mem_dim"], c["image_size"]
        feat = maps["feat"][0]
        if box is not None:
            h, w = hw
            scale = torch.tensor([size / w, size / h] * 2, dtype=self.dtype, device=self.device)
            corners = ((torch.as_tensor(box, dtype=self.dtype, device=self.device) * scale)
                       .reshape(2, 2) + 0.5) / size
            sparse = self.fourier(corners) + torch.cat(
                [self.p[f"{pe}.point_embeddings.2.weight"], self.p[f"{pe}.point_embeddings.3.weight"]])
            sparse = torch.cat([sparse, self.p[f"{pe}.not_a_point_embed.weight"]])
            pix = feat + self.p["no_mem_embed"][0, 0][:, None, None]
        else:
            sparse = self.p[f"{pe}.not_a_point_embed.weight"].repeat(2, 1)
            memories, pointers = bank
            mem_pos = self.sine2d(m, *feat.shape[1:]).flatten(1).t()
            tpos = self.p["maskmem_tpos_enc"][:, 0, 0]
            mem = torch.cat([f for f, _ in memories] + [p.reshape(-1, m) for p, _ in pointers])
            pos = torch.cat([mem_pos + tpos[i] for _, i in memories]
                            + [self.pointer_pos(dt).repeat(d // m, 1) for _, dt in pointers])
            n_ptr = len(pointers) * (d // m)
            pix = self.memory_attention(feat.flatten(1).t(), mem, pos, n_ptr)
            pix = pix.t().reshape(feat.shape)
        masks, iou, tokens, score, up = self.decoder(pix, maps, sparse)
        if box is not None:
            logits = masks[0].flatten()
            area_i = (logits > c["stability_delta"]).sum().to(self.dtype)
            area_u = (logits > -c["stability_delta"]).sum().to(self.dtype)
            stable = bool(area_u == 0) or float(area_i / area_u) >= c["stability_thresh"]
            choice = 0 if stable else 1 + int(torch.argmax(iou[1:]))
            token = tokens[0]
        else:
            choice = 1 + int(torch.argmax(iou[1:])) if choice is None else int(choice)
            stable, token = True, tokens[choice]
        present = bool(score > 0)
        low = masks[choice] if present else torch.full_like(masks[choice], NO_OBJ_SCORE)
        ptr = self.mlp(token, "obj_ptr_proj", 3) if present else self.p["no_obj_ptr"][0]
        high = F.interpolate(low[None, None], size=(size, size), mode="bilinear",
                             align_corners=False)[0, 0]
        mask_mem = (high > 0).to(self.dtype) if box is not None else torch.sigmoid(high)
        mem = self.memory_encoder(maps["feat"], mask_mem * 20.0 - 10.0)
        if not present:
            mem = mem + self.p["no_obj_embed_spatial"][0]
        in_frame = F.interpolate(low[None, None], size=tuple(hw), mode="bilinear",
                                 align_corners=False)[0, 0]
        return {"masks": masks, "up": up, "iou": iou, "score": score, "choice": choice,
                "switched": box is not None and not stable, "mask": torch.sigmoid(in_frame),
                "ptr": ptr, "mem": self.q(mem)}


def _maxpool(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def _windows(x, w):
    b, h, wd, c = x.shape
    hp, wp = -(-h // w) * w, -(-wd // w) * w
    x = F.pad(x, (0, 0, 0, wp - wd, 0, hp - h))
    x = x.reshape(b, hp // w, w, wp // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w, w, c), hp, wp


def _unwindows(x, w, hp, wp):
    b = x.shape[0] // ((hp // w) * (wp // w))
    x = x.reshape(b, hp // w, wp // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)


# ------------------------------------------------------------ the bank


def select(t: int, frames: dict, cfg: dict) -> tuple:
    """What frame ``t`` attends, by the published loops, from ``frames``
    {frame index: (mem, ptr)}, either None where a frame has none, holding
    the conditioning frame 0: memories
    [(mem, tpos index)] (the conditioning frame at ``num_maskmem - 1``,
    frame t - k at k - 1) and pointers [(ptr, signed offset)] (frame 0 at
    t, frame t - k at k, past frames only)."""
    c = model_config(cfg)
    memories = [(frames[0][0], c["num_maskmem"] - 1)]
    for k in range(c["num_maskmem"] - 1, 0, -1):        # t_pos 1 .. 6: t-6 .. t-1
        if t - k >= 1 and frames.get(t - k, (None,))[0] is not None:
            memories.append((frames[t - k][0], k - 1))
    pointers = [(frames[0][1], t)]
    for k in range(1, c["max_obj_ptrs"]):
        if t - k < 1:
            break
        if frames.get(t - k, (None, None))[1] is not None:
            pointers.append((frames[t - k][1], k))
    return memories, pointers


class Tracker:
    """O objects, each with its own bank (a dict), advanced together: the
    control in the program's place, and the CPU tests' closed loop."""

    def __init__(self, ref: Sam2Ref):
        self.ref = ref

    def init(self, frame: torch.Tensor, pos, sz) -> list:
        ref, hw = self.ref, frame.shape[:2]
        maps = ref.image(frame)
        self.t = 1
        self.banks, outs = [], []
        for (cx, cy), (w, h) in zip(torch.as_tensor(pos).tolist(), torch.as_tensor(sz).tolist()):
            out = ref.frame(maps, hw, box=(cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2))
            self.banks.append({0: (out["mem"], out["ptr"])})
            outs.append(out)
        return outs

    def step(self, frame: torch.Tensor) -> list:
        ref, hw = self.ref, frame.shape[:2]
        maps = ref.image(frame)
        outs = []
        for bank in self.banks:
            out = ref.frame(maps, hw, bank=select(self.t, bank, ref.c))
            bank[self.t] = (out["mem"], out["ptr"])
            old = self.t - ref.c["max_obj_ptrs"] + 1
            if old >= 1:                        # never attended again
                bank.pop(old, None)
            outs.append(out)
        self.t += 1
        return outs
