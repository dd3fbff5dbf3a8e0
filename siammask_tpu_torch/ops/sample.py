"""Separable bilinear sampling with a constant border: the search/template
crop and the mask warp-back of the tracker step, in plain PyTorch, for O
windows at once.

Counterpart of the gather path of ``siammask_tpu/ops/sample.py`` and of its
``vmap`` over streams (``siammask_tpu/tracker/tracker.py`` ``_step_vmap``):
the stream axis is written out as a leading dimension. Both maps are
axis-aligned (ys depends only on the output row, xs only on the output
column), so the 2-D bilinear sample factorises into two 1-D gathers. Any tap
that falls outside the image takes the per-channel border value, which
reproduces the reference's mean-padded crop buffer and cv2's
BORDER_CONSTANT. All coordinates stay on the device: nothing here syncs.
"""
from __future__ import annotations

import torch


def separable_bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                              border: torch.Tensor) -> torch.Tensor:
    """Sample O windows: ``img`` (1, H, W, C), one image shared by every
    window, or (O, H, W, C), one each, at the grids ys (O, M) x xs (O, N)
    -> (O, M, N, C), columns first. ``border`` (O, C) replaces every
    out-of-range tap of its window.

    An integer image (a uint8 frame) is cast to float32 after the first
    gather, so no full-frame float copy is made; gather and cast commute."""
    o = ys.shape[0]
    _, h, w, _ = img.shape
    compute_dtype = img.dtype if img.is_floating_point() else torch.float32
    border = border.to(compute_dtype)[:, None, None, :]

    def interp_axis(src, coords, axis, extent):
        c0 = torch.floor(coords)
        shape = [o, 1, 1, 1]
        shape[axis] = -1
        frac = (coords - c0).view(shape)
        c0i = c0.long()
        src = src.expand(o, *src.shape[1:])
        out_shape = list(src.shape)
        out_shape[axis] = coords.shape[1]

        def take(ci):
            index = ci.clamp(0, extent - 1).view(shape).expand(out_shape)
            lines = src.gather(axis, index)
            if not lines.is_floating_point():
                lines = lines.to(compute_dtype)
            valid = ((ci >= 0) & (ci < extent)).view(shape)
            return torch.where(valid, lines, border)

        return take(c0i) * (1.0 - frac) + take(c0i + 1) * frac

    tmp = interp_axis(img, xs, 2, w)     # (O, H, N, C)
    return interp_axis(tmp, ys, 1, h)    # (O, M, N, C)


def subwindow_crop(frame: torch.Tensor, pos_xy: torch.Tensor, crop_sz: torch.Tensor,
                   model_sz: int, avg_chans: torch.Tensor) -> torch.Tensor:
    """On-device ``get_subwindow_tracking`` of O windows of one shared
    (H, W, C) frame: pos_xy (O, 2), crop_sz (O,), avg_chans (O, C) ->
    (O, model_sz, model_sz, C) float32.

    The reference crops an integer-aligned square of side ``crop_sz`` at origin
    ``round(pos - (crop_sz + 1) / 2)`` (half to even, as ``torch.round``) and
    resizes it to ``model_sz`` with cv2's half-pixel bilinear grid. Output
    pixel u samples ``origin + (u + 0.5) * crop_sz / model_sz - 0.5``, clamped
    to the window ``[0, crop_sz - 1]`` because cv2.resize edge-replicates
    inside the crop. Out-of-frame samples take ``avg_chans``."""
    crop_sz = crop_sz.to(torch.float32)[:, None]
    c = (crop_sz + 1.0) / 2.0
    ox = torch.round(pos_xy[:, :1] - c)
    oy = torch.round(pos_xy[:, 1:] - c)
    u = (torch.arange(model_sz, dtype=torch.float32, device=frame.device) + 0.5) \
        * (crop_sz / model_sz) - 0.5
    u = torch.minimum(torch.maximum(u, torch.zeros_like(crop_sz)), crop_sz - 1.0)
    return separable_bilinear_sample(frame[None], oy + u, ox + u, avg_chans)


def warp_back_mask(mask: torch.Tensor, back_box: torch.Tensor, out_hw: tuple[int, int],
                   border_value: float = -1.0) -> torch.Tensor:
    """On-device ``crop_back``: O cell masks (O, S, S) placed into the
    (H, W) frame with back_box (O, 4) -> (O, H, W). Frame pixel (x, y)
    samples mask coordinate ``(x * bw / (W - 1) + bx, y * bh / (H - 1) + by)``
    for back_box [bx, by, bw, bh] (the reference's historical ``out - 1``
    divisor); the border is ``border_value``."""
    out_h, out_w = out_hw
    bx, by, bw, bh = back_box[:, :, None].unbind(1)
    xs = torch.arange(out_w, dtype=torch.float32, device=mask.device) * (bw / (out_w - 1)) + bx
    ys = torch.arange(out_h, dtype=torch.float32, device=mask.device) * (bh / (out_h - 1)) + by
    border = torch.full((mask.shape[0], 1), border_value, dtype=mask.dtype, device=mask.device)
    return separable_bilinear_sample(mask[..., None], ys, xs, border)[..., 0]
