"""Plain SiamMask-sharp tracker step in float32 for O objects on one frame:
the sub-window crop, the network (``model.Net``), the anchor decode with its
scale/ratio penalty and cosine window, the size update, Refine at the chosen
cell, the warp-back into the frame, the threshold and the rotated box.

The formulas are those of foolwood/SiamMask ``tools/test.py``
(``siamese_init`` / ``siamese_track``, ``get_subwindow_tracking``,
``crop_back``): crop sides rounded half to even, cv2's half-pixel bilinear
resize of the integer-aligned window with mean-colour padding, and the
``out - 1`` divisor of ``crop_back``. The crop and warp-back are written as
two 1-D gathers each; nothing here reads the program under test.

``step`` can be told which cell to take (``best``): the benchmark's check
hands it the cell the program chose, and judges the program by the gap
between the score there and the best score, and by the box and mask
computed at that cell.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.model import Net, skip_windows

EXEMPLAR, INSTANCE, STRIDE, BASE = 127, 255, 8, 8
CONTEXT = 0.5
RATIOS, SCALES = (0.33, 0.5, 1, 2, 3), (8,)
SCORE_SIZE = (INSTANCE - EXEMPLAR) // STRIDE + 1 + BASE    # 25
OUT_SIZE = 127


def score_map_anchors() -> np.ndarray:
    """(K*S*S, 4) (cx, cy, w, h), anchor-major, the published tracker's
    ``generate_anchor`` (integer widths, as ``round_dight`` 0)."""
    rows = []
    size = STRIDE * STRIDE
    for r in RATIOS:
        ws = int(math.sqrt(size / r))
        hs = int(ws * r)
        for s in SCALES:
            rows.append((ws * s, hs * s))
    s = SCORE_SIZE
    ori = -(s // 2) * STRIDE
    grid = ori + STRIDE * np.arange(s)
    xx, yy = np.meshgrid(grid, grid)
    out = []
    for w, h in rows:
        out.append(np.stack([xx.ravel(), yy.ravel(), np.full(s * s, w), np.full(s * s, h)], 1))
    return np.concatenate(out).astype(np.float32)


def cosine_window() -> np.ndarray:
    w = np.outer(np.hanning(SCORE_SIZE), np.hanning(SCORE_SIZE))
    return np.tile(w.ravel(), len(RATIOS) * len(SCALES)).astype(np.float32)


def context_size(sz: torch.Tensor) -> torch.Tensor:
    total = sz.sum(-1)
    return torch.sqrt((sz[..., 0] + CONTEXT * total) * (sz[..., 1] + CONTEXT * total))


def _sample(img, ys, xs, border):
    """img (1 or O, H, W, C) float at grids ys (O, M) x xs (O, N) -> (O, M,
    N, C), bilinear, taps outside the image take ``border`` (O, C)."""
    o = ys.shape[0]
    border = border[:, None, None, :]

    def axis(src, coords, dim, extent):
        c0 = torch.floor(coords)
        shape = [o, 1, 1, 1]
        shape[dim] = -1
        frac = (coords - c0).view(shape)
        c0 = c0.long()
        src = src.expand(o, *src.shape[1:])
        out_shape = list(src.shape)
        out_shape[dim] = coords.shape[1]

        def take(ci):
            lines = src.gather(dim, ci.clamp(0, extent - 1).view(shape).expand(out_shape))
            return torch.where(((ci >= 0) & (ci < extent)).view(shape), lines, border)

        return take(c0) * (1.0 - frac) + take(c0 + 1) * frac

    return axis(axis(img, xs, 2, img.shape[2]), ys, 1, img.shape[1])


def crop(frame: torch.Tensor, pos, side, size: int, avg) -> torch.Tensor:
    """``get_subwindow_tracking`` of O windows of one (H, W, 3) frame:
    pos (O, 2), side (O,), avg (O, 3) -> (O, 3, size, size) float32."""
    side = side.to(torch.float32)[:, None]
    c = (side + 1.0) / 2.0
    ox = torch.round(pos[:, :1] - c)
    oy = torch.round(pos[:, 1:] - c)
    u = (torch.arange(size, dtype=torch.float32, device=frame.device) + 0.5) * (side / size) - 0.5
    u = torch.minimum(torch.maximum(u, torch.zeros_like(side)), side - 1.0)
    out = _sample(frame.to(torch.float32)[None], oy + u, ox + u, avg)
    return out.permute(0, 3, 1, 2).contiguous()


def warp_back(mask, box, hw, border=-1.0):
    """``crop_back`` of O cell masks (O, S, S) with box (O, 4) [bx, by, bw, bh]
    into (O, H, W): frame pixel (x, y) samples (x bw / (W-1) + bx, y bh /
    (H-1) + by)."""
    h, w = hw
    bx, by, bw, bh = box[:, :, None].unbind(1)
    xs = torch.arange(w, dtype=torch.float32, device=mask.device) * (bw / (w - 1)) + bx
    ys = torch.arange(h, dtype=torch.float32, device=mask.device) * (bh / (h - 1)) + by
    fill = torch.full((mask.shape[0], 1), border, dtype=mask.dtype, device=mask.device)
    return _sample(mask[..., None], ys, xs, fill)[..., 0]


class Template:
    """What ``siamese_init`` keeps of O objects: template features and the
    frame's channel means."""

    def __init__(self, net: Net, frame: torch.Tensor, pos, sz):
        o = pos.shape[0]
        self.avg = frame.to(torch.float32).mean(dim=(0, 1)).expand(o, -1).contiguous()
        side = torch.round(context_size(sz))
        self.zf = net.template(crop(frame, pos, side, EXEMPLAR, self.avg))


def step(net: Net, hp: dict, template: Template, frame: torch.Tensor, pos, sz, best=None):
    """One frame of ``siamese_track`` for O objects whose state before it is
    pos, sz (O, 2) float32. ``best`` (O,) int, the flat (k, y, x) cell to
    take; by default each object's own argmax. Returns a dict of tensors:
    ``pscore`` (O, K*S*S), ``best``, ``pos``, ``sz``, ``score`` (the
    score at ``best``), ``cell_mask`` (O, 127, 127), the sigmoid mask at the
    cell, and ``mask`` (O, H, W), that mask in the frame."""
    dev = frame.device
    im_h, im_w = frame.shape[:2]
    anchor = torch.as_tensor(score_map_anchors(), device=dev)
    window = torch.as_tensor(cosine_window(), device=dev)
    s_x = context_size(sz)
    scale_x = EXEMPLAR / s_x
    s_x_full = torch.round(s_x + 2 * ((INSTANCE - EXEMPLAR) / 2 / scale_x))
    x = crop(frame, pos, s_x_full, INSTANCE, template.avg)
    p0, p1, p2, p3 = net.backbone(x)
    xf = net.neck(p3)
    cls, loc = net.rpn(template.zf, xf)
    corr = net.corr("mask_model.mask", template.zf, xf)

    o, k = cls.shape[0], len(RATIOS) * len(SCALES)
    logits = cls.reshape(o, 2, -1)
    score = net.q(torch.sigmoid(net.q(logits[:, 1] - logits[:, 0])))
    delta = loc.reshape(o, 4, -1)
    dx = delta[:, 0] * anchor[:, 2] + anchor[:, 0]
    dy = delta[:, 1] * anchor[:, 3] + anchor[:, 1]
    dw = torch.exp(delta[:, 2].clamp(-20.0, 20.0)) * anchor[:, 2]
    dh = torch.exp(delta[:, 3].clamp(-20.0, 20.0)) * anchor[:, 3]

    def change(r):
        return torch.maximum(r, 1.0 / r)

    def sz_of(w, h):
        pad = (w + h) * 0.5
        return torch.sqrt((w + pad) * (h + pad))

    tw = (sz[:, 0] * scale_x)[:, None]
    th = (sz[:, 1] * scale_x)[:, None]
    penalty = torch.exp(-(change((tw / th) / (dw / dh)) * change(sz_of(dw, dh) / sz_of(tw, th))
                          - 1) * hp["penalty_k"])
    pscore = penalty * score * (1 - hp["window_influence"]) + window * hp["window_influence"]
    if best is None:
        best = torch.argmax(pscore, dim=1)
    best = torch.as_tensor(best, device=dev).long().reshape(o)
    bi = best[:, None]

    def at(v):
        return v.gather(1, bi)[:, 0]

    lr = (at(penalty) * at(score) * hp["lr"])[:, None]
    new_pos = pos + torch.stack([at(dx), at(dy)], 1) / scale_x[:, None]
    new_sz = sz * (1 - lr) + torch.stack([at(dw), at(dh)], 1) / scale_x[:, None] * lr
    wh = torch.tensor([im_w, im_h], dtype=torch.float32, device=dev)
    new_pos = torch.minimum(torch.maximum(new_pos, torch.zeros_like(wh)), wh)
    new_sz = torch.minimum(torch.maximum(new_sz, torch.full_like(wh, 10.0)), wh)

    cell = best % (SCORE_SIZE * SCORE_SIZE)
    rows, cols = (cell // SCORE_SIZE).tolist(), (cell % SCORE_SIZE).tolist()
    w0, w1, w2 = skip_windows(p0, p1, p2, rows, cols)
    cvec = torch.stack([corr[i, :, r, c] for i, (r, c) in enumerate(zip(rows, cols))])
    mask = net.q(torch.sigmoid(net.refine(w0, w1, w2, cvec).reshape(o, OUT_SIZE, OUT_SIZE)))
    # the frame in the best cell's mask coordinates (crop_back's sub-box)
    rc = torch.tensor([rows, cols], dtype=torch.float32, device=dev).T
    sc = s_x_full / INSTANCE
    crop_xy = pos - s_x_full[:, None] / 2
    sub_x = crop_xy[:, 0] + (rc[:, 1] - BASE / 2) * STRIDE * sc
    sub_y = crop_xy[:, 1] + (rc[:, 0] - BASE / 2) * STRIDE * sc
    s2 = OUT_SIZE / (sc * EXEMPLAR)
    box = torch.stack([-sub_x * s2, -sub_y * s2, im_w * s2, im_h * s2], 1)
    return {"pscore": pscore, "best": best, "pos": new_pos, "sz": new_sz,
            "score": at(score), "cell_mask": mask, "mask": warp_back(mask, box, (im_h, im_w))}


# ------------------------------------------------------ the rotated box


# the 8 neighbours clockwise (rows down), starting west
_AROUND = ((0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1))


def outer_contour(comp: np.ndarray) -> np.ndarray:
    """The outer border of one 8-connected component (a boolean array with a
    background margin), traced pixel to pixel (Moore neighbours, stopped when
    the first step repeats), as (N, 2) row, col: the points of the border
    following that the published tracker's contours come from."""
    rows, cols = np.nonzero(comp)
    start = (int(rows[0]), int(cols[0]))          # topmost, then leftmost
    path, cur, back = [start], start, 0           # back: the west neighbour, background
    first = None
    while True:
        for k in range(1, 9):
            i = (back + k) % 8
            nxt = (cur[0] + _AROUND[i][0], cur[1] + _AROUND[i][1])
            if comp[nxt]:
                break
        else:
            return np.array(path)                  # a single pixel
        seen = (cur[0] + _AROUND[(i - 1) % 8][0], cur[1] + _AROUND[(i - 1) % 8][1])
        if first is None:
            first = nxt
        elif cur == start and nxt == first:
            return np.array(path[:-1])
        back = _AROUND.index((seen[0] - nxt[0], seen[1] - nxt[1]))
        path.append(nxt)
        cur = nxt


def _labels(mask: np.ndarray):
    from scipy import ndimage

    labels, _ = ndimage.label(mask, structure=np.ones((3, 3), int))
    return labels, ndimage.find_objects(labels)


def _contour(labels, i: int, sl) -> tuple:
    path = outer_contour(np.pad(labels[sl] == i, 1))
    pts = np.stack([path[:, 1] - 1 + sl[1].start, path[:, 0] - 1 + sl[0].start],
                   1).astype(np.float64)
    x, y = pts[:, 0], pts[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))), pts


def count_components(mask: np.ndarray) -> int:
    """The number of 8-connected components (outer contours) of a mask."""
    return len(_labels(mask)[1])


def largest_contour(mask: np.ndarray):
    """(area, (N, 2) x, y) of the outer contour of largest area as a polygon
    through its points, or None for an empty mask. A contour's area is under
    its bounding box's (h - 1)(w - 1), so components are traced from the
    largest box down until no box can beat the best area."""
    labels, boxes = _labels(mask)
    order = sorted(range(len(boxes)), reverse=True,
                   key=lambda i: (boxes[i][0].stop - boxes[i][0].start - 1)
                   * (boxes[i][1].stop - boxes[i][1].start - 1))
    best = None
    for i in order:
        sl = boxes[i]
        if best is not None and (sl[0].stop - sl[0].start - 1) * (
                sl[1].stop - sl[1].start - 1) <= best[0]:
            break
        found = _contour(labels, i + 1, sl)
        if best is None or found[0] > best[0]:
            best = found
    return best


def _hull(pts: np.ndarray) -> np.ndarray:
    """Convex hull (Andrew's monotone chain), counter-clockwise."""
    pts = np.unique(pts, axis=0)
    if len(pts) < 3:
        return pts

    def turn(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(points):
        chain = []
        for p in points:
            while len(chain) >= 2 and turn(chain[-2], chain[-1], p) <= 0:
                chain.pop()
            chain.append(p)
        return chain[:-1]

    return np.array(half(pts) + half(pts[::-1]))


def min_area_rect(pts: np.ndarray) -> np.ndarray:
    """The four corners of the least-area rectangle holding ``pts`` (rotating
    calipers over the hull's edges)."""
    hull = _hull(pts)
    if len(hull) < 3:
        lo, hi = pts.min(0), pts.max(0)
        return np.array([[lo[0], lo[1]], [hi[0], lo[1]], [hi[0], hi[1]], [lo[0], hi[1]]])
    best = None
    for a, b in zip(hull, np.roll(hull, -1, axis=0)):
        e = (b - a) / np.linalg.norm(b - a)
        n = np.array([-e[1], e[0]])
        u, v = hull @ e, hull @ n
        area = (u.max() - u.min()) * (v.max() - v.min())
        if best is None or area < best[0]:
            best = (area, e, n, u.min(), u.max(), v.min(), v.max())
    _, e, n, u0, u1, v0, v1 = best
    return np.array([e * u + n * v for u, v in ((u0, v0), (u1, v0), (u1, v1), (u0, v1))])


def rotated_box(mask: np.ndarray, pos, sz) -> np.ndarray:
    """The published VOT output of a binary mask: the least-area rectangle of
    the outer contour of largest area when that passes 100 px, else the
    axis-aligned box of pos, sz."""
    found = largest_contour(mask)
    if found is not None and found[0] > 100:
        return min_area_rect(found[1])
    x, y = pos[0] - sz[0] / 2, pos[1] - sz[1] / 2
    return np.array([[x, y], [x + sz[0], y], [x + sz[0], y + sz[1]], [x, y + sz[1]]])


def polygon_gap(a: np.ndarray, b: np.ndarray) -> float:
    """How far rectangle ``a`` is from ``b`` (both (4, 2)): the larger of
    their areas' difference over b's and their centres' distance over the
    side of b's area."""
    def area(p):
        x, y = p[:, 0], p[:, 1]
        return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))

    ab = max(area(b), 1.0)
    return float(max(abs(area(a) - area(b)) / ab,
                     np.linalg.norm(a.mean(0) - b.mean(0)) / math.sqrt(ab)))
