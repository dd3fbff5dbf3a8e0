"""COCO RLE mask codec: a ctypes binding of ``csrc/rle.cpp`` and the
string codec.

Counterpart of ``siammask_tpu/data/rle.py``, with the API of
``pycocotools.mask`` that the reference's data preparation uses
(``data/coco/par_crop.py``): ``decode``, ``encode``, ``merge``, ``area``,
``to_bbox``, ``fr_poly``, and ``ann_to_mask`` for COCO annotation dicts
(polygon list, uncompressed RLE, compressed string RLE).

RLE counts run over the column-major flattened mask; the string codec packs
delta-encoded counts into 5-bit groups over ascii 48+ (LEB128-style).

The C++ source is compiled where it is, with ``g++ -O2 -shared -fPIC
-std=c++17``, at first use (never at import) into the gitignored
``build/kernels/``, named by a hash of the source and flags, through
``ops/_build.compile_library``, as ``eval/region.py`` builds its library.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from siammask_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "rle.cpp"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.compile_library("g++", FLAGS, (SOURCE,), "rle")))
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rle_encode.restype = ctypes.c_int
    lib.rle_encode.argtypes = [u8p, ctypes.c_long, u32p]
    lib.rle_decode.argtypes = [u32p, ctypes.c_int, u8p, ctypes.c_long]
    lib.rle_from_poly.restype = ctypes.c_int
    lib.rle_from_poly.argtypes = [ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                                  ctypes.c_int, ctypes.c_int, u32p]
    lib.rle_merge2.restype = ctypes.c_int
    lib.rle_merge2.argtypes = [u32p, ctypes.c_int, u32p, ctypes.c_int,
                               ctypes.c_int, u32p]
    lib.rle_area.restype = ctypes.c_long
    lib.rle_area.argtypes = [u32p, ctypes.c_int]
    lib.rle_to_bbox.argtypes = [u32p, ctypes.c_int, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_double)]
    return lib


def _u32(arr):
    return np.ascontiguousarray(arr, dtype=np.uint32)


def encode(mask: np.ndarray) -> dict:
    """Binary (H, W) mask -> {'size': [h, w], 'counts': str}."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(np.uint8)).ravel(order="F")
    flat = np.ascontiguousarray(flat)
    out = np.empty(flat.size + 1, dtype=np.uint32)
    lib = _load()
    m = lib.rle_encode(flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       flat.size, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return {"size": [h, w], "counts": counts_to_string(out[:m])}


def decode(rle: dict) -> np.ndarray:
    """{'size': [h, w], 'counts': str|list} -> (H, W) uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (str, bytes)):
        counts = string_to_counts(counts)
    counts = _u32(counts)
    flat = np.empty(h * w, dtype=np.uint8)
    _load().rle_decode(counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                       len(counts),
                       flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       flat.size)
    return flat.reshape((w, h)).T.copy()


def fr_poly(xy, h: int, w: int) -> np.ndarray:
    """Flat [x0,y0,x1,y1,...] polygon -> RLE counts array."""
    xy = np.ascontiguousarray(xy, dtype=np.float64)
    k = len(xy) // 2
    out = np.empty(h * w + 2, dtype=np.uint32)
    m = _load().rle_from_poly(
        xy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), k, h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return out[:m].copy()


def merge(counts_list, h: int, w: int, intersect: bool = False) -> np.ndarray:
    """Merge RLE counts arrays (union by default)."""
    counts_list = [_u32(c) for c in counts_list]
    if not counts_list:
        return np.zeros(0, dtype=np.uint32)
    acc = counts_list[0]
    lib = _load()
    for nxt in counts_list[1:]:
        out = np.empty(h * w + 2, dtype=np.uint32)
        m = lib.rle_merge2(
            acc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(acc),
            nxt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(nxt),
            int(intersect), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        acc = out[:m].copy()
    return acc


def area(counts) -> int:
    counts = _u32(counts)
    return int(_load().rle_area(
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(counts)))


def to_bbox(counts, h: int) -> np.ndarray:
    counts = _u32(counts)
    bb = np.zeros(4, dtype=np.float64)
    _load().rle_to_bbox(counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                        len(counts), h,
                        bb.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return bb


def counts_to_string(counts) -> str:
    """5-bit LEB-style delta char encoding (ascii 48..111)."""
    s = []
    counts = list(map(int, counts))
    for i, c in enumerate(counts):
        x = c - (counts[i - 2] if i > 2 else 0)
        more = True
        while more:
            ch = x & 0x1F
            x >>= 5
            more = (x != -1) if (ch & 0x10) else (x != 0)
            if more:
                ch |= 0x20
            s.append(chr(ch + 48))
    return "".join(s)


def string_to_counts(s) -> np.ndarray:
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts = []
    p = 0
    while p < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, dtype=np.uint32)


def ann_to_mask(ann: dict, h: int, w: int) -> np.ndarray:
    """COCO annotation segmentation -> (H, W) binary mask."""
    segm = ann["segmentation"]
    if isinstance(segm, list):  # polygon(s)
        counts = merge([fr_poly(p, h, w) for p in segm], h, w)
        return decode({"size": [h, w], "counts": counts})
    if isinstance(segm.get("counts"), list):  # uncompressed RLE
        return decode({"size": segm["size"], "counts": segm["counts"]})
    return decode(segm)  # compressed RLE
