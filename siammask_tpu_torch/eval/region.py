"""VOT region overlap: a ctypes binding of ``csrc/region_overlap.cpp``.

Counterpart of ``siammask_tpu/eval/region.py`` (the reference Cython API,
``utils/pysot/utils/region.pyx``): ``vot_overlap``, ``vot_overlap_traj``,
``rasterize_polygon`` and ``vot_float2str``. A 4-number region is an
[x, y, w, h] rect, expanded to 4 points as the reference wrapper does; a
region of length 1 (the protocol's markers) gives NaN.

The C++ source is compiled where it is, with ``g++ -O2 -shared -fPIC
-std=c++17``, at first use (never at import) into the gitignored
``build/kernels/``, named by a hash of the source and flags, through
``ops/_build.compile_library`` (an atomic rename, so concurrent builds
never see half a library).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from siammask_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "region_overlap.cpp"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_FP = ctypes.POINTER(ctypes.c_float)


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.compile_library("g++", FLAGS, (SOURCE,), "region_overlap")))
    lib.region_polygon_overlap.restype = ctypes.c_float
    lib.region_polygon_overlap.argtypes = [_FP, _FP, ctypes.c_int, _FP, _FP, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_float, ctypes.c_float,
                                           ctypes.c_float]
    lib.region_rasterize.restype = ctypes.c_int
    lib.region_rasterize.argtypes = [_FP, _FP, ctypes.c_int, ctypes.POINTER(ctypes.c_char),
                                     ctypes.c_int, ctypes.c_int]
    return lib


def _to_polygon(region) -> tuple[np.ndarray, np.ndarray]:
    """Region -> contiguous float32 (xs, ys). Takes the flat list (4 numbers:
    an xywh rect; 2N: polygon coordinates) and the sequence of (x, y) point
    pairs that the online tracker passes."""
    arr = np.asarray(list(region), dtype=np.float32)
    if arr.ndim == 2:                      # point pairs
        return np.ascontiguousarray(arr[:, 0]), np.ascontiguousarray(arr[:, 1])
    if len(arr) == 4:                      # flat xywh rect
        x, y, w, h = arr
        arr = np.asarray([x, y, x + w, y, x + w, y + h, x, y + h], np.float32)
    return np.ascontiguousarray(arr[0::2]), np.ascontiguousarray(arr[1::2])


def _bounds(bounds) -> tuple[float, float, float, float]:
    """(top, bottom, left, right): given as 4 numbers, from (width, height),
    or unbounded."""
    if bounds is not None and len(bounds) == 4:
        return tuple(float(v) for v in bounds)
    if bounds is not None and len(bounds) == 2:
        return 0.0, float(bounds[1]), 0.0, float(bounds[0])
    return -3.4e38, 3.4e38, -3.4e38, 3.4e38


def vot_overlap(polygon1, polygon2, bounds=None) -> float:
    """Overlap (IoU on the protocol's integer raster) of two regions,
    clipped to ``bounds``."""
    if len(polygon1) == 1 or len(polygon2) == 1:
        return float("nan")
    x1, y1 = _to_polygon(polygon1)
    x2, y2 = _to_polygon(polygon2)
    return _load().region_polygon_overlap(
        x1.ctypes.data_as(_FP), y1.ctypes.data_as(_FP), len(x1),
        x2.ctypes.data_as(_FP), y2.ctypes.data_as(_FP), len(x2), *_bounds(bounds))


def vot_overlap_traj(polygons1, polygons2, bounds=None) -> list[float]:
    """``vot_overlap`` of each pair of two equally long trajectories."""
    if len(polygons1) != len(polygons2):
        raise ValueError(f"trajectories of {len(polygons1)} and {len(polygons2)} regions")
    return [vot_overlap(a, b, bounds=bounds) for a, b in zip(polygons1, polygons2)]


def rasterize_polygon(polygon, width: int, height: int) -> np.ndarray:
    """One polygon as a (height, width) uint8 mask on the protocol's grid."""
    x, y = _to_polygon(polygon)
    mask = np.zeros((height, width), dtype=np.uint8)
    _load().region_rasterize(x.ctypes.data_as(_FP), y.ctypes.data_as(_FP), len(x),
                             mask.ctypes.data_as(ctypes.POINTER(ctypes.c_char)), width, height)
    return mask


def vot_float2str(template: str, value: float) -> str:
    """printf-style float formatting, as the VOT result writers use."""
    return template % value
