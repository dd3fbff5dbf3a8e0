"""Build and load the port's CUDA kernels.

The sources under ``siammask_tpu_torch/csrc/`` have a plain C interface. They
are compiled with ``nvcc`` for Hopper (``sm_90a``) into one shared library in
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the sources and flags, and loaded with ``ctypes``; the
compiler's output stays beside it (``<library>.log``: ptxas's registers and
spills per kernel, ``kernel_resources``). The
first call in a fresh checkout builds it (a few seconds); later calls load
the cached library. ``compile_library`` is the same build for any compiler
(``eval/region.py`` builds the host C++ region overlap with it).

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = (CSRC / "xcorr.cu", CSRC / "bn_train.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(stem: str, flags, sources) -> Path:
    """``BUILD_DIR/lib<stem>_<hash of flags and sources>.so``."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def compile_library(compiler: str, flags, sources, stem: str) -> Path:
    """Compile ``sources`` with ``compiler`` and ``flags`` into
    ``BUILD_DIR/lib<stem>_<hash>.so`` unless that library exists; the
    compiler's output goes to the same name with ``.log``."""
    out = library_path(stem, flags, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [compiler, *flags, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    return compile_library(_nvcc(), NVCC_FLAGS, SOURCES, "siammask_kernels")


def kernel_resources(log: str) -> dict[str, dict[str, int]]:
    """Each kernel's registers and spill bytes from ``nvcc -Xptxas -v``'s
    report in ``log``: {kernel (its name and template arguments where
    ``c++filt`` is found, else mangled): {"registers", "spill_stores",
    "spill_loads"}}."""
    out, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = m.group(1)
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    if shutil.which("c++filt") and out:
        names = subprocess.run(["c++filt"], input="\n".join(out), capture_output=True,
                               text=True, check=True).stdout.splitlines()
        # "void (anonymous namespace)::k<float, true>(float const*, ...)" -> "k<float, true>"
        out = {n.split("::", 1)[-1].split("(")[0]: v for n, v in zip(names, out.values())}
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's C signature."""
    return bind(build())


def bind(path: Path) -> ctypes.CDLL:
    """Load a library built from ``SOURCES`` and declare its entry points'
    C signatures."""
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    # (in0, in1, out, b, hx, wx, c, hk, wk, dtype, kernel, device, stream), all three
    for fn in (lib.siammask_depthwise_xcorr, lib.siammask_depthwise_xcorr_grad_input,
               lib.siammask_depthwise_xcorr_grad_kernel):
        fn.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p]
        fn.restype = i
    f = ctypes.c_float
    # csrc/bn_train.cu: pointers, then ints and floats, then (device, stream)
    lib.siammask_bn_train_stats.argtypes = [p, i, i, i, p, p, p, p, p, p, f, f, i, p]
    lib.siammask_bn_train_apply.argtypes = [p, p, p, i, i, i, p, p, p, p, i, i, p]
    lib.siammask_bn_train_backward_reduce.argtypes = [p, p, p, p, i, i, i, p, p, p, p, i, p, p,
                                                      p, i, p]
    lib.siammask_bn_train_backward_elemt.argtypes = [p, p, p, i, i, i, p, p, p, p, p, i, i, p]
    for fn in (lib.siammask_bn_train_stats, lib.siammask_bn_train_apply,
               lib.siammask_bn_train_backward_reduce, lib.siammask_bn_train_backward_elemt):
        fn.restype = i
    lib.siammask_cuda_error_string.argtypes = [i]
    lib.siammask_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.siammask_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {msg}")
