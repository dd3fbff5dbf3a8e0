#!/usr/bin/env python3
"""Variants of the packed bf16 xcorr kernel, timed against each other on one
NVIDIA card: ``python3 scripts/bench_xcorr_bf16.py [--out FILE]``.

Builds ``siammask_tpu_torch/csrc/xcorr.cu`` as it is and with its packed
kernel's constants changed (``VARIANTS``: four channels a lane with 8-byte
loads, kPackWords 2; the band split's kPackedWarpsPerSM and
kPackedBandRows; a minimum of 4 blocks an SM in the packed kernel's
``__launch_bounds__``, which caps its registers at 128 a thread), one ``nvcc -Xptxas -v`` a variant, all started together,
into ``build/kernels/``. Then, on card 0, at the model's bf16 shapes,
(B, 29, 29, 256) * (B, 5, 5, 256) at B = 1, 16 and 64 and stage 2's
(64, 7, 7, 256) * (64, 5, 5, 256):

- each variant's packed forward and grad-input must equal the scalar bf16
  kernel (the strip kernel's bf16 instantiation) bit for bit, or the script
  exits with an error before it times anything;
- device us a call (a CUDA graph of 100 calls, the median of 5 replays) of
  every variant's packed kernels, the scalar bf16 kernel, the fp32 kernel
  at the same shape and cuDNN's grouped conv in bf16 (the library call),
  taken in turns (each in order, then in reverse; each keeps its faster
  turn), beside the bound (inputs read and output written once at 3.35
  TB/s);
- each variant's registers and spills from ptxas, and from
  ``cuobjdump -sass`` each strip kernel's global loads by width and how
  many a warp issues before an instruction reads one of them (a run:
  loads issued back to back, in flight together).

Prints one line a case and the card's name and power limit, and writes
every number to ``--out`` as JSON. Needs one card; run from the repo root.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from siammask_tpu_torch.ops import _build  # noqa: E402
from siammask_tpu_torch.ops.xcorr import _to_groups  # noqa: E402

# name -> {constant: value} changed in csrc/xcorr.cu ("min_blocks": the packed
# kernel's __launch_bounds__ minimum of blocks an SM); "packed" is the source as it is
VARIANTS = {"packed": {}, "words2": {"kPackWords": 2}, "warps16": {"kPackedWarpsPerSM": 16},
            "band8": {"kPackedBandRows": 8}, "blocks4": {"min_blocks": 4},
            "blocks4_band8": {"min_blocks": 4, "kPackedBandRows": 8}}
SHAPES = {"B=1": ((1, 29, 29, 256), (1, 5, 5, 256)),
          "B=16": ((16, 29, 29, 256), (16, 5, 5, 256)),
          "B=64": ((64, 29, 29, 256), (64, 5, 5, 256)),
          "stage2": ((64, 7, 7, 256), (64, 5, 5, 256))}
ENTRIES = {"forward": "siammask_depthwise_xcorr", "grad_input": "siammask_depthwise_xcorr_grad_input"}
PEAK_BYTES_PER_S = 3.35e12


def variant_source(changes: dict) -> str:
    src = (_build.CSRC / "xcorr.cu").read_text()
    for name, value in changes.items():
        if name == "min_blocks":
            pattern = r"(__launch_bounds__\(kChannelTile \* kStripWarps)(\)\s+" \
                      r"depthwise_xcorr_strip_bf16x2_kernel\()"
            src, n = re.subn(pattern, rf"\1, {value}\2", src)
        else:
            src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                             src)
        if n != 1:
            raise RuntimeError(f"{name} not found once in xcorr.cu")
    return src


def build_variants() -> dict:
    """{variant: (library, {kernel: ptxas resources}, {kernel: load_runs})},
    built in parallel."""
    nvcc = _build._nvcc()

    def one(item):
        name, changes = item
        src = _build.BUILD_DIR / "bench_xcorr" / name / "xcorr.cu"
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(variant_source(changes))
        path = _build.compile_library(nvcc, _build.NVCC_FLAGS, (src,), f"bench_xcorr_{name}")
        cuobjdump = Path(nvcc).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True,
                              text=True, check=True).stdout
        if shutil.which("c++filt"):
            sass = subprocess.run(["c++filt"], input=sass, capture_output=True, text=True,
                                  check=True).stdout
        return name, (_build.bind(path),
                      _build.kernel_resources(path.with_suffix(".log").read_text()),
                      load_runs(sass))

    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(pool.map(one, VARIANTS.items()))


def load_runs(sass: str) -> dict:
    """Per strip kernel in ``cuobjdump -sass`` output: {"loads": {opcode:
    count}, "runs": [loads issued before the next instruction that reads
    one of their registers, in program order]}."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0]
        if "strip" not in name:
            continue
        widths, runs, pending, run = {}, [], set(), 0
        for ins in re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]*);", part):
            words = ins.split()
            if words[0].startswith("@"):     # a predicate guard
                words = words[1:]
            op, regs = words[0], [int(r) for r in re.findall(r"\bR(\d+)\b", " ".join(words[1:]))]
            if op.startswith("LDG"):
                widths[op] = widths.get(op, 0) + 1
                pending.update(range(regs[0], regs[0] + (2 if ".64" in op else 1)))
                run += 1
                continue
            sources = regs if op.startswith("ST") else regs[1:]
            if pending & set(sources):
                runs.append(run)
                pending, run = set(), 0
        out[name.split("::", 1)[-1].split("(")[0]] = {"loads": widths, "runs": runs + [run] * (run > 0)}
    return out


def graph_us(fn, n: int = 100, reps: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / n)
    return statistics.median(times)


def call(lib, which: str, a: torch.Tensor, k: torch.Tensor, out: torch.Tensor, hx: int,
         wx: int, kernel: int) -> None:
    """One launch of ``which`` on the current stream into ``out``."""
    b, _, _, c = a.shape
    _, hk, wk, _ = k.shape
    stream = torch.cuda.current_stream().cuda_stream
    code = getattr(lib, ENTRIES[which])(a.data_ptr(), k.data_ptr(), out.data_ptr(), b, hx, wx, c,
                                        hk, wk, 0 if a.dtype == torch.float32 else 1, kernel,
                                        a.device.index, ctypes.c_void_p(stream))
    _build.check(lib, code, f"{which} kernel {kernel}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(REPO / "chiprun_out" / "bench_xcorr_bf16.json"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_xcorr_bf16: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip() \
        if shutil.which("nvidia-smi") else "nvidia-smi not found"
    libs = build_variants()
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "resources": {},
              "sass": {}, "cases": {}}
    for name, (_, res, sass) in libs.items():
        result["resources"][name] = {k: v for k, v in res.items() if "strip" in k}
        result["sass"][name] = sass
        for k, v in result["resources"][name].items():
            print(f"[ptxas] {name}: {k}: {v['registers']} registers, {v['spill_stores']} / "
                  f"{v['spill_loads']} bytes spill stores / loads")
        for k, v in sass.items():
            runs = v["runs"]
            print(f"[sass] {name}: {k}: loads {v['loads']}; {len(runs)} runs of loads issued "
                  f"back to back, longest {max(runs)}, median {statistics.median(runs)}")
    base = libs["packed"][0]
    g = torch.Generator().manual_seed(0)
    for shape, (xs, ks) in SHAPES.items():
        x = torch.randn(xs, generator=g).cuda().bfloat16()
        k = torch.randn(ks, generator=g).cuda().bfloat16()
        go = torch.randn((xs[0], xs[1] - ks[1] + 1, xs[2] - ks[2] + 1, xs[3]),
                         generator=g).cuda().bfloat16()
        hx, wx = xs[1], xs[2]
        for which, a in (("forward", x), ("grad_input", go)):
            out_shape = tuple(go.shape) if which == "forward" else xs
            outs = {}
            runs = {}
            scalar = torch.empty(out_shape, dtype=torch.bfloat16, device="cuda")
            call(base, which, a, k, scalar, hx, wx, 0)
            for name, (lib, _, _) in libs.items():
                out = torch.empty(out_shape, dtype=torch.bfloat16, device="cuda")
                call(lib, which, a, k, out, hx, wx, 1)
                torch.cuda.synchronize()
                if not torch.equal(out, scalar):
                    raise SystemExit(f"{name} {which} {shape}: not bit-identical to the scalar "
                                     f"kernel (max abs diff "
                                     f"{(out.float() - scalar.float()).abs().max().item()})")
                outs[name] = out
                runs[name] = (lambda lib=lib, out=out: call(lib, which, a, k, out, hx, wx, 1))
            runs["scalar_bf16"] = lambda: call(base, which, a, k, scalar, hx, wx, 0)
            a32, k32 = a.float(), k.float()
            out32 = torch.empty(out_shape, dtype=torch.float32, device="cuda")
            runs["fp32"] = lambda: call(base, which, a32, k32, out32, hx, wx, 0)
            groups = a.shape[0] * a.shape[3]
            data, weight = _to_groups(a)[None], _to_groups(k)[:, None]
            conv = F.conv2d if which == "forward" else F.conv_transpose2d
            runs["library"] = lambda: conv(data, weight, groups=groups)
            order = list(runs)
            times = {}
            for name in order + order[::-1]:
                t = graph_us(runs[name])
                times[name] = min(times.get(name, t), t)
            nbytes = (x.numel() + k.numel() + go.numel()) * 2
            bound = nbytes / PEAK_BYTES_PER_S * 1e6
            result["cases"][f"{which} {shape}"] = {"us": times, "bound_us": bound}
            print(f"[bench] {which} {shape}: " + ", ".join(
                f"{n} {t:.2f} us ({100 * bound / t:.0f}%)" for n, t in times.items())
                + f"; bound {bound:.2f} us (bytes) | {smi}")
    print(smi)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
