#!/usr/bin/env python3
"""Variants of the packed bf16 xcorr kernels, timed against each other on one
NVIDIA card: ``python3 scripts/bench_xcorr_bf16.py [--kernels all|strip|grad]
[--out FILE]``.

Builds ``siammask_tpu_torch/csrc/xcorr.cu`` as it is and with a packed
kernel's constants changed, one ``nvcc -Xptxas -v`` a variant, all started
together, into ``build/kernels/``:

- the packed strip kernel (forward and grad-input; ``STRIP_VARIANTS``):
  four channels a lane with 8-byte loads, kPackWords 2; the band split's
  kPackedWarpsPerSM and kPackedBandRows; a minimum of 4 blocks an SM in
  its ``__launch_bounds__``, which caps its registers at 128 a thread;
- the packed grad-kernel (``GRAD_VARIANTS``): two words (four channels) a
  lane, kGradPackWords 2; the split count, by the most blocks a cluster
  (kGradPackedMaxCluster 1, no split of a (b, tile) over blocks, or 4) and
  by the waves of resident blocks the grid aims at (kGradPackedWaves 2);
  at most 5 warps a block with a minimum of 3 blocks an SM in its
  ``__launch_bounds__`` (136 registers); stage 2's taps added up through
  the warps' partials in shared memory instead of stored by the one warp
  that owns them; and two diagnostics that compute another function and
  are timed only (``DIAGNOSTICS``): no loads after a band's first rows (the
  FMAs alone) and no FMAs (the loads alone, each word folded into one
  sum).

Then, on card 0, at the model's bf16 shapes, (B, 29, 29, 256) * (B, 5, 5,
256) at B = 1, 16 and 64 and stage 2's (64, 7, 7, 256) * (64, 5, 5, 256):

- each strip variant's packed forward and grad-input must equal the scalar
  bf16 kernel (the strip kernel's bf16 instantiation) bit for bit, and each
  grad-kernel variant must be within 2e-2 of the largest entry of the plain
  version (a grouped conv in float32 on the bf16 inputs: the packed
  grad-kernel sums in another order than the scalar one), or the script
  exits with an error before it times anything;
- device us a call (a CUDA graph of 100 calls, the median of 5 replays) of
  every variant's packed kernel, the scalar bf16 kernel, the fp32 kernel
  at the same shape and cuDNN's grouped conv in bf16 (the library call),
  taken in turns (each in order, then in reverse; each keeps its faster
  turn), beside the bound (inputs read and output written once at 3.35
  TB/s);
- each variant's registers and spills from ptxas, and from
  ``cuobjdump -sass`` each packed kernel's global loads by width and how
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

# name -> {constant: value} changed in csrc/xcorr.cu ("min_blocks" /
# "grad_min_blocks": the packed strip / grad-kernel's __launch_bounds__ minimum
# of blocks an SM); "packed" and "grad" are the source as it is
STRIP_VARIANTS = {"packed": {}, "words2": {"kPackWords": 2},
                  "warps16": {"kPackedWarpsPerSM": 16}, "band8": {"kPackedBandRows": 8},
                  "blocks4": {"min_blocks": 4},
                  "blocks4_band8": {"min_blocks": 4, "kPackedBandRows": 8}}
GRAD_VARIANTS = {"grad": {}, "grad_words2": {"kGradPackWords": 2},
                 "grad_cluster1": {"kGradPackedMaxCluster": 1},
                 "grad_cluster4": {"kGradPackedMaxCluster": 4},
                 "grad_waves2": {"kGradPackedWaves": 2},
                 "grad_regs136": {"kGradPackedMaxWarps": 5, "grad_min_blocks": 3},
                 "grad_partials": {}, "grad_fma_only": {}, "grad_loads_only": {}}
# variants made by replacing a text of xcorr.cu: {variant: (text, its replacement)}
TEXT_CHANGES = {
    "grad_partials": ("  const bool direct = k == 1 && chunks == 1",
                      "  const bool direct = false && chunks == 1"),
    "grad_fma_only": ("if (u + 1 < end) load(u + 1);", ""),
    "grad_loads_only": (
        """        if (full)
          grad_kernel_row_packed<P, true>(acc, xr, gw, live, th, n, wk);""",
        """        unsigned int fold = live;
#pragma unroll
        for (int t = 0; t < W; ++t) fold ^= xr[t][0];
#pragma unroll
        for (int t = 0; t < kGradChunk; ++t) fold ^= gw[0][t][0];
        acc[0][0][0] += __uint_as_float(fold & 0x3fffffffu);
        if (false)
          grad_kernel_row_packed<P, true>(acc, xr, gw, live, th, n, wk);""")}
# the variants that compute another function, to split the time between
# loads and FMAs: timed, not checked
DIAGNOSTICS = {"grad_fma_only", "grad_loads_only"}
# the __launch_bounds__ each "min_blocks" change rewrites
LAUNCH_BOUNDS = {"min_blocks": ("kStripWarps", "depthwise_xcorr_strip_bf16x2_kernel"),
                 "grad_min_blocks": ("kGradPackedMaxWarps",
                                     "depthwise_xcorr_grad_kernel_bf16x2_kernel")}
SHAPES = {"B=1": ((1, 29, 29, 256), (1, 5, 5, 256)),
          "B=16": ((16, 29, 29, 256), (16, 5, 5, 256)),
          "B=64": ((64, 29, 29, 256), (64, 5, 5, 256)),
          "stage2": ((64, 7, 7, 256), (64, 5, 5, 256))}
ENTRIES = {"forward": "siammask_depthwise_xcorr",
           "grad_input": "siammask_depthwise_xcorr_grad_input",
           "grad_kernel": "siammask_depthwise_xcorr_grad_kernel"}
PEAK_BYTES_PER_S = 3.35e12


def variant_source(changes: dict, name: str = "") -> str:
    src = (_build.CSRC / "xcorr.cu").read_text()
    if name in TEXT_CHANGES:
        old, new = TEXT_CHANGES[name]
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: its text is not found once in xcorr.cu")
        src = src.replace(old, new)
    for name, value in changes.items():
        if name in LAUNCH_BOUNDS:
            warps, kernel = LAUNCH_BOUNDS[name]
            pattern = rf"(__launch_bounds__\(kChannelTile \* {warps})(\)\s+{kernel}\()"
            src, n = re.subn(pattern, rf"\1, {value}\2", src)
        else:
            src, n = re.subn(rf"constexpr (int|bool) {name} = \w+;",
                             rf"constexpr \1 {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"{name} not found once in xcorr.cu")
    return src


def build_variants(variants: dict) -> dict:
    """{variant: (library, {kernel: ptxas resources}, {kernel: load_runs})},
    built in parallel."""
    nvcc = _build._nvcc()

    def one(item):
        name, changes = item
        src = _build.BUILD_DIR / "bench_xcorr" / name / "xcorr.cu"
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(variant_source(changes, name))
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

    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(pool.map(one, variants.items()))


def packed(name: str) -> bool:
    """Whether a kernel's name is a packed bf16 kernel's."""
    return "bf16x2" in name


def load_runs(sass: str) -> dict:
    """Per packed kernel in ``cuobjdump -sass`` output: {"loads": {opcode:
    count}, "runs": [loads issued before the next instruction that reads
    one of their registers, in program order], "opcodes": {the 12 most
    frequent opcodes: count}, "instructions": count}."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0]
        if not packed(name):
            continue
        widths, runs, pending, run, ops = {}, [], set(), 0, {}
        for ins in re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]*);", part):
            words = ins.split()
            if words[0].startswith("@"):     # a predicate guard
                words = words[1:]
            op, regs = words[0], [int(r) for r in re.findall(r"\bR(\d+)\b", " ".join(words[1:]))]
            base = op.split(".")[0]
            ops[base] = ops.get(base, 0) + 1
            if base == "LDG":
                widths[op] = widths.get(op, 0) + 1
                pending.update(range(regs[0], regs[0] + (2 if ".64" in op else 1)))
                run += 1
                continue
            sources = regs if op.startswith("ST") else regs[1:]
            if pending & set(sources):
                runs.append(run)
                pending, run = set(), 0
        top = dict(sorted(ops.items(), key=lambda kv: -kv[1])[:12])
        out[name.split("::", 1)[-1].split("(")[0]] = {
            "loads": widths, "runs": runs + [run] * (run > 0), "opcodes": top,
            "instructions": sum(ops.values())}
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


def call(lib, which: str, a: torch.Tensor, b_: torch.Tensor, out: torch.Tensor, dims: tuple,
         kernel: int) -> None:
    """One launch of ``which`` on the current stream into ``out``; ``dims``
    is (b, hx, wx, c, hk, wk)."""
    stream = torch.cuda.current_stream().cuda_stream
    code = getattr(lib, ENTRIES[which])(a.data_ptr(), b_.data_ptr(), out.data_ptr(), *dims,
                                        0 if a.dtype == torch.float32 else 1, kernel,
                                        a.device.index, ctypes.c_void_p(stream))
    _build.check(lib, code, f"{which} kernel {kernel}")


def check_variants(libs: dict, which: str, shape: str, args: tuple, out_shape: tuple,
                   dims: tuple) -> dict:
    """Each variant's packed kernel on ``args`` against the scalar bf16
    kernel of the source as it is: bit for bit for the strip kernel; for
    grad-kernel within 2e-2 of the plain version's largest entry, with the
    elements that differ from the scalar kernel counted. Returns {variant:
    its output tensor}."""
    base = libs.get("packed", libs.get("grad"))[0]
    scalar = torch.empty(out_shape, dtype=torch.bfloat16, device="cuda")
    call(base, which, *args, scalar, dims, 0)
    if which == "grad_kernel":
        x, go = args
        groups = x.shape[0] * x.shape[3]
        plain = F.conv2d(_to_groups(x.float())[None], _to_groups(go.float())[:, None],
                         groups=groups)
        plain = plain.reshape(x.shape[0], x.shape[3], *plain.shape[-2:]).permute(0, 2, 3, 1)
    outs = {}
    for name, (lib, _, _) in libs.items():
        out = torch.empty(out_shape, dtype=torch.bfloat16, device="cuda")
        call(lib, which, *args, out, dims, 1)
        torch.cuda.synchronize()
        outs[name] = out
        if name in DIAGNOSTICS:
            continue
        diff = (out.float() - scalar.float()).abs().max().item()
        if which != "grad_kernel":
            if not torch.equal(out, scalar):
                raise SystemExit(f"{name} {which} {shape}: not bit-identical to the scalar "
                                 f"kernel (max abs diff {diff})")
        else:
            err = (out.float() - plain).abs().max().item()
            scale = plain.abs().max().item()
            if not err <= 2e-2 * scale:
                raise SystemExit(f"{name} {which} {shape}: max abs error {err} against the "
                                 f"plain version (largest entry {scale})")
            print(f"[check] {name} {which} {shape}: max abs error {err:.3e} against the plain "
                  f"version (largest entry {scale:.3f}); {int((out != scalar).sum())} of "
                  f"{out.numel()} elements differ from the scalar kernel, by at most {diff:.3e}")
    return outs


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", choices=("all", "strip", "grad"), default="all",
                        help="which packed kernel's variants to build and time")
    parser.add_argument("--out", default=str(REPO / "chiprun_out" / "bench_xcorr_bf16.json"))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_xcorr_bf16: no CUDA device")
    torch.backends.cudnn.allow_tf32 = False    # the plain version in full float32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip() \
        if shutil.which("nvidia-smi") else "nvidia-smi not found"
    sets = {"strip": STRIP_VARIANTS, "grad": GRAD_VARIANTS}
    sets = sets if args.kernels == "all" else {args.kernels: sets[args.kernels]}
    libs = build_variants({k: v for variants in sets.values() for k, v in variants.items()})
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "resources": {},
              "sass": {}, "cases": {}}
    for kind, variants in sets.items():
        for name in variants:
            res, sass = libs[name][1:]
            mine = {k: v for k, v in res.items() if packed(k)
                    and ("grad_kernel" in k) == (kind == "grad")}
            result["resources"][name] = mine
            for k, v in mine.items():
                print(f"[ptxas] {name}: {k}: {v['registers']} registers, {v['spill_stores']} / "
                      f"{v['spill_loads']} bytes spill stores / loads")
            result["sass"][name] = {k: v for k, v in sass.items() if k in mine}
            for k, v in result["sass"][name].items():
                runs = v["runs"]
                print(f"[sass] {name}: {k}: loads {v['loads']}; {len(runs)} runs of loads "
                      f"issued back to back, longest {max(runs)}, median "
                      f"{statistics.median(runs)}; {v['instructions']} instructions, most "
                      f"frequent {v['opcodes']}")
    g = torch.Generator().manual_seed(0)
    for shape, (xs, ks) in SHAPES.items():
        x = torch.randn(xs, generator=g).cuda().bfloat16()
        k = torch.randn(ks, generator=g).cuda().bfloat16()
        go = torch.randn((xs[0], xs[1] - ks[1] + 1, xs[2] - ks[2] + 1, xs[3]),
                         generator=g).cuda().bfloat16()
        dims = (xs[0], xs[1], xs[2], xs[3], ks[1], ks[2])
        cases = {"forward": ("strip", (x, k), tuple(go.shape), F.conv2d, (x, k)),
                 "grad_input": ("strip", (go, k), xs, F.conv_transpose2d, (go, k)),
                 "grad_kernel": ("grad", (x, go), ks, F.conv2d, (x, go))}
        for which, (kind, inputs, out_shape, conv, lib_args) in cases.items():
            if kind not in sets:
                continue
            mine = {name: libs[name] for name in sets[kind]}
            outs = check_variants(mine, which, shape, inputs, out_shape, dims)
            base = mine["packed" if kind == "strip" else "grad"][0]
            runs = {name: (lambda lib=lib, out=outs[name]: call(lib, which, *inputs, out, dims, 1))
                    for name, (lib, _, _) in mine.items()}
            scalar = torch.empty(out_shape, dtype=torch.bfloat16, device="cuda")
            runs["scalar_bf16"] = lambda: call(base, which, *inputs, scalar, dims, 0)
            inputs32 = tuple(t.float() for t in inputs)
            out32 = torch.empty(out_shape, dtype=torch.float32, device="cuda")
            runs["fp32"] = lambda: call(base, which, *inputs32, out32, dims, 0)
            groups = xs[0] * xs[3]
            data, weight = _to_groups(lib_args[0])[None], _to_groups(lib_args[1])[:, None]
            runs["library"] = (lambda conv=conv, data=data, weight=weight:
                               conv(data, weight, groups=groups))
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
