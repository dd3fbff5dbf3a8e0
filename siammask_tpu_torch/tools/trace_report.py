"""Aggregate a torch.profiler Chrome trace into a device-time table.

Counterpart of ``tools/trace_report.py``, which reads jax.profiler traces.
Export a trace with ``torch.profiler.profile(activities=[CPU, CUDA])`` and
``prof.export_chrome_trace(path)`` (``scripts/trace_cell.py`` does for a
benchmark cell's traced stretch, ``python -m siammask_tpu_torch.bench
--profile-dir DIR`` for each row's timed windows; an operator's own
``torch.profiler`` session does too), then::

    python -m siammask_tpu_torch.tools.trace_report <dir or .json[.gz]> [--top N]
        [--all-pids] [--long]

to see where device time goes: the self time of every kernel, copy and
memset on the card's lanes, grouped by category (cuDNN conv passes, GEMM,
BN, dtype casts, NCHW<->NHWC transposes, copies and memsets, reduce/pool,
gather/scatter/upsample, elementwise, each xcorr kernel by name,
collectives), and the card's idle time: the window from the first device
event's start to the last one's end, less the union of the busy
intervals, with the three longest gaps and the gaps counted by size.
``report`` returns the same table as a dict. Tracing adds its own time
between kernels, so the idle share of a traced call is an upper bound on
the untraced call's.

When the trace holds the program's own spans (``utils/trace.py``: any
``torch.profiler`` session records them, as ``user_annotation`` events named
``<layer>.<what>``), two more tables: each span's calls, time and self time
(its time less that of the program spans nested in it), and the device's
idle by the innermost program span open on the host at each gap's middle,
with the innermost host op inside that span that held most of it; a gap
outside every program span is "outside the program" (the caller's code).

Device events are the ``ph: "X"`` events whose ``cat`` is ``kernel``,
``gpu_memcpy`` or ``gpu_memset``; their pids are the device lanes (named
``GPU N`` by the trace's metadata). Kernel names are CUPTI's, demangled.
"""
from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re

from siammask_tpu_torch.utils.trace import is_program_span

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OP_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
OUTSIDE = "outside the program"


def load_trace_events(path: str) -> list:
    """The events of one Chrome trace: ``path`` itself, or the newest
    ``*.json`` / ``*.json.gz`` under the directory ``path``."""
    if os.path.isdir(path):
        paths = (glob.glob(os.path.join(path, "**", "*.json"), recursive=True)
                 + glob.glob(os.path.join(path, "**", "*.json.gz"), recursive=True))
        if not paths:
            raise FileNotFoundError(f"no .json(.gz) trace under {path}")
        path = max(paths, key=os.path.getmtime)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _is_device_event(e: dict) -> bool:
    return e.get("ph") == "X" and "dur" in e and e.get("cat") in DEVICE_CATS


def device_pids(events) -> dict:
    """pid -> process name (``GPU N``), for the processes that carry device
    events."""
    names = {e["pid"]: e.get("args", {}).get("name", "") for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    return {e["pid"]: names.get(e["pid"], str(e["pid"]))
            for e in events if _is_device_event(e)}


def op_lane_tids(events, pids) -> set:
    """(pid, tid) lanes of ``pids`` carrying device events: a stream's
    kernels, or copies and memsets. A ``gpu_user_annotation`` span of a
    ``record_function`` may share a stream's lane and enclose its kernels;
    it is no device work and is left out."""
    return {(e["pid"], e["tid"]) for e in events
            if _is_device_event(e) and e["pid"] in pids}


# first match wins, on the lowercased name
CATEGORIES = (
    ("xcorr strip fwd (fp32, bf16 scalar)",
     r"depthwise_xcorr_strip_kernel<[^>]*\b(false|\(bool\)0)>"),
    ("xcorr strip grad-input (fp32, bf16 scalar)",
     r"depthwise_xcorr_strip_kernel<[^>]*\b(true|\(bool\)1)>"),
    ("xcorr grad-kernel (fp32, bf16 scalar)", r"depthwise_xcorr_grad_kernel_kernel"),
    ("xcorr packed bf16 fwd", r"depthwise_xcorr_strip_bf16x2_kernel<[^>]*\b(false|\(bool\)0)>"),
    ("xcorr packed bf16 grad-input",
     r"depthwise_xcorr_strip_bf16x2_kernel<[^>]*\b(true|\(bool\)1)>"),
    ("xcorr packed bf16 grad-kernel", r"depthwise_xcorr_grad_kernel_bf16x2_kernel"),
    ("collective (nccl)", r"nccl"),
    ("BN", r"batch_?norm|cudnn::bn_|\bbn_(fw|bw)"),
    ("NCHW<->NHWC transpose", r"nchw\w*nhwc|nhwc\w*nchw|transpose"),
    ("conv wgrad", r"wgrad"),
    ("conv dgrad", r"dgrad"),
    ("conv fprop", r"fprop|convolve|conv2d|winograd|cudnn"),
    ("conv FFT (any pass)", r"fft|flip_filter|mult_and_sum_complex"),
    ("GEMM", r"gemm|gemv|cublas|cutlass|xmma|matmul|nvjet"),
    ("dtype cast", r"bfloat16_copy_kernel|float16_copy_kernel|float8_copy_kernel|withcast"),
    ("device copy / memset", r"^memcpy|^memset|copy_kernel|catarraybatchedcopy"),
    ("reduce / pool", r"reduce|pool|softmax|sort|topk|argmax|lpnorm|norm_kernel"),
    ("gather / scatter / upsample", r"gather|scatter|index|upsample"),
    ("elementwise", r"elementwise|functor|pointwise|multi_tensor_apply"),
)


def categorize(name: str) -> str:
    low = name.lower()
    for cat, pat in CATEGORIES:
        if re.search(pat, low):
            return cat
    return "other"


def _self_times(lanes: dict) -> tuple[collections.Counter, collections.Counter]:
    """Per name, the self time (us) and the count of its events over every
    lane: each event's duration less that of the events nested in it on its
    lane. An event nests in one that starts no later and ends no earlier;
    two that only overlap (a kernel whose start the device stamps before
    the previous kernel's end) each keep their whole duration, as the
    profiler's own self device time does."""
    per_op, per_op_n = collections.Counter(), collections.Counter()
    for lane in lanes.values():
        # start ascending, end descending: a parent before its children
        lane.sort(key=lambda ev: (ev[0], -ev[1]))
        stack, self_time, names = [], [], []
        for ts, te, name in lane:
            while stack and stack[-1][0] < te:   # ends before this one: not its parent
                stack.pop()
            if stack:
                self_time[stack[-1][1]] -= te - ts
            self_time.append(te - ts)
            names.append(name)
            stack.append((te, len(self_time) - 1))
        for name, st in zip(names, self_time):
            per_op[name] += max(st, 0)
            per_op_n[name] += 1
    return per_op, per_op_n


# the idle gaps' sizes are counted in these bins (upper edges, us)
GAP_BINS_US = (2.0, 10.0, 100.0, 1000.0, float("inf"))


def _busy(lanes: dict) -> tuple[float, float, float, list]:
    """(window start us, window us, busy us, every idle gap as (start us
    after the window's start, us)) over every lane together."""
    spans = sorted((ts, te) for lane in lanes.values() for ts, te, _ in lane)
    start, end = spans[0][0], max(te for _, te in spans)
    busy, idle = 0.0, []
    cur_s, cur_e = spans[0]
    for ts, te in spans[1:]:
        if ts > cur_e:
            busy += cur_e - cur_s
            idle.append((cur_e - start, ts - cur_e))
            cur_s, cur_e = ts, te
        else:
            cur_e = max(cur_e, te)
    busy += cur_e - cur_s
    return start, end - start, busy, idle


def _innermost(intervals: list, points: list) -> list:
    """For each of ``points`` (us, ascending), ``{lane: the innermost of
    ``intervals`` ((ts, te, lane, name), nested within a lane) open at it}``.
    One sweep, with no limit on how far back an open interval started."""
    intervals = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    stacks = collections.defaultdict(list)
    out, i = [], 0
    for t in points:
        while i < len(intervals) and intervals[i][0] <= t:
            iv = intervals[i]
            stack = stacks[iv[2]]
            while stack and stack[-1][1] < iv[0]:
                stack.pop()
            stack.append(iv)
            i += 1
        open_ = {}
        for lane, stack in stacks.items():
            while stack and stack[-1][1] < t:
                stack.pop()
            if stack:
                open_[lane] = stack[-1]
        out.append(open_)
    return out


def program_spans(events: list) -> dict:
    """The program's spans in a trace: ``{name: {"calls", "ms", "self_ms"}}``,
    largest self time first; self time is a span's time less that of the
    program spans nested in it on its lane."""
    lanes = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and "dur" in e and e.get("cat") == "user_annotation" \
                and is_program_span(e["name"]):
            ts = float(e["ts"])
            lanes[(e["pid"], e["tid"])].append((ts, ts + float(e["dur"]), e["name"]))
    total, calls = collections.Counter(), collections.Counter()
    for lane in lanes.values():
        for ts, te, name in lane:
            total[name] += te - ts
            calls[name] += 1
    self_us, _ = _self_times(lanes)
    return {name: {"calls": calls[name], "ms": total[name] / 1e3, "self_ms": us / 1e3}
            for name, us in self_us.most_common()}


def idle_by_span(events: list, gaps: list) -> dict:
    """Device idle by the program's innermost span open on the host at each
    gap's middle: ``{span or OUTSIDE: {"ms", "gaps", "op", "op_ms"}}``,
    largest first, where ``op`` is the innermost host op inside the span at
    the gaps that held most of its idle (None if no op was open). ``gaps``:
    (start us, us) on the trace's clock."""
    spans, ops = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts = float(e["ts"])
        iv = (ts, ts + float(e["dur"]), (e["pid"], e["tid"]), e["name"])
        if e.get("cat") == "user_annotation" and is_program_span(e["name"]):
            spans.append(iv)
        elif e.get("cat") in HOST_OP_CATS:
            ops.append(iv)
    lanes = {iv[2] for iv in spans}
    gaps = sorted(gaps)
    mids = [g0 + d / 2 for g0, d in gaps]
    ms, n = collections.Counter(), collections.Counter()
    by_op = collections.defaultdict(collections.Counter)
    open_ops = _innermost([iv for iv in ops if iv[2] in lanes], mids)
    for (_, d), open_spans, open_op in zip(gaps, _innermost(spans, mids), open_ops):
        span = max(open_spans.values(), default=None)        # the latest to start
        name = span[3] if span else OUTSIDE
        ms[name] += d / 1e3
        n[name] += 1
        op = open_op.get(span[2]) if span else None
        by_op[name][op[3] if op is not None and op[0] >= span[0] else None] += d / 1e3
    out = {}
    for name, v in ms.most_common():
        op, op_ms = by_op[name].most_common(1)[0]
        out[name] = {"ms": v, "gaps": n[name], "op": op, "op_ms": op_ms}
    return out


def report(events: list, all_pids: bool = False) -> dict:
    """The device-time table of a trace's events, times in ms:
    ``{"lanes": {pid: name}, "total_ms": the summed self time, "window_ms",
    "busy_ms": the union of the busy intervals, "idle_ms", "idle_share",
    "gaps": [(ms after the window's start, ms)] (the three longest),
    "gap_bins": [(upper edge us, gaps, ms)] over ``GAP_BINS_US``,
    "categories": {category: {"ms", "share", "calls"}}, largest first,
    "ops": {name: {"ms", "calls", "category", "args"}}, largest first,
    "spans": ``program_spans``, "idle_by_span": ``idle_by_span`` (both empty
    when the trace holds no program span)}``.
    ``all_pids`` takes every complete event of every lane, host ones too;
    otherwise the device events of the device lanes. A trace with no such
    event raises ``ValueError``."""
    pids = {} if all_pids else device_pids(events)
    op_lanes = None if all_pids else op_lane_tids(events, pids)
    lanes = collections.defaultdict(list)
    meta = {}   # name -> args of the first event with that name
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if op_lanes is not None and not (_is_device_event(e)
                                         and (e["pid"], e["tid"]) in op_lanes):
            continue
        ts = float(e["ts"])
        lanes[(e.get("pid"), e.get("tid"))].append((ts, ts + float(e["dur"]), e["name"]))
        meta.setdefault(e["name"], e.get("args", {}))
    if not lanes:
        raise ValueError("no device events in the trace" if not all_pids
                         else "no complete events in the trace")
    per_op, per_op_n = _self_times(lanes)
    total = sum(per_op.values())
    start, window, busy, gaps = _busy(lanes)
    spans = program_spans(events)
    longest = sorted(gaps, key=lambda g: -g[1])[:3]
    bins = [(edge, [d for _, d in gaps if lo <= d < edge])
            for lo, edge in zip((0.0, *GAP_BINS_US), GAP_BINS_US)]
    per_cat, per_cat_n = collections.Counter(), collections.Counter()
    for name, us in per_op.items():
        per_cat[categorize(name)] += us
        per_cat_n[categorize(name)] += per_op_n[name]
    return {
        "lanes": pids, "total_ms": total / 1e3, "window_ms": window / 1e3,
        "busy_ms": busy / 1e3, "idle_ms": (window - busy) / 1e3,
        "idle_share": (window - busy) / window if window else 0.0,
        "gaps": [(s / 1e3, d / 1e3) for s, d in longest],
        "gap_bins": [(edge, len(ds), sum(ds) / 1e3) for edge, ds in bins],
        "categories": {cat: {"ms": us / 1e3, "share": us / total if total else 0.0,
                             "calls": per_cat_n[cat]} for cat, us in per_cat.most_common()},
        "ops": {name: {"ms": us / 1e3, "calls": per_op_n[name], "category": categorize(name),
                       "args": meta.get(name, {})} for name, us in per_op.most_common()},
        "spans": spans,
        "idle_by_span": idle_by_span(events, [(start + s, d) for s, d in gaps]) if spans else {},
    }


def format_table(table: dict, top: int = 20, long: bool = False) -> str:
    """``report``'s table as text: the lanes, the totals and idle, the
    categories, and the ``top`` ops (with their args when ``long``)."""
    lines = [f"device lanes: {sorted(table['lanes'].values()) or 'ALL'}",
             f"total device time {table['total_ms']:.3f} ms (self time summed); window "
             f"{table['window_ms']:.3f} ms, busy {table['busy_ms']:.3f} ms, idle "
             f"{table['idle_ms']:.3f} ms ({100 * table['idle_share']:.1f}%); longest gaps: "
             + ", ".join(f"{d:.3f} ms at +{s:.3f}" for s, d in table["gaps"]),
             "idle gaps by size: " + ", ".join(f"< {edge:g} us {n} ({ms:.3f} ms)"
                                               for edge, n, ms in table["gap_bins"]), "",
             f"{'category':<44}{'ms':>10}{'%':>8}{'calls':>8}"]
    for cat, row in table["categories"].items():
        lines.append(f"{cat:<44}{row['ms']:>10.3f}{100 * row['share']:>7.1f}%"
                     f"{row['calls']:>8}")
    lines += ["", f"{'op (top ' + str(top) + ')':<72}{'ms':>9}{'%':>7}{'calls':>8}"]
    for name, row in list(table["ops"].items())[:top]:
        label = name if len(name) <= 70 else name[:67] + "..."
        share = row["ms"] / table["total_ms"] if table["total_ms"] else 0.0
        lines.append(f"{label:<72}{row['ms']:>9.3f}{100 * share:>6.1f}%{row['calls']:>8}")
        if long and row["args"]:
            lines.append(f"    {json.dumps(row['args'])[:200]}")
    if table["spans"]:
        lines += ["", f"{'program span':<44}{'calls':>8}{'ms':>11}{'self ms':>11}"]
        for name, row in table["spans"].items():
            lines.append(f"{name:<44}{row['calls']:>8}{row['ms']:>11.3f}{row['self_ms']:>11.3f}")
        idle = table["idle_ms"]
        lines += ["", f"{'device idle by program span':<44}{'ms':>10}{'%':>7}{'gaps':>7}"
                      "  top host op inside (ms)"]
        for name, row in table["idle_by_span"].items():
            share = row["ms"] / idle if idle else 0.0
            lines.append(f"{name:<44}{row['ms']:>10.3f}{100 * share:>6.1f}%{row['gaps']:>7}"
                         f"  {row['op'] or '-'} ({row['op_ms']:.3f})")
    return "\n".join(lines)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trace", help="a Chrome trace (.json or .json.gz) or a directory "
                                      "holding some (the newest is read)")
    parser.add_argument("--top", type=int, default=20, help="rows in the per-op table")
    parser.add_argument("--all-pids", action="store_true",
                        help="every complete event of every lane, host ones too")
    parser.add_argument("--long", action="store_true",
                        help="print each top op's args (grid, block, registers, stream)")
    args = parser.parse_args(argv)
    events = load_trace_events(args.trace)
    if not args.all_pids and not device_pids(events):
        print("no device lanes recognized; rerun with --all-pids")
        args.all_pids = True
    table = report(events, args.all_pids)
    print(format_table(table, args.top, args.long))
    return table


if __name__ == "__main__":
    main()
