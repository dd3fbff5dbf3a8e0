"""Spans from the benchmark's own wrappers, and the reading of a
``torch.profiler`` Chrome trace.

``Spans`` times named calls on the host clock and, while a profiler runs,
marks them in its trace (``record_function``). ``read_trace`` takes the
device's kernels, copies and memsets inside one marked host span (the
profiled stretch) and gives its busy time, idle gaps labelled by what the
host was doing, the top device operations, and sums by name pattern.

The category patterns and the self-time arithmetic are copied from the
program's ``tools/trace_report.py`` (``CATEGORIES``, ``_self_times``); idle
is measured here over the profiled wall span, not from the first device
event to the last, so a host stall at either edge counts.
"""
from __future__ import annotations

import bisect
import collections
import json
import re
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")

# first match wins, on the lowercased name (``tools/trace_report.py``)
CATEGORIES = (
    ("xcorr", r"depthwise_xcorr"),
    ("collective (nccl)", r"nccl"),
    ("BN", r"batch_?norm|cudnn::bn_|\bbn_(fw|bw)"),
    ("NCHW<->NHWC transpose", r"nchw\w*nhwc|nhwc\w*nchw|transpose"),
    ("conv wgrad", r"wgrad"),
    ("conv dgrad", r"dgrad"),
    ("conv fprop", r"fprop|convolve|conv2d|winograd|cudnn"),
    ("conv FFT (any pass)", r"fft|flip_filter|mult_and_sum_complex"),
    ("GEMM", r"gemm|gemv|cublas|cutlass|xmma|matmul|nvjet"),
    ("dtype cast", r"bfloat16_copy_kernel|float16_copy_kernel|float8_copy_kernel|withcast"),
    ("host<->device copy", r"^memcpy (htod|dtoh)"),
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


class Spans:
    """Host seconds of each call of a wrapped function, by name."""

    def __init__(self):
        self.seconds: dict[str, list] = collections.defaultdict(list)

    def wrap(self, name: str, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.seconds[name].append(time.perf_counter() - t0)
        return timed

    def mean_ms(self, name: str):
        v = self.seconds.get(name)
        return 1e3 * sum(v) / len(v) if v else None


def _self_times(lanes: dict) -> collections.Counter:
    """Per name, the self time (us) over every lane: each event's duration
    less that of the events nested in it on its lane."""
    per_op = collections.Counter()
    for lane in lanes.values():
        lane.sort(key=lambda ev: (ev[0], -ev[1]))
        stack, self_time, names = [], [], []
        for ts, te, name in lane:
            while stack and stack[-1][0] < te:
                stack.pop()
            if stack:
                self_time[stack[-1][1]] -= te - ts
            self_time.append(te - ts)
            names.append(name)
            stack.append((te, len(self_time) - 1))
        for name, st in zip(names, self_time):
            per_op[name] += max(st, 0)
    return per_op


def _host_label(host: list, starts: list, t: float) -> str:
    """The outermost span of the benchmark (``bench.``) and the innermost
    host operation running at ``t`` on the host thread."""
    i = bisect.bisect_right(starts, t)
    outer = inner = None
    for ts, te, name in reversed(host[max(0, i - 400):i]):
        if te >= t:
            if inner is None:
                inner = name
            if name.startswith("bench."):
                outer = name
    parts = [p for p in (outer, inner) if p]
    return " / ".join(dict.fromkeys(parts)) if parts else "host: no traced operation"


def read_trace(path: str, stretch: str) -> dict:
    """The device events inside the host span named ``stretch``:
    ``window_s``, ``busy_s`` (the union of device intervals), ``categories``
    {name: s}, ``device_ops`` (the 10 longest by self time, [name, s]),
    ``idle_gaps`` (idle time by host label, the 10 largest, [label, s]),
    ``ops`` {name: s}."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    mark = [e for e in events if e.get("ph") == "X" and e.get("name") == stretch]
    if not mark:
        raise ValueError(f"no span {stretch!r} in the trace")
    w0 = float(mark[0]["ts"])
    w1 = w0 + float(mark[0]["dur"])
    thread = (mark[0]["pid"], mark[0]["tid"])
    lanes = collections.defaultdict(list)
    host = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts = float(e["ts"])
        te = ts + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            ts, te = max(ts, w0), min(te, w1)
            if te > ts:
                lanes[(e["pid"], e["tid"])].append((ts, te, e["name"]))
        elif (e["pid"], e["tid"]) == thread and e.get("cat") in HOST_CATS and e["name"] != stretch:
            host.append((ts, te, e["name"]))
    per_op = _self_times({k: list(v) for k, v in lanes.items()})
    spans = sorted((ts, te) for lane in lanes.values() for ts, te, _ in lane)
    busy, gaps, cur = 0.0, [], w0
    for ts, te in spans:
        if ts > cur:
            gaps.append((cur, ts))
        if te > cur:
            busy += te - max(ts, cur)
            cur = te
    if w1 > cur:
        gaps.append((cur, w1))
    host.sort()
    starts = [h[0] for h in host]
    idle = collections.Counter()
    for g0, g1 in gaps:
        idle[_host_label(host, starts, (g0 + g1) / 2)] += g1 - g0
    cats = collections.Counter()
    for name, us in per_op.items():
        cats[categorize(name)] += us
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "categories": {k: v / 1e6 for k, v in cats.most_common()},
            "ops": {k: v / 1e6 for k, v in per_op.items()},
            "device_ops": [[k, v / 1e6] for k, v in per_op.most_common(10)],
            "idle_gaps": [[k, v / 1e6] for k, v in idle.most_common(10)]}


def profile(run, trace_path: str, stretch: str):
    """Run ``run()`` under ``torch.profiler`` (CPU and CUDA) inside a host
    span named ``stretch`` that ends after a device sync; export the Chrome
    trace to ``trace_path``; return what ``run`` returned."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(stretch):
            out = run()
            torch.cuda.synchronize()
    prof.export_chrome_trace(trace_path)
    return out
