"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the plain reference, and the result line.

A cell is found by name: ``BENCHMARK.json`` gives its configuration and
traffic; ``perfbench/configs/<config>.json`` holds the configuration,
``perfbench/traffic/<cell>.json`` the traffic and the check's limits, and
names the driver (``perfbench/drivers/<driver>.py``) that makes its inputs,
drives the program and checks what it produced. A per-layer metric is read
by ``perfbench/metrics/<metric>.py`` (``read(run) -> float | None``).

A driver module gives ``setup(ctx) -> cell``; the cell has
``window(seconds, spans)`` (the measured loop; returns its end-to-end
numbers and counts), ``stretch(spans)`` (the bounded part that a traced run
profiles), ``free()`` (drops the program's state) and ``check()`` (the
comparison with the reference: a list of (name, value, limit)).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "siammask_tpu")


def process_seconds() -> float:
    """Seconds since this process started (its start time in /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def set_cache_dirs(root: Path = ROOT) -> None:
    """The build and kernel caches inside the checkout, at fixed paths."""
    cache = root / "build" / "perfbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, root: Path = ROOT) -> dict:
    """The cell's entry, its configuration and its traffic, by name."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    own = BENCH / "traffic" / f"{name}.json"
    if name not in cells and own.is_file() and "cell" in load_json(own):
        # a cell defined by its traffic file alone, not yet in BENCHMARK.json:
        # it runs with no end-to-end metric but set-up, and is checked
        cells[name] = {"name": name, "traffic": name, **load_json(own)["cell"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[cell["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    end_to_end = [m for m in bench["end_to_end"]
                  if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name]) and m["moves"] in reported]
    return {"bench": bench, "cell": cell, "config": config, "traffic": traffic,
            "end_to_end": end_to_end, "per_layer": per_layer}


def driver(traffic: dict):
    return importlib.import_module(f"perfbench.drivers.{traffic['driver']}")


def metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """What a driver's ``setup`` is handed."""

    def __init__(self, name, found, seed, device, chips, overrides=None, system=None):
        self.name = name
        self.cell = found["cell"]
        self.config = {**found["config"], **(overrides or {}).get("config", {})}
        self.traffic = {**found["traffic"], **(overrides or {}).get("traffic", {})}
        self.seed = seed
        self.device = device
        self.chips = chips
        # None: the program; "control": the reference at fp8 in its place;
        # "no_exchange": the program with a planted fault (several cards)
        self.system = system


class Run:
    """What the per-layer metric readers see."""

    def __init__(self, cell, result, spans, trace, units):
        self.cell = cell
        self.result = result            # the window's numbers (end-to-end and counts)
        self.spans = spans
        self.trace = trace              # ``tracing.read_trace`` of the stretch, or None
        self.units = units              # frames, object-frames or steps in the stretch


def device_info(torch, chips: int) -> dict:
    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0)
        peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
        return {"platform": "gpu", "kind": kind, "count": chips, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT,
             device: str = "cuda", overrides: dict | None = None, system=None,
             require_card: bool = True, readings: dict | None = None) -> dict:
    """One run; returns the result dict (the last line's content). Tests call
    it with ``device="cpu"``, ``require_card=False`` and small overrides;
    ``readings``, when given, receives every number the check read, held or
    not."""
    if not (root / "siammask_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(f"perfbench: the program, siammask_tpu_torch, is not in {root}")
    import torch

    found = find_cell(name, root)
    chips = int(found["cell"]["chips"])
    if require_card and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        raise SystemExit(f"perfbench: {name} needs {chips} CUDA card(s); "
                         f"cuda available {torch.cuda.is_available()}, "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                         "visible")
    from perfbench import tracing

    ctx = Context(name, found, seed, torch.device(device), chips, overrides, system)
    cell = driver(ctx.traffic).setup(ctx)
    spawns = getattr(cell, "spawns", False)     # its own processes hold the cards
    if device == "cuda" and not spawns:
        torch.cuda.synchronize()
    setup_s = process_seconds()
    spans = tracing.Spans() if trace else None
    result = cell.window(seconds, spans)
    setup_s = getattr(cell, "setup_s", setup_s)
    metrics, dev_extra, breakdown = {}, {}, None
    if trace:
        trace_read, units = None, 0
        if spawns:
            trace_read, units = cell.traced()
        elif device == "cuda":
            tmp = Path(os.environ.get("TMPDIR", root / "build")) / f"perfbench_{name}.json"
            tmp.parent.mkdir(parents=True, exist_ok=True)
            units = tracing.profile(lambda: cell.stretch(spans), str(tmp), "perfbench.stretch")
            try:
                trace_read = tracing.read_trace(str(tmp), "perfbench.stretch")
            finally:
                tmp.unlink(missing_ok=True)
        if trace_read is not None and device == "cuda":
            dev_extra = {"busy_s": trace_read["busy_s"], "window_s": trace_read["window_s"]}
            breakdown = {"device_ops": trace_read["device_ops"],
                         "idle_gaps": trace_read["idle_gaps"]}
        run = Run(cell, result, spans, trace_read, units)
        for m in found["per_layer"]:
            value = metric_reader(m["name"])(run)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in found["end_to_end"]:
            value = setup_s if m["name"] == "setup_s" else result.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {**device_info(torch, chips), **dev_extra}
    if spawns:
        dev["memory_peak_bytes"] = cell.memory_peak
    cell.free()
    checks = cell.check()
    if readings is not None:
        readings.update(cell.readings)
    correct = all(math.isfinite(v) and v <= limit for _, v, limit in checks)
    out = {"correct": correct, "attempted": result["attempted"], "failed": result["failed"],
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {n: {"value": v, "limit": limit} for n, v, limit in checks}
    return out


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="perfbench/run.py",
                                     description="run one benchmark cell once")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    for n, c in out["checks"].items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0
