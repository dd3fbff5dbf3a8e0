"""One benchmark cell's traced stretch, read by the port's spans.

Runs ``perfbench`` cell ``--workload`` once with ``--trace 1`` (a short
measured window, then the profiled stretch) on the card and prints one JSON
line: the run's per-layer metrics and idle labels, the stretch's wall and
busy seconds, and ``trace_report``'s tables of the stretch's Chrome trace
(the gaps by size, the program spans' self time and the device's idle by
the innermost program span). ``--no-spans`` runs the stretch with the
program's spans paused, for their cost on the stretch's wall time.
``--span-cost`` instead times ``utils.trace.span`` alone, off and under a
CPU profiler session, in ns a span.

Usage (from the repository's root, on a machine with a card)::

    python scripts/trace_cell.py --workload sharp_vos_16obj --seed 7
    python scripts/trace_cell.py --workload base_train_b64 --seed 7 --no-spans
    python scripts/trace_cell.py --span-cost
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def span_cost(n_off: int = 1_000_000, n_on: int = 20_000) -> dict:
    """ns a ``with span(...)`` block, less the bare loop, off (no profiler)
    and on (a CPU profiler session); and ns a ``count``, off."""
    from torch.profiler import ProfilerActivity, profile

    from siammask_tpu_torch.utils import trace

    def loop(n, body):
        t0 = time.perf_counter_ns()
        body(n)
        return (time.perf_counter_ns() - t0) / n

    def bare(n):
        for _ in range(n):
            pass

    def spans(n):
        for _ in range(n):
            with trace.span("train.cost"):
                pass

    def counts(n):
        for _ in range(n):
            trace.count("cost.things")

    base = min(loop(n_off, bare) for _ in range(3))
    off = min(loop(n_off, spans) for _ in range(3)) - base
    count = min(loop(n_off, counts) for _ in range(3)) - base
    with profile(activities=[ProfilerActivity.CPU]):
        spans(100)                                  # a session's first events
        on = min(loop(n_on, spans) for _ in range(3)) - base
    trace.clear()
    return {"span_off_ns": off, "span_on_ns": on, "count_off_ns": count, "loop_ns": base}


def traced_cell(name: str, seed: int, seconds: float, spans: bool) -> dict:
    from perfbench import harness, tracing
    from siammask_tpu_torch.tools import trace_report
    from siammask_tpu_torch.utils import trace

    harness.set_cache_dirs(ROOT)
    profile = tracing.profile

    def read(run, path, stretch):
        def stretch_run():
            if spans:
                return run()
            with trace.paused():
                return run()

        result = profile(stretch_run, path, stretch)
        read.table = trace_report.report(trace_report.load_trace_events(path))
        return result

    tracing.profile = read
    try:
        line = harness.run_cell(name, seed, seconds, True)
    finally:
        tracing.profile = profile
    table = read.table
    idle = table["idle_ms"]
    by_span = table["idle_by_span"]
    outside = by_span.get(trace_report.OUTSIDE, {}).get("ms", 0.0)
    return {"workload": name, "seed": seed, "spans": spans, "correct": line["correct"],
            "metrics": {k: v["value"] for k, v in line["metrics"].items()},
            "stretch_s": line["device"].get("window_s"), "busy_s": line["device"].get("busy_s"),
            "trace_idle_ms": idle,
            "idle_in_program_pct": 100.0 * (1 - outside / idle) if idle and by_span else None,
            "gap_bins": table["gap_bins"], "idle_by_span": by_span,
            "program_spans": table["spans"],
            "breakdown": line.get("breakdown")}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload")
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--seconds", type=float, default=3.0,
                        help="the measured window before the stretch")
    parser.add_argument("--no-spans", action="store_true",
                        help="pause the program's spans through the stretch")
    parser.add_argument("--span-cost", action="store_true")
    args = parser.parse_args(argv)
    if args.span_cost:
        print(json.dumps(span_cost()), flush=True)
        return 0
    if not args.workload:
        parser.error("--workload or --span-cost")
    print(json.dumps(traced_cell(args.workload, args.seed, args.seconds, not args.no_spans)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
