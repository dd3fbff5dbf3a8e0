"""Readings that set the check's limits (not run by the benchmark's runs):

    python3 perfbench/control.py --workload <cell> --seconds <s>
        [--program-seeds a,b,...] [--control-seeds c,d,...]
        [--no-exchange-seeds e,...] [--look]

For each program seed, a run of the cell at its own size with a short window
(the sound readings, the lower end of each limit); for each control seed,
the same run with the plain reference at fp8 in the program's place (the
upper end). One JSON line a run with every number the check reads. A
training cell also reads its planted faults: on each control seed, "half
of the batch left out" (the float32 reference stepped on the first half of
each checked batch, against the whole); on each program seed, "an answer
altered where it is produced" (the reported mask loss x1.5); a several-card
cell, "the exchange between cards left out" on each ``--no-exchange-seeds``
seed. ``--look`` holds the float32 reference against a float64 one, leaf by
leaf, and the program against the float64 one.
"""
import json
import os
import sys
from pathlib import Path


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(prog="perfbench/control.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--program-seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--no-exchange-seeds", default="",
                        help="several cards: the program with its gradient, count and metric "
                             "exchanges left out (a planted fault)")
    parser.add_argument("--look", action="store_true",
                        help="training: also the float32 reference against a float64 one, "
                             "leaf by leaf, on each program seed")
    args = parser.parse_args(argv)

    import torch

    from perfbench import harness
    from perfbench.drivers import train

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    found = harness.find_cell(args.workload)
    training = found["traffic"]["driver"] == "train"
    runs = [(s, None) for s in seeds(args.program_seeds)] + \
        [(s, "control") for s in seeds(args.control_seeds)] + \
        [(s, "no_exchange") for s in seeds(args.no_exchange_seeds)]
    for seed, system in runs:
        if not training:
            readings = {}
            harness.run_cell(args.workload, seed, args.seconds, False, system=system,
                             readings=readings)
            print(json.dumps({"system": system or "program", "seed": seed,
                              "checks": readings}), flush=True)
            continue
        ctx = harness.Context(args.workload, found, seed, torch.device("cuda"), 1,
                              system=system)
        cell = train.setup(ctx)
        cell.free()
        with torch.enable_grad():
            full = cell.reference()
        checks = cell.compare(cell.losses, cell.grad1, cell.params3, cell.buffers3, full)
        print(json.dumps({"system": system or "program", "seed": seed, "checks": checks}),
              flush=True)
        if system is None:     # the reported mask loss altered (x1.5) where produced
            altered = [[a, b, 1.5 * c] for a, b, c in cell.losses]
            fault = cell.compare(altered, cell.grad1, cell.params3, cell.buffers3, full)
            print(json.dumps({"system": "fault_answer_altered", "seed": seed,
                              "checks": {"loss_gap": fault["loss_gap"]}}), flush=True)
        if args.look and system is None:
            with torch.enable_grad():
                exact = cell.reference(dtype=torch.float64)
            exact = (exact[0], {k: v.float() for k, v in exact[1].items()},
                     {k: v.float() for k, v in exact[2].items()})
            params3 = {k: full[2][k] for k in cell.params3}
            buffers3 = {k: full[2][k] for k in cell.buffers3}
            look = {"float32_vs_float64": cell.compare(full[0], full[1], params3, buffers3,
                                                       exact),
                    "program_vs_float64": cell.compare(cell.losses, cell.grad1, cell.params3,
                                                       cell.buffers3, exact)}
            print(json.dumps({"system": "look", "seed": seed, "checks": look}), flush=True)
        if system == "control":
            with torch.enable_grad():
                half = cell.reference(rows=ctx.traffic["batch"] // 2)
            params3 = {k: half[2][k] for k in cell.params3}
            buffers3 = {k: half[2][k] for k in cell.buffers3}
            fault = cell.compare(half[0], half[1], params3, buffers3, full)
            print(json.dumps({"system": "fault_half_batch", "seed": seed, "checks": fault}),
                  flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    root = Path(__file__).resolve().parent.parent
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(root)] + [p for p in sys.path if os.path.abspath(p or ".") != here]
    from perfbench import harness as _h

    _h.set_cache_dirs(root)
    sys.exit(main())
