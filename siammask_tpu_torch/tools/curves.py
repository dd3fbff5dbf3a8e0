"""Summarize a training log into per-epoch training curves.

Counterpart of ``tools/curves.py``. Parses the `epoch E step S lr L k=v ...`
lines that ``siammask_tpu_torch.tools.train`` (and the JAX package's
``tools/train.py``) log and emits one JSON object per epoch with the mean of
every metric over that epoch's logged steps — the compact artifact checked
into experiment records (the full logs stay in the experiment dir). The
port's per-group ``lr/<group>=`` tokens follow the metrics and are not read.

Usage:
    python -m siammask_tpu_torch.tools.curves <train.log> [--json out.json] [--metrics a,b,c]
"""
from __future__ import annotations

import argparse
import json
import re
from collections import defaultdict

LINE = re.compile(
    r"epoch (\d+) step (\d+) lr ([0-9.eE+-]+) ((?:\w+=[0-9.eE+-]+ ?)+)")


def parse(path: str) -> list[dict]:
    per_epoch: dict[int, dict[str, list[float]]] = defaultdict(
        lambda: defaultdict(list))
    lr: dict[int, float] = {}
    with open(path) as f:
        for line in f:
            m = LINE.search(line)
            if not m:
                continue
            epoch = int(m.group(1))
            lr[epoch] = float(m.group(3))
            for kv in m.group(4).split():
                k, v = kv.split("=")
                per_epoch[epoch][k].append(float(v))
    out = []
    for epoch in sorted(per_epoch):
        row = {"epoch": epoch, "lr": lr[epoch],
               "steps_logged": len(next(iter(per_epoch[epoch].values())))}
        for k, vals in sorted(per_epoch[epoch].items()):
            row[k] = round(sum(vals) / len(vals), 4)
        out.append(row)
    return out


def main(argv=None) -> list[dict]:
    """Prints the table; returns the rows."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("log")
    ap.add_argument("--json", default=None, help="write the rows here")
    ap.add_argument("--metrics", default="cls_loss,loc_loss,mask_loss,"
                    "iou_mean,iou_at_5,total_loss")
    args = ap.parse_args(argv)
    rows = parse(args.log)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    cols = ["epoch", "lr"] + [c for c in args.metrics.split(",") if c]
    print("  ".join(f"{c:>10}" for c in cols))
    for row in rows:
        print("  ".join(f"{row.get(c, float('nan')):>10}" for c in cols))
    return rows


if __name__ == "__main__":
    main()
