#!/usr/bin/env python3
"""The port's overfit tool for each of its tasks, at the tool's defaults on
the card, on the synthetic clip of ``chip_smoke.write_overfit_clip`` (70
frames of 480x854): one ``--task multi --prepare`` (which writes every
task's tree), then ``--train --evaluate`` for ``mask``, ``siamrpn`` and
``multi``, each a subprocess of ``python -m siammask_tpu_torch.tools.overfit``::

    python3 scripts/overfit_torch.py

Under ``build/overfit_torch/logs`` it keeps each run's tool log
(``<task>.log``), the train CLI's log (``<task>.train.log``), the train
logs' per-epoch curves (``<task>_curve.json``, ``tools/curves.py``) and the
reports; the work tree (crops, checkpoints) goes to ``build/overfit_torch``.
It prints one line a run (wall s by stage; samples/s of each train CLI run,
and of the halves of its epochs, from its log's timestamps by
``chip_smoke.train_log_runs``; the report's headline numbers), the card's
name and power limit, and last one JSON object with all of it. Exits 1 if a
run fails.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from siammask_tpu_torch.tools import curves  # noqa: E402

REPORTS = {"mask": "report.json", "siamrpn": "report_rpn.json", "multi": "report_multi.json"}
ROOT = REPO / "build" / "overfit_torch"


def run(args: list[str], out: Path, name: str) -> dict:
    """One tool run: its stdout to ``<name>.log``, its stderr (the train
    CLI's logging) to ``<name>.train.log``. Returns the walls it logged."""
    log, train_log = out / f"{name}.log", out / f"{name}.train.log"
    with open(log, "w") as f, open(train_log, "w") as g:
        rc = subprocess.run([sys.executable, "-m", "siammask_tpu_torch.tools.overfit", *args],
                            stdout=f, stderr=g, cwd=REPO).returncode
    if rc != 0:
        raise SystemExit(f"{name}: rc={rc}; {train_log.read_text()[-3000:]}")
    lines = log.read_text().splitlines()
    return {m.group(1): float(m.group(2))
            for line in lines if (m := chip_smoke.OVERFIT_WALL.match(line))}


def headline(report: dict) -> dict:
    fit, held = report["train_fit"], report["held_out_tracking"]
    keys = [k for k in ("cls_loss", "loc_loss", "mask_loss", "total_loss", "iou_at_5",
                        "iou_mean") if k in fit["init"]]
    clips = held if report["task"] == "multi" else {"clip": held}
    return {"train_fit": {s: {k: fit[s][k] for k in keys} for s in ("init", "trained")},
            "held_out": {c: {s: {k: h[s][k] for k in ("mean_iou", "min_iou", "lost")}
                             for s in ("init", "trained")} for c, h in clips.items()}}


def main() -> None:
    shutil.rmtree(ROOT, ignore_errors=True)
    clip, work, out = ROOT / "clip", ROOT / "work", ROOT / "logs"
    out.mkdir(parents=True)
    chip_smoke.write_overfit_clip(clip)
    common = ["--work-dir", str(work), "--frames-dir", str(clip), "--device", "cuda"]
    smi = chip_smoke.smi_line()
    results = {"prepare": run(["--prepare", "--task", "multi", *common], out, "prepare")}
    print(f"prepare (--task multi, both clips): {results['prepare']} | {smi}", flush=True)
    for task in REPORTS:
        walls = run(["--train", "--evaluate", "--task", task, *common], out, task)
        curve = curves.parse(str(out / f"{task}.train.log"))
        (out / f"{task}_curve.json").write_text(json.dumps(curve, indent=1))
        report = json.loads((work / REPORTS[task]).read_text())
        shutil.copy(work / REPORTS[task], out / REPORTS[task])
        rates = [dict(r, samples_per_s=chip_smoke.OVERFIT_BATCH / r["s_it"],
                      samples_per_s_halves=[chip_smoke.OVERFIT_BATCH / t
                                            for t in r["s_it_halves"]])
                 for r in chip_smoke.train_log_runs(out / f"{task}.train.log")]
        results[task] = {"walls": walls, "train_runs": rates, **headline(report)}
        print(f"{task}: {json.dumps(results[task])} | {smi}", flush=True)
    print(smi)
    print(json.dumps({"overfit": results, "card": smi}))


if __name__ == "__main__":
    main()
