"""Offline evaluation over written result dirs: VOT EAO / Accuracy /
Robustness, DAVIS J&F (region similarity + boundary accuracy), and
YouTube-VOS J_s/J_u/F_s/F_u (seen/unseen category split).

Counterpart of ``tools/eval.py``, with the same flags plus ``--eao-interval``
(the EAO curve's frame interval, as ``tools/tune.py`` takes it: the standard
VOT2018 window, frames 100..356, is empty on short sequences). It mirrors the
reference `tools/eval.py` for VOT (glob tracker result dirs by prefix, score AR
then EAO, pretty table, process-pool fan-out over trackers); the DAVIS and
ytb_vos paths score the fused masks that ``tools/test.py --save_mask`` writes.
numpy, cv2 and PIL only: it needs no torch and no card::

    python -m siammask_tpu_torch.tools.eval --dataset VOT2018 --dataset-dir data \\
        --result-dir test

``main(argv)`` prints the table and returns the summary, per tracker.
"""
from __future__ import annotations

import argparse
from glob import glob
from multiprocessing import get_context
from os.path import basename, isdir, join


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Evaluate VOT results")
    parser.add_argument("--dataset", default="VOT2018")
    parser.add_argument("--dataset-dir", default="data",
                        help="dir containing <dataset>.json metadata")
    parser.add_argument("--result-dir", default="test")
    parser.add_argument("--tracker-prefix", default="",
                        help="filter tracker result dirs by prefix")
    parser.add_argument("--num", type=int, default=4, help="process pool size")
    parser.add_argument("--eao-interval", default=None,
                        help="override the EAO curve interval as 'low,high' "
                             "(for short/synthetic sequences)")
    return parser.parse_args(argv)


def evaluate(trackers: list[str], num: int, *evals) -> list[dict]:
    """Each of ``evals`` (tracker name -> {tracker: result}) over every
    tracker, merged into one dict each; in a pool of ``min(num, trackers)``
    spawned processes when both exceed 1."""
    results = [{} for _ in evals]
    if num > 1 and len(trackers) > 1:
        with get_context("spawn").Pool(min(num, len(trackers))) as pool:
            for merged, fn in zip(results, evals):
                for r in pool.imap_unordered(fn, trackers):
                    merged.update(r)
    else:
        for merged, fn in zip(results, evals):
            for t in trackers:
                merged.update(fn(t))
    return results


def _table(columns: list[tuple[str, int]], name_len: int) -> tuple[str, str]:
    header = f"|{'Tracker Name':^{name_len}}|" + "".join(f"{c:^{w}}|" for c, w in columns)
    return header, "-" * len(header)


def main(argv=None) -> dict:
    args = parse_args(argv)
    tracker_root = join(args.result_dir, args.dataset)
    trackers = sorted(basename(x) for x in glob(join(tracker_root, args.tracker_prefix + "*"))
                      if isdir(x))
    if not trackers:
        print(f"no tracker results under {tracker_root}")
        return {}
    name_len = max(max(len(t) for t in trackers) + 2, 12)

    if args.dataset.startswith("DAVIS"):
        from siammask_tpu_torch.eval.datasets import load_dataset
        from siammask_tpu_torch.eval.davis import DAVISBenchmark

        bench = DAVISBenchmark(load_dataset(args.dataset, args.dataset_dir),
                               args.dataset, args.result_dir)
        summary = DAVISBenchmark.summarize(evaluate(trackers, args.num, bench.eval)[0])
        header, bar = _table([("J-mean", 8), ("J-recall", 10), ("J-decay", 9), ("F-mean", 8),
                              ("F-recall", 10), ("F-decay", 9)], name_len)
        print(bar + "\n" + header + "\n" + bar)
        for name in sorted(trackers, key=lambda t: -summary[t]["J_mean"]):
            s = summary[name]
            print(f"|{name:^{name_len}}|{s['J_mean']:^8.3f}|{s['J_recall']:^10.3f}|"
                  f"{s['J_decay']:^9.3f}|{s['F_mean']:^8.3f}|"
                  f"{s['F_recall']:^10.3f}|{s['F_decay']:^9.3f}|")
        print(bar)
        return summary

    if args.dataset == "ytb_vos":
        from siammask_tpu_torch.eval.datasets import load_dataset
        from siammask_tpu_torch.eval.ytb_vos import YTBVOSBenchmark

        bench = YTBVOSBenchmark(load_dataset("ytb_vos", args.dataset_dir), args.result_dir,
                                args.dataset, data_dir=args.dataset_dir)
        summary = bench.summarize(evaluate(trackers, args.num, bench.eval)[0])
        header, bar = _table([("J_seen", 8), ("J_unseen", 10), ("F_seen", 8),
                              ("F_unseen", 10), ("Overall", 9)], name_len)
        print(bar + "\n" + header + "\n" + bar)
        for name in sorted(trackers, key=lambda t: -summary[t]["overall"]):
            s = summary[name]
            print(f"|{name:^{name_len}}|{s['J_seen']:^8.3f}|"
                  f"{s['J_unseen']:^10.3f}|{s['F_seen']:^8.3f}|"
                  f"{s['F_unseen']:^10.3f}|{s['overall']:^9.3f}|")
        print(bar)
        return summary

    from siammask_tpu_torch.eval.benchmarks import AccuracyRobustnessBenchmark, EAOBenchmark
    from siammask_tpu_torch.eval.datasets import VOTDataset

    dataset = VOTDataset(args.dataset, args.dataset_dir)
    dataset.set_tracker(tracker_root, trackers)
    ar = AccuracyRobustnessBenchmark(dataset)
    eao = EAOBenchmark(dataset)
    if args.eao_interval:
        eao.low, eao.high = (int(x) for x in args.eao_interval.split(","))
    ar_results, eao_results = evaluate(trackers, args.num, ar.eval, eao.eval)

    summary = AccuracyRobustnessBenchmark.summarize(ar_results)
    header, bar = _table([("Accuracy", 10), ("Robustness", 12), ("Lost Number", 13),
                          ("EAO", 7)], name_len)
    print(bar)
    print(header)
    print(bar)
    for name in sorted(trackers, key=lambda t: -eao_results[t]["all"]):
        s = summary[name]
        print(f"|{name:^{name_len}}|{s['accuracy']:^10.3f}|"
              f"{s['robustness']:^12.3f}|{s['lost_number']:^13.1f}|"
              f"{eao_results[name]['all']:^7.3f}|")
    print(bar)
    return {name: {**summary[name], "eao": eao_results[name]["all"]} for name in trackers}


if __name__ == "__main__":
    main()
