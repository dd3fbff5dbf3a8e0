"""VOT Accuracy/Robustness and Expected Average Overlap benchmarks.

Counterpart of ``siammask_tpu/eval/benchmarks.py`` (numpy only). Protocol
parity with `utils/pysot/evaluation/{ar_benchmark,eao_benchmark}.py`:

- A = per-video nanmean of overlaps with a 10-frame burn-in after each re-init.
- R = failures / total-length x 100 (averaged per repeat).
- EAO: trajectories split into fragments at failures (+skipping), NaN-padded
  fragment matrix + per-fragment tag weights, expected-overlap curve averaged
  over the dataset-specific frame interval (VOT2018/17/16: 100..356; VOT2019:
  46..291).
"""
from __future__ import annotations

import itertools
import warnings

import numpy as np

from siammask_tpu_torch.eval.statistics import (calculate_accuracy,
                                                calculate_expected_overlap, calculate_failures)


class AccuracyRobustnessBenchmark:
    def __init__(self, dataset, burnin: int = 10):
        self.dataset = dataset
        self.burnin = burnin

    def eval(self, eval_trackers=None) -> dict:
        if eval_trackers is None:
            eval_trackers = self.dataset.tracker_names
        if isinstance(eval_trackers, str):
            eval_trackers = [eval_trackers]
        return {name: dict(zip(("overlaps", "failures"),
                               self._accuracy_robustness(name)))
                for name in eval_trackers}

    def _accuracy_robustness(self, tracker_name):
        overlaps, failures = {}, {}
        for video in self.dataset:
            gt_traj = video.gt_traj
            trajs = video.pred_trajs.get(tracker_name) or video.load_tracker(
                self.dataset.tracker_path, tracker_name, False)
            overlaps_group, failures_group = [], []
            for traj in trajs:
                failures_group.append(calculate_failures(traj)[0])
                overlaps_group.append(calculate_accuracy(
                    traj, gt_traj, burnin=self.burnin,
                    bound=(video.width, video.height))[1])
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", category=RuntimeWarning)
                overlaps[video.name] = np.nanmean(overlaps_group, axis=0).tolist()
            failures[video.name] = failures_group
        return overlaps, failures

    @staticmethod
    def summarize(result: dict) -> dict:
        """{tracker: {accuracy, robustness, lost_number}} from eval() output."""
        out = {}
        for name, ret in result.items():
            overlaps = list(itertools.chain(*ret["overlaps"].values()))
            length = sum(len(x) for x in ret["overlaps"].values())
            failures = list(ret["failures"].values())
            has_valid = len(overlaps) > 0 and not np.all(np.isnan(overlaps))
            out[name] = {
                # all-NaN when every frame is burnin-masked (very short videos)
                "accuracy": float(np.nanmean(overlaps)) if has_valid
                            else float("nan"),
                "lost_number": float(np.mean(np.sum(failures, axis=0))),
                "robustness": float(np.mean(np.sum(np.array(failures), axis=0)
                                            / length) * 100),
            }
        return out


class EAOBenchmark:
    def __init__(self, dataset, skipping: int = 5, tags=("all",)):
        self.dataset = dataset
        self.skipping = skipping
        self.tags = list(tags)
        if dataset.name in ("VOT2019",):
            self.low, self.high, self.peak = 46, 291, 128
        else:  # VOT2018 / VOT2017 / VOT2016
            self.low, self.high, self.peak = 100, 356, 160

    def eval(self, eval_trackers=None) -> dict:
        if eval_trackers is None:
            eval_trackers = self.dataset.tracker_names
        if isinstance(eval_trackers, str):
            eval_trackers = [eval_trackers]
        return {name: self._calculate_eao(name, self.tags)
                for name in eval_trackers}

    def _calculate_eao(self, tracker_name, tags):
        all_overlaps, all_failures = [], []
        video_names, gt_traj_length = [], []
        for video in self.dataset:
            gt_traj = video.gt_traj
            trajs = video.pred_trajs.get(tracker_name) or video.load_tracker(
                self.dataset.tracker_path, tracker_name, False)
            for traj in trajs:
                gt_traj_length.append(len(gt_traj))
                video_names.append(video.name)
                all_overlaps.append(calculate_accuracy(
                    traj, gt_traj, bound=(video.width - 1, video.height - 1))[1])
                all_failures.append(calculate_failures(traj)[1])
        fragment_num = sum(len(x) + 1 for x in all_failures)
        max_len = max(len(x) for x in all_overlaps)
        # NOTE: intentionally uses the LAST video's repeat count, reproducing the
        # reference protocol's own loop-variable leak (pysot eao_benchmark.py) —
        # all VOT videos share the repeat count, so the value is uniform anyway.
        seq_weight = 1.0 / len(trajs)

        eao = {}
        for tag in tags:
            fweights = np.full(fragment_num, np.nan)
            fragments = np.full((fragment_num, max_len), np.nan)
            seg = 0
            for name, traj_len, failures, overlaps in zip(
                    video_names, gt_traj_length, all_failures, all_overlaps):
                if failures:
                    points = [x + self.skipping for x in failures
                              if x + self.skipping <= len(overlaps)]
                    points.insert(0, 0)
                    for i in range(len(points)):
                        if i != len(points) - 1:
                            fragment = np.array(overlaps[points[i]:points[i + 1] + 1])
                            fragments[seg, :] = 0
                        else:
                            fragment = np.array(overlaps[points[i]:])
                        fragment[np.isnan(fragment)] = 0
                        fragments[seg, :len(fragment)] = fragment
                        if i != len(points) - 1:
                            tag_value = self.dataset[name].select_tag(
                                tag, points[i], points[i + 1] + 1)
                            w = sum(tag_value) / (points[i + 1] - points[i] + 1)
                        else:
                            tag_value = self.dataset[name].select_tag(
                                tag, points[i], len(overlaps))
                            w = sum(tag_value) / (traj_len - points[i] + 1e-16)
                        fweights[seg] = seq_weight * w
                        seg += 1
                else:
                    max_idx = min(len(overlaps), max_len)
                    # (reference keeps NaNs here — they mark the fragment end)
                    fragments[seg, :max_idx] = overlaps[:max_idx]
                    tag_value = self.dataset[name].select_tag(tag, 0, max_idx)
                    fweights[seg] = seq_weight * (sum(tag_value) / max_idx)
                    seg += 1

            expected = calculate_expected_overlap(fragments, fweights)
            weight = np.zeros(len(expected))
            weight[self.low - 1:self.high] = 1
            is_valid = np.logical_not(np.isnan(expected))
            eao[tag] = float(np.sum(expected[is_valid] * weight[is_valid])
                             / np.sum(weight[is_valid]))
        return eao
