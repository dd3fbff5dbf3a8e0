"""Evaluation statistics (VOT protocol + OTB-style curves), vectorized numpy.

Counterpart of ``siammask_tpu/eval/statistics.py``, over the port's region
overlap (``eval/region.py``). Semantics follow `utils/pysot/utils/statistics.py` (numba kernels there; pure
vectorized numpy here — same numbers):

- ``calculate_failures``: failure frames are the [2] markers in a trajectory.
- ``calculate_accuracy``: mean region overlap with a burn-in window zeroed after
  each re-init marker [1]; overlaps via the C++ region kernel.
- ``calculate_expected_overlap``: the EAO curve over NaN-padded fragments.
"""
from __future__ import annotations

import numpy as np

from siammask_tpu_torch.eval.region import vot_overlap_traj


def calculate_failures(trajectory):
    """Returns (num_failures, failure_frame_indices). A failure entry is [2]."""
    failures = [i for i, x in enumerate(trajectory) if len(x) == 1 and x[0] == 2]
    return len(failures), failures


def calculate_accuracy(pred_trajectory, gt_trajectory, burnin=0,
                       ignore_unknown=True, bound=None):
    """Average overlap over a sequence with post-re-init burn-in masking.

    Re-init entries are [1]; the following ``burnin`` frames are replaced with the
    unknown marker [0] (overlap NaN, excluded from the nanmean)."""
    pred = pred_trajectory
    if burnin > 0:
        pred = list(pred_trajectory)
        for i, x in enumerate(pred_trajectory):
            if len(x) == 1 and x[0] == 1:
                for j in range(burnin):
                    if i + j < len(pred):
                        pred[i + j] = [0]
    min_len = min(len(pred), len(gt_trajectory))
    overlaps = vot_overlap_traj(pred[:min_len], gt_trajectory[:min_len], bound)
    # guard the all-NaN case (e.g. a burnin window covering the whole fragment)
    # before nanmean: it would warn 'Mean of empty slice' and return NaN
    valid = np.asarray(overlaps)
    valid = valid[~np.isnan(valid)]
    acc = float(np.mean(valid)) if len(valid) > 0 else 0
    return acc, overlaps


def overlap_ratio(rect1, rect2):
    """IoU between [N,4] xywh rect arrays."""
    rect1 = np.asarray(rect1, dtype=np.float64)
    rect2 = np.asarray(rect2, dtype=np.float64)
    left = np.maximum(rect1[:, 0], rect2[:, 0])
    right = np.minimum(rect1[:, 0] + rect1[:, 2], rect2[:, 0] + rect2[:, 2])
    top = np.maximum(rect1[:, 1], rect2[:, 1])
    bottom = np.minimum(rect1[:, 1] + rect1[:, 3], rect2[:, 1] + rect2[:, 3])
    inter = np.maximum(0, right - left) * np.maximum(0, bottom - top)
    union = rect1[:, 2] * rect1[:, 3] + rect2[:, 2] * rect2[:, 3] - inter
    return np.clip(inter / union, 0, 1)


def success_overlap(gt_bb, result_bb, n_frame):
    """Success curve over IoU thresholds 0..1 step .05."""
    thresholds = np.arange(0, 1.05, 0.05)
    iou = np.full(len(gt_bb), -1.0)
    mask = np.sum(gt_bb > 0, axis=1) == 4
    iou[mask] = overlap_ratio(gt_bb[mask], result_bb[mask])
    return np.array([np.sum(iou > t) / float(n_frame) for t in thresholds])


def success_error(gt_center, result_center, thresholds, n_frame):
    """Precision curve over center-distance thresholds."""
    dist = np.full(len(gt_center), -1.0)
    mask = np.sum(gt_center > 0, axis=1) == 2
    dist[mask] = np.sqrt(np.sum((gt_center[mask] - result_center[mask]) ** 2, axis=1))
    return np.array([np.sum(dist <= t) / float(n_frame) for t in thresholds])


def determine_thresholds(scores, resolution=100):
    scores = np.sort(scores[np.logical_not(np.isnan(scores))])
    delta = np.floor(len(scores) / (resolution - 2))
    idxs = np.floor(np.linspace(delta - 1, len(scores) - delta,
                                resolution - 2) + 0.5).astype(np.int32)
    thresholds = np.zeros(resolution)
    thresholds[0] = -np.inf
    thresholds[-1] = np.inf
    thresholds[1:-1] = scores[idxs]
    return thresholds


def calculate_f1(overlaps, score, bound, thresholds, N):
    overlaps = np.nan_to_num(np.asarray(overlaps, dtype=np.float64))
    score = np.nan_to_num(np.asarray(score, dtype=np.float64))
    precision = np.zeros(len(thresholds))
    recall = np.zeros(len(thresholds))
    for i, th in enumerate(thresholds):
        idx = score > 0 if th == -np.inf else score >= th
        if np.sum(idx) == 0:
            precision[i] = 1
            recall[i] = 0
        else:
            precision[i] = np.mean(overlaps[idx])
            recall[i] = np.sum(overlaps[idx]) / N
    f1 = 2 * precision * recall / (precision + recall)
    return f1, precision, recall


def calculate_expected_overlap(fragments, fweights):
    """EAO curve: for each length i, the fragment-weighted mean of per-fragment
    average overlap over frames 1..i (fragments NaN-padded past their end)."""
    max_len = fragments.shape[1]
    expected = np.zeros(max_len, np.float32)
    expected[0] = 1
    valid = np.logical_not(np.isnan(fragments))
    # cumulative sums let every i reuse one pass
    frag0 = np.nan_to_num(fragments)
    csum = np.cumsum(frag0[:, 1:], axis=1)  # sum of frames 1..i
    for i in range(1, max_len):
        mask = valid[:, i]
        if np.any(mask):
            seq_mean = csum[mask, i - 1] / i
            expected[i] = np.sum(seq_mean * fweights[mask]) / np.sum(fweights[mask])
    return expected
