"""YouTube-VOS J_s/J_u/F_s/F_u scorer.

Counterpart of ``siammask_tpu/eval/ytb_vos.py`` (numpy and PIL).

The reference reports the four YouTube-VOS numbers in its README (reference
README.md:141) but contains no scorer — they come from the codalab evaluation
server. This module makes the framework self-contained: region similarity (J)
and boundary accuracy (F) per object, averaged within the *seen* and *unseen*
category splits, in BASELINE.md's ``J_s / J_u / F_s / F_u`` format.

Protocol (matching the official server semantics):

- Each object is scored on exactly ITS OWN annotated frame list from meta.json
  (``objects[k]["frames"]``), excluding the first (init) frame — NOT on every
  merged-frame-list index inside its [start, end] range. The lists are sparse
  on the real valid split (every 5th frame) and differ per object, so scoring
  in-between merged indices would grade an object against frames where it has
  no annotation (`eval/datasets.py` exposes them as ``obj_frames``; reference
  `utils/benchmark_helper.py:68-94` loads the same per-object lists).
- Ground-truth annotation PNGs must exist for the scored frames. On the real
  YouTube-VOS valid split only first-frame annotations are public (scoring
  happens server-side), so this scorer requires a densely annotated split
  (train-derived or custom). Frames whose annotation PNG is missing are
  skipped with a warning naming the file rather than silently scored against
  an empty mask.
- "Seen" categories are those present in the training split; "unseen" are
  val-only. The split is resolved from (in order): an explicit
  ``seen_categories`` argument, the training split's own ``meta.json``
  (categories that appear in training ARE the seen set, by definition), or a
  ``seen_categories.json`` list file next to the valid split. With no source
  available every category is scored as seen and the summary says so.
- Result masks are the fused PNGs ``track_vos`` writes (pixel value =
  object id), one per frame, in ``<result_root>/<dataset>/<tracker>/<video>/``.
"""
from __future__ import annotations

import json
import logging
from glob import glob
from os.path import exists, join

import numpy as np

from siammask_tpu_torch.eval.davis import db_eval_boundary, db_eval_iou

logger = logging.getLogger("siammask_tpu_torch")


def seen_categories_for(data_dir: str = "data") -> set | None:
    """Resolve the seen-category set for the ytb_vos valid split, or None.

    Seen = appears in the training split (that is the definition of the
    split), so the train meta.json is the authoritative offline source."""
    train_meta = join(data_dir, "ytb_vos", "train", "meta.json")
    if exists(train_meta):
        with open(train_meta) as f:
            videos = json.load(f)["videos"]
        return {o.get("category")
                for v in videos.values() for o in v["objects"].values()}
    listing = join(data_dir, "ytb_vos", "valid", "seen_categories.json")
    if exists(listing):
        with open(listing) as f:
            return set(json.load(f))
    return None


class YTBVOSBenchmark:
    """Scores saved ytb_vos result masks against the valid-split annotations."""

    def __init__(self, dataset: dict, result_root: str,
                 dataset_name: str = "ytb_vos",
                 seen_categories: set | None = None,
                 data_dir: str = "data"):
        self.dataset = dataset          # eval.datasets.load_dataset output
        self.dataset_name = dataset_name
        self.result_root = result_root
        if seen_categories is None:
            seen_categories = seen_categories_for(data_dir)
        self.seen_categories = seen_categories

    def eval(self, tracker_name: str) -> dict:
        """-> {video: {object_id: {"J": mean, "F": mean, "category": str,
        "seen": bool}}} over each object's own annotated frame list."""
        from PIL import Image

        out = {}
        for name, video in self.dataset.items():
            pred_dir = join(self.result_root, self.dataset_name, tracker_name,
                            name)
            pred_files = sorted(glob(join(pred_dir, "*.png")))
            if len(pred_files) != len(video["anno_files"]):
                continue        # incomplete result dir — skip like the toolkit
            loaded = {}         # frame index -> (anno, pred), lazily

            def frame(t):
                if t not in loaded:
                    loaded[t] = (np.array(Image.open(video["anno_files"][t])),
                                 np.array(Image.open(pred_files[t])))
                return loaded[t]

            video_res = {}
            missing = []
            obj_frames = video.get("obj_frames") or {
                # legacy dict without per-object lists: every merged index
                # in the object's range (dense-annotation assumption)
                k: list(range(video["start_frame"][k],
                              video["end_frame"][k] + 1))
                for k in video["start_frame"]}
            for obj, frame_ids in obj_frames.items():
                o_id = int(obj)
                j_scores, f_scores = [], []
                # score on the object's own annotated frames, init excluded
                for t in frame_ids[1:]:
                    if not exists(video["anno_files"][t]):
                        missing.append(video["anno_files"][t])
                        continue
                    gt_anno, pred_anno = frame(t)
                    gt = gt_anno == o_id
                    pred = pred_anno == o_id
                    j_scores.append(db_eval_iou(pred, gt))
                    f_scores.append(db_eval_boundary(pred, gt))
                if not j_scores:
                    continue    # single-frame object / no scoreable frames
                cat = video.get("category", {}).get(obj)
                seen = (self.seen_categories is None
                        or cat in self.seen_categories)
                video_res[o_id] = {"J": float(np.mean(j_scores)),
                                   "F": float(np.mean(f_scores)),
                                   "category": cat, "seen": bool(seen)}
            if missing:
                logger.warning(
                    "ytb_vos video %s: %d scoring frame(s) have no ground-"
                    "truth annotation (first: %s) — skipped, not scored as "
                    "empty. The official valid split's gt is server-private; "
                    "this scorer needs an annotated split.",
                    name, len(missing), missing[0])
            out[name] = video_res
        return {tracker_name: out}

    def summarize(self, results: dict) -> dict:
        """-> {tracker: {"J_seen", "J_unseen", "F_seen", "F_unseen",
        "overall"}} — the server's headline layout (overall = mean of the
        four, the G-mean)."""
        summary = {}
        for tracker, videos in results.items():
            js, ju, fs, fu = [], [], [], []
            for video_res in videos.values():
                for obj_res in video_res.values():
                    (js if obj_res["seen"] else ju).append(obj_res["J"])
                    (fs if obj_res["seen"] else fu).append(obj_res["F"])
            mean = lambda v: float(np.mean(v)) if v else 0.0
            entry = {"J_seen": mean(js), "J_unseen": mean(ju),
                     "F_seen": mean(fs), "F_unseen": mean(fu)}
            entry["overall"] = float(np.mean(list(entry.values())))
            if self.seen_categories is None:
                entry["split_source_missing"] = True
                logger.warning(
                    "ytb_vos seen/unseen split unavailable (no train "
                    "meta.json or seen_categories.json) — all objects "
                    "scored as seen")
            summary[tracker] = entry
        return summary

    @staticmethod
    def show_result(summary: dict, log=print):
        for tracker, s in summary.items():
            log(f"{tracker}: J_s {s['J_seen']:.3f} / J_u {s['J_unseen']:.3f} "
                f"/ F_s {s['F_seen']:.3f} / F_u {s['F_unseen']:.3f} "
                f"(overall {s['overall']:.3f})")
