"""Benchmark dataset layouts: ``load_dataset`` builds the per-video dicts that
``tracker/vos.py``'s drivers take.

Counterpart of ``load_dataset`` in ``siammask_tpu/eval/datasets.py`` (numpy
only), which mirrors `utils/benchmark_helper.py`: the list.txt/groundtruth.txt
VOT layout with its 4->8 point upgrade, DAVIS ImageSets, YouTube-VOS meta.json.
"""
from __future__ import annotations

import json
from glob import glob
from os.path import join

import numpy as np


def load_dataset(dataset: str, data_dir: str = "data") -> dict:
    """Load per-video dicts: {name: {image_files, gt, ...}} for the online driver
    (benchmark_helper.py:35-108)."""
    info = {}
    if "VOT" in dataset:
        base_path = join(data_dir, dataset)
        list_path = join(base_path, "list.txt")
        with open(list_path) as f:
            videos = [v.strip() for v in f if v.strip()]
        for video in videos:
            video_path = join(base_path, video)
            image_files = sorted(glob(join(video_path, "*.jpg")))
            if len(image_files) == 0:  # VOT2018 layout keeps frames in color/
                image_files = sorted(glob(join(video_path, "color", "*.jpg")))
            gt_path = join(video_path, "groundtruth.txt")
            gt = np.loadtxt(gt_path, delimiter=",").astype(np.float64)
            if gt.shape[1] == 4:
                # axis-aligned xywh -> 8-point polygon (TL, BL, BR, TR), the
                # inclusive-pixel upgrade used by benchmark_helper.py:54-56
                x, y, w, h = gt[:, 0], gt[:, 1], gt[:, 2], gt[:, 3]
                gt = np.column_stack((x, y, x, y + h - 1,
                                      x + w - 1, y + h - 1, x + w - 1, y))
            info[video] = {"image_files": image_files, "gt": gt, "name": video}
    elif "DAVIS" in dataset and "TEST" not in dataset:
        year = dataset[5:] or "2016"
        base_path = join(data_dir, "DAVIS")
        list_path = join(base_path, "ImageSets", year, "val.txt")
        with open(list_path) as f:
            videos = [v.strip() for v in f if v.strip()]
        for video in videos:
            info[video] = {
                "anno_files": sorted(glob(join(base_path, "Annotations", "480p",
                                               video, "*.png"))),
                "image_files": sorted(glob(join(base_path, "JPEGImages", "480p",
                                                video, "*.jpg"))),
                "name": video,
            }
    elif dataset == "ytb_vos":
        base_path = join(data_dir, "ytb_vos", "valid")
        with open(join(base_path, "meta.json")) as f:
            meta = json.load(f)["videos"]
        for video, v in meta.items():
            objects = v["objects"]
            frames = sorted({f for obj in objects.values() for f in obj["frames"]})
            info[video] = {
                "image_files": [join(base_path, "JPEGImages", video, f + ".jpg")
                                for f in frames],
                "anno_files": [join(base_path, "Annotations", video, f + ".png")
                               for f in frames],
                "anno_init_files": [join(base_path, "Annotations", video,
                                         obj["frames"][0] + ".png")
                                    for obj in objects.values()],
                # start/end are INDICES into the merged frame list
                "start_frame": {k: frames.index(o["frames"][0])
                                for k, o in objects.items()},
                "end_frame": {k: frames.index(o["frames"][-1])
                              for k, o in objects.items()},
                # each object's OWN annotated frames as merged-list indices:
                # the official server scores an object exactly on this list
                # (minus the init frame), NOT on every merged index in its
                # [start, end] range — the lists can be sparse (every 5th
                # frame) and differ per object (benchmark_helper.py:68-94
                # loads the same per-object lists)
                "obj_frames": {k: [frames.index(f) for f in o["frames"]]
                               for k, o in objects.items()},
                # per-object category (drives the seen/unseen J/F split)
                "category": {k: o.get("category") for k, o in objects.items()},
                "name": video,
            }
    elif "TEST" in dataset:
        base_path = join(data_dir, "DAVIS2017TEST")
        with open(join(base_path, "ImageSets", "2017", "test-dev.txt")) as f:
            videos = [v.strip() for v in f if v.strip()]
        for video in videos:
            info[video] = {
                "anno_files": sorted(glob(join(base_path, "Annotations", "480p",
                                               video, "*.png"))),
                "image_files": sorted(glob(join(base_path, "JPEGImages", "480p",
                                                video, "*.jpg"))),
                "name": video,
            }
    else:
        raise ValueError(f"unknown dataset {dataset!r}")
    return info
