"""Benchmark datasets: the VOT toolkit's dataset (json metadata and result
trajectories) that the eval benchmarks score, and ``load_dataset``, the
per-video dicts that the drivers in ``tracker/`` take.

Counterpart of ``siammask_tpu/eval/datasets.py`` (numpy only), which mirrors
`utils/pysot/datasets/{vot,video,dataset}.py` and `utils/benchmark_helper.py`:
the list.txt/groundtruth.txt VOT layout with its 4->8 point upgrade, DAVIS
ImageSets, YouTube-VOS meta.json.
"""
from __future__ import annotations

import json
from glob import glob
from os.path import basename, exists, isdir, join

import numpy as np


class Video:
    def __init__(self, name, root, video_dir, init_rect, img_names, gt_rect, attr):
        self.name = name
        self.video_dir = video_dir
        self.init_rect = init_rect
        self.gt_traj = gt_rect
        self.attr = attr
        self.pred_trajs = {}
        self.img_names = [join(root, x) for x in img_names]
        self.imgs = None

    def __len__(self):
        return len(self.img_names)


class VOTVideo(Video):
    """One VOT sequence with per-frame attribute tags (vot.py:20-93)."""

    TAG_NAMES = ("camera_motion", "illum_change", "motion_change",
                 "size_change", "occlusion")

    def __init__(self, name, root, video_dir, init_rect, img_names, gt_rect,
                 tags: dict, width, height):
        super().__init__(name, root, video_dir, init_rect, img_names, gt_rect, None)
        self.tags = {"all": [1] * len(gt_rect)}
        for t in self.TAG_NAMES:
            self.tags[t] = tags.get(t, [])
        self.width = width
        self.height = height
        all_tag = [v for v in self.tags.values() if len(v) > 0]
        self.tags["empty"] = np.all(
            1 - np.array(all_tag), axis=0).astype(np.int32).tolist() if all_tag else []
        self.tag_names = list(self.tags.keys())

    def select_tag(self, tag, start=0, end=0):
        if tag == "empty":
            return self.tags[tag]
        return self.tags[tag][start:end]

    def load_tracker(self, path, tracker_names=None, store=True):
        """Load result trajectories (15-repeat or single run) from
        <path>/<tracker>/baseline/<video>/*0*.txt."""
        if not tracker_names:
            tracker_names = [basename(x) for x in glob(path) if isdir(x)]
        if isinstance(tracker_names, str):
            tracker_names = [tracker_names]
        for name in tracker_names:
            traj_files = sorted(glob(join(path, name, "baseline", self.name,
                                          "*0*.txt")))
            if len(traj_files) != 15:
                traj_files = traj_files[0:1]
            pred_traj = []
            for traj_file in traj_files:
                with open(traj_file) as f:
                    traj = [list(map(float, line.strip().split(",")))
                            for line in f]
                pred_traj.append(traj)
            if store:
                self.pred_trajs[name] = pred_traj
            else:
                return pred_traj


class VOTDataset:
    """VOT benchmark from the toolkit's VOT20xx.json metadata (vot.py:95-128)."""

    def __init__(self, name, dataset_root):
        self.name = name
        self.dataset_root = dataset_root
        self.tracker_path = None
        self.tracker_names = []
        with open(join(dataset_root, name + ".json")) as f:
            meta = json.load(f)
        self.videos = {}
        for video, m in meta.items():
            tags = {t: m.get(t, []) for t in VOTVideo.TAG_NAMES}
            self.videos[video] = VOTVideo(
                video, dataset_root, m["video_dir"], m["init_rect"],
                m["img_names"], m["gt_rect"], tags, m["width"], m["height"])
        self.tags = ["all", *VOTVideo.TAG_NAMES, "empty"]

    def __getitem__(self, idx):
        if isinstance(idx, str):
            return self.videos[idx]
        return list(self.videos.values())[idx]

    def __len__(self):
        return len(self.videos)

    def __iter__(self):
        return iter(self.videos.values())

    def set_tracker(self, path, tracker_names):
        self.tracker_path = path
        self.tracker_names = tracker_names


# ---------------------------------------------------------------------------
# online-test dataset discovery (utils/benchmark_helper.py)


def dataset_zoo(data_dir="data"):
    """Discover available benchmark datasets by probing the data directory."""
    zoo = []
    for name in ("VOT2016", "VOT2018", "VOT2019", "DAVIS2016", "DAVIS2017",
                 "ytb_vos"):
        probe = join(data_dir, name if not name.startswith("DAVIS") else "DAVIS")
        if exists(probe):
            zoo.append(name)
    return zoo


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
