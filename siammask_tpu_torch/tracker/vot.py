"""VOT benchmark driver: the reset-on-failure protocol and its result files.

Counterpart of ``siammask_tpu/tracker/vot.py`` (the reference's
``tools/test.py:318-418``): init from the axis-aligned equivalent of the
rotated gt box; each frame's overlap with the gt through the region library
(``eval/region.py``); at zero overlap the frame is marked lost (2), the next
5 frames are skipped and the tracker is re-initialised from the gt; the
result is ``<video>_001.txt`` with the 1 / 2 / 0 markers and ``%.4f``
regions. Frames are read with cv2 (BGR, as the reference), imported inside
the function; the reads are outside the driver's clock.
"""
from __future__ import annotations

import time
from os import makedirs
from os.path import isdir, join

import numpy as np

from siammask_tpu_torch.eval.region import vot_float2str, vot_overlap
from siammask_tpu_torch.utils.bbox import cxy_wh_2_rect, get_axis_aligned_bbox

SKIP = 5    # frames from a lost frame to the re-init


def track_vot(runtime, video: dict, dataset: str = "VOT2018", mask_enable: bool = True,
              result_dir: str | None = None, tracker_name: str = "SiamMask", log=print):
    """runtime: ``TrackerRuntime``; video: a dict of ``eval.datasets.load_dataset``.
    With ``mask_enable`` the reported region is the mask's rotated box (8
    numbers), else the box (x, y, w, h). Returns (lost_times, fps) on the
    driver's clock."""
    import cv2

    regions = []  # 1 init / 2 lost / 0 skip / region
    image_files, gt = video["image_files"], video["gt"]
    start_frame, lost_times, toc = 0, 0, 0.0
    vot = "VOT" in dataset

    for f, image_file in enumerate(image_files):
        im = cv2.imread(image_file)
        tic = time.perf_counter()
        if f == start_frame:  # (re-)init from gt
            cx, cy, w, h = get_axis_aligned_bbox(gt[f])
            runtime.init(im, np.array([cx, cy]), np.array([w, h]))
            regions.append(1 if vot else gt[f])
        elif f > start_frame:  # tracking
            out = runtime.track(im, soft_mask=False)
            if mask_enable:
                location = out["polygon"].flatten()
                pred_polygon = tuple((location[2 * i], location[2 * i + 1]) for i in range(4))
            else:
                location = cxy_wh_2_rect(out["target_pos"], out["target_sz"])
                x, y, w, h = location
                pred_polygon = ((x, y), (x + w, y), (x + w, y + h), (x, y + h))
            if vot:
                gt_polygon = tuple((gt[f][2 * i], gt[f][2 * i + 1]) for i in range(4))
                b_overlap = vot_overlap([c for p in gt_polygon for c in p],
                                        [c for p in pred_polygon for c in p],
                                        (im.shape[1], im.shape[0]))
            else:
                b_overlap = 1
            if b_overlap:
                regions.append(location)
            else:  # lost: skip SKIP frames, then re-init
                regions.append(2)
                lost_times += 1
                start_frame = f + SKIP
        else:  # skipped frame
            regions.append(0)
        toc += time.perf_counter() - tic

    if result_dir is not None:
        if vot:
            video_path = join(result_dir, dataset, tracker_name, "baseline", video["name"])
            if not isdir(video_path):
                makedirs(video_path)
            with open(join(video_path, f"{video['name']}_001.txt"), "w") as fout:
                for x in regions:
                    if isinstance(x, int):
                        fout.write(f"{x:d}\n")
                    else:
                        fout.write(",".join(vot_float2str("%.4f", i) for i in x) + "\n")
        else:
            video_path = join(result_dir, dataset, tracker_name)
            if not isdir(video_path):
                makedirs(video_path)
            with open(join(video_path, f"{video['name']}.txt"), "w") as fout:
                for x in regions:
                    fout.write(",".join(str(i) for i in x) + "\n")

    fps = (len(image_files) - 1) / max(toc, 1e-9)
    log(f"Video: {video['name']:12s} Time: {toc:4.1f}s Speed: {fps:5.1f}fps Lost: {lost_times}")
    return lost_times, fps
