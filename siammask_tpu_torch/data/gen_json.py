"""Training-annotation JSON builders for each source dataset.

Host-only copy of ``siammask_tpu/data/gen_json.py``.

Builds the ``{video: {track: {frame: [x1, y1, x2, y2]}}}`` train.json consumed by
`data/dataset.py`, mirroring the reference generators (`data/*/gen_json.py`,
`data/vid/parse_vid.py`, `data/ytb_vos/parse_ytb_vos.py`):

- VID: snippets split at frame gaps, isolated frames dropped.
- DET/COCO: one pseudo-video per image, frame 000000.
- YouTube-VOS: per-object tracks keyed by zero-padded frame names.
"""
from __future__ import annotations

import json
import xml.etree.ElementTree as ET
from glob import glob
from os.path import basename, join

import numpy as np


def gen_json_vid(vid_info: list, out_prefix: str | None = None):
    """vid_info: the parsed VID structure (list of subsets -> videos with
    'frame' entries holding objs/trackid/bbox) — see parse_vid below."""
    snippets: dict = {}
    for subset in vid_info:
        for video in subset:
            frames = video["frame"]
            id_frames: dict[int, list[int]] = {}
            for f, frame in enumerate(frames):
                for obj in frame["objs"]:
                    id_frames.setdefault(obj["trackid"], []).append(f)
            if id_frames:
                snippets.setdefault(video["base_path"], {})
            for trackid, frame_ids in id_frames.items():
                frame_ids = sorted(frame_ids)
                seqs = np.split(np.array(frame_ids),
                                np.where(np.diff(frame_ids) > 1)[0] + 1)
                for seq in (s for s in seqs if len(s) > 1):
                    snippet = {}
                    for frame_id in seq:
                        frame = frames[frame_id]
                        for obj in frame["objs"]:
                            if obj["trackid"] == trackid:
                                snippet[frame["img_path"].split(".")[0]] = obj["bbox"]
                    snippets[video["base_path"]][f"{trackid:02d}"] = snippet
    train = {k: v for k, v in snippets.items() if "train" in k}
    val = {k: v for k, v in snippets.items() if "val" in k}
    if out_prefix:
        json.dump(train, open(out_prefix + "train.json", "w"), indent=4,
                  sort_keys=True)
        json.dump(val, open(out_prefix + "val.json", "w"), indent=4,
                  sort_keys=True)
    return train, val


def parse_vid(vid_root: str) -> list:
    """Parse ImageNet-VID XML annotations into the vid_info structure
    (data/vid/parse_vid.py semantics)."""
    info = []
    for subset in ("train", "val"):
        subset_videos = []
        anno_base = join(vid_root, "Annotations", "VID", subset)
        for video_dir in sorted(glob(join(anno_base, "*", "*"))
                                if subset == "train"
                                else glob(join(anno_base, "*"))):
            frames = []
            for xml_file in sorted(glob(join(video_dir, "*.xml"))):
                root = ET.parse(xml_file).getroot()
                size = root.find("size")
                frame = {
                    "img_path": basename(xml_file).replace("xml", "JPEG"),
                    "frame_sz": [int(size.find("width").text),
                                 int(size.find("height").text)],
                    "objs": [],
                }
                for obj in root.iter("object"):
                    bb = obj.find("bndbox")
                    frame["objs"].append({
                        "trackid": int(obj.find("trackid").text),
                        "c": obj.find("name").text,
                        "occ": int(obj.find("occluded").text),
                        "bbox": [int(bb.find("xmin").text),
                                 int(bb.find("ymin").text),
                                 int(bb.find("xmax").text),
                                 int(bb.find("ymax").text)],
                    })
                frames.append(frame)
            rel = video_dir.replace(anno_base, "").lstrip("/")
            # reference key convention (vid/parse_vid.py:25): train videos key
            # as "<SUBSET>/<video>" (the subset name itself contains 'train',
            # which gen_json_vid's split relies on), val as "val/<video>" —
            # matching the crop dirs prep.prep_vid writes.
            subset_videos.append({
                "base_path": rel if subset == "train" else join("val", rel),
                "frame": frames,
            })
        info.append(subset_videos)
    return info


def gen_json_ytb_vos(instances: dict, out_file: str | None = None):
    """YouTube-VOS instances json -> train.json (data/ytb_vos/gen_json.py)."""
    snippets = {}
    for video_name, objects in instances.items():
        video = {}
        for i, key in enumerate(list(objects)):
            snippet = {}
            for frame in objects[key]:
                frame_name = f"{int(frame['file_name'].split('/')[-1]):06d}"
                bbox = list(frame["bbox"])
                bbox[2] += bbox[0]
                bbox[3] += bbox[1]
                snippet[frame_name] = bbox
            video[f"{i:02d}"] = snippet
        snippets["train/" + video_name] = video
    if out_file:
        json.dump(snippets, open(out_file, "w"), indent=4, sort_keys=True)
    return snippets


def gen_json_det(det_root: str, out_file: str | None = None):
    """ImageNet-DET XMLs -> train.json: one pseudo-video per image."""
    snippets = {}
    for xml_file in sorted(glob(join(det_root, "Annotations", "DET", "train",
                                     "**", "*.xml"), recursive=True)):
        root = ET.parse(xml_file).getroot()
        tracks = {}
        for t, obj in enumerate(root.iter("object")):
            bb = obj.find("bndbox")
            tracks[f"{t:02d}"] = {"000000": [int(bb.find("xmin").text),
                                             int(bb.find("ymin").text),
                                             int(bb.find("xmax").text),
                                             int(bb.find("ymax").text)]}
        if tracks:
            # reference key convention (det/gen_json.py:30): "<subset>/<stem>"
            # — the per-wnid nesting of ILSVRC2013_train is dropped, matching
            # the crop dirs prep.prep_det writes.
            rel = xml_file.split("Annotations/")[-1].replace(".xml", "")
            parts = rel.split("/")          # DET/train/<subset>[/<wnid>]/<stem>
            snippets[join(parts[2], parts[-1])] = tracks
    if out_file:
        json.dump(snippets, open(out_file, "w"), indent=4, sort_keys=True)
    return snippets


def parse_ytb_vos(data_dir: str, out_file: str | None = None):
    """Raw YouTube-VOS annotations -> instances json consumed by
    ``gen_json_ytb_vos`` (data/ytb_vos/parse_ytb_vos.py): per-video, per-object
    frame entries with pixel-count-filtered tight boxes from mask contours."""
    import cv2

    ann_dir = join(data_dir, "train", "Annotations")
    with open(join(data_dir, "train", "meta.json")) as f:
        meta = json.load(f)["videos"]

    ann_dict = {}
    for video, v in meta.items():
        frames = sorted({f for obj in v["objects"].values()
                         for f in obj["frames"]})
        video_ann: dict[str, list] = {}
        for frame in frames:
            img = cv2.imread(join(ann_dir, video, frame + ".png"), 0)
            if img is None:
                continue
            h, w = img.shape[:2]
            for inst_id in np.unique(img):
                if inst_id == 0:
                    continue
                mask = (img == inst_id).astype(np.uint8)
                pixel_count = int(mask.sum())
                contours, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL,
                                               cv2.CHAIN_APPROX_NONE)
                polys = [c.reshape(-1).tolist() for c in contours]
                polys = [p for p in polys if len(p) > 4]
                if not polys or pixel_count <= 1000:
                    continue
                x0 = min(min(p[0::2]) for p in polys)
                x1 = max(max(p[0::2]) for p in polys)
                y0 = min(min(p[1::2]) for p in polys)
                y1 = max(max(p[1::2]) for p in polys)
                video_ann.setdefault(str(int(inst_id)), []).append({
                    "h": h, "w": w,
                    "file_name": join(video, frame),
                    "id": int(inst_id),
                    "area": pixel_count,
                    "bbox": [x0, y0, x1 - x0 + 1, y1 - y0 + 1],
                })
        ann_dict[video] = video_ann
    if out_file:
        json.dump(ann_dict, open(out_file, "w"))
    return ann_dict


def create_vot_json(vot_root: str, dataset_name: str,
                    out_file: str | None = None):
    """Build the eval-toolkit VOT<year>.json metadata from a VOT dataset dir
    (data/create_json.py): gt rects, image names, per-frame attribute tags,
    frame geometry."""
    import cv2

    with open(join(vot_root, "list.txt")) as f:
        videos = [v.strip() for v in f if v.strip()]
    meta = {}
    for video in videos:
        vdir = join(vot_root, video)
        imgs = sorted(glob(join(vdir, "*.jpg"))) or \
            sorted(glob(join(vdir, "color", "*.jpg")))
        gt = np.loadtxt(join(vdir, "groundtruth.txt"), delimiter=",")
        if gt.ndim == 1:
            gt = gt[None]
        im0 = cv2.imread(imgs[0])
        tags = {}
        for tag in ("camera_motion", "illum_change", "motion_change",
                    "size_change", "occlusion"):
            tag_file = join(vdir, tag + ".tag")
            try:
                with open(tag_file) as f:
                    vals = [int(v.strip()) for v in f if v.strip()]
                # pad to full length (tag files may be truncated)
                vals += [0] * (len(imgs) - len(vals))
                tags[tag] = vals
            except FileNotFoundError:
                tags[tag] = []
        meta[video] = {
            "video_dir": video,
            "init_rect": gt[0].tolist(),
            "img_names": [join(video, basename(x)) if "color" not in x
                          else join(video, "color", basename(x)) for x in imgs],
            "gt_rect": gt.tolist(),
            "width": im0.shape[1],
            "height": im0.shape[0],
            **tags,
        }
    if out_file:
        json.dump(meta, open(out_file, "w"))
    return meta
