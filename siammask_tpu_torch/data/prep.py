"""Offline data preparation: pre-crop training images + build anno JSONs.

Host-only copy of ``siammask_tpu/data/prep.py``. Re-implements the reference `data/{coco,vid,det,ytb_vos}/par_crop.py` and
`gen_json.py` pipelines: every annotated object becomes a 511x511 search-region
crop (SiamFC context formula) named ``{frame:06d}.{track}.x.jpg`` with an
optional ``.m.png`` mask, plus a train.json of
``{video: {track: {frame: [x1, y1, x2, y2]}}}``.

COCO masks decode through our C++ RLE codec (data/rle.py); a minimal COCO
annotation reader replaces the vendored pycocotools API. cv2 is imported
where an image is read, warped or written, not with the module.
"""
from __future__ import annotations

import json
import xml.etree.ElementTree as ET
from concurrent import futures
from glob import glob
from os import makedirs
from os.path import basename, isdir, isfile, join

import numpy as np

from siammask_tpu_torch.data import rle as rle_codec


def crop_hwc(image, bbox, out_sz, padding=(0, 0, 0)):
    import cv2

    a = (out_sz - 1) / (bbox[2] - bbox[0])
    b = (out_sz - 1) / (bbox[3] - bbox[1])
    mapping = np.array([[a, 0, -a * bbox[0]], [0, b, -b * bbox[1]]],
                       dtype=np.float64)
    return cv2.warpAffine(image, mapping, (out_sz, out_sz),
                          borderMode=cv2.BORDER_CONSTANT, borderValue=padding)


def pos_s_to_bbox(pos, s):
    return [pos[0] - s / 2, pos[1] - s / 2, pos[0] + s / 2, pos[1] + s / 2]


def crop_like_siamfc(image, bbox, exemplar_size=127, context_amount=0.5,
                     search_size=511, padding=(0, 0, 0), plus1=True):
    """SiamFC-context crop of the (corner) bbox region to search_size
    (coco/par_crop.py:63-75). ``plus1``: COCO's par_crop measures the target as
    x2-x1+1 while the VID/DET/ytb_vos ones use x2-x1 (their crop_like_SiamFCx) —
    reproduce each dataset's exact crop geometry."""
    target_pos = [(bbox[2] + bbox[0]) / 2.0, (bbox[3] + bbox[1]) / 2.0]
    one = 1 if plus1 else 0
    target_size = [bbox[2] - bbox[0] + one, bbox[3] - bbox[1] + one]
    wc_z = target_size[1] + context_amount * sum(target_size)
    hc_z = target_size[0] + context_amount * sum(target_size)
    s_z = np.sqrt(wc_z * hc_z)
    scale_z = exemplar_size / s_z
    pad = (search_size - exemplar_size) / 2 / scale_z
    s_x = s_z + 2 * pad
    return crop_hwc(image, pos_s_to_bbox(target_pos, s_x), search_size, padding)


class CocoAnnotations:
    """Minimal COCO instances reader (replaces the vendored pycocotools API)."""

    def __init__(self, anno_file: str):
        with open(anno_file) as f:
            data = json.load(f)
        self.imgs = {img["id"]: img for img in data["images"]}
        self.img_anns: dict[int, list] = {i: [] for i in self.imgs}
        for ann in data["annotations"]:
            self.img_anns.setdefault(ann["image_id"], []).append(ann)

    def ann_to_mask(self, ann, img) -> np.ndarray:
        return rle_codec.ann_to_mask(ann, img["height"], img["width"])


def crop_coco_image(coco: CocoAnnotations, img_id: int, img_base: str,
                    crop_base: str, search_size=511, enable_mask=True):
    """Crop every annotation of one COCO image (par_crop.py:78-99)."""
    import cv2

    img = coco.imgs[img_id]
    anns = coco.img_anns.get(img_id, [])
    stem = img["file_name"].split("/")[-1].split(".")[0]
    out_dir = join(crop_base, stem)
    if not isdir(out_dir):
        makedirs(out_dir)
    im = cv2.imread(join(img_base, img["file_name"]))
    avg_chans = np.mean(im, axis=(0, 1))
    for track_id, ann in enumerate(anns):
        rect = ann["bbox"]
        if rect[2] <= 0 or rect[3] <= 0:
            continue
        bbox = [rect[0], rect[1], rect[0] + rect[2] - 1, rect[1] + rect[3] - 1]
        x = crop_like_siamfc(im, bbox, search_size=search_size, padding=avg_chans)
        cv2.imwrite(join(out_dir, f"{0:06d}.{track_id:02d}.x.jpg"), x)
        if enable_mask and "segmentation" in ann:
            mask = coco.ann_to_mask(ann, img).astype(np.float32)
            xm = (crop_like_siamfc(mask, bbox, search_size=search_size) > 0.5)
            cv2.imwrite(join(out_dir, f"{0:06d}.{track_id:02d}.m.png"),
                        xm.astype(np.uint8) * 255)


def prep_coco(data_dir: str, crop_path: str | None = None, search_size=511,
              enable_mask=True, num_workers=16, subsets=("val2017", "train2017")):
    """Full COCO crop pass (par_crop.py:102-123) with process fan-out."""
    crop_path = crop_path or join(data_dir, f"crop{search_size}")
    for subset in subsets:
        coco = CocoAnnotations(join(data_dir, "annotations",
                                    f"instances_{subset}.json"))
        crop_base = join(crop_path, subset)
        img_base = join(data_dir, subset)
        with futures.ProcessPoolExecutor(max_workers=num_workers) as ex:
            list(ex.map(_crop_coco_star,
                        [(coco, i, img_base, crop_base, search_size, enable_mask)
                         for i in coco.imgs]))


def _crop_coco_star(args):
    return crop_coco_image(*args)


def gen_json_coco(data_dir: str, out_file: str | None = None,
                  subsets=("train2017", "val2017")):
    """COCO -> train.json {video: {track: {frame: corner_bbox}}}
    (data/coco/gen_json.py semantics: one video per image, frame '000000')."""
    out = {}
    for subset in subsets:
        coco = CocoAnnotations(join(data_dir, "annotations",
                                    f"instances_{subset}.json"))
        for img_id, img in coco.imgs.items():
            stem = f"{subset}/{img['file_name'].split('/')[-1].split('.')[0]}"
            tracks = {}
            for track_id, ann in enumerate(coco.img_anns.get(img_id, [])):
                rect = ann["bbox"]
                if rect[2] <= 0 or rect[3] <= 0:
                    continue
                tracks[f"{track_id:02d}"] = {
                    "000000": [rect[0], rect[1],
                               rect[0] + rect[2] - 1, rect[1] + rect[3] - 1]}
            if tracks:
                out[stem] = tracks
    if out_file:
        with open(out_file, "w") as f:
            json.dump(out, f, indent=2)
    return out


# ---------------------------------------------------------------------------
# per-dataset crop drivers (reference data/{vid,det,ytb_vos}/par_crop.py):
# each walks that dataset's real on-disk layout with process fan-out.
# num_workers=0 runs inline (tests / single-core hosts).


def _fan_out(fn, jobs, num_workers):
    if num_workers <= 0:
        for job in jobs:
            fn(*job)
        return
    with futures.ProcessPoolExecutor(max_workers=num_workers) as ex:
        for f in [ex.submit(fn, *job) for job in jobs]:
            f.result()


def _read_xml_objects(xml_file: str):
    """(image_path, [(trackid, corner_bbox)]) from one ImageNet VID/DET
    annotation XML; image lives under Data/ mirroring Annotations/."""
    root = ET.parse(xml_file).getroot()
    img_path = xml_file.replace("xml", "JPEG").replace("Annotations", "Data")
    objs = []
    for i, obj in enumerate(root.iter("object")):
        tid_node = obj.find("trackid")
        trackid = int(tid_node.text) if tid_node is not None else i
        bb = obj.find("bndbox")
        objs.append((trackid, [int(bb.find("xmin").text),
                               int(bb.find("ymin").text),
                               int(bb.find("xmax").text),
                               int(bb.find("ymax").text)]))
    return img_path, objs


def _crop_vid_video(video_dir: str, out_dir: str, search_size: int):
    """One VID video: every frame XML -> {frame:06d}.{track:02d}.x.jpg
    (vid/par_crop.py crop_video)."""
    import cv2

    if not isdir(out_dir):
        makedirs(out_dir)
    for xml_file in sorted(glob(join(video_dir, "*.xml"))):
        root = ET.parse(xml_file).getroot()
        frame_idx = int(root.find("filename").text)
        img_path, objs = _read_xml_objects(xml_file)
        if not objs:
            continue
        im = cv2.imread(img_path)
        avg_chans = np.mean(im, axis=(0, 1))
        for trackid, bbox in objs:
            x = crop_like_siamfc(im, bbox, search_size=search_size,
                                 padding=avg_chans, plus1=False)
            cv2.imwrite(join(out_dir, f"{frame_idx:06d}.{trackid:02d}.x.jpg"), x)


def prep_vid(vid_root: str, crop_path: str | None = None, search_size=511,
             num_workers=16):
    """ImageNet-VID crop pass (vid/par_crop.py main): walks
    Annotations/VID/train/<subset>/<video>/*.xml plus Annotations/VID/val —
    the reference reaches val through a manual 'train/val' symlink; here val is
    walked explicitly. Output dirs crop<size>/<subset>/<video> and
    crop<size>/val/<video> match gen_json.parse_vid's base_path keys."""
    crop_path = crop_path or join(vid_root, f"crop{search_size}")
    jobs = []
    for subset in ("train", "val"):
        ann_base = join(vid_root, "Annotations", "VID", subset)
        pattern = ("*", "*") if subset == "train" else ("*",)
        for video_dir in sorted(glob(join(ann_base, *pattern))):
            if not isdir(video_dir):
                continue
            rel = video_dir.replace(ann_base, "").lstrip("/")
            out = join(crop_path, rel if subset == "train" else join("val", rel))
            jobs.append((video_dir, out, search_size))
    _fan_out(_crop_vid_video, jobs, num_workers)
    return crop_path


def _crop_det_xml(xml_file: str, out_base: str, search_size: int):
    """One DET image XML: objects have no track ids — enumerate
    (det/par_crop.py crop_xml). Output dir is named by the image stem."""
    import cv2

    img_path, objs = _read_xml_objects(xml_file)
    out_dir = join(out_base, basename(xml_file).split(".")[0])
    if not isdir(out_dir):
        makedirs(out_dir)
    im = cv2.imread(img_path)
    avg_chans = np.mean(im, axis=(0, 1))
    for obj_id, (_, bbox) in enumerate(objs):
        x = crop_like_siamfc(im, bbox, search_size=search_size,
                             padding=avg_chans, plus1=False)
        cv2.imwrite(join(out_dir, f"{0:06d}.{obj_id:02d}.x.jpg"), x)


def prep_det(det_root: str, crop_path: str | None = None, search_size=511,
             num_workers=16):
    """ImageNet-DET crop pass (det/par_crop.py main): walks
    Annotations/DET/train/<subset>/*.xml — ILSVRC2013_train nests one level
    deeper (per-wnid dirs), which the glob handles for any subset."""
    crop_path = crop_path or join(det_root, f"crop{search_size}")
    ann_base = join(det_root, "Annotations", "DET", "train")
    jobs = []
    for subset_dir in sorted(glob(join(ann_base, "*"))):
        if not isdir(subset_dir):
            continue
        xmls = sorted(glob(join(subset_dir, "*.xml")) +
                      glob(join(subset_dir, "*", "*.xml")))
        out_base = join(crop_path, basename(subset_dir))
        jobs += [(x, out_base, search_size) for x in xmls]
    _fan_out(_crop_det_xml, jobs, num_workers)
    return crop_path


def _crop_ytb_vos_video(video: str, objects: dict, out_dir: str,
                        data_path: str, search_size: int):
    """One YouTube-VOS video (ytb_vos/par_crop.py crop_video): search crop from
    JPEGImages, mask crop from the instance-id PNG label (padding 0,
    binarized at 0.2 — the reference's exact mask threshold)."""
    import cv2

    if not isdir(out_dir):
        makedirs(out_dir)
    anno_base = join(data_path, "Annotations")
    img_base = join(data_path, "JPEGImages")
    for trackid, obj_id in enumerate(list(objects)):
        for frame in objects[obj_id]:
            name = frame["file_name"]
            im = cv2.imread(join(img_base, name + ".jpg"))
            label = cv2.imread(join(anno_base, name + ".png"), 0)
            avg_chans = np.mean(im, axis=(0, 1))
            bbox = list(frame["bbox"])          # xywh -> corners
            bbox[2] += bbox[0]
            bbox[3] += bbox[1]
            frame_idx = int(name.split("/")[-1])
            x = crop_like_siamfc(im, bbox, search_size=search_size,
                                 padding=avg_chans, plus1=False)
            cv2.imwrite(join(out_dir, f"{frame_idx:06d}.{trackid:02d}.x.jpg"), x)
            m = crop_like_siamfc((label == int(obj_id)).astype(np.float32),
                                 bbox, search_size=search_size, padding=0,
                                 plus1=False)
            cv2.imwrite(join(out_dir, f"{frame_idx:06d}.{trackid:02d}.m.png"),
                        ((m > 0.2) * 255).astype(np.uint8))


def prep_ytb_vos(data_dir: str, crop_path: str | None = None, search_size=511,
                 num_workers=16, instances: dict | None = None):
    """YouTube-VOS crop pass (ytb_vos/par_crop.py main): consumes the
    instances json built by gen_json.parse_ytb_vos (generated on the fly when
    absent), crops train/<video>/ frame+mask pairs."""
    crop_path = crop_path or join(data_dir, f"crop{search_size}")
    if instances is None:
        inst_file = join(data_dir, "instances_train.json")
        if isfile(inst_file):
            with open(inst_file) as f:
                instances = json.load(f)
        else:
            from siammask_tpu_torch.data.gen_json import parse_ytb_vos
            instances = parse_ytb_vos(data_dir)
    data_path = join(data_dir, "train")
    jobs = [(video, objs, join(crop_path, "train", video), data_path,
             search_size) for video, objs in instances.items()]
    _fan_out(_crop_ytb_vos_video, jobs, num_workers)
    return crop_path


def crop_video_frames(frames: list, annos: dict, out_dir: str,
                      search_size=511, masks: dict | None = None):
    """Generic video cropper: frames = [(frame_idx, image_path)], annos =
    {frame_idx: {track_id: corner_bbox}} (vid/ytb_vos par_crop shape)."""
    import cv2

    if not isdir(out_dir):
        makedirs(out_dir)
    for frame_idx, image_path in frames:
        if frame_idx not in annos:
            continue
        im = cv2.imread(image_path)
        avg_chans = np.mean(im, axis=(0, 1))
        for track_id, bbox in annos[frame_idx].items():
            x = crop_like_siamfc(im, bbox, search_size=search_size,
                                 padding=avg_chans)
            cv2.imwrite(join(out_dir, f"{frame_idx:06d}.{track_id}.x.jpg"), x)
            if masks and frame_idx in masks and track_id in masks[frame_idx]:
                m = masks[frame_idx][track_id].astype(np.float32)
                xm = (crop_like_siamfc(m, bbox, search_size=search_size) > 0.5)
                cv2.imwrite(join(out_dir, f"{frame_idx:06d}.{track_id}.m.png"),
                            xm.astype(np.uint8) * 255)
