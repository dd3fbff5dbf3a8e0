"""Training input pipeline: sampled template/search pairs with augmentation
and anchor targets (host-side numpy and cv2), uploaded to the card.

Counterpart of ``siammask_tpu/data/dataset.py`` (the reference's
``datasets/siam_mask_dataset.py``), formula for formula:

- ``SubDataset``: one source (coco, vid, det, ytb_vos pre-cropped 511x511
  images), its anno JSON ``{video: {track: {frame: bbox}}}`` with zero boxes
  dropped, paths ``{frame:06d}.{track}.x.jpg`` / ``.m.png``, positive pairs
  within +-frame_range, picks oversampled and shuffled to ``num_use``;
- ``Augmentation``: the crop box shifted and scaled by ``aug_apply``, the
  affine ``crop_hwc`` warp, the PCA-style colour offset, a random
  directional blur, flip and grayscale;
- ``PairDataset``: the sources mixed with shuffled picks, negative pairs,
  context-scaled target boxes, anchor targets and masks in {-1, +1} with a
  per-cell mask weight (any positive anchor);
- ``collate`` stacks samples into numpy arrays, NHWC images, as the JAX
  package's;
- ``DataLoader``: item workers (threads, or forked processes that run only
  numpy and cv2 and never touch ``torch.cuda``) and a batch-assembly pool
  that keeps a few batches in flight;
- ``to_device``: a background thread uploads each batch through pinned host
  memory with non-blocking copies on a side stream, images permuted to
  NCHW (B, 3, H, W) on the card; an error of the source is raised at the
  consumer.

Every random draw comes from an explicit generator: each item gets private
``random.Random`` and ``np.random.RandomState`` streams, a function of
(seed, shuffle generation, index) only, so the items are the same whatever
the worker count or mode, and for a given seed bit for bit the JAX
package's. A dataset made without a seed draws one from the OS. cv2 is
imported where an image is read or warped, not with the module.
"""
from __future__ import annotations

import json
import math
import queue
import random
import threading
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass
from os.path import join

import numpy as np
import torch

from siammask_tpu_torch.data.anchor_target import AnchorTarget, AnchorTargetConfig
from siammask_tpu_torch.tracker.anchors import AnchorConfig, Anchors
from siammask_tpu_torch.utils.bbox import Center, Corner, aug_apply, center2corner

IMAGE_KEYS = ("template", "search")


class SubDataset:
    def __init__(self, cfg: dict):
        for key in ("root", "anno"):
            if key not in cfg:
                raise ValueError(f"SubDataset needs '{key}'")

        with open(cfg["anno"]) as fin:
            self.labels = self._filter_zero(json.load(fin))

        def isint(x):
            try:
                int(x)
                return True
            except (TypeError, ValueError):
                return False

        to_del = []
        for video in self.labels:
            for track in self.labels[video]:
                frames = self.labels[video][track]
                frames = sorted(map(int, filter(isint, frames.keys())))
                self.labels[video][track]["frames"] = frames
                if not frames:
                    to_del.append((video, track))
        for video, track in to_del:
            del self.labels[video][track]
        for video in [v for v in self.labels if not self.labels[v]]:
            del self.labels[video]

        self.videos = list(self.labels.keys())

        self.root = cfg.get("root", "/")
        self.start = cfg.get("start", 0)
        self.num = len(self.labels)
        self.num_use = int(cfg.get("num_use", self.num))
        self.frame_range = cfg.get("frame_range", 100)
        self.mark = cfg.get("mark", "vid")
        self.path_format = cfg.get("path_format", "{}.{}.{}.jpg")
        self.mask_format = cfg.get("mask_format", "{}.{}.m.png")
        self.has_mask = self.mark in ("coco", "ytb_vos")
        self.pick: list[int] = []

    @staticmethod
    def _filter_zero(anno: dict) -> dict:
        out = {}
        for video, tracks in anno.items():
            new_tracks = {}
            for trk, frames in tracks.items():
                new_frames = {}
                for frm, bbox in frames.items():
                    if len(bbox) == 4:
                        w, h = bbox[2] - bbox[0], bbox[3] - bbox[1]
                    else:
                        w, h = bbox
                    if w == 0 or h == 0:
                        continue
                    new_frames[frm] = bbox
                if new_frames:
                    new_tracks[trk] = new_frames
            if new_tracks:
                out[video] = new_tracks
        return out

    def shuffle(self, rng: random.Random) -> list[int]:
        lists = list(range(self.start, self.start + self.num))
        pick: list[int] = []
        m = 0
        while m < self.num_use:
            rng.shuffle(lists)
            pick += lists
            m += self.num
        self.pick = pick[: self.num_use]
        return self.pick

    def get_image_anno(self, video, track, frame):
        frame = f"{frame:06d}"
        image_path = join(self.root, video, self.path_format.format(frame, track, "x"))
        image_anno = self.labels[video][track][frame]
        mask_path = join(self.root, video, self.mask_format.format(frame, track))
        return image_path, image_anno, mask_path

    def get_positive_pair(self, index, rng: random.Random):
        video_name = self.videos[index]
        video = self.labels[video_name]
        track = rng.choice(list(video.keys()))
        track_info = video[track]
        frames = track_info["frames"]

        template_idx = rng.randint(0, len(frames) - 1)
        left = max(template_idx - self.frame_range, 0)
        right = min(template_idx + self.frame_range, len(frames) - 1) + 1
        search_range = frames[left:right]
        template_frame = frames[template_idx]
        search_frame = rng.choice(search_range)
        return (self.get_image_anno(video_name, track, template_frame),
                self.get_image_anno(video_name, track, search_frame))

    def get_random_target(self, rng: random.Random, index=-1):
        if index == -1:
            index = rng.randint(0, self.num - 1)
        video_name = self.videos[index]
        video = self.labels[video_name]
        track = rng.choice(list(video.keys()))
        frame = rng.choice(video[track]["frames"])
        return self.get_image_anno(video_name, track, frame)


def crop_hwc(image, bbox, out_sz, padding=(0, 0, 0)):
    """Affine warp of the corner-box region to out_sz x out_sz."""
    import cv2

    bbox = [float(x) for x in bbox]
    a = (out_sz - 1) / (bbox[2] - bbox[0])
    b = (out_sz - 1) / (bbox[3] - bbox[1])
    mapping = np.array([[a, 0, -a * bbox[0]], [0, b, -b * bbox[1]]], dtype=np.float64)
    return cv2.warpAffine(image, mapping, (out_sz, out_sz),
                          borderMode=cv2.BORDER_CONSTANT, borderValue=padding)


class Augmentation:
    """Shift/scale crop and colour/blur/flip/gray augmentation."""

    def __init__(self, cfg: dict):
        self.shift = 0
        self.scale = 0
        self.blur = 0
        self.resize = False
        self.flip = 0
        self.rgbVar = np.array(
            [[-0.55919361, 0.98062831, -0.41940627],
             [1.72091413, 0.19879334, -1.82968581],
             [4.64467907, 4.73710203, 4.88324118]], dtype=np.float32)
        self.__dict__.update(cfg)

    @staticmethod
    def random(rng: random.Random):
        return rng.random() * 2 - 1.0

    def blur_image(self, image, rng: random.Random, nprng: np.random.RandomState):
        import cv2

        def rand_kernel():
            size = int(np.round(nprng.randn(1)[0])) * 2 + 1
            if size < 0 or rng.random() < 0.5:
                return None
            size = min(size, 45)
            kernel = np.zeros((size, size))
            c = int(size / 2)
            wx = rng.random()
            kernel[:, c] += 1.0 / size * wx
            kernel[c, :] += 1.0 / size * (1 - wx)
            return kernel

        kernel = rand_kernel()
        if kernel is not None:
            image = cv2.filter2D(image, -1, kernel)
        return image

    def __call__(self, image, bbox, size, rng: random.Random,
                 nprng: np.random.RandomState, gray=False, mask=None):
        import cv2

        if gray:
            grayed = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
            image = np.stack([grayed] * 3, axis=-1)

        shape = image.shape
        # (the reference takes shape[0] // 2 as cx: the same on square crops)
        crop_bbox = center2corner(Center(shape[0] // 2, shape[1] // 2,
                                         size - 1, size - 1))
        param = {}
        if self.shift:
            param["shift"] = (Augmentation.random(rng) * self.shift,
                              Augmentation.random(rng) * self.shift)
        if self.scale:
            param["scale"] = (1.0 + Augmentation.random(rng) * self.scale,
                              1.0 + Augmentation.random(rng) * self.scale)

        crop_bbox, _ = aug_apply(Corner(*crop_bbox), param, shape)

        x1, y1 = crop_bbox.x1, crop_bbox.y1
        bbox = Corner(bbox.x1 - x1, bbox.y1 - y1, bbox.x2 - x1, bbox.y2 - y1)
        if self.scale:
            sx, sy = param["scale"]
            bbox = Corner(bbox.x1 / sx, bbox.y1 / sy, bbox.x2 / sx, bbox.y2 / sy)

        image = crop_hwc(image, crop_bbox, size)
        if mask is not None:
            mask = crop_hwc(mask, crop_bbox, size)

        offset = np.dot(self.rgbVar, nprng.randn(3, 1))[::-1].reshape(3)
        image = image - offset

        if self.blur > rng.random():
            image = self.blur_image(image, rng, nprng)

        if self.resize:
            im_sz = image.shape[:2]
            ratio = max(math.pow(rng.random(), 0.5), 0.2)
            rand_sz = (int(round(ratio * im_sz[0])), int(round(ratio * im_sz[1])))
            image = cv2.resize(image, rand_sz)
            image = cv2.resize(image, tuple(im_sz))

        if self.flip and self.flip > Augmentation.random(rng):
            image = cv2.flip(image, 1)
            if mask is not None:
                mask = cv2.flip(mask, 1)
            width = image.shape[1]
            bbox = Corner(width - 1 - bbox.x2, bbox.y1, width - 1 - bbox.x1, bbox.y2)

        return image, bbox, mask


@dataclass
class Sample:
    """One training example (NHWC images; labels shaped for models/losses.py)."""
    template: np.ndarray      # (127, 127, 3) f32
    search: np.ndarray        # (S_in, S_in, 3) f32
    cls: np.ndarray           # (k, S, S) int64 in {-1, 0, 1}
    delta: np.ndarray         # (4, k, S, S) f32
    delta_weight: np.ndarray  # (k, S, S) f32
    bbox: np.ndarray          # (4,) f32 gt corner box in the search crop
    mask: np.ndarray          # (S_in, S_in) f32 in {-1, +1}
    mask_weight: np.ndarray   # (S, S) f32


class PairDataset:
    """Multi-source pair dataset (the reference's ``DataSets``)."""

    def __init__(self, cfg: dict, anchor_cfg: AnchorConfig | dict, num_epoch: int = 1,
                 seed: int | None = None):
        if isinstance(anchor_cfg, dict):
            anchor_cfg = AnchorConfig.from_dict(anchor_cfg)
        self.anchors = Anchors(anchor_cfg)
        self.seed = seed if seed is not None else random.SystemRandom().randrange(2 ** 31)
        self._generation = 0  # bumped by shuffle(): each epoch draws fresh streams
        self._shuffle_rng = random.Random(self.seed)

        self.template_size = cfg.get("template_size", 127)
        self.origin_size = cfg.get("origin_size", 127)
        self.search_size = cfg.get("search_size", 255)
        self.base_size = cfg.get("base_size", 0)
        self.size = cfg.get("size", 17)
        self.crop_size = cfg.get("crop_size", 0)
        self.template_small = cfg.get("template_small", False)

        expected = (self.search_size - self.template_size) / self.anchors.cfg.stride \
            + 1 + self.base_size
        if expected != self.size:
            raise ValueError(f"size mismatch: computed {expected}, config {self.size}")

        self.anchors.generate_all_anchors(im_c=self.search_size // 2, size=self.size)
        self.target_cfg = AnchorTargetConfig(**(cfg.get("anchor_target") or {}))

        self.all_data = []
        start = 0
        self.num = 0
        for name, ds_cfg in cfg["datasets"].items():
            ds_cfg = dict(ds_cfg)
            ds_cfg["mark"] = name
            ds_cfg["start"] = start
            sub = SubDataset(ds_cfg)
            self.all_data.append(sub)
            start += sub.num
            self.num += sub.num_use

        aug_cfg = cfg["augmentation"]
        self.template_aug = Augmentation(aug_cfg.get("template", {}))
        self.search_aug = Augmentation(aug_cfg.get("search", {}))
        self.gray = aug_cfg.get("gray", 0)
        self.neg = aug_cfg.get("neg", 0)
        self.inner_neg = aug_cfg.get("inner_neg", 0)

        if "num" in cfg:
            self.num = int(cfg["num"])
        self.num *= num_epoch
        self.pick: list[int] = []
        self.shuffle()

    def shuffle(self):
        self._generation += 1
        pick: list[int] = []
        while len(pick) < self.num:
            p = []
            for subset in self.all_data:
                p += subset.shuffle(self._shuffle_rng)
            self._shuffle_rng.shuffle(p)
            pick += p
        self.pick = pick

    def __len__(self):
        return self.num

    def _find_dataset(self, index):
        for dataset in self.all_data:
            if dataset.start + dataset.num > index:
                return dataset, index - dataset.start
        raise IndexError(index)

    def _imread(self, path):
        import cv2

        img = cv2.imread(path)
        if img is None:
            raise FileNotFoundError(path)
        if self.origin_size == self.template_size:
            return img, 1.0
        nsize = int(round((self.template_size + 1) / (self.origin_size + 1)
                          * (img.shape[1] + 1) - 1))
        img = cv2.resize(img, (nsize, nsize))
        return img, nsize / img.shape[1]

    def _to_bbox(self, image, shape):
        """Context-scaled gt box centred in the crop (the reference's toBBox)."""
        imh, imw = image.shape[:2]
        if len(shape) == 4:
            w, h = shape[2] - shape[0], shape[3] - shape[1]
        else:
            w, h = shape
        wc_z = w + 0.5 * (w + h)
        hc_z = h + 0.5 * (w + h)
        scale_z = self.template_size / np.sqrt(wc_z * hc_z)
        return center2corner(Center(imw // 2, imh // 2, w * scale_z, h * scale_z))

    def __getitem__(self, index) -> Sample:
        item = self.seed * 1000003 + self._generation * 7368787 + index
        rng = random.Random(item % (2 ** 31))
        nprng = np.random.RandomState((item * 920419823 + 3) % (2 ** 31))
        return self._get_item(index, rng, nprng)

    def _get_item(self, index, rng: random.Random, nprng: np.random.RandomState) -> Sample:
        import cv2

        index = self.pick[index]
        dataset, index = self._find_dataset(index)

        gray = self.gray and self.gray > rng.random()
        neg = self.neg and self.neg > rng.random()

        if neg:
            template = dataset.get_random_target(rng, index)
            if self.inner_neg and self.inner_neg > rng.random():
                search = dataset.get_random_target(rng)
            else:
                search = rng.choice(self.all_data).get_random_target(rng)
        else:
            template, search = dataset.get_positive_pair(index, rng)

        def center_crop(img, size):
            shape = img.shape[1]
            if shape == size:
                return img
            c = shape // 2
            return img[c - size // 2: c + size // 2 + 1,
                       c - size // 2: c + size // 2 + 1]

        template_image, _ = self._imread(template[0])
        if self.template_small:
            template_image = center_crop(template_image, self.template_size)
        search_image, _ = self._imread(search[0])

        if dataset.has_mask and not neg:
            search_mask = (cv2.imread(search[2], 0) > 0).astype(np.float32)
        else:
            search_mask = np.zeros(search_image.shape[:2], dtype=np.float32)

        if self.crop_size > 0:
            search_image = center_crop(search_image, self.crop_size)
            search_mask = center_crop(search_mask, self.crop_size)

        template_box = self._to_bbox(template_image, template[1])
        search_box = self._to_bbox(search_image, search[1])

        template_im, _, _ = self.template_aug(template_image, template_box,
                                              self.template_size, rng, nprng, gray=gray)
        search_im, bbox, mask = self.search_aug(search_image, search_box,
                                                self.search_size, rng, nprng, gray=gray,
                                                mask=search_mask)

        cls, delta, delta_weight = AnchorTarget(nprng, self.target_cfg)(
            self.anchors, bbox, self.size, neg)
        if dataset.has_mask and not neg:
            mask_weight = cls.max(axis=0).astype(np.float32)
        else:
            mask_weight = np.zeros((cls.shape[1], cls.shape[2]), dtype=np.float32)

        mask = ((mask > 0.5) * 2 - 1).astype(np.float32)

        return Sample(
            template=np.ascontiguousarray(template_im, dtype=np.float32),
            search=np.ascontiguousarray(search_im, dtype=np.float32),
            cls=cls, delta=delta, delta_weight=delta_weight,
            bbox=np.array(bbox, np.float32), mask=mask, mask_weight=mask_weight)


def collate(samples: list[Sample]) -> dict[str, np.ndarray]:
    """Stack samples into a batch dict of numpy arrays (NHWC images)."""
    return {
        "template": np.stack([s.template for s in samples]),
        "search": np.stack([s.search for s in samples]),
        "label_cls": np.stack([s.cls for s in samples]),
        "label_loc": np.stack([s.delta for s in samples]),
        "label_loc_weight": np.stack([s.delta_weight for s in samples]),
        "bbox": np.stack([s.bbox for s in samples]),
        "label_mask": np.stack([s.mask for s in samples]),
        "label_mask_weight": np.stack([s.mask_weight for s in samples]),
    }


# Live process-mode loaders' datasets, keyed per loader: published before
# the pool forks, so each child inherits its loader's dataset (nothing is
# pickled per task), and removed when the iteration ends.
_WORKER_DATASETS: dict = {}
_WORKER_DATASET = None  # set in each worker process by _init_worker


def _init_worker(key):
    """A forked worker: its loader's dataset, and cv2 on this one thread (a
    worker is one item at a time; a thread pool of cv2's inherited through
    fork has no threads behind it)."""
    import cv2

    global _WORKER_DATASET
    _WORKER_DATASET = _WORKER_DATASETS[key]
    cv2.setNumThreads(0)


def _worker_get_item(i):
    return _WORKER_DATASET[i]


class DataLoader:
    """Prefetching loader: a pool of item workers over ``__getitem__`` and a
    separate batch-assembly pool that keeps ``prefetch`` collated batches in
    flight (one shared pool would let batch tasks starve the item tasks they
    wait on).

    ``workers_mode``: "thread" (cv2 releases the GIL in imread and
    warpAffine) or "process" (forked children, the reference's torch
    ``num_workers``; they run numpy and cv2 only). ``num_workers=0`` loads
    in the caller's thread."""

    def __init__(self, dataset: PairDataset, batch_size: int, num_workers: int = 8,
                 drop_last: bool = True, prefetch: int = 3,
                 workers_mode: str = "thread"):
        if workers_mode not in ("thread", "process"):
            raise ValueError(f"workers_mode {workers_mode!r}: 'thread' or 'process'")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        self.workers_mode = workers_mode
        n = len(dataset)
        self.num_batches = n // batch_size if drop_last else -(-n // batch_size)

    def __len__(self):
        return self.num_batches

    def _indices(self, b):
        return range(b * self.batch_size,
                     min((b + 1) * self.batch_size, len(self.dataset)))

    def __iter__(self):
        if self.num_workers <= 0:
            for b in range(self.num_batches):
                yield collate([self.dataset[i] for i in self._indices(b)])
            return

        worker_key = None
        if self.workers_mode == "process":
            import multiprocessing
            worker_key = id(self)
            _WORKER_DATASETS[worker_key] = self.dataset
            items = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=multiprocessing.get_context("fork"),
                initializer=_init_worker, initargs=(worker_key,))
            get_item = _worker_get_item
        else:
            items = ThreadPoolExecutor(max_workers=self.num_workers)
            get_item = self.dataset.__getitem__

        try:
            with items, ThreadPoolExecutor(max_workers=self.prefetch) as batches:

                def load_batch(b):
                    return collate(list(items.map(get_item, self._indices(b))))

                pending = deque()
                for b in range(self.num_batches):
                    pending.append(batches.submit(load_batch, b))
                    if len(pending) > self.prefetch:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
        finally:
            if worker_key is not None:
                _WORKER_DATASETS.pop(worker_key, None)


def _stage(batch: dict, device: torch.device, stream) -> dict:
    """Numpy batch -> tensors on ``device``, images NCHW. On a card: pinned
    host copies, non-blocking uploads on ``stream``."""
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(value)
        if stream is not None:
            t = t.pin_memory().to(device, non_blocking=True)
        if key in IMAGE_KEYS:
            t = t.permute(0, 3, 1, 2).contiguous()
        out[key] = t
    return out


def to_device(batches, device="cuda", size: int = 2):
    """Iterate ``batches`` (numpy dicts, as ``DataLoader`` yields them) as
    tensors on ``device``, images (B, 3, H, W): a background thread stages
    up to ``size`` batches ahead. On a card the uploads run on a side
    stream; the consumer's stream waits for each batch's event before it
    gets the batch. An exception of the source or the upload is raised at
    the consumer's next pull; a consumer that stops early stops the
    thread."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    side = torch.cuda.Stream(device) if on_card else None
    q: queue.Queue = queue.Queue(maxsize=max(1, size))
    end = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if on_card:
                    with torch.cuda.stream(side):
                        staged = _stage(b, device, side)
                        event = torch.cuda.Event()
                        event.record(side)
                else:
                    staged, event = _stage(b, device, None), None
                if not put((staged, event)):
                    return
            put(end)
        except BaseException as e:  # noqa: BLE001 - raised at the consumer
            put(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            staged, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for t in staged.values():
                    t.record_stream(current)
            yield staged
    finally:
        stop.set()
