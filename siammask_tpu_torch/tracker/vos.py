"""VOS benchmark driver: multi-object semi-supervised segmentation.

Counterpart of ``siammask_tpu/tracker/vos.py``, protocol for protocol, with
the reference's (`tools/test.py:421-542`) scoring: each object id from the
init annotation is tracked from its init rect; per-object soft masks are
fused by argmax over objects gated by max > thr and scored with the
multi-object IoU meter over thresholds 0.3..0.5.

- ``track_vos``: each object runs its own pass over the video through
  ``TrackerRuntime`` (the reference's sequential loop).
- ``track_vos_batched``: all objects advance together through the
  tracker's batched step; full ``scan_chunk``-frame windows go through
  ``track_video_multi`` (a CUDA-graph replay per frame on the card) and the
  ragged tail through ``step_batched``; the host runs one chunk behind the
  card.

Frames are read with cv2 (BGR, as the reference) and annotations with PIL;
both are imported inside the functions that read or write files.
"""
from __future__ import annotations

import time
from os import makedirs
from os.path import exists, isdir, join

import numpy as np
import torch

from siammask_tpu_torch.tracker.tracker import TrackState
from siammask_tpu_torch.utils import trace

THRS = np.arange(0.3, 0.5, 0.05)


def multi_batch_iou(thrs, outputs, targets, start=None, end=None):
    """Per-object mean IoU of the fused prediction at each threshold
    (MultiBatchIouMeter, tools/test.py:421-456)."""
    targets = np.array(targets)
    outputs = np.array(outputs)
    num_frame = targets.shape[0]
    if start is None:
        object_ids = np.arange(outputs.shape[0]) + 1
    else:
        object_ids = [int(i) for i in start]

    num_object = len(object_ids)
    res = np.zeros((num_object, len(thrs)), dtype=np.float32)

    output_max_id = np.argmax(outputs, axis=0).astype("uint8") + 1
    outputs_max = np.max(outputs, axis=0)
    for k, thr in enumerate(thrs):
        output_thr = outputs_max > thr
        for j in range(num_object):
            target_j = targets == object_ids[j]
            if start is None:
                start_frame, end_frame = 1, num_frame - 1
            else:
                start_frame = start[str(object_ids[j])] + 1
                end_frame = end[str(object_ids[j])] - 1
            iou = []
            for i in range(start_frame, end_frame):
                pred = (output_thr[i] * output_max_id[i]) == (j + 1)
                inter = np.sum(pred & (target_j[i] > 0))
                union = np.sum(pred | (target_j[i] > 0))
                if union > 0:
                    iou.append(inter / union)
                else:
                    iou.append(1)
            res[j, k] = np.mean(iou) if iou else 0.0
    return res


def _read_annotations(video: dict, mot_enable: bool):
    """(annos, annos_init, annos_complete): per-frame label maps (None where
    the file is missing, as in the ytb_vos valid split), the init
    annotations, and whether every frame has one (scoring needs it)."""
    from PIL import Image

    annos = [np.array(Image.open(x)) if exists(x) else None for x in video["anno_files"]]
    annos_complete = (all(a is not None for a in annos)
                      and len(annos) == len(video["image_files"]))
    if "anno_init_files" in video:
        annos_init = [np.array(Image.open(x)) for x in video["anno_init_files"]]
    else:
        annos_init = [annos[0]]
    if not mot_enable:  # single-object mode: everything is object 1
        annos = [(a > 0).astype(np.uint8) if a is not None else None for a in annos]
        annos_init = [(a > 0).astype(np.uint8) for a in annos_init]
    return annos, annos_init, annos_complete


def _score_and_save(runtime, video, pred_masks, annos, annos_complete, result_dir,
                    dataset, tracker_name, save_mask, log):
    """The fused-mask IoU lines and, with ``save_mask``, the fused argmax
    PNGs (object id where the max clears ``seg_thr``, else 0)."""
    image_files = video["image_files"]
    if annos_complete:
        multi_mean_iou = multi_batch_iou(
            THRS, pred_masks, annos,
            start=video.get("start_frame"), end=video.get("end_frame"))
        for i in range(pred_masks.shape[0]):
            for j, thr in enumerate(THRS):
                log(f"Fusion Multi Object {video['name']}_{i + 1:d} "
                    f"IOU at {thr:.2f}: {multi_mean_iou[i, j]:.4f}")
    else:
        multi_mean_iou = []

    if save_mask and result_dir is not None:
        import cv2

        video_path = join(result_dir, dataset, tracker_name, video["name"])
        if not isdir(video_path):
            makedirs(video_path)
        fused = (np.argmax(pred_masks, axis=0).astype("uint8") + 1) * \
            (np.max(pred_masks, axis=0) > runtime.p.seg_thr).astype("uint8")
        for i in range(fused.shape[0]):
            name = image_files[i].split("/")[-1].split(".")[0] + ".png"
            cv2.imwrite(join(video_path, name), fused[i])
    return multi_mean_iou


def _upload(imgs: np.ndarray, device: torch.device) -> torch.Tensor:
    """(T, H, W, 3) uint8 frames to the device. On the card the copy goes
    through pinned memory and does not block the host, so it queues behind
    the chunk the card is running."""
    with trace.span("vos.upload"):
        frames = torch.from_numpy(imgs)
        trace.count("h2d_bytes", frames.nbytes)
        if device.type != "cuda":
            return frames
        with trace.span("vos.upload.pin"):
            pinned = frames.pin_memory()
        return pinned.to(device, non_blocking=True)


def _start_copy_to_host(masks: torch.Tensor):
    """Start the copy of a chunk's (T, O, H, W) masks to the host: on the
    card a non-blocking copy into pinned memory and the event that marks its
    end; elsewhere the tensor itself and no event."""
    with trace.span("vos.copy_to_host"):
        trace.count("d2h_bytes", masks.nbytes)
        if masks.device.type != "cuda":
            return masks, None
        host = torch.empty(masks.shape, dtype=masks.dtype, pin_memory=True)
        host.copy_(masks, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done


def track_vos_batched(runtime, video: dict, mot_enable: bool = True,
                      result_dir: str | None = None, dataset: str = "DAVIS2016",
                      tracker_name: str = "SiamMask", save_mask: bool = False,
                      log=print, scan_chunk: int = 32):
    """Batched multi-object VOS: all objects advance together through the
    tracker's batched step. Full ``scan_chunk``-frame windows run through
    ``track_video_multi`` (on the card, a CUDA-graph replay per frame with no
    host sync between frames); the ragged tail steps per frame through
    ``step_batched``. The host runs one chunk behind the card, as the
    reference does: it reads and uploads chunk t's frames, queues chunk t,
    starts the copy of its masks to pinned host memory, and only then waits
    for chunk t-1's masks and merges them, so the file decode, the copies
    and the merge overlap the card's work on chunk t.

    Per-object start/end frame ranges (YouTube-VOS) are handled in-stream:
    every stream exists from frame 0 (later-starting objects carry their init
    rect as a placeholder state whose outputs are discarded), the frame axis
    is cut at each object's start frame, where that stream's state is
    re-initialised from its init annotation (an index scatter of a fresh
    ``init_batched`` sub-batch into the batched TrackState), and a validity
    mask keeps only in-range outputs, so each frame is decoded once."""
    import cv2

    image_files = video["image_files"]
    n = len(image_files)
    annos, annos_init, annos_complete = _read_annotations(video, mot_enable)

    if "start_frame" in video:      # ranged objects (ytb_vos)
        object_ids = [int(i) for i in video["start_frame"]]
        starts = [video["start_frame"][str(o)] for o in object_ids]
        ends = [video["end_frame"][str(o)] for o in object_ids]
    else:                           # every object spans the video (DAVIS)
        object_ids = [int(o) for o in np.unique(annos_init[0]) if o != 0]
        if len(annos_init) != len(object_ids):
            annos_init = annos_init * len(object_ids)
        starts = [0] * len(object_ids)
        ends = [n - 1] * len(object_ids)
    object_num = len(object_ids)
    tracker = runtime.tracker
    if not tracker.late_starts and any(s > 0 for s in starts):
        raise NotImplementedError(
            f"{type(tracker).__name__} tracks objects that start on frame 0 only; video "
            f"{video['name']!r} starts objects on frames {sorted(set(starts) - {0})}")

    pos0, sz0 = [], []
    for idx, o_id in enumerate(object_ids):
        x, y, bw, bh = cv2.boundingRect((annos_init[idx] == o_id).astype(np.uint8))
        pos0.append([x + bw / 2, y + bh / 2])
        sz0.append([bw, bh])
    pos0, sz0 = np.array(pos0, np.float32), np.array(sz0, np.float32)

    toc = 0.0
    tic = time.perf_counter()
    # uint8 upload; the crop casts after its first gather. ALL streams
    # initialise at frame 0 -- later-starting objects get their init rect as
    # a placeholder (outputs masked out until their re-init)
    states = tracker.init_batched(cv2.imread(image_files[0]), pos0, sz0)
    toc += time.perf_counter() - tic

    h, w = annos_init[0].shape
    pred_masks = np.full((object_num, n, h, w), -1.0, dtype=np.float32)
    # tracked outputs count only inside (start, end]; the start frame itself
    # carries the init annotation (the sequential driver's semantics)
    valid = np.zeros((object_num, n), bool)
    for idx in range(object_num):
        valid[idx, starts[idx] + 1:ends[idx] + 1] = True
        pred_masks[idx, starts[idx]] = (annos_init[idx] == object_ids[idx]).astype(np.float32)

    @trace.span("vos.materialize")
    def materialize(first, host, done):
        """Merge the masks of frames first..first+T-1 once their copy is done."""
        if done is not None:
            done.synchronize()
        m = host.numpy().transpose(1, 0, 2, 3)      # (O, T, H, W)
        sl = slice(first, first + m.shape[1])
        pred_masks[:, sl] = np.where(valid[:, sl, None, None], m, pred_masks[:, sl])

    @trace.span("vos.reinit")
    def reinit(indices, frame):
        """Re-init the given streams from their init rects on this frame."""
        frame_index = tracker.frame_index
        sub = tracker.init_batched(frame, pos0[indices], sz0[indices])
        tracker.frame_index = frame_index       # the video goes on
        ii = torch.as_tensor(indices, device=tracker.device)
        with torch.inference_mode():
            return TrackState(*(full.index_copy(0, ii, new) for full, new in zip(states, sub)))

    # cut the frame axis at every late start so re-inits land between steps
    events = sorted({s for s in starts if 0 < s < n})
    cuts = [*events, n - 1] if (n - 1) not in events else [*events]

    pending = None                                  # the chunk the card may still run
    f = 1
    for cut in cuts:                                # segments [f .. cut]
        frames = None
        while f <= cut:
            end = min(f + scan_chunk, cut + 1)
            with trace.span("vos.read_frames", request=f):
                imgs = np.stack([cv2.imread(image_files[i]) for i in range(f, end)])
            tic = time.perf_counter()
            frames = _upload(imgs, tracker.device)
            if end - f == scan_chunk:               # full window
                states, outs = tracker.track_video_multi(states, frames)
                masks = outs.mask_in_frame          # (T, O, H, W)
            else:                                   # ragged tail: per frame
                chunk = []
                for frame in frames:
                    states, o = tracker.step_batched(states, frame)
                    chunk.append(o.mask_in_frame)
                masks = torch.stack(chunk)
            if pending is not None:
                materialize(*pending)
            pending = (f, *_start_copy_to_host(masks))
            toc += time.perf_counter() - tic
            f = end
        started = [i for i in range(object_num) if starts[i] == cut]
        if started and cut < n - 1:
            tic = time.perf_counter()
            states = reinit(started, frames[-1])
            toc += time.perf_counter() - tic
    if pending is not None:
        tic = time.perf_counter()
        materialize(*pending)
        toc += time.perf_counter() - tic

    multi_mean_iou = _score_and_save(runtime, video, pred_masks, annos, annos_complete,
                                     result_dir, dataset, tracker_name, save_mask, log)
    n_steps = (n - 1) * object_num
    fps = n_steps / max(toc, 1e-9)
    log(f"Video: {video['name']:12s} Time: {toc:4.1f}s Speed: {fps:5.1f}fps "
        f"(batched x{object_num})")
    return multi_mean_iou, fps


def track_vos(runtime, video: dict, mot_enable: bool = True,
              result_dir: str | None = None, dataset: str = "DAVIS2016",
              tracker_name: str = "SiamMask", save_mask: bool = False,
              log=print):
    """runtime: ``TrackerRuntime``. Each object runs its own pass over the
    video from its start frame to its end frame. Returns (multi_mean_iou,
    fps)."""
    import cv2

    image_files = video["image_files"]
    annos, annos_init, annos_complete = _read_annotations(video, mot_enable)

    if "start_frame" in video:
        object_ids = [int(i) for i in video["start_frame"]]
    else:
        object_ids = [int(o) for o in np.unique(annos[0]) if o != 0]
        if len(object_ids) != len(annos_init):
            annos_init = annos_init * len(object_ids)
    object_num = len(object_ids)

    toc = 0.0
    h, w = annos_init[0].shape[0], annos_init[0].shape[1]
    pred_masks = np.full((object_num, len(image_files), h, w), -1.0, dtype=np.float32)

    for obj_idx, o_id in enumerate(object_ids):
        if "start_frame" in video:
            start_frame = video["start_frame"][str(o_id)]
            end_frame = video["end_frame"][str(o_id)]
        else:
            start_frame, end_frame = 0, len(image_files)

        mask = None
        for f, image_file in enumerate(image_files):
            im = cv2.imread(image_file)
            tic = time.perf_counter()
            if f == start_frame:  # init from the object's annotation rect
                obj_mask = annos_init[obj_idx] == o_id
                x, y, bw, bh = cv2.boundingRect(obj_mask.astype(np.uint8))
                runtime.init(im, np.array([x + bw / 2, y + bh / 2]), np.array([bw, bh]))
                mask = obj_mask.astype(np.float32)
            elif end_frame >= f > start_frame:
                mask = runtime.track(im)["mask"]
            toc += time.perf_counter() - tic
            if end_frame >= f >= start_frame and mask is not None:
                pred_masks[obj_idx, f] = mask

    multi_mean_iou = _score_and_save(runtime, video, pred_masks, annos, annos_complete,
                                     result_dir, dataset, tracker_name, save_mask, log)
    n_steps = (len(image_files) - 1) * len(object_ids)
    fps = n_steps / max(toc, 1e-9)
    log(f"Video: {video['name']:12s} Time: {toc:4.1f}s Speed: {fps:5.1f}fps")
    return multi_mean_iou, fps
