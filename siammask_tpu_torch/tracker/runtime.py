"""Host-level tracker runtime: numpy frames in, reference-format results out.

Counterpart of ``siammask_tpu/tracker/runtime.py``: feeds frames to the
device step and does the one piece of host work left, the rotated box from
the binary mask (cv2 contours + minAreaRect) that the VOT protocol reports.
cv2 is imported where that box is made and nowhere else.
"""
from __future__ import annotations

import numpy as np
import torch

from siammask_tpu_torch.config import TrackerConfig
from siammask_tpu_torch.tracker.tracker import Tracker, TrackState
from siammask_tpu_torch.utils.bbox import cxy_wh_2_rect


def mask_to_rotated_box(target_mask: np.ndarray, target_pos, target_sz):
    """Largest-contour minAreaRect polygon; the axis-aligned box of the box
    branch when the mask has no contour over 100 px."""
    import cv2

    # [-2] is the contour list under both the 2- and 3-tuple cv2 APIs
    contours = cv2.findContours(target_mask.astype(np.uint8),
                                cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)[-2]
    cnt_area = [cv2.contourArea(cnt) for cnt in contours]
    if len(contours) != 0 and np.max(cnt_area) > 100:
        contour = contours[int(np.argmax(cnt_area))]
        return cv2.boxPoints(cv2.minAreaRect(contour.reshape(-1, 2)))
    location = cxy_wh_2_rect(target_pos, target_sz)
    return np.array([[location[0], location[1]],
                     [location[0] + location[2], location[1]],
                     [location[0] + location[2], location[1] + location[3]],
                     [location[0], location[1] + location[3]]])


class TrackerRuntime:
    """Stateful wrapper over ``Tracker`` with the reference's init/track API;
    ``mask`` and ``refine`` as ``Tracker`` takes them."""

    def __init__(self, model, p: TrackerConfig, device: torch.device | str,
                 mask: bool = True, refine: bool = True):
        self.tracker = Tracker(model, p, device, mask=mask, refine=refine)
        self.p = p
        self.state: TrackState | None = None

    def init(self, im: np.ndarray, target_pos, target_sz) -> TrackState:
        # uint8 frames upload as they are; the crop casts after its gather
        self.state = self.tracker.init(im, np.asarray(target_pos, np.float32),
                                       np.asarray(target_sz, np.float32))
        return self.state

    def track(self, im: np.ndarray, soft_mask: bool = True) -> dict:
        """One frame. ``soft_mask=False`` thresholds the mask on the device and
        fetches a uint8 binary mask ("mask_bin") instead of the float32 soft
        mask ("mask"). Without the mask the result has neither, and no
        polygon."""
        self.state, out = self.tracker.step(self.state, im)
        result = {
            "target_pos": out.target_pos.cpu().numpy(),
            "target_sz": out.target_sz.cpu().numpy(),
            "score": float(out.score),
        }
        if not self.tracker.mask:
            return result
        if soft_mask:
            mask_in_frame = out.mask_in_frame.cpu().numpy()
            target_mask = (mask_in_frame > self.p.seg_thr).astype(np.uint8)
            result["mask"] = mask_in_frame
        else:
            target_mask = (out.mask_in_frame > self.p.seg_thr).to(torch.uint8).cpu().numpy()
            result["mask_bin"] = target_mask
        result["polygon"] = mask_to_rotated_box(target_mask, result["target_pos"],
                                                result["target_sz"])
        return result
