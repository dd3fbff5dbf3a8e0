"""Host ms a video frame inside the program's own root spans in the profiled
stretch: the spans with no parent in the program's trace log
(``siammask_tpu_torch/utils/trace.py``: ``vos.upload``,
``tracker.track_video_multi``, ``vos.copy_to_host``), which record only
while a profiler runs. None where the program records no span."""


def read(run):
    try:
        from siammask_tpu_torch.utils import trace
    except ImportError:
        return None
    roots = [r for r in trace.records() if r["parent"] is None and r["end_ns"] is not None]
    if not roots or not run.units:
        return None
    frames = run.units / run.cell.ctx.traffic["objects"]
    return sum(r["end_ns"] - r["start_ns"] for r in roots) / 1e6 / frames
