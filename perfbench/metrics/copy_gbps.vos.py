"""GB/s of the host<->device copies in the profiled stretch: the bytes the
program counted as it issued them (``h2d_bytes``, the frame uploads, plus
``d2h_bytes``, the mask downloads, in its trace log,
``siammask_tpu_torch/utils/trace.py``) over the device seconds of the
trace's host<->device copies. None where the program counts nothing."""


def read(run):
    try:
        from siammask_tpu_torch.utils import trace
    except ImportError:
        return None
    moved = sum(r["counts"].get("h2d_bytes", 0) + r["counts"].get("d2h_bytes", 0)
                for r in trace.records())
    if not moved or run.trace is None:
        return None
    seconds = run.trace["categories"].get("host<->device copy")
    if not seconds:
        return None
    return moved / 1e9 / seconds
