"""Host ms a frame in ``mask_to_rotated_box`` (the VOT polygon: contours and
the least-area rectangle), from the benchmark's span around that call in the
traced run's window."""


def read(run):
    return run.spans.mean_ms("bench.polygon")
