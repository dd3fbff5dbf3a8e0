"""Device ms a video frame of host<->device copies (frame uploads, mask
downloads) in the profiled stretch."""


def read(run):
    if run.trace is None or not run.units:
        return None
    copies = run.trace["categories"].get("host<->device copy")
    if copies is None:
        return None
    frames = run.units / run.cell.ctx.traffic["objects"]
    return 1e3 * copies / frames
