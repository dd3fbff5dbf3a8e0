"""Host ms a training step inside the program's ``train.step`` span, less
its ``train.sync`` child (the NaN guard's one wait on the device), in the
profiled stretch, from the program's trace log
(``siammask_tpu_torch/utils/trace.py``). None where the program records no
such span."""


def read(run):
    try:
        from siammask_tpu_torch.utils import trace
    except ImportError:
        return None
    log = [r for r in trace.records() if r["end_ns"] is not None]
    steps = {r["id"]: r["end_ns"] - r["start_ns"] for r in log if r["name"] == "train.step"}
    if not steps:
        return None
    for r in log:
        if r["name"] == "train.sync" and r["parent"] in steps:
            steps[r["parent"]] -= r["end_ns"] - r["start_ns"]
    return sum(steps.values()) / 1e6 / len(steps)
