"""Host ms a frame inside ``Tracker.step`` (the eager device step), from the
benchmark's span around that call in the traced run's window."""


def read(run):
    return run.spans.mean_ms("bench.Tracker.step")
