"""Share of the profiled wall span in which no kernel, copy or memset ran on
the card (the SAM 2 VOS cell)."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
