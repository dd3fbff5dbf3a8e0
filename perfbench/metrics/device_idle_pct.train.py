"""Share of the profiled wall span in which no kernel, copy or memset ran on
the card (training cells; rank 0's card on several)."""


def read(run):
    if run.trace is None:
        return None
    card = run.trace.get("rank0", run.trace)
    return 100.0 * (1.0 - card["busy_s"] / card["window_s"])
