"""Share of the traced window in which no kernel, copy or fill ran on
the device; nothing where the trace holds no device operation."""


def read(run):
    if run.trace.busy_s <= 0:
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
