"""The device's idle share of the traced window, in %: 100 (1 - the
union of its kernel, copy and set intervals over the window)."""


def read(run):
    if run.kind != "progressive" or run.trace is None or run.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
