"""Per layer: the share of the window in which no operation ran on the
card, from the union of the process's device intervals (kernels,
copies, sets) in the profiler's trace."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
