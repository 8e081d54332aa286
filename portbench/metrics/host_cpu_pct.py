"""Per layer: CPU seconds of the benchmark's process over the window,
as a share of one core.  Near 100, the receiver's host thread (staging,
dispatch, host back half) sets the pace."""


def read(run):
    return 100.0 * run.cpu_s / run.window_s
