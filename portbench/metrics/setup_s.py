"""End to end: from the process's start to the window's first timed
step (imports, the receiver, inputs, its warm-up, warm steps)."""


def read(run):
    return run.setup_s
