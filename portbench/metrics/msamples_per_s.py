"""End to end: input samples of the steps whose packets were collected
inside the window (each step at its n_in, halo included), over the
window's seconds."""


def read(run):
    return run.steps * run.geo.n_in / run.window_s / 1e6
