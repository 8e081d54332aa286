"""Per layer: K1 (cr1 wire channelizer, `wire_bits_kernel` with one wire
bit a sample) as a share of its roofline over the window (roofline.py)."""

import re

import roofline

NAME = re.compile(r"wire_bits_kernel<\d+, ?\d+, ?\d+, ?1>")


def read(run):
    if run.trace is None:
        return None
    hits = [v for k, v in run.trace.kernels.items() if NAME.search(k)]
    g = run.geo
    work = roofline.channelizer_work("cr1", g.n_in, g.n_chan, g.n_out, g.ntaps)
    return roofline.share_pct(work, sum(n for n, _ in hits), sum(s for _, s in hits))
