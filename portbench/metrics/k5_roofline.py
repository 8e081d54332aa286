"""Per layer: K5's cu8 entry (`channelizer_kernel` with the `DecodeCu8`
prologue: rtl_sdr's bytes decoded, mixed and filtered in one kernel) as
a share of the cu8 wire -> channels stage's roofline over the window
(roofline.py).  K5 on complex samples and the other wires' entries are
not counted."""

import roofline


def _is_cu8_entry(name: str) -> bool:
    return "channelizer_kernel<" in name and "DecodeCu8" in name


def read(run):
    if run.trace is None:
        return None
    hits = [v for k, v in run.trace.kernels.items() if _is_cu8_entry(k)]
    g = run.geo
    work = roofline.channelizer_work("cu8", g.n_in, g.n_chan, g.n_out, g.ntaps)
    return roofline.share_pct(work, sum(n for n, _ in hits), sum(s for _, s in hits))
