"""Per layer: K2 (`matched_filter_kernel`, the preamble correlation and
|corr|^2 over every demod block of both channels) as a share of its
roofline over the window (roofline.py)."""

import roofline

PREAMBLE_SYMBOLS = 28  # the NRZI training pattern [1, 1, 0, 0] x 7


def read(run):
    if run.trace is None:
        return None
    hits = [v for k, v in run.trace.kernels.items() if "matched_filter_kernel" in k]
    g, cfg = run.geo, run.cfg
    sps = round(cfg["input_rate"] / cfg["decimation"] / cfg["bit_rate"])
    work = roofline.matched_filter_work(g.n_chan * g.n_blocks, g.block_len, PREAMBLE_SYMBOLS * sps)
    return roofline.share_pct(work, sum(n for n, _ in hits), sum(s for _, s in hits))
