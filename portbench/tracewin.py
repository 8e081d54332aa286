"""Reduce a run's recording (`hook.py`) to the measured window.

The card's busy time is the union of the process's device intervals
(kernels, copies, sets) within the window, on the wall clock that the
profiler and the harness share.  Kernel sums count the launches that
started inside the window, with their whole durations.  An idle gap of
the union is named by the receiver calls (`hook.SPANS`) that the host
thread was in at its middle.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    kernels: dict        # name -> (launches, seconds), launches started in the window
    device_ops: list     # [name, seconds], the ten longest in all
    idle_gaps: list      # [label, seconds], the ten longest


def _label(rec: dict, t: int) -> str:
    if "span_t" not in rec or not len(rec["span_t"]):
        return "no receiver call"
    span_t = rec["span_t"]
    live = np.nonzero((span_t[:, 0] <= t) & (span_t[:, 1] > t))[0]
    names = sorted({str(rec["span_names"][rec["span_name"][i]]) for i in live})
    return "+".join(names) or "no receiver call"


def reduce(rec: dict, t0_ns: int, t1_ns: int) -> Trace | None:
    """The window [t0_ns, t1_ns) of the recording; None when it holds
    no device events."""
    if "ev_start" not in rec or not len(rec["ev_start"]):
        return None
    s, e = rec["ev_start"], rec["ev_start"] + rec["ev_dur"]
    keep = (e > t0_ns) & (s < t1_ns)
    kernels = {}
    for i in np.nonzero((s >= t0_ns) & (s < t1_ns))[0]:
        name = str(rec["ev_names"][rec["ev_name"][i]])
        n, sec = kernels.get(name, (0, 0.0))
        kernels[name] = (n + 1, sec + float(rec["ev_dur"][i]) * 1e-9)
    s, e = np.maximum(s[keep], t0_ns), np.minimum(e[keep], t1_ns)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    busy = 0
    gaps = []
    cur_s, cur_e = int(t0_ns), int(t0_ns)
    for a, b in zip(s.tolist(), e.tolist()):
        if a > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, a))
            cur_s = a
        cur_e = max(cur_e, b)
    busy += cur_e - cur_s
    if cur_e < t1_ns:
        gaps.append((cur_e, int(t1_ns)))
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [[_label(rec, (a + b) // 2), (b - a) * 1e-9] for a, b in gaps[:10]]
    ops = sorted(([n[:120], sec] for n, (_, sec) in kernels.items()), key=lambda r: -r[1])
    return Trace((t1_ns - t0_ns) * 1e-9, busy * 1e-9, kernels, ops[:10], idle)
