"""Fractional-delay interpolation bank (port of `ais_tpu/ops/interp.py`).

Taps dotted with x[i .. i+7] approximate the signal at x[i + 3 + mu],
mu in [0, 1], at 129 quantized phases: a Blackman-windowed sinc bank
with the geometry of GNU Radio's 8-tap, 128-step MMSE interpolator.
"""

from __future__ import annotations

import functools

import numpy as np

NTAPS = 8
NSTEPS = 128
DELAY = 3  # interpolation point sits between tap index 3 and 4


@functools.lru_cache(maxsize=4)
def interp_taps(ntaps: int = NTAPS, nsteps: int = NSTEPS) -> np.ndarray:
    """(nsteps + 1, ntaps) float32 bank; row k interpolates mu = k/nsteps.

    Cached: treat the returned array as read-only."""
    rows = []
    for k in range(nsteps + 1):
        mu = k / nsteps
        t = np.arange(ntaps, dtype=np.float64) - (DELAY + mu)
        h = np.sinc(t)
        span = ntaps / 2.0
        w = np.where(
            np.abs(t) < span,
            0.42 + 0.5 * np.cos(np.pi * t / span) + 0.08 * np.cos(2 * np.pi * t / span),
            0.0,
        )
        h = h * w
        rows.append(h / h.sum())  # unity DC gain
    return np.asarray(rows, dtype=np.float32)
