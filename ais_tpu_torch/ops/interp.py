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


def interpolate(x, index, mu, bank=None, tap_index=None):
    """Value of each row of `x` at fractional position index + DELAY + mu.

    x: (N, L) complex64; index: (N,) int64 first sample of the 8 read;
    mu: (N,) float32 in [0, 1]; bank: the (129, 8) float32 bank on x's
    device (built from `interp_taps` when not given); tap_index:
    arange(8) on x's device, for a caller that interpolates in a loop.
    Returns (N,) complex64: the row of the bank nearest mu (round half
    to even, as the reference) dotted with x[n, index[n] : index[n] + 8]."""
    import torch

    if bank is None:
        bank = torch.from_numpy(interp_taps()).to(x.device)
    if tap_index is None:
        tap_index = torch.arange(NTAPS, device=x.device)
    imu = torch.clamp(torch.round(mu * NSTEPS).to(torch.int64), 0, NSTEPS)
    frames = x.gather(-1, index.to(torch.int64)[:, None] + tap_index[None, :])
    return (frames * bank[imu]).sum(-1)
