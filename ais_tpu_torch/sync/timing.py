"""Burst-scoped MSK timing recovery (D'Andrea-Mengali-Reggiannini).

Port of `ais_tpu/sync/timing.py`, the receiver's one sequential loop,
batched over bursts: the correlator seeds it, and 2 * n_symbols
half-symbol steps track timing across the packet, every step a handful
of tensor operations over all N bursts at once (as `sync/mlse.py`
loops over symbols).

Loop semantics, step for step the reference's:
  - it runs at 2 samples a symbol: half_sps = sps / 2;
  - 8-tap fractional interpolation at (iidx, mu);
  - nonlinearity e = Re[y^2 * conj(y_prev)^2 - prev], y_prev the
    previous half-symbol interpolant;
  - every second step: err clipped to +-3, omega += gain^2/4 * err with
    omega clamped to half_sps +- limit, mu += gain * err;
  - every other step emits one output symbol;
  - seed: mu = the correlator's centre; if mu < 0 then mu += 1 and the
    start index -= 1.
All loop state is float32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ais_tpu_torch.ops.interp import NTAPS, interp_taps, interpolate


class TimingResult(NamedTuple):
    symbols: torch.Tensor   # (N, n_symbols) complex64, 1 sample a symbol
    valid: torch.Tensor     # (N, n_symbols) bool, False past the burst end
    err: torch.Tensor       # (N, n_symbols) float32, loop error (debug)
    mu: torch.Tensor        # (N, n_symbols) float32, loop mu (debug)


def msk_timing_recovery(bursts: torch.Tensor, mu0: torch.Tensor, sps: float, gain: float,
                        limit: float, n_symbols: int, start_index=1,
                        bank: torch.Tensor | None = None) -> TimingResult:
    """Recover `n_symbols` symbol-rate samples from each burst window.

    bursts: (N, L) complex64, each starting at least one sample before
    its seed point so the mu < 0 adjustment has room; mu0: (N,) the
    correlator's centre-of-mass fractional offset in (-1, 1);
    start_index: an int or (N,) the seed sample of each burst; bank: the
    interpolation bank on the bursts' device (built when not given)."""
    n_bursts, length = bursts.shape
    dev = bursts.device
    if bank is None:
        bank = torch.from_numpy(interp_taps()).to(dev)
    # The loop constants rounded to float32 as the reference rounds them.
    g32 = np.float32(gain)
    half_sps = float(np.float32(sps / 2.0))
    gain_omega = float(g32 * g32 * np.float32(0.25))
    gain_f, limit_f = float(g32), float(np.float32(limit))

    mu0 = mu0.to(device=dev, dtype=torch.float32)
    start = torch.as_tensor(start_index, device=dev).to(torch.int64).expand(n_bursts)
    neg = mu0 < 0
    mu = torch.where(neg, mu0 + 1.0, mu0)
    iidx = torch.where(neg, start - 1, start)
    omega = torch.full_like(mu, half_sps)
    prev_y = torch.zeros(n_bursts, dtype=bursts.dtype, device=dev)
    prev_nlin = torch.zeros_like(prev_y)
    tap_index = torch.arange(NTAPS, device=dev)

    symbols, valid, errs, mus = [], [], [], []
    for step in range(2 * n_symbols):
        y = interpolate(bursts, iidx.clamp(0, length - NTAPS), mu, bank, tap_index)
        nlin = (y * y) * torch.conj(prev_y * prev_y)
        err = (nlin - prev_nlin).real
        if step % 2 == 1:
            err_c = err.clamp(-3.0, 3.0)
            omega = half_sps + (omega + gain_omega * err_c - half_sps).clamp(-limit_f, limit_f)
            mu_adv = mu + gain_f * err_c + omega
        else:
            symbols.append(y)
            valid.append(iidx + NTAPS <= length)
            errs.append(err)
            mus.append(mu)
            mu_adv = mu + omega
        # Advance by omega (nominally half a symbol).
        shift = torch.floor(mu_adv)
        iidx = iidx + shift.to(torch.int64)
        mu = mu_adv - shift
        prev_y, prev_nlin = y, nlin
    return TimingResult(torch.stack(symbols, 1), torch.stack(valid, 1),
                        torch.stack(errs, 1), torch.stack(mus, 1))
