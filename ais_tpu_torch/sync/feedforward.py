"""Feedforward burst timing from the MSK tone pair, batched over bursts.

Port of `ais_tpu/sync/feedforward.py` (`_calibrate`, `refine_freq`,
`estimate_timing`, `feedforward_symbols_fir`).  Squaring an MSK/GMSK burst gives tones at
+-Rs/2 whose phases encode the symbol clock: per segment,
psi = arg(C+ conj(C-)) = psi0 - 2 pi tau / T, so two correlations per
segment locate the symbol centres, a weighted line across segments
tracks clock drift, and symbols come out of one 8-tap interpolation at
a single fractional delay per burst.  The tone-phase-to-position
offset `delta` is calibrated once, in numpy, against the reference
package's own modulator.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ais_tpu_torch.ops.interp import DELAY, NSTEPS, NTAPS, interp_taps


def _tone_psi(x: np.ndarray, sps: float) -> float:
    n = np.arange(x.size)
    theta = np.pi / sps
    z = x.astype(np.complex128) ** 2
    cp = np.sum(z * np.exp(-1j * theta * n))
    cm = np.sum(z * np.exp(+1j * theta * n))
    return float(np.angle(cp * np.conj(cm)))


@functools.lru_cache(maxsize=8)
def _calibrate(sps_int: int, bt: float) -> float:
    """`delta` such that symbol centres sit at p = delta - psi*sps/(2 pi)
    (mod sps) for a measured tone phase psi, found by an eye-opening
    search on clean modulated data."""
    from ais_tpu_torch.tx.gmsk import modulate_bits

    rng = np.random.default_rng(12345)
    bits = rng.integers(0, 2, 600)
    x = np.asarray(modulate_bits(bits, sps_int, bt)).astype(np.complex128)
    bank = interp_taps()
    best_q, best_m = 0.0, -1.0
    for qi in range(int(sps_int * 20)):
        q = qi / 20.0
        pos = np.arange(100 + q, x.size - 20, sps_int)
        i0 = np.floor(pos).astype(int)
        mu = pos - i0
        rows = bank[np.round(mu * NSTEPS).astype(int)]
        frames = x[(i0 - DELAY)[:, None] + np.arange(NTAPS)[None, :]]
        ys = (frames * rows).sum(axis=1)
        m = np.abs(np.angle(ys[1:] * np.conj(ys[:-1]))).mean()
        if m > best_m:
            best_m, best_q = m, q
    psi = _tone_psi(x[100:-100], sps_int)
    return float(np.mod(best_q + psi * sps_int / (2 * np.pi), sps_int))


def _tones(length: int, sps: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    theta = np.pi / sps
    n = np.arange(length)
    tp = torch.tensor(np.exp(-1j * theta * n).astype(np.complex64), device=device)
    tm = torch.tensor(np.exp(+1j * theta * n).astype(np.complex64), device=device)
    return tp, tm


def refine_freq(bursts: torch.Tensor, sps: float, seg_len: int = 256,
                min_weight_frac: float = 0.25) -> torch.Tensor:
    """Fine residual carrier of (N, L) bursts in rad/sample, (N,) float32.

    The +Rs/2 tone of x^2 sits at pi/sps + 2 w0, so the phase step of its
    segment correlations between neighbouring segments is 2 w0 seg_len:
    their weighted mean angle gives w0 (unambiguous for |w0| <
    pi / (2 seg_len), ~+-46 Hz at 48 ksps)."""
    n_bursts, length = bursts.shape
    n_segs = length // seg_len
    tone_p, _ = _tones(length, sps, bursts.device)
    z = bursts * bursts
    cp = (z * tone_p)[:, : n_segs * seg_len].reshape(n_bursts, n_segs, seg_len).sum(-1)
    w = cp.abs()
    prod = cp[:, 1:] * cp[:, :-1].conj()
    ww = torch.sqrt(w[:, 1:] * w[:, :-1])
    ww = torch.where(ww >= min_weight_frac * ww.amax(-1, keepdim=True), ww, torch.zeros_like(ww))
    norm = ww / ww.sum(-1, keepdim=True).clamp(min=1e-12)
    slope = torch.angle((prod * norm).sum(-1))
    return (slope / (2.0 * seg_len)).to(torch.float32)


def estimate_timing(bursts: torch.Tensor, sps: float, delta: float,
                    seg_len: int = 256, min_weight_frac: float = 0.25):
    """Tone-phase timing of (N, L) bursts: (base, intercept, slope), each (N,).

    Symbol centres sit at p_k = base + k*sps + intercept + slope*(...)."""
    n_bursts, length = bursts.shape
    n_segs = length // seg_len
    tone_p, tone_m = _tones(length, sps, bursts.device)
    z = bursts * bursts
    span = n_segs * seg_len
    cp = (z * tone_p)[:, :span].reshape(n_bursts, n_segs, seg_len).sum(-1)
    cm = (z * tone_m)[:, :span].reshape(n_bursts, n_segs, seg_len).sum(-1)
    prod = cp * cm.conj()
    psi = torch.angle(prod)
    w = torch.sqrt(prod.abs())
    w = torch.where(w >= min_weight_frac * w.amax(-1, keepdim=True), w, torch.zeros_like(w))

    tau = delta - psi * (sps / (2.0 * np.pi))
    conf = w > 0
    # Forward fill of confident estimates; tau[0] before the first.
    idx = torch.arange(n_segs, device=bursts.device)
    last = torch.where(conf, idx, torch.full_like(idx, -1)).cummax(-1).values
    tau_f = torch.where(last >= 0, tau.gather(-1, last.clamp(min=0)), tau[:, :1])
    first_idx = torch.argmax(conf.to(torch.int32), dim=-1, keepdim=True)
    tau0 = tau_f.gather(-1, first_idx)[:, 0]
    d = tau_f[:, 1:] - tau_f[:, :-1]
    d = d - sps * torch.round(d / sps)
    un = torch.cat([torch.zeros_like(tau[:, :1]), torch.cumsum(d, -1)], -1)
    dtau = un - un.gather(-1, first_idx)
    centers = (torch.arange(n_segs, device=bursts.device, dtype=torch.float32) + 0.5) * seg_len
    wsum = w.sum(-1, keepdim=True) + 1e-12
    cbar = (w * centers).sum(-1, keepdim=True) / wsum
    tbar = (w * dtau).sum(-1, keepdim=True) / wsum
    cov = (w * (centers - cbar) * (dtau - tbar)).sum(-1)
    var = (w * (centers - cbar) ** 2).sum(-1) + 1e-12
    slope = cov / var
    intercept = tbar[:, 0] - slope * cbar[:, 0]
    base = tau0 + torch.ceil((DELAY + 1.0 - tau0) / sps) * sps
    return base, intercept, slope


def feedforward_symbols_fir(bursts: torch.Tensor, sps: float, n_symbols: int,
                            delta: float, bank: torch.Tensor, seg_len: int = 256,
                            min_weight_frac: float = 0.25):
    """Symbols at one fractional delay per burst, for (N, L) bursts.

    symbols[k] = sum_t row[t] * burst[sps*k + (R - DELAY) + t], with R
    and the interpolation-bank row picked from the timing estimate
    tau = base + intercept (clamped into the comb range, so a wild
    estimate degrades to a CRC failure, never a silent zero burst).
    Returns (symbols complex64 (N, n_symbols), valid bool (N, n_symbols)).
    """
    length = bursts.shape[-1]
    sps_i = int(round(sps))
    base, intercept, _ = estimate_timing(bursts, sps, delta, seg_len, min_weight_frac)
    tau = base + intercept
    r0 = DELAY
    n_cand = sps_i + 2
    tau = torch.clamp(tau, float(r0), float(r0 + n_cand) - 1e-3)
    R = torch.floor(tau).to(torch.int32)
    mu = tau - R.to(torch.float32)
    nz = n_cand - 1 + sps_i * n_symbols
    if nz > length - NTAPS + 1:
        raise ValueError(
            f"burst window {length} too short for {n_symbols} symbols "
            f"at sps {sps_i} (needs {nz + NTAPS - 1})"
        )
    imu = torch.clamp(torch.round(mu * NSTEPS).to(torch.int64), 0, NSTEPS)
    rows = bank[imu]                                             # (N, NTAPS)
    start = (R - r0).to(torch.int64)[:, None] + sps_i * torch.arange(
        n_symbols, device=bursts.device)[None, :]                # (N, n_symbols)
    symbols = torch.zeros(bursts.shape[0], n_symbols, dtype=bursts.dtype,
                          device=bursts.device)
    for t in range(NTAPS):
        symbols += rows[:, t: t + 1] * bursts.gather(-1, start + t)
    kpos = R.to(torch.float32)[:, None] + torch.arange(
        n_symbols, device=bursts.device, dtype=torch.float32) * sps_i
    valid = (kpos >= 0) & (kpos + sps_i + 8 <= length)
    return symbols, valid


def ff_delta(sps: float, bt: float) -> float:
    """The calibrated tone-phase offset for integer `sps`."""
    if abs(sps - round(sps)) > 1e-9:
        raise NotImplementedError(
            f"feedforward timing at non-integer sps {sps} needs the bank "
            f"interpolation path (ROADMAP A.11)"
        )
    return _calibrate(int(round(sps)), bt)

