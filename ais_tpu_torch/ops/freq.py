"""Square-and-FFT frequency offset estimation and derotation (AFC).

Port of `ais_tpu/ops/freq.py`.  Squaring a GMSK signal collapses its
modulation into two tones at 2*f_offset +- bit_rate; a shifted FFT of
each squared chunk is scanned for the bin pair spaced
fftlen*bit_rate/fs apart with the most energy, and the pair's centre
bin maps back to Hz.  Low-confidence chunks take the estimate of the
nearest confident chunk, and the block is derotated by an NCO that
holds one estimate per chunk.
"""

from __future__ import annotations

import math

import torch


def freqest(squared_chunks: torch.Tensor, sample_rate: float, bit_rate: float):
    """Per-chunk frequency estimate of the *squared* signal.

    squared_chunks: (..., n_chunks, fftlen) complex.  Returns (est Hz,
    confidence), each (..., n_chunks) float32; confidence is the winning
    pair energy over twice the mean spectrum level."""
    fftlen = squared_chunks.shape[-1]
    offset = int(fftlen * (bit_rate / sample_rate))
    binsize = sample_rate / fftlen
    spec = torch.fft.fftshift(torch.fft.fft(squared_chunks, dim=-1), dim=-1).abs()
    # DC notch: a receiver DC offset (or any non-circular content) piles
    # energy into the squared spectrum's DC bin, which the pair search
    # would lock onto with false confidence.
    dc = fftlen // 2
    mask = torch.ones(fftlen, dtype=spec.dtype, device=spec.device)
    mask[dc - 1: dc + 2] = 0.0
    spec = spec * mask
    pair = spec[..., : fftlen - offset] + spec[..., offset:]
    maxpair = pair.amax(dim=-1)
    # argmax returns the first maximum, as jnp.argmax does.
    maxpos = torch.argmax(pair, dim=-1) + offset // 2
    est = ((maxpos - fftlen // 2) * (binsize / 2.0)).to(torch.float32)
    floor = 2.0 * spec.mean(dim=-1)
    confidence = (maxpair / torch.clamp(floor, min=1e-30)).to(torch.float32)
    return est, confidence


def _fill_forward(est: torch.Tensor, ok: torch.Tensor, big: int):
    """Hold the last confident estimate along the last axis.

    Returns (held, distance): distance to that estimate, or big + i + 1
    (and estimate 0) before the first confident position."""
    n = est.shape[-1]
    idx = torch.arange(n, device=est.device)
    last = torch.where(ok, idx, torch.full_like(idx, -1)).cummax(dim=-1).values
    found = last >= 0
    held = torch.where(found, est.gather(-1, last.clamp(min=0)), torch.zeros_like(est))
    dist = torch.where(found, idx - last, big + idx + 1)
    return held, dist


def gate_and_hold(est: torch.Tensor, confidence: torch.Tensor, min_ratio: float) -> torch.Tensor:
    """Nearest-confident fill of low-confidence estimates per chunk.

    Chunks whose tone-to-floor ratio is below `min_ratio` take the
    estimate of the nearest confident chunk (ties prefer the earlier);
    with none confident the estimate is 0.  The reference's two
    sequential scans become index fills with `cummax`."""
    ok = confidence >= min_ratio
    big = est.shape[-1] + 1
    fwd_e, fwd_d = _fill_forward(est, ok, big)
    bwd_e, bwd_d = _fill_forward(est.flip(-1), ok.flip(-1), big)
    bwd_e, bwd_d = bwd_e.flip(-1), bwd_d.flip(-1)
    return torch.where(bwd_d < fwd_d, bwd_e, fwd_e)


def derotate(x: torch.Tensor, est_hz: torch.Tensor, sample_rate: float, fftlen: int) -> torch.Tensor:
    """Apply the per-chunk AFC correction: x (..., n), est_hz (..., n // fftlen).

    The NCO phase accumulates across chunk boundaries (a float32
    cumulative sum, as in the reference)."""
    inc = est_hz.repeat_interleave(fftlen, dim=-1) * (-2.0 * math.pi / sample_rate)
    phase = torch.cumsum(inc, dim=-1)
    return x * torch.polar(torch.ones_like(phase), phase)


def square_and_fft_sync(x: torch.Tensor, sample_rate: float, bit_rate: float,
                        fftlen: int, gate_ratio: float | None = None):
    """Full AFC stage: returns (derotated x, per-chunk estimates in Hz).

    x: (..., n) complex with n a multiple of fftlen; `gate_ratio` None
    applies every chunk's raw estimate (the reference's ungated
    behaviour)."""
    n = x.shape[-1]
    if n % fftlen != 0:
        raise ValueError(f"block length {n} not a multiple of fftlen {fftlen}")
    chunks = (x * x).reshape(*x.shape[:-1], n // fftlen, fftlen)
    est, confidence = freqest(chunks, sample_rate, bit_rate)
    if gate_ratio is not None:
        est = gate_and_hold(est, confidence, gate_ratio)
    return derotate(x, est, sample_rate, fftlen), est
