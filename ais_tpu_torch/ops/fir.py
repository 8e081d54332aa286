"""Mixer carrier and start phase, the plain polyphase decimating FIR,
and the one-channel frequency-translating decimator.

Port of `ais_tpu/ops/fir.py`: `mixer_phase`, `_mixer_carrier`, the
contraction formulation of `_fir_polyphase_einsum`, and
`freq_xlating_fir_decimate`, which runs on K5 (`ops/channelizer.py`).
"""

from __future__ import annotations

import numpy as np
import torch


def mixer_phase(offset_hz: float, sample_rate: float, start_sample) -> np.ndarray:
    """Starting phase (radians, float32) of the down-mixer at an absolute
    sample index.  Host-side float64, so a stream of steps keeps a
    phase-continuous carrier."""
    start = np.asarray(start_sample, dtype=np.float64)
    return np.remainder(
        -2.0 * np.pi * (offset_hz / sample_rate) * start, 2.0 * np.pi
    ).astype(np.float32)


def fir_polyphase(x: torch.Tensor, taps: torch.Tensor, decim: int) -> torch.Tensor:
    """Decimating FIR y[m] = sum_k taps[k] * x[m*D + k] on (..., n) float32.

    With k = p*D + r:  y[m] = sum_p Z[m+p, p],  Z = X @ H^T, where
    X[j, r] = x[j*D + r] (a reshape) and H the padded tap matrix.
    Returns (..., n_out) with n_out = (n - ntaps) // D + 1.
    """
    ntaps = taps.numel()
    n = x.shape[-1]
    n_out = (n - ntaps) // decim + 1
    p_rows = -(-ntaps // decim)
    h = torch.nn.functional.pad(taps.to(torch.float32), (0, p_rows * decim - ntaps))
    h = h.reshape(p_rows, decim)
    n_rows = n_out + p_rows - 1
    need = n_rows * decim
    if need > n:
        x = torch.nn.functional.pad(x, (0, need - n))
    X = x[..., :need].reshape(*x.shape[:-1], n_rows, decim)
    Z = X @ h.T  # (..., n_rows, P)
    y = Z[..., 0:n_out, 0].clone()
    for p in range(1, p_rows):
        y += Z[..., p : p + n_out, p]
    return y


def mixer_carrier(offset_hz: float, sample_rate: float, length: int) -> np.ndarray:
    """e^{-j 2 pi f n / fs} for n in [0, length), complex64 from a float64
    phase (the reference's `_mixer_carrier`, uncached here: at a full
    step's length it is hundreds of MB)."""
    n = np.arange(length, dtype=np.float64)
    phase = -2.0 * np.pi * (offset_hz / sample_rate) * n
    return np.exp(1j * np.remainder(phase, 2.0 * np.pi)).astype(np.complex64)


def freq_xlating_fir_decimate(x: torch.Tensor, taps, offset_hz: float, sample_rate: float,
                              decim: int, phase0: float = 0.0) -> torch.Tensor:
    """Mix (n,) complex64 `x` down by `offset_hz`, low-pass with `taps`,
    decimate: (n - ntaps)//decim + 1 outputs, y[m] = sum_k taps[k] *
    x[m*decim + k] * e^{-j 2 pi f (m*decim + k) / fs} * e^{j phase0}.

    K5 with one channel on the tensor's device (the CUDA kernel for a
    CUDA tensor, its plain version for a CPU tensor).  The input is cut
    to the samples the outputs read and zero-padded to whole decimation
    rows, which leaves every output as it is."""
    from ais_tpu_torch.ops.channelizer import channel_carrier, freq_xlating_polyphase, rotate_carrier

    taps_t = torch.as_tensor(np.asarray(taps, np.float32), device=x.device)
    ntaps = taps_t.numel()
    n = x.shape[-1]
    if n < ntaps:
        raise ValueError(f"input of {n} samples is shorter than the filter ({ntaps} taps)")
    m = (n - ntaps) // decim + 1
    used = (m - 1) * decim + ntaps
    rows = -(-used // decim) * decim
    x = torch.nn.functional.pad(x[:used], (0, rows - used))
    car = channel_carrier(float(offset_hz), float(sample_rate), rows, x.device)
    ph = torch.tensor([float(phase0)], dtype=torch.float32, device=x.device)
    y = freq_xlating_polyphase(x.contiguous(), rotate_carrier(car, ph), taps_t, decim=decim)
    return y[0, :m]
