"""Mixer start phase and the plain polyphase decimating FIR.

Port of `ais_tpu/ops/fir.py:mixer_phase` and the contraction
formulation of `_fir_polyphase_einsum`.
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
