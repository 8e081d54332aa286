"""Preamble burst detection (port of `ais_tpu/sync/corr.py`).

The correlator itself is K2 (`ops/matched_filter.py`).  Detection scans
its |corr|^2 for local maxima above min(absolute, CFAR) thresholds,
suppresses all but the strongest peak within +-nms_radius, keeps peaks
whose index lies in the block core (overlap-save ownership), and
returns up to K earliest peaks with a 3-point centre of mass and the
correlator phase at each.  Indexing: corr[i] = sum_k conj(p[k]) x[i+k],
so a peak at i means the preamble starts at x[i].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ais_tpu_torch.ops.window import sliding_max_centered


def autocorr_threshold(preamble: np.ndarray, threshold: float) -> float:
    """threshold * (sum |p|^2)^2, the reference corr_est threshold."""
    energy = float(np.sum(np.abs(np.asarray(preamble)) ** 2))
    return float(threshold) * energy * energy


class Detections(NamedTuple):
    position: torch.Tensor    # (B, K) int32, preamble start sample
    center: torch.Tensor      # (B, K) float32, fractional peak offset
    phase: torch.Tensor       # (B, K) float32, correlator phase at the peak
    mag: torch.Tensor         # (B, K) float32, |corr|^2 at the peak
    valid: torch.Tensor       # (B, K) bool
    n_detected: torch.Tensor  # (B,) int32, accepted peaks before the cap


def detect_bursts(corr: torch.Tensor, mag2: torch.Tensor, threshold: float,
                  nms_radius: int, max_bursts: int, core_len: int,
                  cfar_k: float | None = None) -> Detections:
    """Up to `max_bursts` preamble peaks per row of (B, n) corr, earliest first.

    A peak passes when |corr|^2 exceeds min(threshold, cfar_k *
    mean(|corr|^2)) of its row, is a local maximum (>= left, > right),
    is the maximum of its +-nms_radius window, and has index in
    [1, min(core_len, n - 1)).  `n_detected` counts every such peak, so
    n_detected > max_bursts shows that the table overflowed.
    """
    b, n = mag2.shape
    thresh = torch.full((b, 1), float(threshold), dtype=mag2.dtype, device=mag2.device)
    if cfar_k is not None:
        thresh = torch.minimum(thresh, cfar_k * mag2.mean(dim=-1, keepdim=True))
    left = torch.cat([mag2[:, :1], mag2[:, :-1]], dim=-1)
    right = torch.cat([mag2[:, 1:], mag2[:, -1:]], dim=-1)
    is_peak = (mag2 > thresh) & (mag2 >= left) & (mag2 > right)
    is_peak &= mag2 == sliding_max_centered(mag2, nms_radius)
    idx = torch.arange(n, dtype=torch.int32, device=mag2.device)
    is_peak &= (idx >= 1) & (idx < core_len) & (idx < n - 1)

    key = torch.where(is_peak, idx, torch.full_like(idx, n))
    sel = torch.topk(key, max_bursts, dim=-1, largest=False, sorted=True).values
    valid = sel < n
    pos = sel.clamp(1, n - 2).to(torch.int64)

    m_prev = mag2.gather(-1, pos - 1)
    m_cur = mag2.gather(-1, pos)
    m_next = mag2.gather(-1, pos + 1)
    den = m_prev + m_cur + m_next
    centers = (m_prev + 2.0 * m_cur + 3.0 * m_next) / torch.clamp(den, min=1e-30) - 2.0
    peak = corr.gather(-1, pos)
    phases = torch.atan2(peak.imag, peak.real)
    return Detections(
        pos.to(torch.int32), centers, phases, m_cur, valid,
        is_peak.sum(dim=-1, dtype=torch.int32),
    )
