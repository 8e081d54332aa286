"""Sliding-window maxima with clamped edges.

Port of `ais_tpu/ops/window.py`: the same logarithmic shift-doubling
(ceil(log2 w) elementwise `maximum` passes), whose edge semantics are
the contract — near an edge the window shrinks to what exists.
"""

from __future__ import annotations

import torch


def _shift_left(x: torch.Tensor, k: int) -> torch.Tensor:
    """x shifted left by k along the last axis, right edge replicated."""
    if k == 0:
        return x
    return torch.cat([x[..., k:], x[..., -1:].expand(*x.shape[:-1], k)], dim=-1)


def _shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    if k == 0:
        return x
    return torch.cat([x[..., :1].expand(*x.shape[:-1], k), x[..., :-k]], dim=-1)


def sliding_max_forward(x: torch.Tensor, window: int) -> torch.Tensor:
    """m[i] = max(x[i .. i+window-1]), right edge clamped (shrinking)."""
    m = x
    span = 1
    while span < window:
        step = min(span, window - span)
        m = torch.maximum(m, _shift_left(m, step))
        span += step
    return m


def sliding_max_centered(x: torch.Tensor, radius: int) -> torch.Tensor:
    """m[i] = max(x[i-radius .. i+radius]), edges clamped."""
    fwd = sliding_max_forward(x, radius + 1)
    bwd = x
    span = 1
    while span < radius + 1:
        step = min(span, radius + 1 - span)
        bwd = torch.maximum(bwd, _shift_right(bwd, step))
        span += step
    return torch.maximum(fwd, bwd)
