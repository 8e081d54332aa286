"""Quadrature demodulation and bit slicing (port of `ais_tpu/ops/demod.py`)."""

from __future__ import annotations

import math

import torch


def quadrature_demod(x: torch.Tensor, gain: float = math.pi / 2) -> torch.Tensor:
    """out[n] = gain * arg(x[n] * conj(x[n-1])); out[0] uses x[-1] = x[0]."""
    prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    d = x * prev.conj()
    return gain * torch.atan2(d.imag, d.real)


def slice_diff_invert(soft: torch.Tensor) -> torch.Tensor:
    """Soft FM output -> NRZI-decoded bits (uint8): slice at 0, XOR with
    the previous bit, invert.  The first bit uses b[-1] = b[0]."""
    b = (soft > 0).to(torch.uint8)
    prev = torch.cat([b[..., :1], b[..., :-1]], dim=-1)
    return 1 - (b ^ prev)
