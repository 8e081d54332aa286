"""Overlap-save framing as strided views.

Port of `ais_tpu/ops/framing.py`.  The reference assembles windows
from shifted reshapes because gathers were unsafe on its TPU backend;
here a window is a view made by `Tensor.unfold` over a zero-padded
copy, with the same contract: block b starts at b*core, and windows
running past the end are zero-filled.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad_last(x: torch.Tensor, n: int) -> torch.Tensor:
    if n <= 0:
        return x
    if x.is_complex():
        return torch.view_as_complex(F.pad(torch.view_as_real(x), (0, 0, 0, n)))
    return F.pad(x, (0, n))


def frame_overlap_big(x: torch.Tensor, core: int, halo: int) -> torch.Tensor:
    """(..., n) -> (..., n // core, core + halo); any halo, tail zero-filled."""
    n = x.shape[-1]
    if n % core != 0:
        raise ValueError(f"length {n} not a multiple of core {core}")
    return _pad_last(x, halo).unfold(-1, core + halo, core)


def frame_overlap(x: torch.Tensor, core: int, halo: int) -> torch.Tensor:
    """(..., n) -> (..., n // core, core + halo) with halo <= core."""
    if halo > core:
        raise ValueError(f"halo {halo} larger than core {core} not supported")
    return frame_overlap_big(x, core, halo)
