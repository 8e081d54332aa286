"""Feedforward burst AGC (port of `ais_tpu/ops/agc.py`).

Every output sample is the input scaled so that the peak envelope over
the `window` samples *ahead* of it equals `reference` (upstream
`analog.feedforward_agc_cc(512, 2)`): the gain snaps to a burst's
amplitude before the burst arrives.
"""

from __future__ import annotations

import torch

from ais_tpu_torch.ops.window import sliding_max_forward


def feedforward_agc(x: torch.Tensor, window: int = 512, reference: float = 2.0,
                    floor: float = 1e-12) -> torch.Tensor:
    """x: (..., n) complex.  Returns x * reference / lookahead_env_max.

    At the block tail the lookahead window shrinks; callers keep bursts
    out of the last `window` samples via halo framing."""
    env = sliding_max_forward(x.abs(), window)
    gain = reference / torch.clamp(env, min=floor)
    return x * gain
