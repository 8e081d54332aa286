"""K6: the toolchain probe, o = 2x + y on one (8, 128) float32 tile.

Counterpart of `tools/tpu_pallas_probe.py:f`: a kernel that shows the
toolchain builds and the device runs what it built.  `probe` launches
`csrc/probe.cu` for CUDA tensors and takes the plain version for CPU
tensors.
"""

from __future__ import annotations

import torch

from ais_tpu_torch import _build

SHAPE = (8, 128)


def probe_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return 2.0 * x + y


def probe(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """2x + y on the tensors' device."""
    if x.shape != y.shape or x.dtype != torch.float32 or y.dtype != torch.float32:
        raise ValueError("x and y must be float32 tensors of one shape")
    if x.device.type == "cuda":
        if y.device != x.device:
            raise ValueError("x and y must be on one device")
        x, y = x.contiguous(), y.contiguous()
        out = torch.empty_like(x)
        _build.PROBE(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
                     torch.cuda.current_stream(x.device).cuda_stream)
        return out
    if x.device.type == "cpu":
        return probe_plain(x, y)
    raise NotImplementedError(f"no probe for device {x.device}")
