"""K2: the preamble matched filter with fused |corr|^2.

Counterpart of `ais_tpu/ops/pallas_corr.py:pallas_matched_filter` with
`with_mag2=True`.  For x of shape (B, n) and a preamble p of length L:

    corr[b, i] = sum_{k < L} conj(p[k]) * x[b, i + k],   i < n - L + 1
    mag2[b, i] = |corr[b, i]|^2

Two implementations of one contract:

  - `matched_filter_plain`: one `conv1d` over the real and imaginary
    planes (cuDNN's TF32 default is off, see the package `__init__`);
  - the CUDA kernel `csrc/matched_filter.cu`, launched by
    `matched_filter` for a CUDA tensor.

`matched_filter` takes the plain version only for a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch

from ais_tpu_torch import _build


def matched_filter_plain(x: torch.Tensor, taps_conj: torch.Tensor):
    """(B, n) complex64 -> corr (B, n-L+1) complex64, mag2 (B, n-L+1) f32.

    `taps_conj` is conj(p), (L,) complex64."""
    pr, pi = taps_conj.real, taps_conj.imag
    # (xr + j xi)(pr + j pi) = (xr pr - xi pi) + j (xr pi + xi pr);
    # conv1d is a cross-correlation, which is what corr is.
    weight = torch.stack(
        [torch.stack([pr, -pi]), torch.stack([pi, pr])]
    )  # (out=2, in=2, L)
    planes = torch.stack([x.real, x.imag], dim=1)  # (B, 2, n)
    out = torch.nn.functional.conv1d(planes, weight)
    cr, ci = out[:, 0], out[:, 1]
    return torch.complex(cr, ci), cr * cr + ci * ci


def _matched_filter_cuda(x: torch.Tensor, taps_conj: torch.Tensor):
    if x.dtype != torch.complex64 or x.dim() != 2:
        raise ValueError(f"expected (B, n) complex64 input, got {x.dtype} {tuple(x.shape)}")
    if taps_conj.dtype != torch.complex64 or taps_conj.dim() != 1:
        raise ValueError("taps must be a 1-D complex64 tensor")
    if taps_conj.device != x.device:
        raise ValueError("input and taps must be on one device")
    x = x.contiguous()
    taps_conj = taps_conj.contiguous()
    b, n = x.shape
    length = taps_conj.numel()
    n_out = n - length + 1
    if n_out <= 0 or b > 65535:
        raise ValueError(f"unsupported shape {(b, n)} for {length} taps")
    corr = torch.empty((b, n_out), dtype=torch.complex64, device=x.device)
    mag2 = torch.empty((b, n_out), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.MATCHED_FILTER(
        torch.view_as_real(x).data_ptr(), torch.view_as_real(taps_conj).data_ptr(),
        torch.view_as_real(corr).data_ptr(), mag2.data_ptr(),
        b, n, n_out, length, stream,
    )
    return corr, mag2


def matched_filter(x: torch.Tensor, taps_conj: torch.Tensor):
    """K2 on the tensor's device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Returns (corr, mag2)."""
    if x.device.type == "cuda":
        return _matched_filter_cuda(x, taps_conj)
    if x.device.type == "cpu":
        return matched_filter_plain(x, taps_conj)
    raise NotImplementedError(f"no matched filter for device {x.device}")


class MatchedFilter(torch.nn.Module):
    """Correlator against a fixed preamble; owns the conjugated taps."""

    def __init__(self, preamble: np.ndarray, device="cuda"):
        super().__init__()
        device = _build.require_card(device, type(self).__name__)
        pc = np.conj(np.asarray(preamble, np.complex64)).astype(np.complex64)
        self.register_buffer("taps_conj", torch.tensor(pc, device=device))

    def forward(self, x: torch.Tensor):
        return matched_filter(x, self.taps_conj)
