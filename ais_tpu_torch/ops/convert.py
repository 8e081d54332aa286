"""cr1 wire format: decode on the tensor's device, encode on the host.

Port of the cr1 part of `ais_tpu/ops/convert.py`.  cr1 is the
1-bit-per-complex-sample wire: the encoder shifts the baseband to an
fs/4 IF (multiply by j^n), keeps the real part and noise-shapes the
1-bit quantization with a second-order bandpass sigma-delta whose
notch covers both AIS channels; 8 real samples a byte, MSB first.  The
decoder maps bits to +-1 and downconverts by (-j)^n.

On the main path the decode never runs on its own: the wire
channelizer (ops/wire_channelizer.py) folds it into its kernel.
`iq_from_bytes_cr1` is the plain reading of the format, for tests.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Encoder headroom: the 99.9th-percentile component amplitude maps to
# this fraction of the quantizer level (reference CR1_HEADROOM).
CR1_HEADROOM = 0.6
# NTF z^-2 coefficient (NTF = 1 + a2 z^-2 + z^-4): the two zeros split
# onto the AIS channels at fs/4 +- 25 kHz (reference CR1_A2).
CR1_A2 = 2.0 - 4.0 * math.cos(2.0 * math.pi * (0.25 - 25e3 / 2.4e6)) ** 2


def cr1_wire_nbytes(n_samples: int) -> int:
    """Wire bytes for one n-sample cr1 step (last byte zero-padded)."""
    return -(-n_samples // 8)


def unpack_bits_pm1(raw_u8: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(ceil(n/8),) uint8 -> (n,) float32 in {-1, +1}, MSB first."""
    shifts = torch.arange(7, -1, -1, device=raw_u8.device, dtype=torch.int32)
    bits = (raw_u8.to(torch.int32)[:, None] >> shifts) & 1
    return bits.reshape(-1)[:n_samples].to(torch.float32) * 2.0 - 1.0


def iq_from_bytes_cr1(raw_u8: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(ceil(n/8),) cr1 bytes -> (n,) complex64 baseband: +-1 times (-j)^n."""
    r = unpack_bits_pm1(raw_u8, n_samples)
    n4 = -(-n_samples // 4)
    dev = raw_u8.device
    re_pat = torch.tensor([1.0, 0.0, -1.0, 0.0], device=dev).repeat(n4)[:n_samples]
    im_pat = torch.tensor([0.0, -1.0, 0.0, 1.0], device=dev).repeat(n4)[:n_samples]
    return torch.complex(r * re_pat, r * im_pat)


def _sigma_delta_cr1_numpy(iq: np.ndarray, scale: float, a2: float = 2.0) -> np.ndarray:
    """Pure-numpy twin of `ais_tpu.native.sigma_delta_cr1` (slow).

    All arithmetic is float32 in the C++ order of evaluation: the loop
    is decision-sensitive, so a float64 twin diverges from the native
    stream after a few thousand samples.
    """
    n = iq.size
    # Re(iq[n] * j^n): cycles re, -im, -re, im.
    x = np.empty(n, np.float32)
    x[0::4] = iq.real[0::4]
    x[1::4] = -iq.imag[1::4]
    x[2::4] = -iq.real[2::4]
    x[3::4] = iq.imag[3::4]
    x *= np.float32(scale)
    bits = np.empty(n, np.uint8)
    f = np.float32
    one, a2f, four = f(1.0), f(a2), f(4.0)
    e1 = e2 = e3 = e4 = f(0.0)
    for k in range(n):
        si = (x[k] - a2f * e2) - e4
        b = bool(si >= 0.0)
        bits[k] = b
        e0 = si - (one if b else -one)
        e0 = np.minimum(four, np.maximum(-four, e0))
        e4, e3, e2, e1 = e3, e2, e1, e0
    return np.packbits(bits)


def host_bytes(iq: np.ndarray, fmt: str) -> np.ndarray:
    """Encode complex IQ into the uint8 wire view (cr1 only in the port).

    Peak-referenced scaling: the larger of the 99.9th-percentile and half
    the maximum component amplitude maps to CR1_HEADROOM.  Uses the
    native encoder when its library builds, the numpy twin otherwise;
    the two are bit-identical.
    """
    if fmt != "cr1":
        raise NotImplementedError(
            f"wire format {fmt!r} is not ported yet (ROADMAP A.9); the port encodes cr1"
        )
    iq = np.ascontiguousarray(iq, np.complex64)
    comps = np.abs(np.concatenate([iq.real, iq.imag]))
    peak = float(max(np.percentile(comps, 99.9), 0.5 * comps.max())) or 1.0
    scale = CR1_HEADROOM / peak
    from ais_tpu import native

    if native.available():
        return native.sigma_delta_cr1(iq, scale, CR1_A2)
    return _sigma_delta_cr1_numpy(iq, scale, CR1_A2)
