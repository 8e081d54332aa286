"""The wire channelizers: packed wire bytes -> decode -> mix -> FIR.

K1, the cr1 wire channelizer (bytes -> +-1 -> IF-folded mix -> FIR), is
the counterpart of `_pallas_wire_channelizer_cr1` in
`ais_tpu/ops/pallas_fir.py`.  For each channel c it computes, from the
definition,

    y[c, m] = sum_{k < ntaps} h[k] * s[m*D + k] * car_c[m*D + k]

where s[n] = +-1 is bit n of the wire (8 samples a byte, MSB first) and
car_c[n] = e^{-j2pi (off_c + fs/4) n / fs} * e^{j phase0_c}: the
channel's mixer with cr1's (-j)^n IF downconversion folded in, n
counted from the start of the buffer, rotated by the runtime start
phase `phase0_c` of the *baseband* offset at the step's stream
position (`ops/fir.py:mixer_phase`).  With rational offsets the carrier
is periodic (q = 96 samples at +-25 kHz + fs/4 on 2.4 Msps), so it
lives in a (n_chan, q) table that is rotated once per call.

Two implementations of one contract:

  - `wire_channelizer_cr1_plain`: bit unpack, carrier, then the
    reshape-and-matmul polyphase FIR (`ops/fir.py:fir_polyphase`);
  - the CUDA kernel `csrc/wire_channelizer.cu`, launched by
    `wire_channelizer_cr1` for a CUDA tensor.

`wire_channelizer_cr1` takes the plain version only for a CPU tensor.

K3 (ci1; cd1 after `ci1_from_bytes_cd1`) and K4 (ci2, ci4) are the
counterparts of `_pallas_wire_channelizer_ci1` and of
`pallas_wire_channelizer` for ci2/ci4: y as in K5 (ops/channelizer.py)
on the decoded complex sample, with the baseband carrier.  Their CUDA
kernels share K5's template in `csrc/channelizer.cu` and differ only in
the decode prologue; their plain versions are the port's decoder
(ops/convert.py) followed by K5's plain version.  `wire_channelizer`
dispatches on the format and the tensor's device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ais_tpu_torch import _build
from ais_tpu_torch.ops import channelizer as _k5
from ais_tpu_torch.ops.channelizer import (
    Channelizer,
    channelizer_supported,
    freq_xlating_polyphase_plain,
    launch,
    rotate_carrier,
)
from ais_tpu_torch.ops.channelizer import n_out as _n_out
from ais_tpu_torch.ops.convert import (
    iq_from_bytes_ci1,
    iq_from_bytes_ci2,
    iq_from_bytes_ci4,
    unpack_bits_pm1,
)
from ais_tpu_torch.ops.fir import fir_polyphase

# The kernel stages the whole carrier table in shared memory.
MAX_CARRIER_PERIOD = 2048
MAX_CHANNELS = 4


def _if_offsets(offsets_hz, sample_rate: float) -> tuple:
    """The channels' mixer frequencies with cr1's fs/4 IF folded in."""
    return tuple(float(o) + float(sample_rate) / 4.0 for o in offsets_hz)


def carrier_table_period(offsets_hz, sample_rate: float) -> int | None:
    """Common period of the IF-folded carriers (None if not periodic)."""
    return _k5.carrier_table_period(_if_offsets(offsets_hz, sample_rate), sample_rate)


class PackedFormat(NamedTuple):
    samples_per_byte: int
    decode: Callable          # (raw_u8,) -> (n,) complex64, ops/convert.py
    kernel: _build.Kernel     # its entry point in csrc/channelizer.cu


# The formats of K3 and K4.
PACKED = {
    "ci1": PackedFormat(4, iq_from_bytes_ci1, _build.WIRE_CHANNELIZER_CI1),
    "ci2": PackedFormat(2, iq_from_bytes_ci2, _build.WIRE_CHANNELIZER_CI2),
    "ci4": PackedFormat(1, iq_from_bytes_ci4, _build.WIRE_CHANNELIZER_CI4),
}


def wire_channelizer_supported(fmt: str, ntaps: int, decim: int, offsets_hz,
                               sample_rate: float, n_in: int | None = None) -> bool:
    """True when a wire kernel handles this (format, geometry).

    cr1 (K1) needs at most MAX_CHANNELS channels; periodic IF-folded
    carriers with a period that fits its shared-memory table; and, when
    `n_in` is given, whole bytes and whole decimation rows.  ci1, ci2
    and ci4 (K3, K4) need what K5 needs (`channelizer_supported`) and,
    with `n_in`, whole bytes.  For ci1, ci2 and ci4, wherever
    `ais_tpu/ops/pallas_fir.py:wire_channelizer_supported` accepts, so
    does this; it accepts more: the TPU kernels' n_in % 200 and
    128-lane rules, ci1's decim % 4 == 2 and ci2's even decim come from
    Mosaic and the MXU, not from the contract.  For cr1 it accepts less
    where the IF-folded period exceeds K1's table (2048, e.g. offsets of
    +-1 kHz at 2.4 Msps): the receiver then decodes cr1 to complex
    samples and runs K5.
    """
    if fmt == "cr1":
        if not 1 <= len(offsets_hz) <= MAX_CHANNELS:
            return False
        q = carrier_table_period(offsets_hz, sample_rate)
        if q is None or q > MAX_CARRIER_PERIOD:
            return False
        if n_in is not None and (n_in % 8 or n_in % decim or n_in < ntaps):
            return False
        return True
    if fmt in PACKED:
        if n_in is not None and n_in % PACKED[fmt].samples_per_byte:
            return False
        return channelizer_supported(ntaps, decim, offsets_hz, sample_rate, n_in)
    return False


def carrier_table(offsets_hz, sample_rate: float) -> np.ndarray:
    """(n_chan, q, 2) float32: entry [c, i] is e^{-j2pi f_c i / fs} with
    f_c = off_c + fs/4; float64 phase on the host."""
    return _k5.carrier_table(_if_offsets(offsets_hz, sample_rate), sample_rate)


def wire_channelizer_cr1_plain(raw_u8: torch.Tensor, car: torch.Tensor,
                               taps: torch.Tensor, decim: int,
                               n_in: int) -> torch.Tensor:
    """Plain PyTorch K1: (n_in/8,) uint8 -> (n_chan, n_out) complex64.

    `car` is the rotated (n_chan, q, 2) carrier table."""
    s = unpack_bits_pm1(raw_u8, n_in)                       # (n_in,)
    q = car.shape[1]
    reps = -(-n_in // q)
    seq = car.repeat(1, reps, 1)[:, :n_in]                  # (n_chan, n_in, 2)
    mixed = (seq * s[None, :, None]).movedim(-1, -2)        # (n_chan, 2, n_in)
    y = fir_polyphase(mixed, taps, decim)                   # (n_chan, 2, n_out)
    return torch.complex(y[:, 0], y[:, 1])


def _wire_channelizer_cr1_cuda(raw_u8: torch.Tensor, car: torch.Tensor,
                               taps: torch.Tensor, decim: int,
                               n_in: int) -> torch.Tensor:
    dev = raw_u8.device
    if raw_u8.dtype != torch.uint8 or raw_u8.dim() != 1 or not raw_u8.is_contiguous():
        raise ValueError("raw_u8 must be a contiguous 1-D uint8 tensor")
    if raw_u8.numel() != n_in // 8 or n_in % 8 or n_in % decim:
        raise ValueError(f"wire of {raw_u8.numel()} bytes does not hold n_in={n_in}")
    if car.dtype != torch.float32 or car.dim() != 3 or car.shape[-1] != 2:
        raise ValueError("carrier must be a (n_chan, q, 2) float32 table")
    if taps.dtype != torch.float32 or taps.dim() != 1:
        raise ValueError("taps must be a 1-D float32 tensor")
    if car.device != dev or taps.device != dev:
        raise ValueError("raw, carrier and taps must be on one device")
    n_chan, q = car.shape[0], car.shape[1]
    if not 1 <= n_chan <= MAX_CHANNELS or q > MAX_CARRIER_PERIOD:
        raise ValueError(f"unsupported carrier table {tuple(car.shape)}")
    car = car.contiguous()
    taps = taps.contiguous()
    ntaps = taps.numel()
    n_out = _n_out(n_in, ntaps, decim)
    if n_out <= 0:
        raise ValueError(f"n_in={n_in} is shorter than the filter ({ntaps} taps)")
    out = torch.empty((n_chan, n_out), dtype=torch.complex64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.WIRE_CHANNELIZER_CR1(
        raw_u8.data_ptr(), car.data_ptr(), taps.data_ptr(),
        torch.view_as_real(out).data_ptr(),
        raw_u8.numel(), n_out, ntaps, decim, q, n_chan, stream,
    )
    return out


def wire_channelizer_cr1(raw_u8: torch.Tensor, car: torch.Tensor,
                         taps: torch.Tensor, *, decim: int,
                         n_in: int) -> torch.Tensor:
    """K1 on the tensor's device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Returns (n_chan, n_out) complex64."""
    if raw_u8.device.type == "cuda":
        return _wire_channelizer_cr1_cuda(raw_u8, car, taps, decim, n_in)
    if raw_u8.device.type == "cpu":
        return wire_channelizer_cr1_plain(raw_u8, car, taps, decim, n_in)
    raise NotImplementedError(f"no wire channelizer for device {raw_u8.device}")


def wire_channelizer_packed_plain(fmt: str, raw_u8: torch.Tensor, car: torch.Tensor,
                                  taps: torch.Tensor, decim: int) -> torch.Tensor:
    """Plain PyTorch K3/K4: decode `fmt`'s bytes, then K5's plain version.
    `car` is the rotated baseband (n_chan, q, 2) carrier table."""
    return freq_xlating_polyphase_plain(PACKED[fmt].decode(raw_u8), car, taps, decim)


def wire_channelizer_packed(fmt: str, raw_u8: torch.Tensor, car: torch.Tensor,
                            taps: torch.Tensor, *, decim: int, n_in: int) -> torch.Tensor:
    """K3 (fmt "ci1") or K4 ("ci2", "ci4") on the tensor's device: the
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor.
    Returns (n_chan, n_out) complex64."""
    spec = PACKED[fmt]
    if raw_u8.dtype != torch.uint8 or n_in % spec.samples_per_byte \
            or raw_u8.numel() != n_in // spec.samples_per_byte:
        raise ValueError(f"{fmt} wire of {raw_u8.numel()} bytes does not hold n_in={n_in}")
    if raw_u8.device.type == "cuda":
        return launch(spec.kernel, raw_u8, car, taps, decim, n_in)
    if raw_u8.device.type == "cpu":
        return wire_channelizer_packed_plain(fmt, raw_u8, car, taps, decim)
    raise NotImplementedError(f"no wire channelizer for device {raw_u8.device}")


class WireChannelizer(torch.nn.Module):
    """cr1 wire bytes -> (n_chan, n_out) channels; owns the taps and the
    unrotated carrier table."""

    def __init__(self, taps: np.ndarray, decim: int, offsets_hz,
                 sample_rate: float, n_in: int, device=None):
        super().__init__()
        taps = np.asarray(taps, np.float32)
        if not wire_channelizer_supported("cr1", taps.size, decim, offsets_hz,
                                          sample_rate, n_in):
            raise ValueError(
                f"cr1 wire channelizer unsupported: decim={decim}, "
                f"offsets={tuple(offsets_hz)}, rate={sample_rate}, n_in={n_in}"
            )
        self.decim = int(decim)
        self.n_in = int(n_in)
        self.n_out = _n_out(self.n_in, taps.size, self.decim)
        self.register_buffer("taps", torch.tensor(taps, device=device))
        self.register_buffer(
            "carrier", torch.tensor(carrier_table(offsets_hz, sample_rate), device=device)
        )

    def forward(self, raw_u8: torch.Tensor, phase0s: torch.Tensor) -> torch.Tensor:
        car = rotate_carrier(self.carrier, phase0s)
        return wire_channelizer_cr1(raw_u8, car, self.taps, decim=self.decim, n_in=self.n_in)


class PackedWireChannelizer(Channelizer):
    """ci1 / ci2 / ci4 wire bytes -> (n_chan, n_out) channels (K3, K4);
    owns the taps and the baseband carrier table, as K5's module does."""

    def __init__(self, fmt: str, taps, decim: int, offsets_hz, sample_rate: float,
                 n_in: int, device=None):
        if fmt not in PACKED:
            raise ValueError(f"no packed wire channelizer for {fmt!r}")
        if n_in % PACKED[fmt].samples_per_byte:
            raise ValueError(f"n_in={n_in} is not whole {fmt} bytes")
        super().__init__(taps, decim, offsets_hz, sample_rate, n_in, device=device)
        self.fmt = fmt

    def forward(self, raw_u8: torch.Tensor, phase0s: torch.Tensor) -> torch.Tensor:
        car = rotate_carrier(self.carrier, phase0s)
        return wire_channelizer_packed(self.fmt, raw_u8, car, self.taps,
                                       decim=self.decim, n_in=self.n_in)
