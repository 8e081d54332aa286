"""K5: the float channelizer (complex IQ -> periodic-carrier mix -> FIR).

Counterpart of `pallas_freq_xlating_polyphase` / `PallasChannelizer` in
`ais_tpu/ops/pallas_fir.py`.  For each channel c it computes, from the
definition,

    y[c, m] = sum_{k < ntaps} h[k] * x[m*D + k] * car_c[(m*D + k) mod q]

where x is the complex input, n counted from the start of the buffer,
and car_c[n] = e^{-j2pi off_c n / fs} * e^{j phase0_c}: the channel's
baseband mixer (no fs/4 fold: that belongs to cr1 alone, see
ops/wire_channelizer.py) rotated by the runtime start phase `phase0_c`
of the step's stream position (`ops/fir.py:mixer_phase`).  With
rational offsets the carrier is periodic (q = 96 at +-25 kHz on
2.4 Msps), so it lives in a (n_chan, q, 2) table that is rotated once
per call.

Two implementations of one contract:

  - `freq_xlating_polyphase_plain`: mix, then the reshape-and-matmul
    polyphase FIR (`ops/fir.py:fir_polyphase`);
  - the CUDA kernel `csrc/channelizer.cu`, launched by
    `freq_xlating_polyphase` for a CUDA tensor.  The same source holds
    the wire kernels K3/K4 (ops/wire_channelizer.py): one template
    whose decode prologue is the only difference.

`freq_xlating_polyphase` takes the plain version only for a CPU tensor.
A geometry no kernel covers (an offset with no short period, such as a
ppm-shifted radio) raises: its formulation is the reference's FFT
overlap-save channelizer (`ais_tpu/ops/fir.py:freq_xlating_polyphase`),
which is ROADMAP A.10's remainder.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ais_tpu_torch import _build
from ais_tpu_torch.ops.fir import fir_polyphase

MAX_CHANNELS = 4
# The kernel's block: THREADS threads, G of them share one output (each
# sums every G-th tap, then a warp shuffle adds the G partial sums), so
# a block covers THREADS / G outputs.  The tile's mixed samples, for
# every channel, and the taps are staged in shared memory; G grows (the
# tile shrinks) until that fits the 227 KB a block may opt into.
THREADS = 256
GROUPS = (4, 8, 16, 32)
MAX_SMEM_BYTES = 232_448
# Two blocks a streaming multiprocessor when the tile allows it.
TARGET_SMEM_BYTES = 113_000

UNSUPPORTED_HINT = (
    "no channelizer kernel covers this geometry: the carrier has no short "
    "period (or the tile does not fit shared memory); its formulation is the "
    "FFT overlap-save channelizer ais_tpu/ops/fir.py:freq_xlating_polyphase, "
    "ROADMAP A.10's remainder")


def carrier_period_samples(offset_hz: float, sample_rate: float,
                           max_period: int = 1 << 14) -> int | None:
    """Smallest q with offset/fs = p/q exactly (None if > max_period)."""
    if offset_hz == 0:
        return 1
    fr = Fraction(offset_hz / sample_rate).limit_denominator(max_period)
    if fr == 0:
        return None
    err = abs(offset_hz / sample_rate - float(fr))
    return int(fr.denominator) if err < 1e-12 else None


def carrier_table_period(offsets_hz, sample_rate: float) -> int | None:
    """Common period of the baseband carriers (None if not periodic)."""
    periods = [carrier_period_samples(o, sample_rate) for o in offsets_hz]
    if any(p is None for p in periods):
        return None
    return int(np.lcm.reduce(periods))


def carrier_table(offsets_hz, sample_rate: float) -> np.ndarray:
    """(n_chan, q, 2) float32: entry [c, i] is e^{-j2pi off_c i / fs};
    float64 phase on the host."""
    q = carrier_table_period(offsets_hz, sample_rate)
    if q is None:
        raise ValueError(f"offsets {tuple(offsets_hz)} give no periodic carrier at {sample_rate}")
    n = np.arange(q, dtype=np.float64)
    out = np.empty((len(offsets_hz), q, 2), np.float32)
    for c, off in enumerate(offsets_hz):
        cplx = np.exp(1j * np.remainder(-2.0 * np.pi * (off / sample_rate) * n, 2 * np.pi))
        out[c, :, 0] = cplx.real.astype(np.float32)
        out[c, :, 1] = cplx.imag.astype(np.float32)
    return out


def rotate_carrier(car: torch.Tensor, phase0s: torch.Tensor) -> torch.Tensor:
    """Rotate a (n_chan, q, 2) table by the per-channel start phases."""
    rot_r = torch.cos(phase0s)[:, None]
    rot_i = torch.sin(phase0s)[:, None]
    cr, ci = car[..., 0], car[..., 1]
    return torch.stack([cr * rot_r - ci * rot_i, cr * rot_i + ci * rot_r], dim=-1)


def n_out(n_in: int, ntaps: int, decim: int) -> int:
    return (n_in - ntaps) // decim + 1


def smem_bytes(group: int, ntaps: int, decim: int, n_chan: int) -> int:
    """Shared memory of one block: the tile's mixed samples (float2, every
    channel) and the taps."""
    tile = THREADS // group
    return n_chan * ((tile - 1) * decim + ntaps) * 8 + ntaps * 4


def kernel_group(ntaps: int, decim: int, n_chan: int) -> int | None:
    """Threads per output for this geometry (None: no tile fits)."""
    fits = [g for g in GROUPS if smem_bytes(g, ntaps, decim, n_chan) <= MAX_SMEM_BYTES]
    if not fits:
        return None
    small = [g for g in fits if smem_bytes(g, ntaps, decim, n_chan) <= TARGET_SMEM_BYTES]
    return (small or fits)[0]


def channelizer_supported(ntaps: int, decim: int, offsets_hz, sample_rate: float,
                          n_in: int | None = None) -> bool:
    """True when K5 handles this geometry.

    The kernel needs periodic baseband carriers (any period up to
    2**14: the table is read once a sample, in the decode prologue), at
    most MAX_CHANNELS channels, and one tile's span in shared memory;
    with `n_in`, whole decimation rows and at least one output.  It
    accepts everything `pallas_channelizer_supported` accepts at the
    receiver's geometries, and more: no P <= 64, row-period <= 1024 or
    tile-size limit (those come from the MXU and Mosaic).  It accepts
    less only where one tile does not fit in shared memory, from a
    decimation of about 160 at two channels.
    """
    if not 1 <= len(offsets_hz) <= MAX_CHANNELS:
        return False
    if carrier_table_period(offsets_hz, sample_rate) is None:
        return False
    if kernel_group(int(ntaps), int(decim), len(offsets_hz)) is None:
        return False
    if n_in is not None and (n_in % decim or n_in < ntaps):
        return False
    return True


def mix_plain(x: torch.Tensor, car: torch.Tensor) -> torch.Tensor:
    """(n,) complex64 times the periodic rotated carrier of each channel
    -> (n_chan, 2, n) float32 planes (re, im)."""
    n = x.shape[-1]
    q = car.shape[1]
    seq = car.repeat(1, -(-n // q), 1)[:, :n]                # (n_chan, n, 2)
    cr, ci = seq[..., 0], seq[..., 1]
    xr, xi = x.real, x.imag
    return torch.stack([xr * cr - xi * ci, xr * ci + xi * cr], dim=1)


def freq_xlating_polyphase_plain(x: torch.Tensor, car: torch.Tensor,
                                 taps: torch.Tensor, decim: int) -> torch.Tensor:
    """Plain PyTorch K5: (n_in,) complex64 -> (n_chan, n_out) complex64.

    `car` is the rotated (n_chan, q, 2) carrier table."""
    y = fir_polyphase(mix_plain(x, car), taps, decim)       # (n_chan, 2, n_out)
    return torch.complex(y[:, 0], y[:, 1])


def launch(kernel: _build.Kernel, src: torch.Tensor, car: torch.Tensor,
           taps: torch.Tensor, decim: int, n_in: int) -> torch.Tensor:
    """Launch one of `csrc/channelizer.cu`'s kernels (K3, K4 or K5) on
    `src`'s device and stream: `src` is the input in the kernel's own
    format (complex64 samples or packed wire bytes) for n_in samples."""
    dev = src.device
    if not src.is_contiguous() or src.dim() != 1:
        raise ValueError("the input must be a contiguous 1-D tensor")
    if car.dtype != torch.float32 or car.dim() != 3 or car.shape[-1] != 2:
        raise ValueError("carrier must be a (n_chan, q, 2) float32 table")
    if taps.dtype != torch.float32 or taps.dim() != 1:
        raise ValueError("taps must be a 1-D float32 tensor")
    if car.device != dev or taps.device != dev:
        raise ValueError("input, carrier and taps must be on one device")
    n_chan, q = car.shape[0], car.shape[1]
    ntaps = taps.numel()
    if not 1 <= n_chan <= MAX_CHANNELS:
        raise ValueError(f"unsupported carrier table {tuple(car.shape)}")
    if n_in % decim or n_in < ntaps:
        raise ValueError(f"n_in={n_in} is not whole decimation rows of at least {ntaps} taps")
    group = kernel_group(ntaps, decim, n_chan)
    if group is None:
        raise NotImplementedError(UNSUPPORTED_HINT)
    car = car.contiguous()
    taps = taps.contiguous()
    m = n_out(n_in, ntaps, decim)
    out = torch.empty((n_chan, m), dtype=torch.complex64, device=dev)
    kernel(src.data_ptr(), car.data_ptr(), taps.data_ptr(),
           torch.view_as_real(out).data_ptr(), n_in, m, ntaps, decim, q, n_chan, group,
           torch.cuda.current_stream(dev).cuda_stream)
    return out


def freq_xlating_polyphase(x: torch.Tensor, car: torch.Tensor, taps: torch.Tensor, *,
                           decim: int) -> torch.Tensor:
    """K5 on the tensor's device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Returns (n_chan, n_out) complex64."""
    if x.device.type == "cuda":
        if x.dtype != torch.complex64:
            raise ValueError("x must be complex64")
        return launch(_build.CHANNELIZER, torch.view_as_real(x).reshape(-1), car, taps,
                      decim, x.numel())
    if x.device.type == "cpu":
        return freq_xlating_polyphase_plain(x, car, taps, decim)
    raise NotImplementedError(f"no channelizer for device {x.device}")


class Channelizer(torch.nn.Module):
    """Complex IQ -> (n_chan, n_out) channels on the input's device; owns
    the taps and the unrotated baseband carrier table (the counterpart
    of `PallasChannelizer`)."""

    def __init__(self, taps, decim: int, offsets_hz, sample_rate: float, n_in: int,
                 device=None):
        super().__init__()
        taps = torch.tensor(np.asarray(taps, np.float32), device=device)
        if not channelizer_supported(taps.numel(), decim, offsets_hz, sample_rate, n_in):
            raise NotImplementedError(
                f"{UNSUPPORTED_HINT} (decim={decim}, offsets={tuple(offsets_hz)}, "
                f"rate={sample_rate}, n_in={n_in})")
        self.decim = int(decim)
        self.n_in = int(n_in)
        self.n_out = n_out(self.n_in, taps.numel(), self.decim)
        self.register_buffer("taps", taps)
        self.register_buffer(
            "carrier", torch.tensor(carrier_table(offsets_hz, sample_rate), device=device))

    def forward(self, x: torch.Tensor, phase0s: torch.Tensor) -> torch.Tensor:
        car = rotate_carrier(self.carrier, phase0s)
        return freq_xlating_polyphase(x, car, self.taps, decim=self.decim)
