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

The kernel runs the sum on the tensor cores.  Since car_c[n] =
e^{j phase0_c} e^{-j w_c n}, the carrier leaves the sum:

    y[c, m] = car_c[m*D] * sum_k g_c[k] * s[m*D + k],
    g_c[k] = h[k] * e^{-j w_c k}                      (`fold_taps`)

a product of the +-1 samples (exact in fp16) with constant complex taps,
rotated once an output by the periodic table at index m*D mod q.  Each
scaled tap is split into two fp16 parts, hi + lo (`split_taps`), so the
columns of the B operand are (channel, re/im, hi/lo); `pack_fragments`
lays them out in the order the kernel's `mma.sync.m16n8k16` lanes read
them.  The layout arithmetic lives here (`fragment_tap`, `window`,
`a_registers`) so that the CPU tests can check every index the kernel
uses; `wire_channelizer_cr1_folded` is the folded form in plain
PyTorch, from the packed buffer.

K3 (ci1; cd1 after `ci1_from_bytes_cd1`) and K4 (ci2, ci4) are the
counterparts of `_pallas_wire_channelizer_ci1` and of
`pallas_wire_channelizer` for ci2/ci4: y as in K5 (ops/channelizer.py)
on the decoded complex sample, with the baseband carrier.  K5's cu8
entry is the same on rtl_sdr's offset-binary bytes (no TPU kernel: the
reference decodes cu8 on the host).  Their plain versions are the
port's decoder (ops/convert.py) followed by K5's plain version.  K4's
CUDA kernels, the cu8 entry, and K3's for the geometries its own form
does not take, share K5's template in `csrc/channelizer.cu` and differ
only in the decode prologue.

K3's own form is K1's on the wire's bit sequence.  A ci1 sample is
x[n] = I[n] + jQ[n], both +-1, and the bytes hold I0 Q0 I1 Q1 .. MSB
first, so with b[2n] = I[n], b[2n + 1] = Q[n] and the baseband carrier
folded into g_c[k] = h[k] e^{-j w_c k} (`fold_taps(..., baseband=True)`):

    y[c, m] = car_c[m*D] * sum_{i < 2 ntaps} G_c[i] * b[2*m*D + i],
    G_c[2k] = g_c[k], G_c[2k + 1] = j g_c[k]          (`bit_stream_taps`)

the same product with 2 ntaps taps and a decimation of 2D bits, rotated
by the table at index m*D mod q.  `ci1_mma_supported` says which
geometries it takes (periodic carriers up to MAX_CARRIER_PERIOD, B and a
tile's words within shared memory); `PackedWireChannelizer` builds the
fragments once, `wire_channelizer_packed` launches the kernel (the
second entry point of `csrc/wire_channelizer.cu`), and
`wire_channelizer_ci1_folded` is the form in plain PyTorch.  The choice
between the two CUDA kernels of K3 follows from the geometry alone.
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
    CI2_INNER,
    CI2_OUTER,
    iq_from_bytes_ci1,
    iq_from_bytes_ci2,
    iq_from_bytes_ci4,
    iq_from_bytes_cu8,
    unpack_bits_pm1,
)
from ais_tpu_torch.ops.fir import fir_polyphase

# K1's carrier table is periodic and short (the rule of the first kernel,
# which staged it in shared memory; kept so that the cr1 route of a
# geometry does not change).
MAX_CARRIER_PERIOD = 2048
MAX_CHANNELS = 4
# The kernel's geometry (csrc/wire_channelizer.cu): a block walks tiles
# of TILE_OUTPUTS outputs; its K loop goes in super-steps of SUPER_TAPS
# taps (8 mma k-steps of 16), in which lane t of a quad owns 32
# consecutive taps of each of its rows: one 32-bit window of wire bits.
TILE_OUTPUTS = 256
CI1_TILE_OUTPUTS = 384      # K3: 12 warps of 32 outputs (K1: 4 of 64)
SUPER_TAPS = 128
MAX_SMEM_BYTES = 232_448
# fp16 parts: 11 significant bits each, so hi + lo carries 22; below
# fp16's normal range (the far tail taps) the parts are subnormal, with
# absolute spacing 2**-24.
SPLIT_REL_ERR = 2.0 ** -22
SPLIT_ABS_ERR = 2.0 ** -25


def _if_offsets(offsets_hz, sample_rate: float) -> tuple:
    """The channels' mixer frequencies with cr1's fs/4 IF folded in."""
    return tuple(float(o) + float(sample_rate) / 4.0 for o in offsets_hz)


def carrier_table_period(offsets_hz, sample_rate: float) -> int | None:
    """Common period of the IF-folded carriers (None if not periodic)."""
    return _k5.carrier_table_period(_if_offsets(offsets_hz, sample_rate), sample_rate)


class PackedFormat(NamedTuple):
    samples_per_word: int     # samples in a 32-bit word of wire bytes, the kernel's unit
    decode: Callable          # (raw_u8,) -> (n,) complex64, ops/convert.py
    kernel: _build.Kernel     # its entry point in csrc/channelizer.cu

    def whole(self, n_in: int) -> bool:
        """True when n_in samples fill whole wire bytes."""
        return 4 * n_in % self.samples_per_word == 0

    def nbytes(self, n_in: int) -> int:
        return 4 * n_in // self.samples_per_word


# The formats decoded inside csrc/channelizer.cu's template: K3, K4, K5's cu8 entry.
PACKED = {
    "ci1": PackedFormat(16, iq_from_bytes_ci1, _build.WIRE_CHANNELIZER_CI1),
    "ci2": PackedFormat(8, iq_from_bytes_ci2, _build.WIRE_CHANNELIZER_CI2),
    "ci4": PackedFormat(4, iq_from_bytes_ci4, _build.WIRE_CHANNELIZER_CI4),
    "cu8": PackedFormat(2, iq_from_bytes_cu8, _build.WIRE_CHANNELIZER_CU8),
}
_CU8_INV = np.float32(1.0 / 127.5)


def word_sample(fmt: str, word: int, k: int) -> complex:
    """Sample k of one 32-bit little-endian word of `fmt`'s wire bytes
    (byte b at bits 8b..8b+7), by the shifts and float32 arithmetic of
    the kernel's decode prologue, which reads a word a thread: 16
    samples of ci1, 8 of ci2, 4 of ci4, 2 of cu8."""
    if fmt == "ci1":
        sh = 8 * (k >> 2) + 6 - 2 * (k & 3)
        return complex(2.0 * ((word >> (sh + 1)) & 1) - 1.0, 2.0 * ((word >> sh) & 1) - 1.0)
    if fmt == "ci2":
        sh = 8 * (k >> 1) + (0 if k & 1 else 4)
        level = (-CI2_OUTER, -CI2_INNER, CI2_INNER, CI2_OUTER)
        return complex(level[(word >> (sh + 2)) & 3], level[(word >> sh) & 3])
    if fmt == "ci4":
        def nibble(v):
            return (v & 15) - 16 * ((v & 15) >= 8)
        return complex(nibble(word >> (8 * k + 4)) * 0.125, nibble(word >> (8 * k)) * 0.125)
    if fmt == "cu8":
        i, q = (np.float32((word >> sh) & 255) - np.float32(127.5) for sh in (16 * k, 16 * k + 8))
        return complex(i * _CU8_INV, q * _CU8_INV)
    raise ValueError(f"no packed wire format {fmt!r}")


def wire_channelizer_supported(fmt: str, ntaps: int, decim: int, offsets_hz,
                               sample_rate: float, n_in: int | None = None) -> bool:
    """True when a wire kernel handles this (format, geometry).

    cr1 (K1) needs at most MAX_CHANNELS channels; periodic IF-folded
    carriers with a period of at most MAX_CARRIER_PERIOD; the packed taps
    and one tile's wire bits within a block's shared memory; and, when
    `n_in` is given, whole bytes and whole decimation rows.  ci1, ci2
    and ci4 (K3, K4) and cu8 (K5's cu8 entry) need what K5 needs
    (`channelizer_supported`) and, with `n_in`, whole bytes (cu8 always
    has them, so it takes every geometry K5 takes and no other).  For
    ci1, ci2 and ci4, wherever `ais_tpu/ops/pallas_fir.py:
    wire_channelizer_supported` accepts, so
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
        return kernel_smem_bytes(ntaps, decim, len(offsets_hz)) <= MAX_SMEM_BYTES
    if fmt in PACKED:
        if n_in is not None and not PACKED[fmt].whole(n_in):
            return False
        return channelizer_supported(ntaps, decim, offsets_hz, sample_rate, n_in)
    return False


def ci1_mma_takes(ntaps: int, decim: int, n_chan: int, period: int | None) -> bool:
    """True when K3's 1-bit tensor-core form takes a geometry whose
    carrier table has `period` entries (None: no periodic table): 1 to
    MAX_CHANNELS channels, a period of at most MAX_CARRIER_PERIOD, and
    the 2*ntaps bit-stream taps with one tile's words within a block's
    shared memory."""
    if not 1 <= n_chan <= MAX_CHANNELS or period is None or period > MAX_CARRIER_PERIOD:
        return False
    return kernel_smem_bytes(2 * ntaps, 2 * decim, n_chan, CI1_TILE_OUTPUTS) <= MAX_SMEM_BYTES


def ci1_mma_supported(ntaps: int, decim: int, offsets_hz, sample_rate: float,
                      n_in: int | None = None) -> bool:
    """`ci1_mma_takes` from the channels' offsets (the period of their
    baseband carriers); with `n_in`, also whole bytes, whole decimation
    rows and at least one output.  Every other ci1 geometry stays on the
    template kernel (`wire_channelizer_supported("ci1", ...)`)."""
    if not offsets_hz or (n_in is not None and (n_in % 4 or n_in % decim or n_in < ntaps)):
        return False
    period = _k5.carrier_table_period(offsets_hz, sample_rate)
    return ci1_mma_takes(int(ntaps), int(decim), len(offsets_hz), period)


def carrier_table(offsets_hz, sample_rate: float) -> np.ndarray:
    """(n_chan, q, 2) float32: entry [c, i] is e^{-j2pi f_c i / fs} with
    f_c = off_c + fs/4; float64 phase on the host."""
    return _k5.carrier_table(_if_offsets(offsets_hz, sample_rate), sample_rate)


class FoldedTaps(NamedTuple):
    """K1's B operand: the folded taps, split and in fragment order."""
    frags: torch.Tensor   # (n_super, 8, n_tiles_n, 32, 2) int32, two fp16 each
    unscale: float        # 2**-e: the power-of-two scale of the parts, undone
    ntaps: int


def n_super_steps(ntaps: int) -> int:
    return -(-int(ntaps) // SUPER_TAPS)


def n_column_tiles(n_chan: int) -> int:
    """mma n-tiles of 8 columns: 4 columns a channel (re/im x hi/lo)."""
    return -(-4 * int(n_chan) // 8)


def tile_words(ntaps: int, decim: int, tile_outputs: int = TILE_OUTPUTS) -> int:
    """32-bit words of wire bits a tile stages: up to the last row's last
    window, plus the word after it that the funnel shift reads.  `ntaps`
    and `decim` count wire bits (for ci1: twice the samples)."""
    last = (tile_outputs - 1) * decim + 32 * 3 + (n_super_steps(ntaps) - 1) * SUPER_TAPS
    return (last >> 5) + 2


def kernel_smem_bytes(ntaps: int, decim: int, n_chan: int,
                      tile_outputs: int = TILE_OUTPUTS) -> int:
    frag_bytes = n_super_steps(ntaps) * 8 * n_column_tiles(n_chan) * 32 * 8
    return frag_bytes + 4 * tile_words(ntaps, decim, tile_outputs)


def fold_taps(taps, offsets_hz, sample_rate: float, baseband: bool = False) -> np.ndarray:
    """(n_chan, ntaps) complex128: g_c[k] = h[k] e^{-j2pi f_c k / fs} with
    f_c = off_c + fs/4 (cr1), or f_c = off_c with `baseband` (ci1);
    float64 phase (as `carrier_table`, unrounded)."""
    h = np.asarray(taps, np.float64)
    k = np.arange(h.size, dtype=np.float64)
    out = np.empty((len(offsets_hz), h.size), np.complex128)
    freqs = offsets_hz if baseband else _if_offsets(offsets_hz, sample_rate)
    for c, f in enumerate(freqs):
        phase = np.remainder(-2.0 * np.pi * (f / float(sample_rate)) * k, 2.0 * np.pi)
        out[c] = h * np.exp(1j * phase)
    return out


def fold_taps_from_table(taps: np.ndarray, car: np.ndarray) -> np.ndarray:
    """`fold_taps` from a (rotated or not) (n_chan, q, 2) carrier table:
    e^{-j w_c k} = car_c[k mod q] * conj(car_c[0]).  Carries the table's
    float32 rounding; for callers that hold no offsets."""
    car = np.asarray(car, np.float64)
    e = car[..., 0] + 1j * car[..., 1]                       # (n_chan, q)
    k = np.arange(np.asarray(taps).size) % e.shape[1]
    return np.asarray(taps, np.float64) * e[:, k] * np.conj(e[:, :1])


def bit_stream_taps(g: np.ndarray) -> np.ndarray:
    """(n_chan, ntaps) folded taps -> (n_chan, 2*ntaps) taps on ci1's bit
    sequence I0 Q0 I1 Q1 ..: G[2k] = g[k] meets I[k], G[2k + 1] = j g[k]
    meets Q[k], so that sum_i G[i] b[i] = sum_k g[k] (I[k] + j Q[k])."""
    g = np.asarray(g, np.complex128)
    return np.stack([g, 1j * g], axis=-1).reshape(g.shape[0], -1)


def split_taps(g: np.ndarray):
    """Scale by a power of two and split into fp16 hi + lo.

    Returns (hi, lo, e): hi, lo float16 arrays of g's shape (g real) with
    |g*2**e - (hi + lo)| <= SPLIT_REL_ERR*|g*2**e| + SPLIT_ABS_ERR, and e
    such that max|g|*2**e lies in [2**14, 2**15): as high as fp16 goes,
    which keeps all but the far tail of the taps out of its subnormals."""
    g = np.asarray(g, np.float64)
    gmax = float(np.abs(g).max())
    if not np.isfinite(gmax) or gmax == 0.0:
        raise ValueError("taps must be finite and not all zero")
    e = 15 - int(np.frexp(gmax)[1])
    v = np.ldexp(g, e)
    hi = v.astype(np.float16)
    lo = (v - hi.astype(np.float64)).astype(np.float16)
    return hi, lo, e


def fragment_tap(j, t, kg, half):
    """Tap, within a super-step, that k-step j (0..7) of the kernel puts
    in lane-of-quad t's slot (kg, half) of an mma fragment.

    An m16n8k16 lane holds k-slots 2t + 8*kg + half, kg, half in {0, 1}
    (A registers kg*2 + row half, B register kg; `half` 1 is the
    register's upper 16 bits).  Any assignment of taps to slots is
    right as long as A and B share it.  The kernel's: lane t owns taps
    32t..32t+31 of the super-step as one 32-bit window w of wire bits
    (tap i at bit 31-i), and (w << (2j + kg)) & 0x80008000 leaves tap
    2j + kg at bit 31 (half 1) and tap 2j + kg + 16 at bit 15 (half 0):
    the two sign bits of an fp16 pair."""
    return 32 * t + 2 * j + kg + 16 * (1 - half)


def _fragment_index(n_super: int, n_tiles_n: int):
    """(tap, column) of every fp16 of the fragment buffer, each of shape
    (n_super, 8, n_tiles_n, 32, 2, 2): [S, j, nt, lane, kg, half]."""
    S, j, nt, lane, kg, half = np.meshgrid(
        np.arange(n_super), np.arange(8), np.arange(n_tiles_n), np.arange(32),
        np.arange(2), np.arange(2), indexing="ij")
    tap = S * SUPER_TAPS + fragment_tap(j, lane & 3, kg, half)
    col = 8 * nt + (lane >> 2)
    return tap, col


def tap_matrix(g: np.ndarray):
    """The B operand in natural order: (k_pad, 8*n_tiles_n) float16,
    column 4c + 2*comp + part (comp 0 re, 1 im; part 0 hi, 1 lo), zero
    rows past ntaps and zero columns past the channels; and e."""
    n_chan, ntaps = g.shape
    planes = np.stack([g.real, g.imag], axis=1)              # (n_chan, 2, ntaps)
    hi, lo, e = split_taps(planes)
    b = np.zeros((n_super_steps(ntaps) * SUPER_TAPS, 8 * n_column_tiles(n_chan)), np.float16)
    parts = np.stack([hi, lo], axis=2)                       # (n_chan, 2, 2, ntaps)
    b[:ntaps, : 4 * n_chan] = parts.reshape(4 * n_chan, ntaps).T
    return b, e


def pack_fragments(g: np.ndarray) -> tuple:
    """Folded taps (n_chan, ntaps) complex -> (frags int32 numpy array of
    shape (n_super, 8, n_tiles_n, 32, 2), unscale)."""
    b, e = tap_matrix(g)
    tap, col = _fragment_index(b.shape[0] // SUPER_TAPS, b.shape[1] // 8)
    bits = b.view(np.uint16)[tap, col].astype(np.uint32)
    frags = (bits[..., 0] | (bits[..., 1] << 16)).view(np.int32)
    return np.ascontiguousarray(frags), float(np.ldexp(1.0, -e))


def unpack_fragments(frags: np.ndarray, unscale: float, ntaps: int, n_chan: int) -> np.ndarray:
    """The taps the kernel sums, back from its buffer: (n_chan, ntaps)
    complex128 of (hi + lo) * unscale."""
    frags = np.asarray(frags).view(np.uint32)
    n_super, _, n_tiles_n = frags.shape[:3]
    tap, col = _fragment_index(n_super, n_tiles_n)
    bits = np.stack([frags & 0xFFFF, frags >> 16], axis=-1).astype(np.uint16)
    b = np.zeros((n_super * SUPER_TAPS, 8 * n_tiles_n), np.float16)
    b[tap, col] = bits.view(np.float16)
    parts = b[:ntaps, : 4 * n_chan].astype(np.float64).T.reshape(n_chan, 2, 2, ntaps)
    planes = parts.sum(axis=2) * unscale
    return planes[:, 0] + 1j * planes[:, 1]


def folded_taps(g: np.ndarray, device=None) -> FoldedTaps:
    frags, unscale = pack_fragments(g)
    return FoldedTaps(torch.from_numpy(frags).to(device), unscale, g.shape[1])


def tile_wire_words(raw: np.ndarray, tile: int, ntaps: int, decim: int,
                    tile_outputs: int = TILE_OUTPUTS) -> np.ndarray:
    """The uint32 words a block stages for output tile `tile`.

    The tile's first bit is bit tile*tile_outputs*decim of the wire: the
    first bit of byte tile*(tile_outputs/8)*decim, a whole 4-byte word for
    any decim (a tile is a multiple of 32 outputs).  Each word is
    byte-swapped so that its wire bit n (MSB first in its byte) sits at
    bit 31 - n; past the buffer's end the words are zero."""
    start = tile * (tile_outputs // 8) * decim
    n = tile_words(ntaps, decim, tile_outputs)
    chunk = np.zeros(4 * n, np.uint8)
    have = np.asarray(raw, np.uint8)[start: start + 4 * n]
    chunk[: have.size] = have
    return chunk.view(">u4").astype(np.uint32)


def window(words: np.ndarray, bit: int) -> int:
    """The 32 wire bits from `bit` on, first bit at bit 31: the kernel's
    funnel shift of two staged words."""
    wi, sh = bit >> 5, bit & 31
    pair = (int(words[wi]) << 32) | int(words[wi + 1])
    return (pair >> (32 - sh)) & 0xFFFFFFFF


def a_registers(win: int, j: int) -> tuple:
    """The two A registers (kg = 0, 1) of k-step j from a row's window:
    fp16 pairs, +1.0 where the wire bit is 1 and -1.0 where it is 0."""
    return tuple((((win << (2 * j + kg)) & 0x80008000) ^ 0xBC00BC00) & 0xFFFFFFFF
                 for kg in (0, 1))


def _folded_form(raw_u8: torch.Tensor, car: torch.Tensor, folded: FoldedTaps, n_bits: int,
                 bit_decim: int, car_stride: int) -> torch.Tensor:
    """The 1-bit kernel's arithmetic in plain PyTorch: the wire's +-1 bits
    through the folded taps as the packed buffer holds them ((hi + lo) *
    unscale) at a decimation of `bit_decim` bits, then one rotation an
    output by car_c[m*car_stride mod q]."""
    n_chan, q = car.shape[0], car.shape[1]
    g = unpack_fragments(folded.frags.cpu().numpy(), folded.unscale, folded.ntaps, n_chan)
    s = unpack_bits_pm1(raw_u8, n_bits)
    dev = raw_u8.device
    rows = []
    for c in range(n_chan):
        re = fir_polyphase(s, torch.tensor(g[c].real, dtype=torch.float32, device=dev), bit_decim)
        im = fir_polyphase(s, torch.tensor(g[c].imag, dtype=torch.float32, device=dev), bit_decim)
        idx = (torch.arange(re.numel(), device=dev, dtype=torch.int64) * car_stride) % q
        rot = torch.complex(car[c, idx, 0], car[c, idx, 1])
        rows.append(torch.complex(re, im) * rot)
    return torch.stack(rows)


def wire_channelizer_cr1_folded(raw_u8: torch.Tensor, car: torch.Tensor,
                                folded: FoldedTaps, decim: int, n_in: int) -> torch.Tensor:
    """K1's form in plain PyTorch: one bit a sample, folded taps, one
    rotation an output by car_c[m*D mod q]."""
    return _folded_form(raw_u8, car, folded, n_in, decim, decim)


def wire_channelizer_ci1_folded(raw_u8: torch.Tensor, car: torch.Tensor,
                                folded: FoldedTaps, decim: int, n_in: int) -> torch.Tensor:
    """K3's 1-bit form in plain PyTorch: ci1's 2*n_in wire bits through
    the 2*ntaps bit-stream taps of `folded` at a decimation of 2D bits,
    rotated by car_c[m*D mod q]."""
    return _folded_form(raw_u8, car, folded, 2 * n_in, 2 * decim, decim)


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


def _wire_bits_cuda(fmt: str, raw_u8: torch.Tensor, car: torch.Tensor, taps: torch.Tensor,
                    decim: int, n_in: int, folded: FoldedTaps | None) -> torch.Tensor:
    """Launch the 1-bit tensor-core kernel: K1 for `fmt` "cr1" (one wire
    bit a sample), K3's own form for "ci1" (two)."""
    bits = {"cr1": 1, "ci1": 2}[fmt]
    tile = TILE_OUTPUTS if fmt == "cr1" else CI1_TILE_OUTPUTS
    dev = raw_u8.device
    if raw_u8.dtype != torch.uint8 or raw_u8.dim() != 1 or not raw_u8.is_contiguous():
        raise ValueError("raw_u8 must be a contiguous 1-D uint8 tensor")
    if (n_in * bits) % 8 or raw_u8.numel() != n_in * bits // 8 or n_in % decim:
        raise ValueError(f"{fmt} wire of {raw_u8.numel()} bytes does not hold n_in={n_in}")
    if car.dtype != torch.float32 or car.dim() != 3 or car.shape[-1] != 2:
        raise ValueError("carrier must be a (n_chan, q, 2) float32 table")
    if taps.dtype != torch.float32 or taps.dim() != 1:
        raise ValueError("taps must be a 1-D float32 tensor")
    if car.device != dev or taps.device != dev:
        raise ValueError("raw, carrier and taps must be on one device")
    n_chan, q = car.shape[0], car.shape[1]
    if not 1 <= n_chan <= MAX_CHANNELS or q > MAX_CARRIER_PERIOD:
        raise ValueError(f"unsupported carrier table {tuple(car.shape)}")
    ntaps = taps.numel()
    n_out = _n_out(n_in, ntaps, decim)
    if n_out <= 0:
        raise ValueError(f"n_in={n_in} is shorter than the filter ({ntaps} taps)")
    bit_taps, bit_decim = bits * ntaps, bits * decim
    if kernel_smem_bytes(bit_taps, bit_decim, n_chan, tile) > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"{ntaps} taps at decimation {decim} for {n_chan} channels do not fit "
            f"a block's shared memory")
    if folded is None:
        # No module holds the folded taps: derive them from the table
        # (a device-to-host copy; the modules never take this).
        g = fold_taps_from_table(taps.cpu().numpy(), car.cpu().numpy())
        folded = folded_taps(bit_stream_taps(g) if fmt == "ci1" else g, device=dev)
    want = (n_super_steps(bit_taps), 8, n_column_tiles(n_chan), 32, 2)
    frags = folded.frags
    if frags.dtype != torch.int32 or tuple(frags.shape) != want or frags.device != dev \
            or not frags.is_contiguous() or folded.ntaps != bit_taps:
        raise ValueError(f"folded taps {tuple(frags.shape)} do not fit {bit_taps} taps, "
                         f"{n_chan} channels (want int32 {want} on {dev})")
    if raw_u8.data_ptr() % 4:
        raw_u8 = raw_u8.clone()     # the kernel reads the wire in aligned words
    car = car.contiguous()
    out = torch.empty((n_chan, n_out), dtype=torch.complex64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    words = tile_words(bit_taps, bit_decim, tile)
    head = (raw_u8.data_ptr(), car.data_ptr(), frags.data_ptr(),
            torch.view_as_real(out).data_ptr(), raw_u8.numel(), n_out, want[0], words)
    tail = (decim, q, n_chan, folded.unscale, stream)
    if fmt == "cr1":
        _build.WIRE_CHANNELIZER_CR1(*head, *tail)
    else:
        _build.WIRE_CHANNELIZER_CI1_MMA(*head, tile, *tail)
    return out


def wire_channelizer_cr1(raw_u8: torch.Tensor, car: torch.Tensor,
                         taps: torch.Tensor, *, decim: int, n_in: int,
                         folded: FoldedTaps | None = None) -> torch.Tensor:
    """K1 on the tensor's device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Returns (n_chan, n_out) complex64.
    `folded` is the kernel's form of the taps (`folded_taps`); without
    it the kernel's wrapper derives them from `car` and `taps`."""
    if raw_u8.device.type == "cuda":
        return _wire_bits_cuda("cr1", raw_u8, car, taps, decim, n_in, folded)
    if raw_u8.device.type == "cpu":
        return wire_channelizer_cr1_plain(raw_u8, car, taps, decim, n_in)
    raise NotImplementedError(f"no wire channelizer for device {raw_u8.device}")


def wire_channelizer_packed_plain(fmt: str, raw_u8: torch.Tensor, car: torch.Tensor,
                                  taps: torch.Tensor, decim: int) -> torch.Tensor:
    """Plain PyTorch K3/K4 and K5 on cu8: decode `fmt`'s bytes, then K5's
    plain version.  `car` is the rotated baseband (n_chan, q, 2) carrier table."""
    return freq_xlating_polyphase_plain(PACKED[fmt].decode(raw_u8), car, taps, decim)


def wire_channelizer_packed(fmt: str, raw_u8: torch.Tensor, car: torch.Tensor,
                            taps: torch.Tensor, *, decim: int, n_in: int,
                            folded: FoldedTaps | None = None) -> torch.Tensor:
    """K3 (fmt "ci1"), K4 ("ci2", "ci4") or K5's cu8 entry ("cu8") on the
    tensor's device: a CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor.  Returns (n_chan, n_out) complex64.

    On the card ci1 runs its 1-bit tensor-core form wherever
    `ci1_mma_takes` accepts the geometry (`folded` is then that form's
    taps, `PackedWireChannelizer.folded`; without it they are derived
    from `car` and `taps`), and the template kernel everywhere else."""
    spec = PACKED[fmt]
    if raw_u8.dtype != torch.uint8 or not spec.whole(n_in) or raw_u8.numel() != spec.nbytes(n_in):
        raise ValueError(f"{fmt} wire of {raw_u8.numel()} bytes does not hold n_in={n_in}")
    if raw_u8.device.type == "cuda":
        if fmt == "ci1" and ci1_mma_takes(taps.numel(), decim, car.shape[0], car.shape[1]):
            return _wire_bits_cuda("ci1", raw_u8, car, taps, decim, n_in, folded)
        return launch(spec.kernel, raw_u8, car, taps, decim, n_in)
    if raw_u8.device.type == "cpu":
        return wire_channelizer_packed_plain(fmt, raw_u8, car, taps, decim)
    raise NotImplementedError(f"no wire channelizer for device {raw_u8.device}")


class WireChannelizer(torch.nn.Module):
    """cr1 wire bytes -> (n_chan, n_out) channels; owns the taps, the
    unrotated carrier table and the kernel's folded taps."""

    def __init__(self, taps: np.ndarray, decim: int, offsets_hz,
                 sample_rate: float, n_in: int, device="cuda"):
        super().__init__()
        device = _build.require_card(device, type(self).__name__)
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
        # The kernel's B operand, built once in float64 on the host.
        frags, self.unscale = pack_fragments(fold_taps(taps, offsets_hz, sample_rate))
        self.register_buffer("frags", torch.from_numpy(frags).to(device))

    @property
    def folded(self) -> FoldedTaps:
        return FoldedTaps(self.frags, self.unscale, self.taps.numel())

    def forward(self, raw_u8: torch.Tensor, phase0s: torch.Tensor) -> torch.Tensor:
        car = rotate_carrier(self.carrier, phase0s)
        return wire_channelizer_cr1(raw_u8, car, self.taps, decim=self.decim,
                                    n_in=self.n_in, folded=self.folded)


class PackedWireChannelizer(Channelizer):
    """ci1 / ci2 / ci4 / cu8 wire bytes -> (n_chan, n_out) channels (K3,
    K4, K5's cu8 entry); owns the taps and the baseband carrier table, as
    K5's module does, and for ci1, where the geometry allows
    (`ci1_mma_supported`), the bit-stream taps of K3's 1-bit form
    (`folded`, else None)."""

    def __init__(self, fmt: str, taps, decim: int, offsets_hz, sample_rate: float,
                 n_in: int, device="cuda"):
        if fmt not in PACKED:
            raise ValueError(f"no packed wire channelizer for {fmt!r}")
        if not PACKED[fmt].whole(n_in):
            raise ValueError(f"n_in={n_in} is not whole {fmt} bytes")
        super().__init__(taps, decim, offsets_hz, sample_rate, n_in, device=device)
        self.fmt = fmt
        self.unscale = None
        if fmt == "ci1" and ci1_mma_supported(self.taps.numel(), decim, offsets_hz,
                                              sample_rate, n_in):
            # The kernel's B operand, built once in float64 on the host.
            g = fold_taps(self.taps.cpu().numpy(), offsets_hz, sample_rate, baseband=True)
            frags, self.unscale = pack_fragments(bit_stream_taps(g))
            self.register_buffer("frags", torch.from_numpy(frags).to(device))

    @property
    def folded(self) -> FoldedTaps | None:
        if self.unscale is None:
            return None
        return FoldedTaps(self.frags, self.unscale, 2 * self.taps.numel())

    def forward(self, raw_u8: torch.Tensor, phase0s: torch.Tensor) -> torch.Tensor:
        car = rotate_carrier(self.carrier, phase0s)
        return wire_channelizer_packed(self.fmt, raw_u8, car, self.taps, decim=self.decim,
                                       n_in=self.n_in, folded=self.folded)
