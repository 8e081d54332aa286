"""Wire formats: decode on the tensor's device, encode on the host.

Port of `ais_tpu/ops/convert.py`.  SDRs emit interleaved integer IQ;
shipping those bytes (or a packed form) and decoding on the device cuts
host-to-device traffic 2-8x against complex64.  Formats, bytes a sample:

  ci16  4     int16 I, Q little-endian, scale 1/32768
  ci8   2     int8 I, Q, scale 1/128
  cu8   2     uint8 offset-binary I, Q (rtl_sdr), (v - 127.5)/127.5
  ci4   1     (I << 4) | Q, 4-bit two's complement, scale 1/8
  ci2   1/2   I0 Q0 I1 Q1 as 2-bit Lloyd-Max codes, MSB first (AGC'd)
  ci1   1/4   I0 Q0 .. I3 Q3, first-order sigma-delta bits, MSB first
  cd1   1/4   ci1's I and Q bit planes, each delta-coded (+1 pad byte
              when n % 8 == 4)
  cr1   1/8   real bits of the fs/4-IF stream, second-order bandpass
              sigma-delta, MSB first

On the receiver's path the 1/2/4-bit formats are decoded inside the
wire channelizer kernels (ops/wire_channelizer.py); the decoders here
are their plain readings (the kernels' plain versions use them), and
the ci16/ci8 decode runs ahead of the float channelizer (K5).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Encoder headroom: the 99.9th-percentile component amplitude maps to
# this fraction of the quantizer level (reference CI1_HEADROOM /
# CR1_HEADROOM).
CI1_HEADROOM = 0.7
CR1_HEADROOM = 0.6
# NTF z^-2 coefficient (NTF = 1 + a2 z^-2 + z^-4): the two zeros split
# onto the AIS channels at fs/4 +- 25 kHz (reference CR1_A2).
CR1_A2 = 2.0 - 4.0 * math.cos(2.0 * math.pi * (0.25 - 25e3 / 2.4e6)) ** 2

# Lloyd-Max 4-level quantizer for a unit-variance Gaussian (Max 1960):
# thresholds {-t, 0, +t}, levels {-b, -a, +a, +b}.
CI2_THRESH = 0.9816
CI2_INNER = 0.4528
CI2_OUTER = 1.5104


def cr1_wire_nbytes(n_samples: int) -> int:
    """Wire bytes for one n-sample cr1 step (last byte zero-padded)."""
    return -(-n_samples // 8)


def cd1_wire_nbytes(n_samples: int) -> int:
    """Wire bytes for one n-sample cd1 step (two padded bit planes)."""
    return 2 * (-(-n_samples // 8))


def _shifts(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.int32, device=device)


def iq_from_bytes_ci16(raw_u8: torch.Tensor, scale: float = 1.0 / 32768.0) -> torch.Tensor:
    """(4n,) uint8 little-endian int16 interleaved IQ -> (n,) complex64."""
    v = raw_u8.to(torch.int32).reshape(-1, 4)
    u_i = v[:, 0] + v[:, 1] * 256
    u_q = v[:, 2] + v[:, 3] * 256
    re = (u_i - 65536 * (u_i >= 32768).to(torch.int32)).to(torch.float32) * scale
    im = (u_q - 65536 * (u_q >= 32768).to(torch.int32)).to(torch.float32) * scale
    return torch.complex(re, im)


def iq_from_bytes_ci8(raw_u8: torch.Tensor, scale: float = 1.0 / 128.0) -> torch.Tensor:
    """(2n,) uint8 holding int8 interleaved IQ -> (n,) complex64."""
    v = raw_u8.view(torch.int8).to(torch.float32).reshape(-1, 2) * scale
    return torch.complex(v[:, 0], v[:, 1])


def iq_from_bytes_cu8(raw_u8: torch.Tensor) -> torch.Tensor:
    """(2n,) uint8 offset-binary (rtl_sdr) interleaved IQ -> (n,) complex64."""
    v = ((raw_u8.to(torch.float32) - 127.5) * (1.0 / 127.5)).reshape(-1, 2)
    return torch.complex(v[:, 0], v[:, 1])


def iq_from_bytes_ci4(raw_u8: torch.Tensor, scale: float = 1.0 / 8.0) -> torch.Tensor:
    """(n,) uint8, each byte (I << 4) | Q as 4-bit two's complement ->
    (n,) complex64."""
    v = raw_u8.to(torch.int32)
    i = v >> 4
    q = v & 15
    i = i - 16 * (i >= 8).to(torch.int32)
    q = q - 16 * (q >= 8).to(torch.int32)
    return torch.complex(i.to(torch.float32) * scale, q.to(torch.float32) * scale)


def ci2_levels(device=None) -> torch.Tensor:
    """Code c -> Lloyd-Max level sign(c - 1.5) * (inner | outer), float32."""
    return torch.tensor([-CI2_OUTER, -CI2_INNER, CI2_INNER, CI2_OUTER],
                        dtype=torch.float32, device=device)


def iq_from_bytes_ci2(raw_u8: torch.Tensor) -> torch.Tensor:
    """(n/2,) uint8, each byte I0 Q0 I1 Q1 as 2-bit codes (MSB first) ->
    (n,) complex64 at the Lloyd-Max levels."""
    codes = (raw_u8.to(torch.int32)[:, None] >> _shifts((6, 4, 2, 0), raw_u8.device)) & 3
    lv = ci2_levels(raw_u8.device)[codes.reshape(-1, 2).long()]  # (n, 2): I, Q
    return torch.complex(lv[:, 0], lv[:, 1])


def iq_from_bytes_ci1(raw_u8: torch.Tensor) -> torch.Tensor:
    """(n/4,) uint8 sigma-delta 1-bit IQ, MSB-first I0 Q0 .. I3 Q3 ->
    (n,) complex64 at levels +-1."""
    bits = (raw_u8.to(torch.int32)[:, None] >> _shifts(range(7, -1, -1), raw_u8.device)) & 1
    lv = bits.reshape(-1, 2).to(torch.float32) * 2.0 - 1.0
    return torch.complex(lv[:, 0], lv[:, 1])


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


def _spread8(b: torch.Tensor) -> torch.Tensor:
    """Bit j of each byte -> bit 2j of an int32 (Morton interleave half)."""
    t = b & 0xFF
    t = (t | (t << 4)) & 0x0F0F
    t = (t | (t << 2)) & 0x3333
    return (t | (t << 1)) & 0x5555


def ci1_from_bytes_cd1(raw_u8: torch.Tensor, n_samples: int) -> torch.Tensor:
    """cd1 wire bytes -> ci1 wire bytes, on the tensor's device.

    cd1 is ci1 with the I and Q bit planes separated and delta-coded
    (bit[k] ^ bit[k-1]), each plane `ceil(n/8)` bytes, MSB first: the
    framing is per buffer.  Undoing the delta is a prefix XOR: inside a
    byte by shifts, across bytes by the parity of all earlier bytes
    (an integer cumulative sum, exclusive, mod 2)."""
    nb = -(-n_samples // 8)
    v = raw_u8.to(torch.int32)

    def plane(d: torch.Tensor) -> torch.Tensor:
        x = d ^ (d >> 1)
        x = x ^ (x >> 2)
        x = x ^ (x >> 4)           # bit j (from the MSB) = XOR of bits 0..j
        parity = x & 1
        carry = ((torch.cumsum(parity, 0) - parity) & 1).to(torch.int32)
        return x ^ (carry * 0xFF)

    o16 = (_spread8(plane(v[:nb])) << 1) | _spread8(plane(v[nb: 2 * nb]))
    pair = torch.stack([(o16 >> 8) & 0xFF, o16 & 0xFF], dim=-1)
    return pair.reshape(2 * nb).to(torch.uint8)[: n_samples // 4]


def iq_from_bytes_cd1(raw_u8: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(2*ceil(n/8),) cd1 bytes -> (n,) complex64 at levels +-1."""
    return iq_from_bytes_ci1(ci1_from_bytes_cd1(raw_u8, n_samples))


def cd1_bytes_from_ci1(ci1_bytes: np.ndarray, n_samples: int) -> np.ndarray:
    """Host-side ci1 -> cd1 transform (see ci1_from_bytes_cd1)."""
    bits = np.unpackbits(np.asarray(ci1_bytes, np.uint8))[: 2 * n_samples]

    def delta(b):
        d = b.copy()
        d[1:] ^= b[:-1]
        return np.packbits(d)

    return np.concatenate([delta(bits[0::2]), delta(bits[1::2])])


def _sigma_delta_ci1_numpy(iq: np.ndarray, scale: float) -> np.ndarray:
    """Pure-numpy twin of `ais_tpu.native.sigma_delta_ci1` (slow)."""
    re = iq.real.astype(np.float64) * scale
    im = iq.imag.astype(np.float64) * scale
    bits = np.empty(2 * iq.size, np.uint8)  # I0 Q0 I1 Q1 ... transmission order
    ei = eq = 0.0
    for n in range(iq.size):
        si = re[n] + ei
        sq = im[n] + eq
        bi = 1 if si >= 0 else 0
        bq = 1 if sq >= 0 else 0
        ei = min(4.0, max(-4.0, si - (2 * bi - 1)))
        eq = min(4.0, max(-4.0, sq - (2 * bq - 1)))
        bits[2 * n] = bi
        bits[2 * n + 1] = bq
    return np.packbits(bits)


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


def _peak_scale(iq: np.ndarray, headroom: float) -> float:
    """Peak-referenced sigma-delta scale: the larger of the 99.9th
    percentile and half the maximum component amplitude maps to
    `headroom` (so a sparse scene's quiet gaps do not set it)."""
    comps = np.abs(np.concatenate([iq.real, iq.imag]))
    peak = float(max(np.percentile(comps, 99.9), 0.5 * comps.max())) or 1.0
    return headroom / peak


def _interleave(i: np.ndarray, q: np.ndarray, dtype) -> np.ndarray:
    out = np.empty(i.size * 2, dtype=dtype)
    out[0::2] = i
    out[1::2] = q
    return out


def host_bytes(iq: np.ndarray, fmt: str, *, ci2_dither: float = 0.2,
               headroom: float | None = None) -> np.ndarray:
    """Encode complex IQ into the uint8 wire view of `fmt`.

    Byte-identical to the reference's `host_bytes`.  `ci2_dither`:
    Gaussian dither for the 2-bit encode as a fraction of the buffer's
    per-component RMS (fixed seed; 0 disables).  `headroom` overrides
    the sigma-delta headroom of ci1/cd1/cr1.  The sigma-delta loops use
    the native encoder when its library builds and the bit-identical
    numpy twin otherwise.
    """
    from ais_tpu import native

    if fmt in ("ci16", "cs16"):
        i = np.round(np.clip(iq.real, -1, 1 - 1 / 32768) * 32768).astype("<i2")
        q = np.round(np.clip(iq.imag, -1, 1 - 1 / 32768) * 32768).astype("<i2")
        return _interleave(i, q, "<i2").view(np.uint8)
    if fmt in ("ci8", "cs8"):
        i = np.round(np.clip(iq.real, -1, 1 - 1 / 128) * 128).astype(np.int8)
        q = np.round(np.clip(iq.imag, -1, 1 - 1 / 128) * 128).astype(np.int8)
        return _interleave(i, q, np.int8).view(np.uint8)
    if fmt == "ci4":
        i = np.round(np.clip(iq.real, -1, 1 - 1 / 8) * 8).astype(np.int32) & 15
        q = np.round(np.clip(iq.imag, -1, 1 - 1 / 8) * 8).astype(np.int32) & 15
        return ((i << 4) | q).astype(np.uint8)
    if fmt == "ci2":
        if iq.size % 2:
            raise ValueError("ci2 packs 2 samples/byte: need even sample count")
        # AGC'd Lloyd-Max encode: normalize the buffer to unit
        # per-component RMS, then threshold at {-t, 0, +t}.
        rms = float(np.sqrt(0.5 * np.mean(np.abs(iq) ** 2))) or 1.0
        t = CI2_THRESH * rms
        re, im = iq.real, iq.imag
        if ci2_dither:
            rng = np.random.default_rng(0xC12)
            amp = ci2_dither * rms
            re = re + rng.normal(size=iq.size) * amp
            im = im + rng.normal(size=iq.size) * amp

        def enc(x):  # code = number of thresholds below x
            return (x > -t).astype(np.int32) + (x > 0) + (x > t)

        i, q = enc(re), enc(im)
        return ((i[0::2] << 6) | (q[0::2] << 4) | (i[1::2] << 2) | q[1::2]).astype(np.uint8)
    if fmt == "ci1":
        if iq.size % 4:
            raise ValueError("ci1 packs 4 samples/byte: need size % 4 == 0")
        scale = _peak_scale(iq, CI1_HEADROOM if headroom is None else headroom)
        iq = np.ascontiguousarray(iq, np.complex64)
        if native.available():
            return native.sigma_delta_ci1(iq, scale)
        return _sigma_delta_ci1_numpy(iq, scale)
    if fmt == "cd1":
        # As in the reference, cd1 encodes at ci1's default headroom.
        return cd1_bytes_from_ci1(host_bytes(iq, "ci1"), iq.size)
    if fmt == "cr1":
        scale = _peak_scale(iq, CR1_HEADROOM if headroom is None else headroom)
        iq = np.ascontiguousarray(iq, np.complex64)
        if native.available():
            return native.sigma_delta_cr1(iq, scale, CR1_A2)
        return _sigma_delta_cr1_numpy(iq, scale, CR1_A2)
    if fmt == "cu8":
        i = np.round(np.clip(iq.real, -1, 1) * 127.5 + 127.5).astype(np.uint8)
        q = np.round(np.clip(iq.imag, -1, 1) * 127.5 + 127.5).astype(np.uint8)
        return _interleave(i, q, np.uint8)
    raise ValueError(f"unsupported format {fmt!r}")
