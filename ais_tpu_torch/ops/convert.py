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

`select_wire_format` (host numpy, a copy of the reference's) judges a
capture against the 1-bit formats' envelope (`wire_format_envelope`):
outside it the capture rides ci8, near cr1's noise floor ci1.
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


def iq_from_bytes(raw_u8: torch.Tensor, fmt: str, n_samples: int) -> torch.Tensor:
    """One step's wire bytes of any format -> complex64 on the tensor's
    device: (n_samples,) for a full step (cr1 and cd1 need `n_samples`
    for their framing; the others hold whole samples)."""
    if fmt in _FRAMED:
        return _FRAMED[fmt](raw_u8, n_samples)
    if fmt in _UNFRAMED:
        return _UNFRAMED[fmt](raw_u8)
    raise ValueError(f"unsupported wire format {fmt!r}")


_UNFRAMED = {"ci16": iq_from_bytes_ci16, "ci8": iq_from_bytes_ci8, "cu8": iq_from_bytes_cu8,
             "ci4": iq_from_bytes_ci4, "ci2": iq_from_bytes_ci2, "ci1": iq_from_bytes_ci1}
_FRAMED = {"cr1": iq_from_bytes_cr1, "cd1": iq_from_bytes_cd1}


def cd1_bytes_from_ci1(ci1_bytes: np.ndarray, n_samples: int) -> np.ndarray:
    """Host-side ci1 -> cd1 transform (see ci1_from_bytes_cd1)."""
    bits = np.unpackbits(np.asarray(ci1_bytes, np.uint8))[: 2 * n_samples]

    def delta(b):
        d = b.copy()
        d[1:] ^= b[:-1]
        return np.packbits(d)

    return np.concatenate([delta(bits[0::2]), delta(bits[1::2])])


def _sigma_delta_ci1_numpy(iq: np.ndarray, scale: float) -> np.ndarray:
    """Pure-numpy twin of `ais_tpu_torch.native.sigma_delta_ci1` (slow)."""
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
    """Pure-numpy twin of `ais_tpu_torch.native.sigma_delta_cr1` (slow).

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
    from ais_tpu_torch import native

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


def wire_format_envelope(
    iq: np.ndarray,
    rate: float = 2.4e6,
    offsets: tuple = (-25e3, +25e3),
    band_hz: float = 15e3,
) -> dict:
    """Capture statistics the 1-bit wire formats' envelopes are judged by.

    Returns:
      near_far_db — in-band power ratio between the strongest and the
        weakest ACTIVE channel (0 when fewer than two channels are
        above the noise floor, so an idle channel never trips the
        near-far guard).
      interferer_db — strongest narrowband out-of-band feature vs the
        strongest in-band feature (smoothed PSD peaks).  A positive
        value means something outside the AIS channels dominates the
        capture and will set the peak-referenced sigma-delta scale.
      channel_snr_db — per channel: peak over chunks of the in-band
        tone-to-floor ratio, 10*log10(noise-subtracted in-band power /
        in-band noise power), -99 when the channel never registered
        activity.  This is the proxy the sensitivity gate judges
        (select_wire_format): measured against calibrated AWGN scenes
        (wire_sweep.py part 2's Eb/N0 convention) it tracks
        Eb/N0 - ~3.9 dB with unit slope over the 10-30 dB decode range
        (the in-band window integrates ~30 kHz of noise against a
        9600 bit/s GMSK tone; tests/test_wire_select.py pins the
        calibration).
    """
    # PSDs over chunks spread across the WHOLE buffer, judged PER CHUNK:
    # AIS traffic is bursty (a packet is ~27 ms), so whole-capture power
    # integration dilutes a weak burst below the noise floor and a
    # leading-chunk-only analysis can miss every transmission.  Activity
    # and channel power are per-chunk peaks (noise-subtracted), so a
    # single weak burst anywhere in the buffer counts at its in-burst
    # strength.
    n = min(int(iq.size), 1 << 17)  # ~55 ms at 2.4 Msps: one burst fits
    # 75%-overlapped chunks (hop n/4): a ~27 ms burst then sits within
    # ±n/8 of SOME chunk's center, bounding its Hanning edge loss to
    # ~1 dB — with the old disjoint chunks a burst straddling a chunk
    # boundary read up to ~10 dB low and spuriously tripped the
    # sensitivity gate.  Beyond the 48-chunk cap (captures > ~0.7 s)
    # chunks spread evenly: the statistics become a sample, which bursty
    # AIS traffic (one packet per slot per vessel) keeps representative.
    n_chunks = max(1, min(48, 1 + 4 * (int(iq.size) - n) // n))
    win = np.hanning(n).astype(np.float32)
    freqs = np.fft.fftfreq(n, 1.0 / rate)
    masks = [np.abs(freqs - off) <= band_hz for off in offsets]
    in_mask = np.zeros(n, bool)
    for m in masks:
        in_mask |= m
    # ~1 kHz smoothing: an interferer is a narrowband feature, not a bin.
    w = max(int(1e3 / rate * n), 1)
    kern = np.ones(w) / w
    tiny = 1e-30
    ch_peak = [0.0] * len(offsets)
    ch_active = [False] * len(offsets)
    ch_dominant = [False] * len(offsets)
    ch_snr = [-99.0] * len(offsets)
    interferer_db = -np.inf
    # A transmission's own spectral skirt lands in the ADJACENT channel
    # ~40-46 dB down (GMSK BT=0.4 at 2x the channel spacing, plus burst
    # ramps): in-band power within this bound of a same-chunk stronger
    # channel is that channel's skirt, not a second transmission, and
    # must not register as near-far "activity" (a lone strong
    # transmitter would otherwise force a permanent ci8 fallback).
    SKIRT_BOUND = 1e-4  # -40 dBc
    for c in range(n_chunks):
        start = (int(iq.size) - n) * c // max(n_chunks - 1, 1)
        x = np.asarray(iq[start : start + n], np.complex64) * win
        psd = np.abs(np.fft.fft(x)) ** 2
        floor = float(np.median(psd))  # per-bin noise floor, this chunk
        p_sub = []
        for m in masks:
            nb = int(m.sum())
            p = float(psd[m].sum())
            p_sub.append(p - floor * nb if p > 3.0 * floor * nb else 0.0)
        strongest = max(p_sub)
        for ci, (p, m) in enumerate(zip(p_sub, masks)):
            if p > 0.0 and p > SKIRT_BOUND * strongest:
                ch_active[ci] = True
                ch_peak[ci] = max(ch_peak[ci], p)
                if p == strongest:
                    # Dominant in its own slot's chunk: a genuine
                    # transmission, however weak globally (AIS is TDMA —
                    # a far vessel owns its slot while the near one is
                    # silent).  Exempt from the global skirt post-pass.
                    ch_dominant[ci] = True
                nb = int(m.sum())
                ch_snr[ci] = max(
                    ch_snr[ci],
                    10.0 * np.log10(p / max(floor * nb, tiny)),
                )
        sm = np.convolve(psd, kern, mode="same")
        peak_in = float(sm[in_mask].max()) if in_mask.any() else tiny
        peak_out = float(sm[~in_mask].max()) if (~in_mask).any() else tiny
        interferer_db = max(
            interferer_db,
            10.0 * np.log10(max(peak_out, tiny) / max(peak_in, tiny)),
        )
    # Global skirt post-pass: the per-chunk bound compares against that
    # chunk's strongest channel, but a chunk catching only a burst's
    # ramp transient sees little of the carrier and lets the ramp's
    # wideband splatter register the OTHER channel as active (with the
    # 75%-overlap chunking this happens reliably).  A channel whose
    # best showing across the whole capture is below -40 dBc of the
    # strongest channel's best showing AND that was never the dominant
    # in-band channel of any chunk is skirt/splatter, not a
    # transmission.  The dominance exemption keeps a genuine far vessel
    # (own TDMA slot, arbitrarily weak globally) active, so an extreme
    # near-far capture still takes the ci8 fallback it needs (an
    # unconditioned post-pass would silently bypass it).
    strongest_peak = max(ch_peak)
    for ci, p in enumerate(ch_peak):
        if (
            ch_active[ci]
            and not ch_dominant[ci]
            and p < SKIRT_BOUND * strongest_peak
        ):
            ch_active[ci] = False
            ch_snr[ci] = -99.0
    act = [p for p, a in zip(ch_peak, ch_active) if a]
    near_far_db = (
        10.0 * np.log10(max(act) / max(min(act), tiny)) if len(act) >= 2 else 0.0
    )
    return {
        "near_far_db": float(near_far_db),
        "interferer_db": float(interferer_db),
        "channels_active": ch_active,
        "channel_snr_db": [float(s) for s in ch_snr],
    }


def select_wire_format(
    iq: np.ndarray,
    preferred: str = "cr1",
    rate: float = 2.4e6,
    offsets: tuple = (-25e3, +25e3),
    near_far_limit_db: float = 24.0,
    interferer_limit_db: float = 6.0,
    min_snr_db: float = 15.5,
) -> tuple[str, str]:
    """Auto-fallback for the 1-bit ingest formats: (format, reason).

    cr1/ci1 buy ingest bandwidth with a peak-referenced 1-bit encode
    whose measured envelopes are 28/26 dB near-far (tests/
    test_wideband.py) and "the AIS channels dominate the capture"
    (the sigma-delta scale is set by the total peak: a strong
    out-of-band interferer pushes the wanted channels toward the
    quantization floor).  When the capture's statistics exceed those
    envelopes — checked per buffer, WIRE.md for the measured bounds —
    fall back to the linear ci8 wire (full front-end dynamic range at
    4x the bytes) instead of silently losing weak packets.  The limits
    sit a few dB inside the tested bounds.

    `min_snr_db` is the AWGN-floor (sensitivity) gate:
    cr1's packet success falls off below Eb/N0 ~18-20 dB while
    ci1 matches the float path to ~1 dB (WIRE.md sensitivity table —
    an envelope the near-far and interferer guards do not check).  When the
    weakest ACTIVE channel's in-band SNR proxy (channel_snr_db, which
    tracks Eb/N0 - ~3.9 dB) is below this margin, a cr1 preference
    falls back to ci1: same 1-bit sigma-delta family at 2x the bytes,
    float-equivalent sensitivity.  The default 15.5 dB corresponds to
    Eb/N0 ~19.4 dB — right at cr1's measured >=95%-success floor
    (20 dB), so captures below the crossover ride ci1.  An idle
    channel (never active in any chunk) does not trip the gate.
    """
    if preferred not in ("cr1", "ci1", "cd1"):
        return preferred, "linear format: no envelope to check"
    env = wire_format_envelope(iq, rate=rate, offsets=offsets)
    if env["interferer_db"] > interferer_limit_db:
        return (
            "ci8",
            f"out-of-band interferer {env['interferer_db']:.1f} dB above "
            f"the AIS channels (> {interferer_limit_db:.0f} dB limit)",
        )
    if env["near_far_db"] > near_far_limit_db:
        return (
            "ci8",
            f"near-far imbalance {env['near_far_db']:.1f} dB "
            f"(> {near_far_limit_db:.0f} dB limit)",
        )
    if preferred == "cr1":
        act_snr = [
            s
            for s, a in zip(env["channel_snr_db"], env["channels_active"])
            if a
        ]
        if act_snr and min(act_snr) < min_snr_db:
            return (
                "ci1",
                f"in-band SNR {min(act_snr):.1f} dB below the cr1 "
                f"sensitivity margin ({min_snr_db:.1f} dB ~ Eb/N0 "
                f"{min_snr_db + 3.9:.0f} dB, cr1's measured AWGN floor "
                f"- WIRE.md): ci1 holds float-path sensitivity",
            )
    return preferred, "within envelope"
