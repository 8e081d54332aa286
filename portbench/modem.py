"""The benchmark's own copy of the AIS transmit chain and filter designs.

Plain NumPy, frozen here so that the yardstick does not move with the
program: HDLC framing (CRC-16/X.25 FCS, bit stuffing, flags, training
sequence), NRZI, the GMSK frequency pulse, the correlator's preamble
waveform, and the windowed-sinc low-pass that the receiver's channelizer
uses.  The formulas are the textbook ones the receiver is specified by
(ITU-R M.1371-5 framing; GNU Radio's `firdes.low_pass` and `gmsk_mod`).
Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

BIT_RATE = 9600.0
GMSK_BT = 0.4
TRAINING_BITS = np.array([0, 1] * 12, dtype=np.uint8)
FLAG = np.array([0, 1, 1, 1, 1, 1, 1, 0], dtype=np.uint8)
PREAMBLE_NRZI = (1, 1, 0, 0) * 7
RAMP_BITS = 8
TAIL_BITS = 8


def _crc_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for byte in range(256):
        crc = byte
        for _ in range(8):
            crc = (crc >> 1) ^ 0x8408 if crc & 1 else crc >> 1
        table[byte] = crc
    return table


_CRC = _crc_table()


def fcs(data: bytes) -> bytes:
    """CRC-16/X.25 of `data` as sent on the wire (low octet first)."""
    crc = 0xFFFF
    for byte in data:
        crc = (crc >> 8) ^ int(_CRC[(crc ^ byte) & 0xFF])
    crc ^= 0xFFFF
    return bytes((crc & 0xFF, crc >> 8))


def stuff(bits: np.ndarray) -> np.ndarray:
    """A 0 after every run of five 1s."""
    out, run = [], 0
    for b in bits.tolist():
        out.append(b)
        run = run + 1 if b else 0
        if run == 5:
            out.append(0)
            run = 0
    return np.array(out, dtype=np.uint8)


def frame_bits(payload: bytes) -> np.ndarray:
    """ramp zeros | training | flag | stuffed(payload + FCS, LSB first) |
    flag | tail ones: the line bits before NRZI."""
    body = np.unpackbits(np.frombuffer(payload + fcs(payload), np.uint8), bitorder="little")
    return np.concatenate([np.zeros(RAMP_BITS, np.uint8), TRAINING_BITS, FLAG, stuff(body),
                           FLAG, np.ones(TAIL_BITS, np.uint8)])


def nrzi(bits: np.ndarray, level: int = 1) -> np.ndarray:
    """NRZ-S: the level toggles on a 0 and holds on a 1."""
    return (level ^ (np.cumsum(bits == 0) & 1)).astype(np.uint8)


def sixbit_bytes(armored: str) -> bytes:
    """An AIVDM armored payload as the HDLC octets that carry it."""
    vals = np.array([ord(c) - 48 for c in armored], np.int64)
    vals = np.where(vals > 40, vals - 8, vals)
    bits = ((vals[:, None] >> np.arange(5, -1, -1)) & 1).reshape(-1).astype(np.uint8)
    return np.packbits(bits).tobytes()


def gaussian(sps: int, bt: float, ntaps: int) -> np.ndarray:
    """The GMSK Gaussian pulse, unit sum (float32, as designed)."""
    alpha = np.sqrt(np.log(2.0)) / (2.0 * np.pi * bt)
    t = (np.arange(ntaps, dtype=np.float64) - 0.5 * ntaps + 1.0) / sps
    g = np.exp(-0.5 * (t / alpha) ** 2)
    return (g / g.sum()).astype(np.float32)


def gmsk_pulse(sps: int, bt: float = GMSK_BT) -> np.ndarray:
    """Frequency pulse: the Gaussian (4 symbols) convolved with a
    one-symbol rectangle; its area is `sps`, so a symbol turns the
    phase by pi/2 under a sensitivity of (pi/2)/sps."""
    g = gaussian(sps, bt, 4 * sps).astype(np.float64)
    return np.convolve(g, np.ones(sps)).astype(np.float32).astype(np.float64)


def gmsk(levels: np.ndarray, sps: int, bt: float = GMSK_BT) -> np.ndarray:
    """GMSK of {0, 1} line levels: complex128, len(levels) * sps samples,
    causal (the pulse's leading edge first)."""
    sym = 2.0 * np.asarray(levels, np.float64) - 1.0
    up = np.zeros(sym.size * sps)
    up[::sps] = sym
    freq = np.convolve(up, gmsk_pulse(sps, bt))[: up.size]
    return np.exp(1j * np.cumsum(freq * (np.pi / 2.0) / sps))


def preamble(sps: int = 5, bt: float = GMSK_BT) -> np.ndarray:
    """The correlator's reference waveform: GMSK of [1,1,0,0]*7."""
    return gmsk(np.array(PREAMBLE_NRZI), sps, bt)


def low_pass(sample_rate: float, cutoff_hz: float, transition_hz: float) -> np.ndarray:
    """Hamming-windowed sinc, unit gain at DC, the 53 dB tap-count rule
    (odd); float64 of the float32 taps the receiver is built with."""
    ntaps = int(53.0 / (22.0 * transition_hz / sample_rate)) | 1
    m = (ntaps - 1) // 2
    n = np.arange(-m, m + 1, dtype=np.float64)
    w = 2.0 * np.pi * cutoff_hz / sample_rate
    h = np.where(n == 0, w / np.pi, np.sin(n * w) / (n * np.pi + (n == 0)))
    h = h * np.hamming(ntaps)
    return (h / h.sum()).astype(np.float32).astype(np.float64)
