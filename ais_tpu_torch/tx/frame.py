"""AIS transmit framing: payload -> HDLC wire bits -> NRZI levels.

The inverse of the receive chain, used for golden-capture synthesis (the
test strategy the reference lacks — see SURVEY.md section 4) and as the
modulate-vector capability.  Produces exactly the structure the receiver's
deframer expects: training sequence, 0x7E flags, bit-stuffed payload+FCS
(LSB-first octets), trailing flag.
"""

from __future__ import annotations

import numpy as np

from ais_tpu_torch.decode.crc import fcs_bytes
from ais_tpu_torch.decode.nmea import ascii_to_sixbit
from ais_tpu_torch.utils.bits import bytes_to_bits_lsb_first

TRAINING_BITS = np.array([0, 1] * 12, dtype=np.uint8)  # 24 alternating bits
FLAG = np.array([0, 1, 1, 1, 1, 1, 1, 0], dtype=np.uint8)


def stuff(bits: np.ndarray) -> np.ndarray:
    """Insert a 0 after every run of five consecutive 1s."""
    out: list[int] = []
    run = 0
    for b in np.asarray(bits, dtype=np.uint8):
        out.append(int(b))
        if b == 1:
            run += 1
            if run == 5:
                out.append(0)
                run = 0
        else:
            run = 0
    return np.array(out, dtype=np.uint8)


def frame_bits(payload: bytes, ramp_bits: int = 8) -> np.ndarray:
    """Payload octets -> full wire bit sequence (pre-NRZI).

    ramp zeros | training 0101... | flag | stuffed(payload+FCS) | flag
    """
    body = payload + fcs_bytes(payload)
    stuffed = stuff(bytes_to_bits_lsb_first(body))
    return np.concatenate(
        [np.zeros(ramp_bits, dtype=np.uint8), TRAINING_BITS, FLAG, stuffed, FLAG]
    )


def nrzi_encode(bits: np.ndarray, initial_level: int = 1) -> np.ndarray:
    """NRZI (NRZ-S): the level toggles on a 0 bit, holds on a 1 bit.

    The receiver inverts this with diff-decode + bit-invert
    (reference: python/ais_demod.py:51-52, lib/invert_impl.cc:62-64).
    """
    bits = np.asarray(bits, dtype=np.uint8)
    # level[n] = initial_level XOR (number of zeros among bits[0..n]) mod 2
    toggles = np.cumsum(bits == 0) & 1
    return (initial_level ^ toggles).astype(np.uint8)


def aivdm_payload_to_bytes(ascii_payload: str, npad: int = 0) -> bytes:
    """AIVDM armored payload chars -> the HDLC payload octets that would
    have produced them.  Total bits (6*nchars - npad) must be octet-aligned."""
    symbols = ascii_to_sixbit(ascii_payload)
    bits = ((symbols[:, None] >> np.arange(5, -1, -1)) & 1).reshape(-1)
    if npad:
        bits = bits[:-npad]
    if bits.size % 8 != 0:
        raise ValueError(f"payload bit count {bits.size} not octet-aligned")
    return np.packbits(bits.astype(np.uint8), bitorder="big").tobytes()


def make_packet_iq(
    payload: bytes,
    samples_per_symbol: int = 5,
    bt: float = 0.4,
    ramp_bits: int = 8,
    tail_bits: int = 8,
    phase0: float = 0.0,
) -> np.ndarray:
    """Payload -> GMSK complex baseband burst at `sps` samples/symbol.

    `tail_bits` buffer bits follow the closing flag (as on-air AIS does)
    so the Gaussian pulse tail doesn't truncate mid-flag.
    """
    from ais_tpu_torch.tx.gmsk import modulate_bits

    wire = frame_bits(payload, ramp_bits)
    wire = np.concatenate([wire, np.ones(tail_bits, dtype=np.uint8)])
    levels = nrzi_encode(wire)
    return modulate_bits(levels, samples_per_symbol, bt, phase0)
