"""CRC-16/X.25 (HDLC FCS), as checked by the reference's deframer.

The reference relies on GNU Radio's `digital.hdlc_deframer_bp`
(reference: python/radio.py:64) whose frame check sequence is the standard
HDLC/X.25 CRC: reflected poly 0x1021 (i.e. 0x8408), init 0xFFFF, final
XOR 0xFFFF, FCS appended little-endian.  Implemented table-driven over
numpy so large batches of candidate frames stay vectorizable.
"""

from __future__ import annotations

import numpy as np

_POLY_REFLECTED = 0x8408


def _build_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint16)
    for byte in range(256):
        crc = byte
        for _ in range(8):
            if crc & 1:
                crc = (crc >> 1) ^ _POLY_REFLECTED
            else:
                crc >>= 1
        table[byte] = crc
    return table


_TABLE = _build_table()


def crc16_x25(data: bytes | np.ndarray) -> int:
    """CRC-16/X.25 of `data`. crc16_x25(b"123456789") == 0x906E."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    crc = np.uint16(0xFFFF)
    for byte in arr:
        crc = np.uint16((crc >> 8) ^ _TABLE[(crc ^ byte) & 0xFF])
    return int(crc ^ 0xFFFF)


def fcs_bytes(data: bytes | np.ndarray) -> bytes:
    """FCS as transmitted on the wire: CRC little-endian (low octet first)."""
    crc = crc16_x25(data)
    return bytes((crc & 0xFF, crc >> 8))


def check_frame(frame: bytes | np.ndarray) -> bool:
    """True if `frame` (payload + 2-byte FCS) passes the HDLC check.

    Matches the acceptance rule of `digital.hdlc_deframer_bp`: the CRC of
    everything but the last two octets must equal those octets (LE).
    """
    frame = bytes(frame)
    if len(frame) < 3:
        return False
    return fcs_bytes(frame[:-2]) == frame[-2:]
