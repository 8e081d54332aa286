"""Bit packing helpers.

HDLC transmits each octet LSB-first; the AIVDM 6-bit armoring reads the
deframed bytes MSB-first (reference: lib/pdu_to_nmea_impl.cc:70-73).  Both
orders are needed, so both are spelled out explicitly here.
"""

from __future__ import annotations

import numpy as np


def bytes_to_bits_lsb_first(data: bytes | np.ndarray) -> np.ndarray:
    """Expand bytes into bits, least-significant bit of each byte first."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    return np.unpackbits(arr, bitorder="little")


def bits_to_bytes_lsb_first(bits: np.ndarray) -> bytes:
    """Pack bits (LSB of each byte first) into bytes. len(bits) % 8 == 0."""
    bits = np.asarray(bits, dtype=np.uint8)
    if bits.size % 8 != 0:
        raise ValueError(f"bit count {bits.size} not a multiple of 8")
    return np.packbits(bits, bitorder="little").tobytes()


def bytes_to_bits_msb_first(data: bytes | np.ndarray) -> np.ndarray:
    """Expand bytes into bits, most-significant bit of each byte first."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    return np.unpackbits(arr, bitorder="big")


def bits_to_bytes_msb_first(bits: np.ndarray) -> bytes:
    bits = np.asarray(bits, dtype=np.uint8)
    if bits.size % 8 != 0:
        raise ValueError(f"bit count {bits.size} not a multiple of 8")
    return np.packbits(bits, bitorder="big").tobytes()
