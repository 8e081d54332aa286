"""HDLC deframing: flag search, bit-unstuffing, CRC-16 validation.

TPU-native equivalent of GNU Radio's `digital.hdlc_deframer_bp(11, 64)`
(reference: python/radio.py:64).  The reference runs this as a sequential
per-bit state machine on a stream thread; here the demodulator hands us a
*bounded per-burst bit tensor* (bursts are <= a few hundred symbols), so
deframing becomes small-array vectorized ops on the host — the TPU keeps
the sample-rate math, the host keeps the byte-rate math.

Behavioral contract (matching the upstream deframer):
  - frames are delimited by 0x7E flags (bit pattern 0,1,1,1,1,1,1,0 in
    transmission order);
  - inside a frame, a 0 following five consecutive 1s is stuffing and is
    removed; six or more consecutive 1s invalidate the candidate frame;
  - the unstuffed frame must be a whole number of octets, within
    [min_len, max_len] *payload* octets (FCS excluded);
  - octets are packed LSB-first (HDLC wire order);
  - the last two octets are the FCS: CRC-16/X.25 of the payload,
    little-endian; frames failing the check are dropped;
  - the emitted frame payload excludes the FCS.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ais_tpu_torch.decode.crc import check_frame
from ais_tpu_torch.utils.bits import bits_to_bytes_lsb_first

FLAG_BITS = np.array([0, 1, 1, 1, 1, 1, 1, 0], dtype=np.uint8)


@dataclass(frozen=True)
class Frame:
    """One successfully deframed HDLC payload."""

    payload: bytes          # FCS stripped
    start_bit: int          # index (in the input bit array) of opening flag
    end_bit: int            # index just past the closing flag


def find_flags(bits: np.ndarray) -> np.ndarray:
    """Indices where the 8-bit HDLC flag begins."""
    bits = np.asarray(bits, dtype=np.uint8)
    if bits.size < 8:
        return np.zeros(0, dtype=np.int64)
    win = np.lib.stride_tricks.sliding_window_view(bits, 8)
    return np.nonzero((win == FLAG_BITS).all(axis=1))[0]


def unstuff(bits: np.ndarray) -> np.ndarray | None:
    """Remove stuffed zeros; None if the run structure is invalid.

    A 0 that follows exactly five consecutive 1s was inserted by the
    transmitter and is dropped.  Any run of >= 6 ones cannot occur inside
    a stuffed frame, so the candidate is rejected.
    """
    bits = np.asarray(bits, dtype=np.uint8)
    n = bits.size
    if n == 0:
        return bits
    # ones_run[i] = length of the run of consecutive ones ending at i.
    idx = np.arange(n)
    zero_pos = np.where(bits == 0, idx, -1)
    last_zero = np.maximum.accumulate(zero_pos)
    ones_run = idx - last_zero
    if (ones_run >= 6).any():
        return None
    # Drop any 0 whose preceding run of ones is exactly 5.
    prev_run = np.concatenate(([0], ones_run[:-1]))
    stuffed = (bits == 0) & (prev_run == 5)
    return bits[~stuffed]


def deframe(
    bits: np.ndarray,
    min_len: int = 11,
    max_len: int = 64,
) -> list[Frame]:
    """Extract all CRC-valid HDLC frames from an unpacked bit array.

    Candidate frames are the spans between consecutive flag patterns, as
    in the reference's sequential state machine where each flag both
    closes one frame and opens the next.
    """
    bits = np.asarray(bits, dtype=np.uint8)
    flags = find_flags(bits)
    frames: list[Frame] = []
    for a, b in zip(flags[:-1], flags[1:]):
        inner = bits[a + 8 : b]
        # Closing flag overlapping the candidate body means b was a
        # spurious/shared match; bounds below reject degenerate spans.
        if inner.size < 8:
            continue
        unstuffed = unstuff(inner)
        if unstuffed is None or unstuffed.size % 8 != 0:
            continue
        nbytes = unstuffed.size // 8
        payload_len = nbytes - 2  # FCS excluded
        if not (min_len <= payload_len <= max_len):
            continue
        frame_bytes = bits_to_bytes_lsb_first(unstuffed)
        if not check_frame(frame_bytes):
            continue
        frames.append(
            Frame(payload=frame_bytes[:-2], start_bit=int(a), end_bit=int(b) + 8)
        )
    return frames
