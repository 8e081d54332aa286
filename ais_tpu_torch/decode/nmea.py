"""AIS payload -> NMEA 0183 !AIVDM sentence encoding.

Equivalent of the reference's `pdu_to_nmea` message block
(reference: lib/pdu_to_nmea_impl.cc:63-131):

  - payload octets are read MSB-first and regrouped into 6-bit symbols,
    with `npad = (6 - nbits % 6) % 6` zero pad bits completing the final
    symbol (lib/pdu_to_nmea_impl.cc:63-79);
  - symbols are armored to ASCII: +48, and +8 first if the symbol value
    exceeds 39 (lib/pdu_to_nmea_impl.cc:81-88);
  - sentences are fragmented at 56 payload characters and carry an XOR
    checksum over everything between '!' and '*'
    (lib/pdu_to_nmea_impl.cc:90-125).

Divergence from the reference, on purpose: for payloads that are not a
multiple of 6 bits the reference left-shifts the final (already
MSB-aligned) symbol `npad` more times, overflowing its bits to zero
(lib/pdu_to_nmea_impl.cc:74-76 — flagged "TODO: test with padding more
thoroughly").  Standard AIS payloads are whole octets in multiples of 6
bits so the bug is latent there; here the final symbol keeps its bits
MSB-aligned and zero-padded, which is the correct ITU-R M.1371 armoring.
"""

from __future__ import annotations

import numpy as np

from ais_tpu_torch.utils.bits import bytes_to_bits_msb_first

NMEA_MAX_PAYLOAD_CHARS = 56  # fragmentation point (lib/pdu_to_nmea_impl.cc:103)


def payload_to_sixbit(payload: bytes | np.ndarray) -> tuple[np.ndarray, int]:
    """Regroup payload octets (MSB-first) into 6-bit symbols + pad count."""
    bits = bytes_to_bits_msb_first(payload)
    nbits = bits.size
    npad = (6 - nbits % 6) % 6
    padded = np.concatenate([bits, np.zeros(npad, dtype=np.uint8)])
    symbols = padded.reshape(-1, 6) @ (1 << np.arange(5, -1, -1)).astype(np.uint8)
    return symbols.astype(np.uint8), npad


def sixbit_to_ascii(symbols: np.ndarray) -> str:
    """AIVDM payload armoring: chr(sym + 48), +8 more when sym > 39."""
    vals = symbols.astype(np.int64)
    vals = np.where(vals > 39, vals + 8, vals) + 48
    return "".join(chr(v) for v in vals)


def ascii_to_sixbit(payload: str) -> np.ndarray:
    """Inverse armoring (for tests and the TX path)."""
    vals = np.array([ord(c) - 48 for c in payload], dtype=np.int64)
    vals = np.where(vals > 40, vals - 8, vals)
    if (vals < 0).any() or (vals > 63).any():
        raise ValueError("invalid AIVDM payload character")
    return vals.astype(np.uint8)


def nmea_checksum(sentence: str) -> int:
    """XOR of all characters, skipping a leading '!'."""
    body = sentence[1:] if sentence.startswith("!") else sentence
    out = 0
    for ch in body:
        out ^= ord(ch)
    return out


def to_sentences(ascii_payload: str, npad: int, designator: str = "A") -> list[str]:
    """Build the (possibly fragmented) !AIVDM sentence list.

    Matches lib/pdu_to_nmea_impl.cc:99-125: fragment at 56 chars, empty
    sequential-message-id field, pad count on every fragment, two-digit
    uppercase hex checksum.
    """
    num_frags = 1 + (max(len(ascii_payload), 1) - 1) // NMEA_MAX_PAYLOAD_CHARS
    sentences = []
    for frag_id in range(1, num_frags + 1):
        frag = ascii_payload[(frag_id - 1) * NMEA_MAX_PAYLOAD_CHARS : frag_id * NMEA_MAX_PAYLOAD_CHARS]
        body = f"!AIVDM,{num_frags},{frag_id},,{designator},{frag},{npad}"
        sentences.append(f"{body}*{nmea_checksum(body):02X}")
    return sentences


def frame_to_nmea(payload: bytes, designator: str = "A") -> str:
    """Deframed HDLC payload -> newline-joined AIVDM sentence(s).

    Equivalent of pdu_to_nmea's `msg_to_sentence`
    (lib/pdu_to_nmea_impl.cc:127-131).
    """
    symbols, npad = payload_to_sixbit(payload)
    return "\n".join(to_sentences(sixbit_to_ascii(symbols), npad, designator))
