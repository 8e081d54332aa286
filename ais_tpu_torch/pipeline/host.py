"""Host back half: burst records -> HDLC frames -> deduplicated packets.

Port of `ais_tpu/pipeline/host.py` (the wire path's
`decode_wire_records`, in two parts that the receiver times apart,
`deframe_wire_records` and `emit_wire_frames`; the complex-IQ path's
per-block `decode_block_records`, over a block axis `deframe_records`), in numpy (it
runs on the host after the device-to-host fetch, and the reference's
module cannot be imported without jax).  The receiver deframes the
valid lanes' rows of a fetch in one native call
(`ais_tpu_torch.native.hdlc_deframe_rows`), whose frames `emit_row_frames`
makes into packets as `emit_wire_frames` does; without the native library
it unpacks the dense records, and each burst goes through the numpy
deframer (`ais_tpu_torch.decode.deframe`) in `deframe_wire_records`, which
otherwise deframes them in one call of the dense planes
(`native.hdlc_deframe_packed_batch`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import torch

from ais_tpu_torch.core.params import DeframerConfig

log = logging.getLogger("ais_tpu_torch")


@dataclass(frozen=True)
class DecodedPacket:
    payload: bytes
    abs_sample: int        # absolute channel-rate index of the burst's preamble
    designator: str
    corr_mag: float
    freq_est_hz: float
    # Mean pre-AGC power over the burst window (corr_mag is measured
    # after the envelope-normalizing AGC and says nothing of strength).
    rssi: float = 0.0

    @property
    def nmea(self) -> str:
        from ais_tpu_torch.decode.nmea import frame_to_nmea

        return frame_to_nmea(self.payload, self.designator)

    @property
    def nmea_pdu(self) -> bytes:
        """The sentence as ASCII bytes (the reference's `to_nmea` PDU port)."""
        return self.nmea.encode("ascii")

    @property
    def fields(self) -> dict:
        from ais_tpu_torch.decode.fields import parse_fields

        return parse_fields(self.payload)


# Two sightings of one transmission land within a few samples of each
# other; distinct packets are >= one minimum frame (~800 samples) apart.
DEDUP_WINDOW = 512

# Decoded bit 0 sits at the burst window start; the opening HDLC flag
# follows the 24-bit training sequence.
PREAMBLE_BITS = 24


@dataclass
class PacketDeduper:
    """Drop repeats of the same payload within a sample-distance window."""

    window: int = DEDUP_WINDOW
    # Packets arrive only roughly ordered, so history is kept well past
    # the match window.
    retention: int = 16384
    _recent: list = field(default_factory=list)

    def admit(self, packet: DecodedPacket) -> bool:
        self._recent = [
            (p, s) for (p, s) in self._recent if packet.abs_sample - s < self.retention
        ]
        for payload, sample in self._recent:
            if payload == packet.payload and abs(packet.abs_sample - sample) < self.window:
                return False
        self._recent.append((packet.payload, packet.abs_sample))
        return True


def native_available() -> bool:
    """True when the port's native host library (`native/`, g++) loads."""
    from ais_tpu_torch import native

    return native.available()


def _deframe_burst(burst_bits: np.ndarray, deframer: DeframerConfig):
    """Deframe one burst's valid bits -> [(payload, start_bit)]."""
    from ais_tpu_torch import native
    from ais_tpu_torch.decode.hdlc import deframe

    if native.available():
        return native.hdlc_deframe(
            burst_bits, deframer.min_length_bytes, deframer.max_length_bytes
        )
    return [
        (fr.payload, fr.start_bit)
        for fr in deframe(burst_bits, deframer.min_length_bytes, deframer.max_length_bytes)
    ]


def _emit_packets(frames, win_start: int, block_start_sample: int, mag: float,
                  freq_hz: float, designator: str, deduper: PacketDeduper | None,
                  samples_per_symbol: float, out: list, rssi: float = 0.0) -> None:
    """Anchor each frame to its own preamble and dedup-admit it: frames
    past the first of a window belong to later transmissions, so each is
    positioned by its flag bit (bit b sits near win_start + b*sps)."""
    for payload, start_bit in frames:
        anchor = win_start + int(round((start_bit - PREAMBLE_BITS) * samples_per_symbol))
        packet = DecodedPacket(
            payload=payload,
            abs_sample=block_start_sample + anchor,
            designator=designator,
            corr_mag=mag,
            freq_est_hz=freq_hz,
            rssi=rssi,
        )
        if deduper is None or deduper.admit(packet):
            out.append(packet)


def warn_table_overflow(n_det: np.ndarray, K: int, chan_start: int, core_len: int) -> None:
    """Log each block of a fetch whose burst table overflowed (`n_det`
    (C, B) bursts detected, K kept)."""
    for c, b in zip(*np.nonzero(n_det > K)):
        log.warning(
            "burst table overflow: %d peaks detected in block at sample %d "
            "but max_bursts_per_block=%d", int(n_det[c, b]),
            chan_start + int(b) * core_len, K,
        )


def deframe_wire_records(wire, n_sym: int, chan_start: int, core_len: int,
                         deframer: DeframerConfig = DeframerConfig()) -> tuple:
    """The frames of a host WireRecords fetch (`pipeline/wideband.py`):
    (lanes, triples), `lanes` the valid lanes' flat (channel, block,
    burst) ids in lane order, `triples` [(payload, start_bit, index into
    `lanes`)] in lane order, from one native call (or the numpy
    deframer, lane by lane)."""
    meta_i = np.asarray(wire.meta_i)  # (C, B, K, 6)
    packed = np.asarray(wire.packed)  # (C, B, K, 2, n_pack)
    C, B, K, _ = meta_i.shape
    warn_table_overflow(meta_i[:, :, 0, 3], K, chan_start, core_len)
    lanes = np.nonzero(meta_i[..., 2].reshape(-1))[0].astype(np.int32)
    if lanes.size == 0:
        return lanes, []
    if native_available():
        from ais_tpu_torch import native

        try:
            return lanes, native.hdlc_deframe_packed_batch(
                packed.reshape(C * B * K, 2, -1), lanes, n_sym,
                deframer.min_length_bytes, deframer.max_length_bytes,
                max_frames=8 * lanes.size + 64,
            )
        except ValueError:
            # Geometry beyond the C kernel's static bit buffer: the
            # numpy path below handles it.
            pass
    planes = np.unpackbits(packed, axis=-1)[..., :n_sym]  # (C,B,K,2,n_sym)
    flat = planes.reshape(C * B * K, 2, n_sym)
    triples = []
    for li, lane in enumerate(lanes):
        row = flat[lane]
        triples.extend((payload, start_bit, li) for payload, start_bit
                       in _deframe_burst(row[0][row[1].astype(bool)], deframer))
    return lanes, triples


def _emit_lane_frames(frames, chan_start: int, core_len: int, B: int, K: int, designators,
                      dedupers, samples_per_symbol: float) -> list:
    """Packets of `frames`, (payload, start_bit, lane, win_start, mag,
    freq_hz, rssi) in lane order: each anchored and dedup-admitted in
    that order; the result is sorted by abs_sample."""
    packets: list[DecodedPacket] = []
    for payload, start_bit, lane, win_start, mag, freq_hz, rssi in frames:
        c, rem = divmod(lane, B * K)
        _emit_packets(
            [(payload, start_bit)], win_start, chan_start + rem // K * core_len, mag, freq_hz,
            designators[c], dedupers[c] if dedupers is not None else None, samples_per_symbol,
            packets, rssi=rssi,
        )
    packets.sort(key=lambda p: p.abs_sample)
    return packets


def emit_wire_frames(wire, lanes, triples, chan_start: int, core_len: int,
                     designators=("A", "B"), dedupers=None,
                     samples_per_symbol: float = 5.0) -> list:
    """Packets of `deframe_wire_records`' frames: each anchored and
    dedup-admitted in lane order (channel, block, burst); the result is
    sorted by abs_sample."""
    meta_i = np.asarray(wire.meta_i)
    meta_f = np.asarray(wire.meta_f)  # (C, B, K, 3)
    _, B, K, _ = meta_i.shape
    mi, mf = meta_i.reshape(-1, 6), meta_f.reshape(-1, 3)

    def frames():
        for payload, start_bit, li in triples:
            lane = int(lanes[li])
            yield (payload, start_bit, lane, int(mi[lane, 1]), float(mf[lane, 0]),
                   float(mf[lane, 1]), float(mf[lane, 2]))

    return _emit_lane_frames(frames(), chan_start, core_len, B, K, designators, dedupers,
                             samples_per_symbol)


def emit_row_frames(rows, frames, chan_start: int, core_len: int, B: int, K: int,
                    designators=("A", "B"), dedupers=None,
                    samples_per_symbol: float = 5.0) -> list:
    """Packets of the frames `native.hdlc_deframe_rows` found in a fetch's
    rows (`pipeline/wideband.py:WireRows`), as
    `emit_wire_frames` makes them: the frame arrays and the rows' fields
    read per frame, each payload's bytes made with its packet."""
    r = frames.rows
    end = int(frames.offsets[-1] + frames.lens[-1]) if r.size else 0
    payload = frames.payload[:end].tobytes()
    mf = rows.meta_f[r]
    return _emit_lane_frames(
        ((payload[o: o + n], s, lane, w, m, f, rssi) for o, n, s, lane, w, m, f, rssi in zip(
            frames.offsets.tolist(), frames.lens.tolist(), frames.starts.tolist(),
            rows.lanes[r].tolist(), rows.win_start[r].tolist(), mf[:, 0].tolist(),
            mf[:, 1].tolist(), mf[:, 2].tolist())),
        chan_start, core_len, B, K, designators, dedupers, samples_per_symbol)


def decode_wire_records(wire, n_sym: int, chan_start: int, core_len: int,
                        designators=("A", "B"), dedupers=None,
                        deframer: DeframerConfig = DeframerConfig(),
                        samples_per_symbol: float = 5.0) -> list:
    """Decode a host WireRecords fetch (`pipeline/wideband.py`) into packets.

    Frames come out in lane order (channel, block, burst), the order the
    dedupers admit them in; the result is sorted by abs_sample."""
    lanes, triples = deframe_wire_records(wire, n_sym, chan_start, core_len, deframer)
    return emit_wire_frames(wire, lanes, triples, chan_start, core_len, designators, dedupers,
                            samples_per_symbol)


def decode_block_records(records, block_start_sample: int, designator: str = "A",
                         deframer: DeframerConfig = DeframerConfig(),
                         deduper: PacketDeduper | None = None, fftlen: int = 1024,
                         samples_per_symbol: float = 5.0) -> list:
    """Deframe one block's BurstRecords (host numpy copies) into packets.

    The complex-IQ path's host half: each valid burst's valid bits go
    through the deframer on their own, in burst order."""
    valid = np.asarray(records.valid)
    n_detected = int(np.asarray(records.n_detected))
    if n_detected > valid.size:
        log.warning(
            "burst table overflow: %d peaks detected in block at sample %d "
            "but max_bursts_per_block=%d", n_detected, block_start_sample, valid.size)
    positions = np.asarray(records.position)
    mags = np.asarray(records.mag)
    rssis = np.asarray(records.rssi)
    bits = np.asarray(records.bits)
    bit_valid = np.asarray(records.bit_valid).astype(bool)
    freq_est = np.asarray(records.freq_est)
    win_starts = np.asarray(records.win_start)
    packets: list[DecodedPacket] = []
    for k in np.nonzero(valid)[0]:
        frames = _deframe_burst(bits[k][bit_valid[k]], deframer)
        chunk = min(int(positions[k]) // fftlen, freq_est.size - 1) if freq_est.size else 0
        _emit_packets(
            frames, int(win_starts[k]), block_start_sample, float(mags[k]),
            float(freq_est[chunk]) if freq_est.size else 0.0, designator, deduper,
            samples_per_symbol, packets, rssi=float(rssis[k]),
        )
    return packets


def deframe_records(records, start: int, core_len: int, designator: str = "A",
                    deduper: PacketDeduper | None = None, n_blocks: int | None = None,
                    deframer: DeframerConfig = DeframerConfig(), fftlen: int = 1024,
                    samples_per_symbol: float = 5.0) -> list:
    """Deframe BurstRecords with a leading block axis (tensors or host
    arrays) into packets: block b starts at sample start + b * core_len,
    the first `n_blocks` blocks (all by default) in block order, every
    block through the one `deduper`."""
    rec = [np.asarray(a.cpu()) if torch.is_tensor(a) else np.asarray(a) for a in records]
    packets: list[DecodedPacket] = []
    for b in range(rec[0].shape[0] if n_blocks is None else n_blocks):
        packets.extend(decode_block_records(
            records._make(a[b] for a in rec), start + b * core_len, designator=designator,
            deframer=deframer, deduper=deduper, fftlen=fftlen,
            samples_per_symbol=samples_per_symbol))
    return packets


# A ghost is the same transmission seen through the mirrored spectrum:
# same decoded bits, so the same frame anchor within a few samples.
IMAGE_GHOST_WINDOW = 64


def suppress_image_ghosts(packets: list, window: int = IMAGE_GHOST_WINDOW,
                          margin_db: float = 6.0) -> list:
    """Drop I/Q-image ghosts from a merged multi-channel packet list.

    Two same-payload sightings on different channels within `window`
    samples cannot both be real transmissions, so the weaker is dropped
    when its pre-AGC power (rssi) is at least `margin_db` below the
    stronger; sightings of comparable power are both kept.  `packets`
    must be sorted by abs_sample."""
    ratio = 10.0 ** (margin_db / 10.0)
    drop: set[int] = set()
    for i, p in enumerate(packets):
        for j in range(i + 1, len(packets)):
            q = packets[j]
            if abs(q.abs_sample - p.abs_sample) >= window:
                break
            if q.designator == p.designator or q.payload != p.payload:
                continue
            weak, strong = (i, q) if p.rssi < q.rssi else (j, p)
            if strong.rssi > ratio * packets[weak].rssi > 0.0:
                drop.add(weak)
    return [p for i, p in enumerate(packets) if i not in drop]
