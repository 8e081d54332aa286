"""The port's native deframe entries against the reference's and the numpy
deframer.

`hdlc_deframe_rows` deframes the valid lanes' rows of a wire fetch, the
compact layout's rows in place and the flat layout's bit planes; it must
give the frames that `hdlc_deframe_packed_batch` gives on the dense planes
`unpack_wire_compact` / `unpack_wire_flat` rebuild from the same buffer,
the port's and the reference's, and lane by lane the numpy deframer.
`hdlc_deframe`, the per-burst entry of the complex-IQ path, must give the
reference's frames at any stream length.
"""

import zlib

import numpy as np
import pytest

from ais_tpu_torch import native as port
from ais_tpu_torch.decode import deframe as deframe_np
from ais_tpu_torch.decode.crc import fcs_bytes
from ais_tpu_torch.decode.hdlc import FLAG_BITS
from ais_tpu_torch.pipeline import wideband as tw
from ais_tpu_torch.tx import frame_bits
from ais_tpu_torch.tx.frame import stuff
from ais_tpu_torch.utils.bits import bytes_to_bits_lsb_first

pytestmark = pytest.mark.skipif(not port.available(),
                                reason="the port's native library did not build")


@pytest.fixture(scope="module")
def ref_native():
    """The reference's native module, loaded."""
    from ais_tpu import native

    if not native.available():
        pytest.skip("the reference's native library did not build")
    return native


C_, B_, K_ = 2, 3, 4
TRAINING = np.tile(np.array([0, 1], np.uint8), 12)


def _hdlc(payload: bytes, fcs_flip: int | None = None) -> np.ndarray:
    """flag | stuffed(payload + FCS) | flag, optionally one FCS bit flipped."""
    bits = frame_bits(payload, ramp_bits=0)[TRAINING.size:].copy()
    if fcs_flip is not None:
        bits[-8 - 1 - fcs_flip] ^= 1
    return bits


def _run_bits(rng, n_sym: int, parts: list, at: int = 0) -> np.ndarray:
    """`parts` back to back from bit `at`, random bits around them."""
    bits = rng.integers(0, 2, n_sym).astype(np.uint8)
    body = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    bits[at: at + body.size] = body[: n_sym - at]
    return bits


def _payload(rng, n: int, alphabet=None) -> bytes:
    if alphabet is None:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    return rng.choice(np.asarray(alphabet, np.uint8), n).tobytes()


def _body_ending_in_ones(rng, ones: int) -> np.ndarray:
    """The bits of a 21-byte payload and its FCS that end in exactly
    `ones` ones (at least, from 6 on)."""
    while True:
        payload = _payload(rng, 21)
        body = bytes_to_bits_lsb_first(payload + fcs_bytes(payload))
        if body[-ones:].all() and (ones >= 6 or body[-ones - 1] == 0):
            return body


def _lanes(case: str, rng):
    """(n_sym, [(bits, first, count)] of the valid lanes, max_frames)."""
    n_sym = 917 if case == "odd_n_sym" else 918
    lanes = []
    if case in ("planted", "odd_n_sym", "cap"):
        for _ in range(9):
            parts = [TRAINING]
            for _ in range(int(rng.integers(1, 4))):
                parts += [_hdlc(_payload(rng, int(rng.integers(11, 30)))),
                          rng.integers(0, 2, int(rng.integers(0, 30))).astype(np.uint8)]
            first = int(rng.integers(0, 40))
            lanes.append((_run_bits(rng, n_sym, parts, first), first, n_sym - first))
    elif case == "run_edges":
        # Opening flag at bit 0 of the run; closing flag ending at its last bit.
        for _ in range(4):
            frame = _hdlc(_payload(rng, 21))
            first = int(rng.integers(1, 300))
            lanes.append((_run_bits(rng, n_sym, [frame], first), first, frame.size + 40))
            end = int(rng.integers(frame.size + 10, n_sym + 1))
            first = int(rng.integers(0, 10))
            lanes.append((_run_bits(rng, n_sym, [frame], end - frame.size), first, end - first))
        # The closing flag's last bit one past the run: no frame.
        lanes.append((_run_bits(rng, n_sym, [frame], 100), 0, 100 + frame.size - 1))
    elif case == "empty_run":
        frame = _hdlc(_payload(rng, 21))
        lanes = [(_run_bits(rng, n_sym, [frame], 5), 0, 0),
                 (_run_bits(rng, n_sym, [frame], 5), 0, n_sym),
                 (_run_bits(rng, n_sym, [frame], 5), 0, 7)]
    elif case == "stuffing":
        # Runs of exactly five ones all through the body: 0x1F, 0xF8, 0xFF.
        for alphabet in ([0x1F], [0xF8], [0xFF], [0x1F, 0xF8, 0xFF, 0x3E, 0x7C]):
            frame = _hdlc(_payload(rng, 30, alphabet))
            assert frame.size > 8 * 34 + 16
            lanes.append((_run_bits(rng, n_sym, [TRAINING, frame], 3), 0, n_sym))
        # A body that ends in five ones with no stuffed zero after them
        # (the closing flag follows): no zero to remove there.
        body = _body_ending_in_ones(rng, 5)
        frame = np.concatenate([FLAG_BITS, stuff(body)[:-1], FLAG_BITS])
        lanes.append((_run_bits(rng, n_sym, [TRAINING, frame], 0), 0, n_sym))
    elif case == "abort":
        for k in range(4):
            frame = _hdlc(_payload(rng, 21, [0x00]))
            at = 8 + 40 * k
            frame[at: at + 6] = 1  # six ones inside the body
            good = _hdlc(_payload(rng, 21))
            lanes.append((_run_bits(rng, n_sym, [TRAINING, frame, good], 0), 0, n_sym))
        # A body whose last seven ones went unstuffed (six would close a
        # flag with the zero before them): it unstuffs to a frame with a
        # good CRC, but more than five ones in a row abort it.
        body = _body_ending_in_ones(rng, 7)
        tail = body.size - int(np.argmin(body[::-1]))
        frame = np.concatenate([FLAG_BITS, stuff(body[:tail]), body[tail:], FLAG_BITS])
        lanes.append((_run_bits(rng, n_sym, [TRAINING, frame], 0), 0, n_sym))
    elif case == "bad_crc":
        for k in range(4):
            lanes.append((_run_bits(rng, n_sym, [TRAINING, _hdlc(_payload(rng, 21), 3 * k),
                                                 _hdlc(_payload(rng, 11))], 0), 0, n_sym))
    elif case == "lengths":
        for n in (10, 11, 64, 65):
            lanes.append((_run_bits(rng, n_sym, [TRAINING, _hdlc(_payload(rng, n))], 2), 0, n_sym))
    return n_sym, lanes, 4 if case == "cap" else None


def _fetch(lanes, n_sym: int, seed: int, layout: str):
    """A `pack_wire_compact` or `pack_wire_flat` buffer whose valid lanes
    carry `lanes`."""
    import torch

    n = C_ * B_ * K_
    rng = np.random.default_rng(seed)
    slots = np.sort(rng.choice(n, len(lanes), replace=False))
    bits = rng.integers(0, 2, (n, n_sym)).astype(np.uint8)
    bit_valid = np.zeros((n, n_sym), bool)
    valid = np.zeros(n, bool)
    for slot, (b, first, count) in zip(slots, lanes):
        bits[slot], valid[slot] = b, True
        bit_valid[slot, first: first + count] = True

    def t(a, *shape):
        return torch.from_numpy(np.ascontiguousarray(a).reshape(C_, B_, *shape))

    lead = (C_, B_, K_)
    rec = tw.BurstRecords(
        position=t(rng.integers(1, 16000, lead).astype(np.int32), K_),
        center=t(np.zeros(lead, np.float32), K_), phase=t(np.zeros(lead, np.float32), K_),
        mag=t(rng.uniform(0, 1, lead).astype(np.float32), K_), valid=t(valid, K_),
        bits=t(bits, K_, n_sym), bit_valid=t(bit_valid, K_, n_sym),
        freq_est=t(rng.uniform(-900, 900, (C_, B_, 16)).astype(np.float32), 16),
        n_detected=t(valid.reshape(C_, B_, K_).sum(-1).astype(np.int32)),
        win_start=t(np.zeros(lead, np.int32), K_), rssi=t(np.ones(lead, np.float32), K_))
    buf = tw.pack_wire_compact(rec, 1024, n) if layout == "compact" else tw.pack_wire_flat(
        rec, 1024)
    return buf.numpy()


def _rows_and_dense(buf, n_pack: int, layout: str):
    """(WireRows of the buffer, its dense records)."""
    if layout == "compact":
        rows, dropped = tw.parse_wire_compact(buf, C_, B_, K_, n_pack)
        assert dropped == [] and rows.plane_offset == 24
        return rows, tw.unpack_wire_compact(buf, C_, B_, K_, n_pack)[0]
    rows = tw.parse_wire_flat(buf, C_, B_, K_, n_pack)
    assert rows.plane_offset == 0
    return rows, tw.unpack_wire_flat(buf, C_, B_, K_, n_pack)


def _row_frames(fr):
    return [(fr.payload[o: o + n].tobytes(), int(s), int(r))
            for o, n, s, r in zip(fr.offsets, fr.lens, fr.starts, fr.rows)]


@pytest.mark.parametrize("layout", ["compact", "flat"])
@pytest.mark.parametrize("case", ["planted", "run_edges", "empty_run", "odd_n_sym", "stuffing",
                                  "abort", "bad_crc", "lengths", "cap"])
def test_row_deframe_matches_dense_planes(case, layout, ref_native, caplog):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    n_sym, lanes, max_frames = _lanes(case, rng)
    n_pack = -(-n_sym // 8)
    buf = _fetch(lanes, n_sym, len(case), layout)
    rows, rec = _rows_and_dense(buf, n_pack, layout)
    assert rows.lanes.size == len(lanes)
    out = port.row_frame_buffers(max_frames or 8 * len(lanes) + 64)
    with caplog.at_level("WARNING", logger="ais_tpu_torch"):
        got = _row_frames(port.hdlc_deframe_rows(rows.rows, rows.first, rows.count, n_sym,
                                                 rows.plane_offset, out=out))
    assert ("hdlc_deframe_rows hit max_frames" in caplog.text) == (case == "cap")

    dense = np.asarray(rec.packed).reshape(-1, 2, n_pack)
    valid = np.nonzero(np.asarray(rec.meta_i)[..., 2].reshape(-1))[0].astype(np.int32)
    np.testing.assert_array_equal(valid, rows.lanes)
    cap = max_frames or 8 * valid.size + 64
    want = port.hdlc_deframe_packed_batch(dense, valid, n_sym, max_frames=cap)
    assert got == want == ref_native.hdlc_deframe_packed_batch(
        dense, valid, n_sym, max_frames=cap)
    planes = np.unpackbits(dense, axis=-1)[..., :n_sym]
    by_lane = [(f.payload, f.start_bit, li) for li, lane in enumerate(valid)
               for f in deframe_np(planes[lane, 0][planes[lane, 1].astype(bool)])]
    assert got == by_lane[: len(got)]
    if case == "cap":
        assert len(got) == max_frames < len(by_lane)
    else:
        n_want = {"empty_run": 1, "stuffing": 5, "abort": 4, "bad_crc": 4, "lengths": 2,
                  "run_edges": 8}
        assert len(got) >= n_want.get(case, len(lanes))
    if case == "lengths":
        assert sorted(len(p) for p, _, _ in got) == [11, 64]
    if case == "run_edges":
        assert [s for _, s, r in got if r % 2 == 0] == [0, 0, 0, 0] and len(got) == 8


def test_row_deframe_clips_each_run(ref_native):
    """Runs given directly: a `first` past the plane, a run past n_sym, a
    `first` > 0 with a count of 0, junk bits after n_sym in the row, a
    plane at another byte offset; each as the dense planes give it."""
    rng = np.random.default_rng(11)
    n_sym, offset = 1001, 13
    n_pack = -(-n_sym // 8)
    first = np.array([0, 1000, 1005, 30, 30, 700, 3, 0, 0], np.int32)
    count = np.array([n_sym, 50, 5, 0, 2000, 400, 500, 9, 2000], np.int32)
    bits = np.stack([_run_bits(rng, n_sym, [TRAINING, _hdlc(_payload(rng, 21)),
                                            _hdlc(_payload(rng, 15))], int(f) % 400)
                     for f in first])
    rows = rng.integers(0, 256, (first.size, offset + n_pack + 3), dtype=np.uint8)
    plane = np.packbits(bits, axis=-1)
    plane[:, -1] |= 0xFF >> (n_sym % 8)  # junk past n_sym
    # The last row's closing flag ends one bit past n_sym, over zero padding.
    frame = _hdlc(_payload(rng, 21))
    bits[-1] = _run_bits(rng, n_sym, [TRAINING, frame], n_sym + 1 - frame.size - TRAINING.size)
    plane[-1] = np.packbits(bits[-1])
    rows[:, offset: offset + n_pack] = plane
    idx = np.arange(n_pack * 8)
    mask = (idx >= first[:, None]) & (idx < (first + count)[:, None])
    dense = np.stack([plane, np.packbits(mask, axis=-1)], axis=1)
    lanes = np.arange(first.size, dtype=np.int32)
    got = _row_frames(port.hdlc_deframe_rows(rows, first, count, n_sym, offset))
    want = ref_native.hdlc_deframe_packed_batch(dense, lanes, n_sym)
    assert got == want == port.hdlc_deframe_packed_batch(dense, lanes, n_sym)
    assert len(got) >= 6 and all(r != first.size - 1 for _, _, r in got)
    with pytest.raises(ValueError, match="n_sym"):
        port.hdlc_deframe_rows(rows, first, count, 8 * (rows.shape[1] - offset) + 1, offset)


def test_flat_rows_are_the_dense_records_valid_lanes():
    """`parse_wire_flat`: the valid lanes of `unpack_wire_flat`'s records,
    their fields and bit planes, and n_det a block."""
    rng = np.random.default_rng(5)
    n_sym = 918
    n_pack = -(-n_sym // 8)
    lanes = [(rng.integers(0, 2, n_sym).astype(np.uint8), int(f), int(c))
             for f, c in zip(rng.integers(0, 50, 7), rng.integers(0, 900, 7))]
    buf = _fetch(lanes, n_sym, 3, "flat")
    rows, rec = _rows_and_dense(buf, n_pack, "flat")
    mi, mf = np.asarray(rec.meta_i).reshape(-1, 6), np.asarray(rec.meta_f).reshape(-1, 3)
    valid = np.flatnonzero(mi[:, 2])
    np.testing.assert_array_equal(rows.lanes, valid)
    np.testing.assert_array_equal(rows.rows, np.asarray(rec.packed).reshape(-1, 2, n_pack)[valid, 0])
    np.testing.assert_array_equal(rows.win_start, mi[valid, 1])
    np.testing.assert_array_equal(rows.first, mi[valid, 4])
    np.testing.assert_array_equal(rows.count, mi[valid, 5])
    np.testing.assert_array_equal(rows.meta_f, mf[valid])
    np.testing.assert_array_equal(rows.n_det, np.asarray(rec.meta_i)[:, :, 0, 3])


@pytest.mark.parametrize("n_bits", [0, 7, 8, 63, 200, 917, 918, 4099, 70001])
def test_burst_deframe_matches_the_reference(n_bits, ref_native):
    """The per-burst `hdlc_deframe` (eight bits packed a step, a longer
    stream than the batched entries' limit on the heap): the reference's
    frames and the numpy deframer's, with frames planted at the stream's
    start, inside it and ending at its last bit."""
    rng = np.random.default_rng(n_bits)
    bits = rng.integers(0, 2, n_bits).astype(np.uint8)
    frames = [_hdlc(_payload(rng, int(rng.integers(11, 40)) if k else 11)) for k in range(12)]
    at = 0
    for fr in frames:
        if at + fr.size > n_bits:
            break
        bits[at: at + fr.size] = fr
        at += fr.size + int(rng.integers(0, 3 * n_bits // 12 + 1))
    if n_bits >= frames[-1].size:
        bits[n_bits - frames[-1].size:] = frames[-1]
    got = port.hdlc_deframe(bits)
    assert got == ref_native.hdlc_deframe(bits)
    assert got == [(f.payload, f.start_bit) for f in deframe_np(bits)]
    assert len(got) >= (2 if n_bits >= 917 else 1 if n_bits >= 200 else 0)
