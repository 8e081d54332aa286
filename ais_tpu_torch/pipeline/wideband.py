"""Wideband dual-channel receiver: complex IQ or wire bytes -> AIS packets.

Port of `ais_tpu/pipeline/wideband.py`.  Two entry paths, one device
program after the channelizer:

  complex IQ (`process` / `decode` / `flush`, `device_step`): the
    receiver buffers complex64 samples and runs each n_in-sample step
    through K5, the float channelizer;
  wire bytes (`stage_wire` / `submit_wire` / `decode_wire`), per format:
    ci16, ci8  decode on the device, then K5
    cu8        K5's cu8 entry (rtl_sdr's bytes decoded inside the kernel)
    ci4, ci2   K4 (decode inside the channelizer kernel)
    ci1        K3; cd1 is undone to ci1 on the device first
    cr1        K1 (the IF-folded 1-bit channelizer)

then, on the device, both channels at 48 ksps
  -> overlap-save framing into demod blocks
  -> BurstDemod (AGC, AFC, K2 matched filter, detection, timing, bits)

A carrier with no short period (a ppm-shifted offset) takes K5's, K3's
or K4's full-length table (ops/channelizer.py); cr1 then goes through
decode and K5, as for any geometry K1 does not take.

The wire path packs the records into ONE uint8 buffer
(`pack_wire_compact`, or `pack_wire_flat` with compact_lanes=0); the host
takes the valid lanes' rows from it (`parse_wire_compact`, read in place,
or `parse_wire_flat`) and deframes them in one native call
(`native.hdlc_deframe_rows`); where the native library is missing it
unpacks the buffer into the dense records and deframes them in numpy
(`unpack_wire_compact`, `unpack_wire_flat`); the complex path fetches the burst records and deframes block by block
(`decode_block_records`).  Both deduplicate and drop I/Q-image ghosts.
A block whose burst table or lane directory overflowed is demodulated
again with a larger table (pipeline/recover.py).
Each channelizer is built at first use, so a geometry only the path in
use must cover.

Stream contract (as in the reference): each call covers n_in samples but
advances the stream by step_raw < n_in.  The wire path's last n_in -
step_raw samples (`wire_overlap_samples`) are the framing halo and must
be presented again at the start of the next call; the complex path
keeps them in its buffer.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import NamedTuple

import numpy as np
import torch

from ais_tpu_torch import native
from ais_tpu_torch.core.params import AIS_BIT_RATE, DeframerConfig, DemodConfig
from ais_tpu_torch.ops.channelizer import Channelizer
from ais_tpu_torch.ops.convert import (
    cd1_wire_nbytes,
    ci1_from_bytes_cd1,
    cr1_wire_nbytes,
    iq_from_bytes,
    iq_from_bytes_ci8,
    iq_from_bytes_ci16,
    iq_from_bytes_cr1,
)
from ais_tpu_torch.ops.fir import mixer_phase
from ais_tpu_torch.ops.interp import NSTEPS, NTAPS
from ais_tpu_torch.ops.wire_channelizer import (
    PACKED,
    PackedWireChannelizer,
    WireChannelizer,
    wire_channelizer_supported,
)
from ais_tpu_torch.pipeline.host import (
    PacketDeduper,
    deframe_records,
    deframe_wire_records,
    emit_row_frames,
    emit_wire_frames,
    suppress_image_ghosts,
    warn_table_overflow,
)
from ais_tpu_torch.pipeline.ingest import PinnedRing, chunk_bytes
from ais_tpu_torch.pipeline.receiver import (
    BurstDemod,
    BurstRecords,
    burst_table_geometry,
    demod_constants,
    required_halo,
)
from ais_tpu_torch.pipeline.recover import recover_overflow_packets
from ais_tpu_torch.utils.profiling import SPANS

log = logging.getLogger("ais_tpu_torch")


class WidebandConfig(NamedTuple):
    """Same fields and defaults as the reference's WidebandConfig."""

    input_rate: float = 2.4e6
    offsets_hz: tuple = (-25e3, +25e3)   # channel A, B around 162.0 MHz
    designators: tuple = ("A", "B")
    decimation: int = 50
    cutoff_hz: float = 11e3
    transition_hz: float = 2e3
    block_len: int = 16384               # demod block at channel rate
    demod: DemodConfig = DemodConfig()
    deframer: DeframerConfig = DeframerConfig()
    # Drop cross-channel I/Q-image ghosts (pipeline/host.py).
    image_reject: bool = True
    # A block whose burst table or lane directory overflows is
    # channelized again on the host and re-demodulated with a larger
    # table (pipeline/recover.py); with False it is only logged.
    overflow_recovery: bool = True
    # Valid-lane compaction of the device-to-host buffer (0 = off): ship
    # only this many valid lanes plus a lane directory.
    compact_lanes: int = 0

    @property
    def channel_rate(self) -> float:
        return self.input_rate / self.decimation

    @property
    def sps(self) -> float:
        return self.channel_rate / AIS_BIT_RATE

    @property
    def core_len(self) -> int:
        return self.block_len - required_halo(self.demod)


class WireRecords(NamedTuple):
    """Record planes the host back half reads (torch on the device, numpy
    on the host)."""

    meta_i: object  # (C, B, K, 6) int32: position, win_start, valid,
                    #   n_detected, bit_valid run (first, count)
    meta_f: object  # (C, B, K, 3) float32: corr mag^2, freq_est_hz, rssi
    packed: object  # (C, B, K, 1|2, n_pack) uint8 bit planes, MSB first


class ReceiverConstants(NamedTuple):
    """The slice's constants: what weights are to a model."""

    taps: np.ndarray         # (ntaps,) float32 channelizer low-pass
    preamble: np.ndarray     # (L,) complex64 GMSK preamble waveform
    interp_bank: np.ndarray  # (129, 8) float32 interpolation bank
    ff_delta: float          # feedforward tone-phase calibration


def channel_taps(cfg: WidebandConfig) -> np.ndarray:
    from ais_tpu_torch.ops.firdes import low_pass

    return low_pass(1.0, cfg.input_rate, cfg.cutoff_hz, cfg.transition_hz)


@functools.lru_cache(maxsize=8)
def num_taps(cfg: WidebandConfig) -> int:
    return int(channel_taps(cfg).size)


def _demod_cfg(cfg: WidebandConfig) -> DemodConfig:
    return dataclasses.replace(cfg.demod, samples_per_symbol=cfg.sps)


def default_constants(cfg: WidebandConfig) -> ReceiverConstants:
    """The constants as the reference builds them for `cfg`."""
    return ReceiverConstants(channel_taps(cfg), *demod_constants(_demod_cfg(cfg)))


def constants_from_reference(taps, preamble, interp_bank, ff_delta) -> ReceiverConstants:
    """Take the reference package's constants (numpy arrays) as the port's.

    `taps`: the channelizer low-pass (`low_pass(1, 2.4e6, 11e3, 2e3)`);
    `preamble`: the correlator waveform; `interp_bank`: the (129, 8)
    interpolation bank; `ff_delta`: `sync/feedforward.py:_calibrate`."""
    taps = np.asarray(taps, np.float32)
    preamble = np.asarray(preamble, np.complex64)
    bank = np.asarray(interp_bank, np.float32)
    if taps.ndim != 1 or preamble.ndim != 1:
        raise ValueError("taps and preamble must be 1-D")
    if bank.shape != (NSTEPS + 1, NTAPS):
        raise ValueError(f"interp_bank must be {(NSTEPS + 1, NTAPS)}, got {bank.shape}")
    return ReceiverConstants(taps, preamble, bank, float(ff_delta))


def wideband_geometry(cfg: WidebandConfig, n_in: int) -> tuple[int, int, int]:
    """(n_channels, n_blocks, core_len) for an input of n_in raw samples."""
    n48 = (n_in - num_taps(cfg)) // cfg.decimation + 1
    core_len = cfg.core_len
    n_blocks = max(0, (n48 - cfg.block_len) // core_len + 1)
    if n_blocks == 0:
        raise ValueError(
            f"n_in {n_in} too short: yields {n48} channel samples < block_len {cfg.block_len}")
    return len(cfg.offsets_hz), n_blocks, core_len


def aligned_n_in(cfg: WidebandConfig, n_in: int | None = None) -> int:
    """n_in rounded up to whole decimation rows and whole wire bytes
    (lcm(decim, 8)); default ~64 demod blocks a call."""
    if n_in is None:
        n48 = cfg.block_len + cfg.core_len * 63
        n_in = (n48 - 1) * cfg.decimation + num_taps(cfg)
    align = int(np.lcm(cfg.decimation, 8))
    return -(-n_in // align) * align


# Wire bytes per sample (num, den) of the formats without padding.
_WIRE_RATIO = {"ci16": (4, 1), "ci8": (2, 1), "cu8": (2, 1), "ci4": (1, 1), "ci2": (1, 2),
               "ci1": (1, 4)}
WIRE_FORMATS = (*_WIRE_RATIO, "cd1", "cr1")


def wire_nbytes(fmt: str, n_in: int) -> int:
    """Wire bytes of one n_in-sample step in `fmt` (the reference's
    `stage_wire` table)."""
    if fmt == "cd1":
        return cd1_wire_nbytes(n_in)
    if fmt == "cr1":
        return cr1_wire_nbytes(n_in)
    if fmt not in _WIRE_RATIO:
        raise ValueError(f"unsupported wire format {fmt!r}; the receiver takes {WIRE_FORMATS}")
    num, den = _WIRE_RATIO[fmt]
    return n_in * num // den


def pack_bits(plane: torch.Tensor) -> torch.Tensor:
    """(..., n) 0/1 -> (..., ceil(n/8)) uint8, MSB first (np.packbits)."""
    n = plane.shape[-1]
    n_pack = -(-n // 8)
    x = torch.nn.functional.pad(plane.to(torch.int32), (0, n_pack * 8 - n))
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=plane.device)
    return (x.reshape(*x.shape[:-1], n_pack, 8) * weights).sum(-1).to(torch.uint8)


def pack_wire_records(rec: BurstRecords, fftlen: int) -> WireRecords:
    """Device-side compaction of BurstRecords (leading dims kept).

    Resolves each burst's AFC chunk to a frequency, packs the bit plane
    8x and replaces the bit_valid plane by its (first, count) run
    (lossless: every demod mode's valid mask is a contiguous run)."""
    n_chunks = rec.freq_est.shape[-1]
    chunk = (rec.position.to(torch.int64) // fftlen).clamp(0, n_chunks - 1)
    bv = rec.bit_valid.to(torch.int32)
    meta_i = torch.stack([
        rec.position.to(torch.int32),
        rec.win_start.to(torch.int32),
        rec.valid.to(torch.int32),
        rec.n_detected[..., None].expand(rec.position.shape).to(torch.int32),
        torch.argmax(bv, dim=-1).to(torch.int32),  # run first (0 if none)
        bv.sum(-1, dtype=torch.int32),             # run count
    ], dim=-1)
    meta_f = torch.stack([rec.mag, rec.freq_est.gather(-1, chunk), rec.rssi], dim=-1)
    return WireRecords(meta_i, meta_f.to(torch.float32), pack_bits(rec.bits)[..., None, :])


def le4_bytes(x_i32: torch.Tensor) -> torch.Tensor:
    """int32 -> 4 little-endian uint8 bytes along a new minor axis
    (arithmetic shifts: exact two's-complement bytes)."""
    return torch.stack([(x_i32 >> s) & 255 for s in (0, 8, 16, 24)], dim=-1).to(torch.uint8)


def _le2_bytes(x_i32: torch.Tensor) -> torch.Tensor:
    return torch.stack([x_i32 & 255, (x_i32 >> 8) & 255], dim=-1).to(torch.uint8)


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32)


def pack_wire_flat(rec: BurstRecords, fftlen: int) -> torch.Tensor:
    """Every lane in ONE uint8 buffer: [meta_i as le-i32 bytes][meta_f as
    le-f32 bytes][bits plane]."""
    w = pack_wire_records(rec, fftlen)
    return torch.cat([
        le4_bytes(w.meta_i).reshape(-1),
        le4_bytes(_f32_bits(w.meta_f)).reshape(-1),
        w.packed.reshape(-1),
    ])


def _bit_valid_plane(meta_i: np.ndarray, n_pack: int) -> np.ndarray:
    C, B, K = meta_i.shape[:3]
    first = meta_i[..., 4:5]
    count = meta_i[..., 5:6]
    idx = np.arange(n_pack * 8, dtype=np.int32)
    mask = (idx >= first) & (idx < first + count)
    return np.packbits(mask, axis=-1).reshape(C, B, K, 1, n_pack)


def unpack_wire_flat(buf: np.ndarray, C: int, B: int, K: int, n_pack: int) -> WireRecords:
    """Host inverse of `pack_wire_flat`; rebuilds the bit_valid plane."""
    buf = np.asarray(buf, dtype=np.uint8)
    ni = C * B * K * 6 * 4
    nf = C * B * K * 3 * 4
    meta_i = np.frombuffer(buf[:ni].tobytes(), "<i4").reshape(C, B, K, 6)
    meta_f = np.frombuffer(buf[ni: ni + nf].tobytes(), "<f4").reshape(C, B, K, 3)
    bits = buf[ni + nf:].reshape(C, B, K, 1, n_pack)
    return WireRecords(meta_i, meta_f,
                       np.concatenate([bits, _bit_valid_plane(meta_i, n_pack)], axis=-2))


def pack_wire_compact(rec: BurstRecords, fftlen: int, l_max: int) -> torch.Tensor:
    """Valid-lane-compacted device-to-host buffer.

    Valid lanes come first in ascending lane order (top-k over the
    distinct keys valid*2N - lane), then `l_max` of them are gathered.
    Per-lane row: pos i32, win_start i32, bit_valid run (first u16,
    count u16), [mag, freq, rssi] f32, packed bits.  Layout (little-endian):
      [header: total_valid, l_max, n_lanes, row_bytes — 4x i32]
      [n_detected (C*B) i32][n_valid (C*B) i32]
      [directory (l_max) i32 flat lane ids][rows (l_max, row_bytes) u8]
    """
    w = pack_wire_records(rec, fftlen)
    C, B, K = w.meta_i.shape[:3]
    n_lanes = C * B * K
    n_pack = w.packed.shape[-1]
    l_max = min(int(l_max), n_lanes)
    row_bytes = 24 + n_pack
    mi = w.meta_i.reshape(n_lanes, 6)
    mf = _f32_bits(w.meta_f.reshape(n_lanes, 3))
    rows = torch.cat([
        le4_bytes(mi[:, 0]),
        le4_bytes(mi[:, 1]),
        _le2_bytes(mi[:, 4]),
        _le2_bytes(mi[:, 5]),
        le4_bytes(mf).reshape(n_lanes, 12),
        w.packed.reshape(n_lanes, n_pack),
    ], dim=1)
    valid = mi[:, 2]
    key = valid * (2 * n_lanes) - torch.arange(n_lanes, dtype=torch.int32, device=valid.device)
    idx = torch.topk(key, l_max, sorted=True).indices
    sel = rows[idx]
    n_valid_blk = w.meta_i[..., 2].reshape(C * B, K).sum(-1, dtype=torch.int32)
    header = torch.cat([
        valid.sum(dtype=torch.int32).reshape(1),
        torch.tensor([l_max, n_lanes, row_bytes], dtype=torch.int32, device=valid.device),
    ])
    n_det = rec.n_detected.reshape(C * B).to(torch.int32)
    return torch.cat([
        le4_bytes(header).reshape(-1),
        le4_bytes(n_det).reshape(-1),
        le4_bytes(n_valid_blk).reshape(-1),
        le4_bytes(idx.to(torch.int32)).reshape(-1),
        sel.reshape(-1),
    ])


def _compact_parts(buf: np.ndarray, C: int, B: int, K: int, n_pack: int):
    """The parts of a `pack_wire_compact` buffer, as views of it:
    (total_valid, l_max, n_det (C, B), n_valid_blk (C, B), directory
    (l_max,), rows (l_max, row_bytes))."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    total_valid, l_max, n_lanes, row_bytes = (int(v) for v in buf[:16].view("<i4"))
    if n_lanes != C * B * K or row_bytes != 24 + n_pack:
        raise ValueError(
            f"compact wire geometry mismatch: buffer says {n_lanes} lanes / "
            f"{row_bytes} B rows, receiver expects {C * B * K} / {24 + n_pack}")
    off = 16
    n_det = buf[off: off + 4 * C * B].view("<i4").reshape(C, B)
    off += 4 * C * B
    n_valid_blk = buf[off: off + 4 * C * B].view("<i4").reshape(C, B)
    off += 4 * C * B
    dirs = buf[off: off + 4 * l_max].view("<i4")
    off += 4 * l_max
    rows = buf[off: off + l_max * row_bytes].reshape(l_max, row_bytes)
    return total_valid, l_max, n_det, n_valid_blk, dirs, rows


def _dropped_blocks(total_valid: int, l_max: int, shipped: np.ndarray, n_valid_blk: np.ndarray,
                    n_det: np.ndarray) -> list:
    """(channel, block, n_detected) of the blocks whose valid lanes did
    not all fit the directory; `shipped` (C, B) counts the lanes it holds."""
    if total_valid <= l_max:
        return []
    return [(int(c), int(b), int(max(n_det[c, b], n_valid_blk[c, b])))
            for c, b in zip(*np.nonzero(shipped < n_valid_blk))]


def unpack_wire_compact(buf: np.ndarray, C: int, B: int, K: int,
                        n_pack: int) -> tuple[WireRecords, list]:
    """Host inverse of `pack_wire_compact`.

    Scatters the shipped lanes back into the dense (C, B, K) layout
    (invalid lanes zero) and returns (records, dropped): `dropped` lists
    (channel, block, n_detected) for blocks whose valid lanes did not
    fit the directory."""
    total_valid, l_max, n_det, n_valid_blk, dirs, rows = _compact_parts(buf, C, B, K, n_pack)
    nv = min(total_valid, l_max)
    d, r = dirs[:nv], rows[:nv]
    meta_i = np.zeros((C * B * K, 6), np.int32)
    meta_f = np.zeros((C * B * K, 3), np.float32)
    bits = np.zeros((C * B * K, n_pack), np.uint8)
    meta_i[d, 0] = np.frombuffer(r[:, 0:4].tobytes(), "<i4")
    meta_i[d, 1] = np.frombuffer(r[:, 4:8].tobytes(), "<i4")
    meta_i[d, 2] = 1
    meta_i[d, 4] = np.frombuffer(r[:, 8:10].tobytes(), "<u2")
    meta_i[d, 5] = np.frombuffer(r[:, 10:12].tobytes(), "<u2")
    meta_f[d] = np.frombuffer(r[:, 12:24].tobytes(), "<f4").reshape(nv, 3)
    bits[d] = r[:, 24: 24 + n_pack]
    meta_i = meta_i.reshape(C, B, K, 6)
    meta_i[..., 3] = n_det[..., None]
    packed = np.concatenate(
        [bits.reshape(C, B, K, 1, n_pack), _bit_valid_plane(meta_i, n_pack)], axis=-2)
    dropped = _dropped_blocks(total_valid, l_max, meta_i[..., 2].sum(axis=-1), n_valid_blk,
                              n_det)
    return WireRecords(meta_i, meta_f.reshape(C, B, K, 3), packed), dropped


class WireRows(NamedTuple):
    """The valid lanes of a wire fetch, one entry a row, rows in lane
    order (`parse_wire_compact`, `parse_wire_flat`)."""

    n_det: np.ndarray      # (C, B) int32 bursts detected a block
    lanes: np.ndarray      # (nv,) int32 flat (channel, block, burst) lane ids
    rows: np.ndarray       # (nv, row_bytes) uint8, the packed bits at plane_offset
    plane_offset: int      # byte of each row where its packed bits start
    win_start: np.ndarray  # (nv,) int32
    first: np.ndarray      # (nv,) bit-valid run
    count: np.ndarray      # (nv,)
    meta_f: np.ndarray     # (nv, 3) float32 corr mag^2, freq_est_hz, rssi


def parse_wire_compact(buf: np.ndarray, C: int, B: int, K: int,
                       n_pack: int) -> tuple[WireRows, list]:
    """The shipped lanes of a `pack_wire_compact` buffer, without the
    dense layout: (rows, dropped), `dropped` as `unpack_wire_compact`
    gives it.  Every field is a view of the fetched bytes."""
    total_valid, l_max, n_det, n_valid_blk, dirs, rows = _compact_parts(buf, C, B, K, n_pack)
    nv = min(total_valid, l_max)
    rows = rows[:nv]
    lanes = dirs[:nv]
    shipped = np.bincount(lanes // K, minlength=C * B).reshape(C, B)
    parsed = WireRows(n_det, lanes, rows, 24, rows[:, 4:8].view("<i4")[:, 0],
                      rows[:, 8:10].view("<u2")[:, 0], rows[:, 10:12].view("<u2")[:, 0],
                      rows[:, 12:24].view("<f4"))
    return parsed, _dropped_blocks(total_valid, l_max, shipped, n_valid_blk, n_det)


def parse_wire_flat(buf: np.ndarray, C: int, B: int, K: int, n_pack: int) -> WireRows:
    """The valid lanes of a `pack_wire_flat` buffer: each lane's metadata
    and its packed bit plane, taken out of the buffer (no bit-valid plane)."""
    buf = np.ascontiguousarray(buf, dtype=np.uint8)
    n = C * B * K
    meta_i = buf[: 24 * n].view("<i4").reshape(n, 6)
    meta_f = buf[24 * n: 36 * n].view("<f4").reshape(n, 3)
    bits = buf[36 * n:].reshape(n, n_pack)
    lanes = np.flatnonzero(meta_i[:, 2]).astype(np.int32)
    m = meta_i[lanes]
    return WireRows(meta_i[:, 3].reshape(C, B, K)[..., 0], lanes, bits[lanes], 0, m[:, 1],
                    m[:, 4], m[:, 5], meta_f[lanes])


def _zero_collect_stats() -> dict:
    """The wire path's per-part seconds and counts (`collect_stats`)."""
    return {"exec_s": 0.0, "fetch_s": 0.0, "host_s": 0.0, "steps": 0, "dispatch_s": 0.0,
            "unpack_s": 0.0, "deframe_s": 0.0, "emit_s": 0.0, "recover_s": 0.0, "lanes": 0,
            "frames": 0, "row_steps": 0, "stage_s": 0.0, "wire_bytes": 0, "pinned_steps": 0,
            "fill_s": 0.0}


class WidebandReceiver:
    """Streaming receiver on one device (see the module docstring).

    The wire path keeps `collect_stats` (seconds and counts summed over
    steps until `reset_collect_stats`): stage_s and wire_bytes, the
    seconds in `stage_wire` and the wire bytes it staged; on a CUDA
    device pinned_steps and fill_s, the steps staged through the pinned
    chunk ring (`pipeline/ingest.py`) and the seconds of its threaded
    fill (its span `rx.stage` holds an `rx.stage.fill` and an
    `rx.stage.copy`, the copy's enqueue, a chunk; a step copied from
    pageable memory has one `rx.stage.copy`, the whole copy);
    exec_s, fetch_s and host_s, the parts of `collect` (the wait for the
    device result, the copy to the host, the host back half); dispatch_s,
    the host enqueueing the device program (`dispatch_wire`); within the
    back half, unpack_s (the fetch parsed, or unpacked, the overflowed
    blocks found), deframe_s (the batched deframe), emit_s (packets,
    dedup admission, the sort, image-ghost suppression) and recover_s
    (overflow recovery: the step's samples from its wire bytes,
    `_recover`, the merge); lanes (valid lanes
    shipped to the host) and frames (frames the deframer returned, before
    dedup); steps, and row_steps (the steps whose compact fetch was read
    in place).  Each part is two `time.perf_counter_ns()` readings a
    step, which also stamp its span (`rx.<part>`) in
    `utils/profiling.SPANS` when that log is on.  The attribute
    `recover_s` is `_recover`'s seconds over the receiver's life."""

    def __init__(self, cfg: WidebandConfig = WidebandConfig(), n_in: int | None = None,
                 *, device="cuda", constants: ReceiverConstants | None = None):
        if cfg.deframer.max_length_bytes > cfg.demod.max_frame_bytes:
            raise ValueError(
                f"deframer.max_length_bytes={cfg.deframer.max_length_bytes} exceeds "
                f"the demod window's frame capacity ({cfg.demod.max_frame_bytes} "
                f"bytes at burst_len={cfg.demod.burst_len}): the extraction window "
                f"would truncate long frames")
        self.cfg = cfg
        self.device = torch.device(device)
        self.n_in = aligned_n_in(cfg, n_in)
        self.n_chan, self.n_blocks, self.core_len = wideband_geometry(cfg, self.n_in)
        self.constants = default_constants(cfg) if constants is None else constants
        # Channelizer modules by kind ("iq" = K5, "cr1" = K1, "ci1" = K3,
        # "ci2"/"ci4" = K4, "cu8" = K5's cu8 entry), each built at first use.
        self._channelizers: dict = {}
        self.demod_cfg = _demod_cfg(cfg)
        self.demod = BurstDemod(
            self.demod_cfg, cfg.block_len, self.core_len,
            preamble=self.constants.preamble, interp_bank=self.constants.interp_bank,
            ff_delta=self.constants.ff_delta, device=self.device)
        # Raw samples consumed per call (stream advance).
        self.step_raw = self.n_blocks * self.core_len * cfg.decimation
        self._buf = np.zeros(0, np.complex64)  # complex path: samples not yet consumed
        self._pos = 0  # absolute raw index of the next call's first sample (= _buf[0])
        self._dedupers = [PacketDeduper() for _ in cfg.offsets_hz]
        # Overflowed blocks seen, and the host seconds spent recovering them.
        self.overflow_blocks = 0
        self.recover_s = 0.0
        self._recover_demods: dict = {}
        self.collect_stats = _zero_collect_stats()
        self._row_frames = None  # `hdlc_deframe_rows` outputs, made at first use
        self._warned_dense = False  # the missing native library logged once
        self._ring = None  # the wire ingest's PinnedRing; False once pinning failed
        # (exec + fetch seconds, host seconds) of the last `collect`.
        self.last_collect_s = (0.0, 0.0)

    @property
    def wire_overlap_samples(self) -> int:
        """Raw samples each wire call must present again from the
        previous call (the framing halo at the input rate)."""
        return self.n_in - self.step_raw

    # -- device half -----------------------------------------------------

    def channelizer_for(self, kind: str) -> torch.nn.Module:
        """The channelizer module of `kind` ("iq": K5 on complex samples;
        "cr1": K1; "ci1": K3; "ci2", "ci4": K4; "cu8": K5's cu8 entry),
        built on first use.
        Raises NotImplementedError when no kernel covers the geometry."""
        mod = self._channelizers.get(kind)
        if mod is None:
            cfg = self.cfg
            args = (self.constants.taps, cfg.decimation, cfg.offsets_hz, cfg.input_rate,
                    self.n_in)
            if kind == "iq":
                mod = Channelizer(*args, device=self.device)
            elif kind == "cr1":
                mod = WireChannelizer(*args, device=self.device)
            else:
                mod = PackedWireChannelizer(kind, *args, device=self.device)
            self._channelizers[kind] = mod
        return mod

    def _wire_route(self, fmt: str):
        """(channelizer kind, device pre-decode or None) for a wire format."""
        if fmt == "ci16":
            return "iq", iq_from_bytes_ci16
        if fmt == "ci8":
            return "iq", iq_from_bytes_ci8
        if fmt in PACKED:
            return fmt, None
        if fmt == "cd1":
            return "ci1", functools.partial(ci1_from_bytes_cd1, n_samples=self.n_in)
        if fmt == "cr1":
            cfg = self.cfg
            if wire_channelizer_supported("cr1", self.constants.taps.size, cfg.decimation,
                                          cfg.offsets_hz, cfg.input_rate, self.n_in):
                return "cr1", None
            # A geometry K1 does not take: decode to complex, then K5.
            return "iq", functools.partial(iq_from_bytes_cr1, n_samples=self.n_in)
        raise ValueError(f"unsupported wire format {fmt!r}; the receiver takes {WIRE_FORMATS}")

    def prepare(self, fmt: str) -> torch.nn.Module:
        """Build the channelizer that `fmt`'s wire bytes run through, its
        tables on the device, ahead of the first step; returns it."""
        return self.channelizer_for(self._wire_route(fmt)[0])

    def demod_channels(self, chans: torch.Tensor) -> BurstRecords:
        """(n_chan, n48) channels -> records with leading (n_chan, n_blocks):
        overlap-save framing (a strided view) and one batched demod."""
        cfg = self.cfg
        blocks = chans.unfold(-1, cfg.block_len, self.core_len)[:, : self.n_blocks]
        rec = self.demod(blocks.reshape(self.n_chan * self.n_blocks, cfg.block_len))
        lead = (self.n_chan, self.n_blocks)
        return BurstRecords(*(t.reshape(*lead, *t.shape[1:]) for t in rec))

    def wire_channels(self, raw: torch.Tensor, phase0s: torch.Tensor,
                      fmt: str = "ci8") -> torch.Tensor:
        """One step's wire bytes (on the device) -> (n_chan, n48) channels."""
        kind, pre = self._wire_route(fmt)
        return self.channelizer_for(kind)(raw if pre is None else pre(raw), phase0s)

    def wire_records(self, raw: torch.Tensor, phase0s: torch.Tensor,
                     fmt: str = "ci8") -> BurstRecords:
        """Device program up to the burst table (channelizer, then the demod)."""
        return self.demod_channels(self.wire_channels(raw, phase0s, fmt))

    def _phase0s(self, at: int) -> np.ndarray:
        return np.stack([mixer_phase(off, self.cfg.input_rate, at)
                         for off in self.cfg.offsets_hz])

    def pack_records(self, rec: BurstRecords) -> torch.Tensor:
        """The step's device-to-host buffer (compact or flat layout)."""
        fftlen = self.cfg.demod.fftlen
        if self.cfg.compact_lanes:
            return pack_wire_compact(rec, fftlen, self.cfg.compact_lanes)
        return pack_wire_flat(rec, fftlen)

    def stage_wire(self, raw_u8: np.ndarray, fmt: str = "ci8", pos: int | None = None):
        """Copy one step's wire bytes to the device; returns a handle for
        `dispatch_wire`.  On a CUDA device the bytes go through the
        pinned chunk ring (`pipeline/ingest.py`), and the current stream
        waits for its copies; `raw_u8` has been read when this returns.
        `fmt` is one of WIRE_FORMATS; its channelizer is built here on
        first use.  `pos` overrides the stream position (absolute raw
        index of the first sample) without advancing the counter."""
        want = wire_nbytes(fmt, self.n_in)
        if raw_u8.size != want:
            raise ValueError(
                f"{fmt} wire buffer {raw_u8.size} bytes != {want} for n_in {self.n_in}")
        at = self._pos if pos is None else int(pos)
        st = self.collect_stats
        t0 = time.perf_counter_ns()
        span = SPANS.begin("rx.stage", at, t0)
        try:
            self.prepare(fmt)
            ring = self._pinned_ring(raw_u8.size)
            if ring is not None:
                raw, ph, fill_ns = ring.stage(np.require(raw_u8, np.uint8, "C"),
                                              self._phase0s(at), at)
                st["fill_s"] += fill_ns * 1e-9
                st["pinned_steps"] += 1
            else:
                host = torch.from_numpy(np.require(raw_u8, np.uint8, ("C", "W")))
                c0 = time.perf_counter_ns()
                raw = host.to(self.device, non_blocking=True)
                c1 = time.perf_counter_ns()
                SPANS.add("rx.stage.copy", at, c0, c1)
                ph = torch.from_numpy(self._phase0s(at)).to(self.device)
        finally:
            t1 = time.perf_counter_ns()
            SPANS.end(span, t1)
        st["stage_s"] += (t1 - t0) * 1e-9
        st["wire_bytes"] += int(raw_u8.size)
        if pos is None:
            self._pos += self.step_raw
        return raw, ph, at, fmt, raw_u8

    def _pinned_ring(self, nbytes: int) -> PinnedRing | None:
        """The ring that stages an `nbytes` wire on a CUDA device, built at
        first use and again for a wire that wants larger chunks; None on
        another device, or once pinned memory could not be had (each step
        is then copied from pageable memory, and not counted in
        `pinned_steps`)."""
        if self.device.type != "cuda" or self._ring is False:
            return None
        chunk = chunk_bytes(nbytes)
        if self._ring is None or self._ring.chunk < chunk:
            try:
                self._ring = PinnedRing(self.device, chunk, self._phase0s(0))
            except RuntimeError as e:
                log.warning("no pinned host memory for the wire ingest (%s): each step is "
                            "copied from pageable memory, a slower stage", e)
                self._ring = False
                return None
        return self._ring

    def dispatch_wire(self, staged):
        """Enqueue the device program on a staged step; returns a handle
        for `collect` (on a CUDA device the work runs asynchronously, and
        `dispatch_s` is the host's enqueue)."""
        raw, ph, at, fmt, raw_u8 = staged
        t0 = time.perf_counter_ns()
        span = SPANS.begin("rx.dispatch", at, t0)
        with SPANS.span("rx.dispatch.channelize", at):
            chans = self.wire_channels(raw, ph, fmt)
        with SPANS.span("rx.dispatch.demod", at):
            rec = self.demod_channels(chans)
        with SPANS.span("rx.dispatch.pack", at):
            flat = self.pack_records(rec)
        done = None
        if flat.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(flat.device))
        t1 = time.perf_counter_ns()
        SPANS.end(span, t1)
        self.collect_stats["dispatch_s"] += (t1 - t0) * 1e-9
        return flat, done, at // self.cfg.decimation, raw_u8, fmt, at

    def submit_wire(self, raw_u8: np.ndarray, fmt: str = "ci8", pos: int | None = None):
        """Stage + dispatch one n_in-sample wire step."""
        return self.dispatch_wire(self.stage_wire(raw_u8, fmt, pos))

    def fetch_wire(self, handle):
        """Wait for a step's device result and copy it to the host; returns
        the payload for `decode_fetched`."""
        flat, _done, chan_start, raw_u8, fmt, at = handle
        return flat.cpu().numpy(), chan_start, raw_u8, fmt, at

    # -- host half -------------------------------------------------------

    def decode_fetched(self, fetched) -> list:
        """Host back half: unpack, deframe, dedup, then recover the
        blocks whose burst table or lane directory overflowed from the
        step's wire bytes (with overflow_recovery on); each part timed
        into `collect_stats`.  The valid lanes' rows are deframed by one
        native call (a compact fetch read in place: a `row_steps` step);
        a host without the native library unpacks the fetch into the
        dense records and deframes them in numpy."""
        flat_np, chan_start, raw_u8, fmt, at = fetched
        st = self.collect_stats
        t0 = time.perf_counter_ns()
        _, n_sym = burst_table_geometry(self.demod_cfg)
        n_pack = -(-n_sym // 8)
        K = self.demod_cfg.max_bursts_per_block
        on_rows = native.available()
        dropped: list = []
        if on_rows and self.cfg.compact_lanes:
            rows, dropped = parse_wire_compact(flat_np, self.n_chan, self.n_blocks, K, n_pack)
        elif on_rows:
            rows = parse_wire_flat(flat_np, self.n_chan, self.n_blocks, K, n_pack)
        elif self.cfg.compact_lanes:
            rec_np, dropped = unpack_wire_compact(flat_np, self.n_chan, self.n_blocks, K, n_pack)
        else:
            rec_np = unpack_wire_flat(flat_np, self.n_chan, self.n_blocks, K, n_pack)
        if not on_rows and not self._warned_dense:
            self._warned_dense = True
            log.warning("native library unavailable: each wire fetch is unpacked into the "
                        "dense records and deframed in numpy, a slower host back half")
        n_det = rows.n_det if on_rows else rec_np.meta_i[:, :, 0, 3]
        over = self._overflowed(n_det, dropped)
        if dropped and not self.cfg.overflow_recovery:
            log.warning("compact_lanes=%d dropped valid lanes in %d block(s) and "
                        "overflow_recovery is off", self.cfg.compact_lanes, len(dropped))
        t1 = time.perf_counter_ns()
        emit_kw = dict(designators=self.cfg.designators, dedupers=self._dedupers,
                       samples_per_symbol=self.cfg.sps)
        if on_rows:
            warn_table_overflow(n_det, K, chan_start, self.core_len)
            dfr = self.cfg.deframer
            frames = native.hdlc_deframe_rows(
                rows.rows, rows.first, rows.count, n_sym, rows.plane_offset,
                dfr.min_length_bytes, dfr.max_length_bytes, out=self._row_frame_buffers())
            n_lanes, n_frames = rows.lanes.size, frames.rows.size
            t2 = time.perf_counter_ns()
            packets = emit_row_frames(rows, frames, chan_start, self.core_len, self.n_blocks, K,
                                      **emit_kw)
        else:
            lanes, triples = deframe_wire_records(rec_np, n_sym, chan_start, self.core_len,
                                                  self.cfg.deframer)
            n_lanes, n_frames = lanes.size, len(triples)
            t2 = time.perf_counter_ns()
            packets = emit_wire_frames(rec_np, lanes, triples, chan_start, self.core_len,
                                       **emit_kw)
        t3 = t4 = time.perf_counter_ns()
        recovered = bool(over) and self.cfg.overflow_recovery
        if recovered:
            # The step's samples from its wire bytes: the device decoders
            # on a CPU tensor.
            host = torch.from_numpy(np.require(raw_u8, np.uint8, ("C", "W")))
            iq_raw = iq_from_bytes(host, fmt, self.n_in).numpy()
            packets.extend(self._recover(iq_raw, at, over))
            packets.sort(key=lambda p: p.abs_sample)
            t4 = time.perf_counter_ns()
        if self.cfg.image_reject:
            packets = suppress_image_ghosts(packets)
        t5 = time.perf_counter_ns()
        st["unpack_s"] += (t1 - t0) * 1e-9
        st["deframe_s"] += (t2 - t1) * 1e-9
        st["emit_s"] += (t3 - t2 + t5 - t4) * 1e-9
        st["recover_s"] += (t4 - t3) * 1e-9
        st["lanes"] += int(n_lanes)
        st["frames"] += int(n_frames)
        st["row_steps"] += int(on_rows and bool(self.cfg.compact_lanes))
        if SPANS.on:
            SPANS.add("rx.host.unpack", at, t0, t1)
            SPANS.add("rx.host.deframe", at, t1, t2)
            if recovered:  # emit, recovery, then the ghosts (emit's)
                SPANS.add("rx.host.emit", at, t2, t3)
                SPANS.add("rx.host.recover", at, t3, t4)
                SPANS.add("rx.host.emit", at, t4, t5)
            else:
                SPANS.add("rx.host.emit", at, t2, t5)
        return packets

    def _row_frame_buffers(self) -> native.RowFrames:
        """The row deframe's outputs, made once: 8 frames for each row a
        fetch can hold (the directory's lanes, or every lane on the flat
        layout), and 64 more."""
        if self._row_frames is None:
            n_lanes = self.n_chan * self.n_blocks * self.demod_cfg.max_bursts_per_block
            n_rows = min(self.cfg.compact_lanes or n_lanes, n_lanes)
            self._row_frames = native.row_frame_buffers(
                8 * n_rows + 64, self.cfg.deframer.max_length_bytes)
        return self._row_frames

    def _overflowed(self, n_det: np.ndarray, dropped=()) -> list:
        """The step's overflowed blocks as (channel, block, n_detected):
        burst table, or lane directory (`dropped`); counted in
        `overflow_blocks`."""
        K = self.demod_cfg.max_bursts_per_block
        over = [(int(c), int(b), int(n_det[c, b])) for c, b in zip(*np.nonzero(n_det > K))]
        seen = {(c, b) for c, b, _ in over}
        over.extend(x for x in dropped if (x[0], x[1]) not in seen)
        self.overflow_blocks += len(over)
        return over

    def _recover(self, iq_raw: np.ndarray, abs_raw_start: int, over: list) -> list:
        """Re-demodulate the overflowed blocks of a step whose raw samples
        are `iq_raw` (pipeline/recover.py), on this receiver's device."""
        t0 = time.perf_counter()
        packets = recover_overflow_packets(
            iq_raw, abs_raw_start, self.cfg, self.constants.taps, over, self._dedupers,
            self._recover_demod)
        self.recover_s += time.perf_counter() - t0
        return packets

    def _recover_demod(self, k: int) -> BurstDemod:
        """The demodulator with a burst table of `k`, built once."""
        demod = self._recover_demods.get(k)
        if demod is None:
            cfg = dataclasses.replace(self.demod_cfg, max_bursts_per_block=k)
            c = self.constants
            demod = BurstDemod(cfg, self.cfg.block_len, self.core_len, preamble=c.preamble,
                               interp_bank=c.interp_bank, ff_delta=c.ff_delta,
                               device=self.device)
            self._recover_demods[k] = demod
        return demod

    def collect(self, handle) -> list:
        """Wait for a submitted step and decode its packets.

        `collect_stats` accumulates exec_s (wait for the device result),
        fetch_s (device-to-host copy) and host_s (the host back half);
        `last_collect_s` is this call's (exec + fetch, host) seconds."""
        at = handle[5]
        t0 = time.perf_counter_ns()
        if handle[1] is not None:
            handle[1].synchronize()
        t1 = time.perf_counter_ns()
        fetched = self.fetch_wire(handle)
        t2 = time.perf_counter_ns()
        span = SPANS.begin("rx.host", at, t2)
        try:
            packets = self.decode_fetched(fetched)
        finally:
            t3 = time.perf_counter_ns()
            SPANS.end(span, t3)
        SPANS.add("rx.wait", at, t0, t1)
        SPANS.add("rx.fetch", at, t1, t2)
        exec_s, fetch_s, host_s = (t1 - t0) * 1e-9, (t2 - t1) * 1e-9, (t3 - t2) * 1e-9
        self.last_collect_s = (exec_s + fetch_s, host_s)
        st = self.collect_stats
        st["exec_s"] += exec_s
        st["fetch_s"] += fetch_s
        st["host_s"] += host_s
        st["steps"] += 1
        return packets

    def decode_wire(self, raw_u8: np.ndarray, fmt: str = "ci8") -> list:
        """Decode one n_in-sample wire step (submit + collect)."""
        return self.collect(self.submit_wire(raw_u8, fmt))

    # -- complex-IQ path ---------------------------------------------------

    def device_step(self, x, start_raw: int) -> BurstRecords:
        """One device call over exactly n_in complex samples whose first
        is at absolute raw index `start_raw`: K5, then the demod.  `x` is
        complex64, numpy or a tensor; it goes to the device as it is."""
        x = torch.as_tensor(np.asarray(x, np.complex64)) if not torch.is_tensor(x) else x
        if x.dtype != torch.complex64 or x.shape != (self.n_in,):
            raise ValueError(f"a step is ({self.n_in},) complex64, got {x.dtype} {tuple(x.shape)}")
        ph = torch.from_numpy(self._phase0s(start_raw)).to(self.device)
        return self.demod_channels(self.channelizer_for("iq")(x.to(self.device), ph))

    def process(self, iq: np.ndarray) -> list:
        """Feed raw samples; returns (records, chan_start, step_iq) for each
        full step: `chan_start` is the absolute channel-rate index of block
        0, `step_iq` the step's samples (a view of the buffer)."""
        self._buf = np.concatenate([self._buf, np.asarray(iq, np.complex64)])
        out = []
        while self._buf.size >= self.n_in:
            step_iq = self._buf[: self.n_in]
            rec = self.device_step(step_iq, self._pos)
            out.append((rec, self._pos // self.cfg.decimation, step_iq))
            self._buf = self._buf[self.step_raw:]
            self._pos += self.step_raw
        return out

    def flush(self) -> list:
        """End of stream: zero-pad the buffered tail to one full step and
        decode it.  The padding becomes part of the stream, so flush only
        at the end."""
        if self._buf.size == 0:
            return []
        return self.decode(np.zeros(max(self.n_in - self._buf.size, 0), np.complex64))

    def decode(self, iq: np.ndarray) -> list:
        """Feed raw samples; returns the packets of the full steps."""
        packets = []
        for rec, chan_start, step_iq in self.process(iq):
            rec_np = BurstRecords(*(t.cpu().numpy() for t in rec))
            packets.extend(self._host_decode(rec_np, chan_start, step_iq))
        packets.sort(key=lambda p: p.abs_sample)
        return packets

    def _host_decode(self, rec_np: BurstRecords, chan_start: int, iq_raw: np.ndarray) -> list:
        """Host half of the complex path: deframe block by block, channel
        major, recover overflowed blocks from the step's raw samples
        `iq_raw`, then drop image ghosts."""
        over = self._overflowed(np.asarray(rec_np.n_detected))
        cfg = self.cfg
        packets = []
        for c in range(self.n_chan):
            packets.extend(deframe_records(
                BurstRecords(*(a[c] for a in rec_np)), chan_start, self.core_len,
                cfg.designators[c], self._dedupers[c], self.n_blocks, deframer=cfg.deframer,
                fftlen=cfg.demod.fftlen, samples_per_symbol=cfg.sps))
        if over and cfg.overflow_recovery:
            packets.extend(self._recover(iq_raw, chan_start * cfg.decimation, over))
        packets.sort(key=lambda p: p.abs_sample)
        if cfg.image_reject:
            packets = suppress_image_ghosts(packets)
        return packets

    def reset_dedup(self) -> None:
        """Forget dedup history (before re-decoding earlier positions)."""
        self._dedupers = [PacketDeduper() for _ in self.cfg.offsets_hz]

    def reset_collect_stats(self) -> None:
        self.collect_stats = _zero_collect_stats()

    # -- checkpoint / resume: the reference's state dict -----------------

    def get_state(self) -> dict:
        """Stream state as the reference's dict: the complex path's sample
        buffer, the absolute position of its first sample (which also
        fixes the mixer phase) and the dedup memory."""
        return {
            "buf": self._buf.copy(),
            "pos": self._pos,
            "dedup_recent": [list(d._recent) for d in self._dedupers],
        }

    def set_state(self, state: dict) -> None:
        self._buf = np.asarray(state["buf"], dtype=np.complex64).copy()
        self._pos = int(state["pos"])
        for d, recent in zip(self._dedupers, state["dedup_recent"]):
            d._recent = list(recent)
