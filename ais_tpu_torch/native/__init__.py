"""Native (C++) runtime kernels with ctypes bindings.

The port's own copy of the reference package's host-side kernels —
integer-IQ conversion, the sigma-delta encoders, CRC-16/X.25, HDLC
deframing — in `ais_native.cpp`.  The library is built with g++ at
first use into `build/ais_tpu_torch/` beside the package (the directory
the CUDA kernels are built into), keyed by a hash of the source, never
into the package folder.  Every entry point has a pure-numpy twin in
the package, so on the CPU the native library is an accelerator, never
a requirement; tests assert both agree bit-for-bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np

from ais_tpu_torch._build import BUILD_DIR

_SRC = Path(__file__).parent / "ais_native.cpp"
_lib = None
_build_attempted = False


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libais_native_{digest}.so"


def _build(out: Path) -> bool:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17", str(_SRC), "-o", str(tmp)],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, out)
        return True
    except Exception:
        tmp.unlink(missing_ok=True)
        return False


def load():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_attempted
    if _lib is not None:
        return _lib
    if _build_attempted or os.environ.get("AIS_TPU_NO_NATIVE"):
        return None
    _build_attempted = True
    path = _lib_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.iq_convert_i16.argtypes = [
        ctypes.POINTER(ctypes.c_int16),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_float,
    ]
    lib.iq_convert_i8.argtypes = [
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_float,
    ]
    lib.iq_convert_u8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.c_float,
    ]
    lib.sigma_delta_ci1.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.sigma_delta_cr1.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.copy_bytes.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int32,
    ]
    lib.copy_bytes.restype = None
    lib.crc16_x25.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.crc16_x25.restype = ctypes.c_uint16
    lib.hdlc_deframe.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
    ]
    lib.hdlc_deframe.restype = ctypes.c_int32
    lib.hdlc_deframe_packed_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),   # packed (n_lanes, 2, n_pack)
        ctypes.POINTER(ctypes.c_int32),   # lanes
        ctypes.c_int32,                   # n_lanes
        ctypes.c_int32,                   # n_pack
        ctypes.c_int32,                   # n_sym
        ctypes.c_int32,                   # min_len
        ctypes.c_int32,                   # max_len
        ctypes.POINTER(ctypes.c_uint8),   # payload_out
        ctypes.c_int64,                   # payload_capacity
        ctypes.POINTER(ctypes.c_int32),   # frame_lens
        ctypes.POINTER(ctypes.c_int64),   # frame_starts
        ctypes.POINTER(ctypes.c_int32),   # frame_lane
        ctypes.c_int32,                   # max_frames
    ]
    lib.hdlc_deframe_packed_batch.restype = ctypes.c_int32
    lib.hdlc_deframe_rows.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),   # rows (n_rows, row_bytes)
        ctypes.c_int32,                   # n_rows
        ctypes.c_int32,                   # row_bytes
        ctypes.c_int32,                   # plane_offset
        ctypes.c_int32,                   # n_sym
        ctypes.POINTER(ctypes.c_int32),   # first
        ctypes.POINTER(ctypes.c_int32),   # count
        ctypes.c_int32,                   # min_len
        ctypes.c_int32,                   # max_len
        ctypes.POINTER(ctypes.c_uint8),   # payload_out
        ctypes.c_int64,                   # payload_capacity
        ctypes.POINTER(ctypes.c_int64),   # frame_offsets
        ctypes.POINTER(ctypes.c_int32),   # frame_lens
        ctypes.POINTER(ctypes.c_int64),   # frame_starts
        ctypes.POINTER(ctypes.c_int32),   # frame_row
        ctypes.c_int32,                   # max_frames
    ]
    lib.hdlc_deframe_rows.restype = ctypes.c_int32
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def iq_convert(raw: np.ndarray, fmt: str) -> np.ndarray:
    """Interleaved integer IQ -> complex64 via the native converter."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    raw = np.ascontiguousarray(raw)
    n = raw.size // 2
    out = np.empty(2 * n, dtype=np.float32)
    optr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if fmt in ("ci16", "cs16"):
        lib.iq_convert_i16(
            raw.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), optr, n, 1.0 / 32768.0
        )
    elif fmt in ("ci8", "cs8"):
        lib.iq_convert_i8(
            raw.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), optr, n, 1.0 / 128.0
        )
    elif fmt == "cu8":
        lib.iq_convert_u8(
            raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            optr,
            n,
            127.5,
            1.0 / 127.5,
        )
    else:
        raise ValueError(f"unsupported native format {fmt!r}")
    return out.view(np.complex64)


def sigma_delta_ci1(iq: np.ndarray, scale: float) -> np.ndarray:
    """First-order sigma-delta 1-bit encode (ci1 wire format).

    `iq`: complex64 (n,) with n % 4 == 0; `scale` maps the signal into
    the unit-level quantizer domain (gain / rms).  Returns (n/4,) uint8.
    Numpy twin: ais_tpu_torch.ops.convert._sigma_delta_ci1_numpy.
    """
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    iq = np.ascontiguousarray(iq, dtype=np.complex64)
    out = np.empty(iq.size // 4, dtype=np.uint8)
    lib.sigma_delta_ci1(
        iq.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        iq.size,
        float(scale),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


def sigma_delta_cr1(iq: np.ndarray, scale: float, a2: float = 2.0) -> np.ndarray:
    """Fourth-order-FIR bandpass sigma-delta 1-bit encode (cr1 wire:
    fs/4-IF real stream, 8 samples/byte, 1 bit per complex sample).

    `iq`: complex64 (n,); `scale` maps into the unit-level quantizer
    domain; `a2` is the NTF's z^-2 coefficient (NTF = 1 + a2 z^-2 +
    z^-4): 2.0 doubles the zeros at fs/4, CR1_A2 (ops/convert.py)
    splits them onto the two AIS channels for ~7 dB lower in-band
    quantization noise at identical loop structure/stability.
    Returns (ceil(n/8),) uint8 (last byte zero-padded).
    Numpy twin: ais_tpu_torch.ops.convert._sigma_delta_cr1_numpy.
    """
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    iq = np.ascontiguousarray(iq, dtype=np.complex64)
    out = np.empty(-(-iq.size // 8), dtype=np.uint8)
    lib.sigma_delta_cr1(
        iq.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        iq.size,
        float(scale),
        float(a2),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


def copy_bytes(dst: np.ndarray, src: np.ndarray, threads: int) -> None:
    """dst[:] = src, split over `threads` native threads (the interpreter
    lock released).  Both are C-contiguous uint8 of one size, and do not
    overlap.  Numpy twin: `np.copyto(dst, src)`."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    for a in (dst, src):
        if a.dtype != np.uint8 or not a.flags.c_contiguous:
            raise ValueError(f"copy_bytes takes C-contiguous uint8, got {a.dtype}")
    if dst.size != src.size or not dst.flags.writeable:
        raise ValueError(f"copy_bytes: a writeable {src.size}-byte destination, got "
                         f"{dst.size} bytes")
    lib.copy_bytes(dst.ctypes.data, src.ctypes.data, src.size, int(threads))


def crc16_x25(data: bytes) -> int:
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    return int(
        lib.crc16_x25(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), arr.size)
    )


def _deframe_out_buffers(max_frames: int, max_len: int):
    """Output arrays shared by the deframe entry points."""
    payload_cap = max_frames * (max_len + 2)
    return (
        np.zeros(payload_cap, dtype=np.uint8),
        payload_cap,
        np.zeros(max_frames, dtype=np.int32),
        np.zeros(max_frames, dtype=np.int64),
    )


def _warn_if_capped(n: int, max_frames: int, entry: str) -> None:
    # The C kernel stops emitting at max_frames; hitting the cap means
    # later frames in this bit stream may have been dropped.
    if n == max_frames:
        import logging

        logging.getLogger("ais_tpu_torch").warning(
            "native %s hit max_frames=%d — possible truncation; pass a "
            "larger max_frames",
            entry,
            max_frames,
        )


def hdlc_deframe(
    bits: np.ndarray, min_len: int = 11, max_len: int = 64, max_frames: int = 64
):
    """Native HDLC deframe; returns list of (payload: bytes, start_bit)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    bits = np.ascontiguousarray(np.asarray(bits, dtype=np.uint8))
    payload, payload_cap, lens, starts = _deframe_out_buffers(max_frames, max_len)
    n = lib.hdlc_deframe(
        bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        bits.size,
        min_len,
        max_len,
        payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        payload_cap,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_frames,
    )
    _warn_if_capped(n, max_frames, "hdlc_deframe")
    out = []
    off = 0
    for i in range(n):
        out.append((payload[off : off + lens[i]].tobytes(), int(starts[i])))
        off += lens[i]
    return out


def hdlc_deframe_packed_batch(
    packed: np.ndarray,
    lanes: np.ndarray,
    n_sym: int,
    min_len: int = 11,
    max_len: int = 64,
    max_frames: int = 512,
):
    """Batched HDLC deframe straight from packed wire bit planes.

    `packed`: (n_lanes, 2, n_pack) uint8, plane 0 bits / plane 1
    bit-valid, MSB-first (pipeline/wideband.py:pack_wire_records layout);
    `lanes`: int32 flat indices of the valid bursts to deframe.  Returns
    a list of (payload: bytes, start_bit, lane_list_index) — start_bit
    in compressed-bit coordinates, identical to `hdlc_deframe`.  ONE
    native call per record fetch; the per-burst ctypes marshalling it
    replaces dominated the host back half at full channel load.
    """
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    lanes = np.ascontiguousarray(lanes, dtype=np.int32)
    n_lanes, two, n_pack = packed.shape[-3:]
    if two != 2 or n_sym > n_pack * 8:
        raise ValueError(
            f"packed planes {packed.shape[-3:]} cannot hold n_sym={n_sym}"
        )
    payload, payload_cap, lens, starts = _deframe_out_buffers(max_frames, max_len)
    lane_of = np.zeros(max_frames, dtype=np.int32)
    n = lib.hdlc_deframe_packed_batch(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lanes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lanes.size,
        n_pack,
        n_sym,
        min_len,
        max_len,
        payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        payload_cap,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lane_of.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_frames,
    )
    if n < 0:
        raise ValueError("n_sym exceeds native bit-buffer capacity")
    _warn_if_capped(n, max_frames, "hdlc_deframe_packed_batch")
    out = []
    off = 0
    for i in range(n):
        out.append(
            (payload[off : off + lens[i]].tobytes(), int(starts[i]),
             int(lane_of[i]))
        )
        off += lens[i]
    return out


class RowFrames(NamedTuple):
    """Frames of `hdlc_deframe_rows`, frame i's payload
    `payload[offsets[i]: offsets[i] + lens[i]]`."""

    payload: np.ndarray  # uint8, the payloads back to back
    offsets: np.ndarray  # (n,) int64
    lens: np.ndarray     # (n,) int32
    starts: np.ndarray   # (n,) int64 start bit, counted from the run's first
    rows: np.ndarray     # (n,) int32 row of each frame


def row_frame_buffers(max_frames: int, max_len: int = 64) -> RowFrames:
    """Output arrays for `hdlc_deframe_rows`, room for `max_frames`
    frames of up to `max_len` payload octets (uninitialised: the call
    writes what it returns)."""
    return RowFrames(np.empty(max_frames * (max_len + 2), np.uint8),
                     np.empty(max_frames, np.int64), np.empty(max_frames, np.int32),
                     np.empty(max_frames, np.int64), np.empty(max_frames, np.int32))


def hdlc_deframe_rows(
    rows: np.ndarray,
    first: np.ndarray,
    count: np.ndarray,
    n_sym: int,
    plane_offset: int,
    min_len: int = 11,
    max_len: int = 64,
    out: RowFrames | None = None,
) -> RowFrames:
    """Batched HDLC deframe straight from a wire fetch's rows.

    `rows`: (n_rows, row_bytes) uint8, each row's packed bit plane
    (`n_sym` bits, MSB first) at byte `plane_offset` (24 in a
    pack_wire_compact row, 0 in pack_wire_flat's bit plane; see
    pipeline/wideband.py:WireRows); `first`, `count`:
    each row's bit-valid run.  Gives the frames `hdlc_deframe_packed_batch`
    gives on the dense planes of the same lanes, as arrays (views of
    `out`, which `row_frame_buffers` makes; by default room for
    8 * n_rows + 64 frames)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    first = np.ascontiguousarray(first, dtype=np.int32)
    count = np.ascontiguousarray(count, dtype=np.int32)
    n_rows, row_bytes = rows.shape
    if first.shape != (n_rows,) or count.shape != (n_rows,):
        raise ValueError(f"first {first.shape} / count {count.shape} for {n_rows} rows")
    if out is None:
        out = row_frame_buffers(8 * n_rows + 64, max_len)
    max_frames = out.lens.size
    if not out.offsets.size == out.starts.size == out.rows.size == max_frames:
        raise ValueError("row_frame_buffers' arrays must hold the same number of frames")
    n = lib.hdlc_deframe_rows(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_rows,
        row_bytes,
        plane_offset,
        n_sym,
        first.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        count.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        min_len,
        max_len,
        out.payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.payload.size,
        out.offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_frames,
    )
    if n < 0:
        raise ValueError(
            f"rows of {row_bytes} B cannot hold n_sym={n_sym} bits at byte {plane_offset}, "
            f"or n_sym exceeds the native bit-buffer capacity")
    _warn_if_capped(n, max_frames, "hdlc_deframe_rows")
    return RowFrames(out.payload, out.offsets[:n], out.lens[:n], out.starts[:n], out.rows[:n])
