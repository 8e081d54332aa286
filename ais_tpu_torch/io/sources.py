"""IQ sample sources: file, UDP, synthetic.

Equivalent of the reference's `_setup_source`
(reference: python/radio.py:151-215), which builds UHD / osmosdr / UDP /
file sources.  SDR hardware libraries don't exist in this environment, so
the hardware paths raise with a clear message while file/UDP/synthetic
cover the decode-path capabilities.  Formats cover the common SDR
interchange encodings (complex64, interleaved int16/int8/uint8).

When the native C++ loader is built (ais_tpu_torch/native), file conversion of
integer formats routes through it; numpy is the fallback.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np

_FORMATS = {
    "complex64": (np.complex64, 1),
    "cf32": (np.complex64, 1),
    "ci16": (np.int16, 2),
    "cs16": (np.int16, 2),
    "ci8": (np.int8, 2),
    "cs8": (np.int8, 2),
    "cu8": (np.uint8, 2),  # rtl_sdr capture format
    "ci4": (np.uint8, 1),  # nibble-packed 4-bit IQ: (I << 4) | Q per byte
    # 2-bit AGC'd Lloyd-Max IQ, 2 samples/byte.  Needs downstream
    # decimation gain: decodes at wideband/250 ksps rates (the
    # channelizer buries the quantization noise) but NOT at 48 ksps
    # channel rate, where 2-bit noise lands in-band.
    "ci2": (np.uint8, 1),
    # 1-bit sigma-delta IQ, 4 samples/byte (ops/convert.py ci1 layout).
    # Same processing-gain requirement as ci2, but stricter: the noise
    # shaping assumes a high oversampling ratio (wideband rates only).
    "ci1": (np.uint8, 1),
    # 1-bit fs/4-IF bandpass sigma-delta, 8 samples/byte — ONE bit per
    # complex sample (ops/convert.py cr1 layout).  Wideband rates only;
    # chunk boundaries land on whole bytes (8 samples), preserving the
    # (-j)^n IF phase (period 4).
    "cr1": (np.uint8, 1),
}


def _bytes_per_sample(fmt: str) -> float:
    """Wire bytes per complex sample (fractional for packed formats)."""
    if fmt == "ci2":
        return 0.5
    if fmt == "ci1":
        return 0.25
    if fmt == "cr1":
        return 0.125
    dtype, lanes = _FORMATS[fmt]
    return float(np.dtype(dtype).itemsize * lanes)


def _convert(raw: np.ndarray, fmt: str) -> np.ndarray:
    """Interleaved integer IQ -> complex64 in [-1, 1]."""
    if fmt in ("complex64", "cf32"):
        return raw.astype(np.complex64)
    if fmt == "ci4":
        # Packed: one byte per complex sample, no deinterleave step.
        v = raw.astype(np.int32)
        i = (v >> 4) & 15
        q = v & 15
        i -= 16 * (i >= 8)
        q -= 16 * (q >= 8)
        return ((i + 1j * q) / 8.0).astype(np.complex64)
    if fmt == "ci2":
        # 2 samples/byte, Lloyd-Max reconstruction levels (the host
        # mirror of ops/convert.py:iq_from_bytes_ci2).
        from ais_tpu_torch.ops.convert import CI2_INNER, CI2_OUTER

        v = raw.astype(np.int32)
        codes = np.stack(
            [(v >> 6) & 3, (v >> 4) & 3, (v >> 2) & 3, v & 3], axis=-1
        ).reshape(v.size * 4)
        m = codes.astype(np.float32) - 1.5
        lv = np.sign(m) * np.where(np.abs(m) > 1.0, CI2_OUTER, CI2_INNER)
        return (lv[0::2] + 1j * lv[1::2]).astype(np.complex64)
    if fmt == "ci1":
        # 4 samples/byte, MSB-first I0 Q0 I1 Q1 ... -> ±1 levels (the
        # host mirror of ops/convert.py:iq_from_bytes_ci1).
        bits = np.unpackbits(raw.astype(np.uint8)).astype(np.float32) * 2.0 - 1.0
        return (bits[0::2] + 1j * bits[1::2]).astype(np.complex64)
    if fmt == "cr1":
        # 8 real samples/byte at an fs/4 IF: ±1 levels downconverted by
        # (-j)^n (the host mirror of ops/convert.py:iq_from_bytes_cr1).
        r = np.unpackbits(raw.astype(np.uint8)).astype(np.float32) * 2.0 - 1.0
        n4 = -(-r.size // 4)
        re = np.tile(np.array([1.0, 0.0, -1.0, 0.0], np.float32), n4)[: r.size]
        im = np.tile(np.array([0.0, -1.0, 0.0, 1.0], np.float32), n4)[: r.size]
        return (r * re + 1j * (r * im)).astype(np.complex64)
    try:
        from ais_tpu_torch.native import iq_convert  # C++ fast path

        return iq_convert(raw, fmt)
    except Exception:
        pass
    if fmt in ("ci16", "cs16"):
        f = raw.astype(np.float32) / 32768.0
    elif fmt in ("ci8", "cs8"):
        f = raw.astype(np.float32) / 128.0
    elif fmt == "cu8":
        f = (raw.astype(np.float32) - 127.5) / 127.5
    else:
        raise ValueError(f"unknown IQ format {fmt!r}")
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


def read_iq_file(path: str | Path, fmt: str = "complex64") -> np.ndarray:
    """Whole-file read -> complex64 baseband (reference: python/radio.py:212)."""
    dtype, lanes = _FORMATS[fmt]
    raw = np.fromfile(str(path), dtype=dtype)
    if fmt in ("complex64", "cf32"):
        return raw.astype(np.complex64)
    if raw.size % 2:
        raw = raw[:-1]
    return _convert(raw, fmt)


class SampleSource:
    """Iterator over chunks of complex64 samples."""

    sample_rate: float

    def chunks(self, chunk_len: int) -> Iterator[np.ndarray]:
        raise NotImplementedError


@dataclass
class FileSource(SampleSource):
    path: str
    sample_rate: float = 250e3
    fmt: str = "complex64"
    repeat: bool = False

    def chunks(self, chunk_len: int) -> Iterator[np.ndarray]:
        dtype, lanes = _FORMATS[self.fmt]
        while True:
            with open(self.path, "rb") as f:
                while True:
                    buf = f.read(int(chunk_len * _bytes_per_sample(self.fmt)))
                    if not buf:
                        break
                    raw = np.frombuffer(buf, dtype=dtype)
                    if lanes == 2 and raw.size % 2:
                        raw = raw[:-1]
                    yield _convert(raw, self.fmt)
            if not self.repeat:
                return


@dataclass
class UdpSource(SampleSource):
    """UDP datagram IQ source (reference: python/radio.py:204-210)."""

    host: str
    port: int
    sample_rate: float = 250e3
    fmt: str = "complex64"
    timeout_s: float | None = None

    def chunks(self, chunk_len: int) -> Iterator[np.ndarray]:
        dtype, lanes = _FORMATS[self.fmt]
        want = int(chunk_len * _bytes_per_sample(self.fmt))
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind((self.host, self.port))
        if self.timeout_s is not None:
            sock.settimeout(self.timeout_s)
        pending = b""
        try:
            while True:
                try:
                    data, _ = sock.recvfrom(65536)
                except socket.timeout:
                    return
                if not data:
                    return
                pending += data
                while len(pending) >= want:
                    raw = np.frombuffer(pending[:want], dtype=dtype)
                    pending = pending[want:]
                    yield _convert(raw, self.fmt)
        finally:
            sock.close()


def open_source(
    source: str,
    sample_rate: float,
    fmt: str = "complex64",
    *,
    device_args: str = "",
    freq_hz: float = 162.0e6,
    gain_db: float | None = None,
    ppm: int = 0,
) -> SampleSource:
    """Parse the reference CLI's `-s` convention: "uhd" | "osmocom" |
    <ip:port> | <filename> (reference: python/radio.py:105-106, 202-213).

    `osmocom` with a ``rtl_tcp=host:port`` device string (the osmosdr
    convention the reference's `-D` argument carries,
    python/radio.py:188) — or a direct ``rtl_tcp:host:port`` source —
    opens a live rtl_tcp network SDR with working freq/rate/gain/ppm
    control (`ais_tpu_torch/io/rtl_tcp.py`).  USB-attached UHD/osmosdr devices
    have no device library in this build and raise with guidance.
    """
    rtl_spec = None
    if source.startswith("rtl_tcp"):
        rtl_spec = source
    elif source == "osmocom":
        rtl_spec = next(
            (a for a in device_args.split(",") if a.strip().startswith("rtl_tcp")),
            None,
        )
    if rtl_spec is not None:
        from ais_tpu_torch.io.rtl_tcp import RtlTcpSource, parse_rtl_tcp_addr

        host, port = parse_rtl_tcp_addr(rtl_spec.strip())
        return RtlTcpSource(
            host=host,
            port=port,
            sample_rate=sample_rate,
            freq_hz=freq_hz,
            gain_db=gain_db,
            ppm=ppm,
        )
    if source in ("uhd", "osmocom"):
        raise RuntimeError(
            f"SDR hardware source {source!r} is not available in this build; "
            "use -s rtl_tcp:<host>:<port> (or -s osmocom -D rtl_tcp=<host>:<port>) "
            "for a network SDR, stream samples over UDP (ip:port), or use a "
            "capture file"
        )
    if ":" in source and not Path(source).exists():
        host, port = source.rsplit(":", 1)
        return UdpSource(host=host, port=int(port), sample_rate=sample_rate, fmt=fmt)
    return FileSource(path=source, sample_rate=sample_rate, fmt=fmt)
