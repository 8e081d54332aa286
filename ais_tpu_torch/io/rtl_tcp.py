"""rtl_tcp network SDR source: a real hardware-source client.

The reference's `-s osmocom` path builds an `osmosdr.source`
(reference: python/radio.py:186-199), whose most common deployment
fronts an RTL-SDR dongle — either locally over USB or remotely through
the `rtl_tcp` server that ships with librtlsdr.  USB device libraries don't
exist in this environment, but the rtl_tcp *network protocol* is plain
TCP and fully implementable: this module speaks it end-to-end, so the
receiver can drive a genuine SDR over the network with working
frequency / sample-rate / gain / ppm control — the controls the
reference applies at python/radio.py:188-199 (tune with ppm folded in
at :191, gain at :195-199).

Wire protocol (public, from the librtlsdr rtl_tcp server):

- On connect the server sends a 12-byte dongle header:
  ``magic[4] = "RTL0"``, ``tuner_type:u32be``, ``tuner_gain_count:u32be``.
- The client sends 5-byte commands: ``opcode:u8`` + ``arg:u32be``.
- The server then streams interleaved offset-binary uint8 IQ (the
  ``cu8`` capture format) forever.

ppm handling: the reference compensates oscillator error by commanding
``162.0e6 * (1 + ppm*1e-6)`` (python/radio.py:160,191).  rtl_tcp has a
first-class frequency-correction command (SET_FREQ_CORRECTION), so this
source tunes to the exact center and sends the ppm natively — the
library applies the same correction on-device.
"""

from __future__ import annotations

import socket
import struct
from dataclasses import dataclass, field
from typing import Iterator

import numpy as np

from ais_tpu_torch.io.sources import SampleSource, _convert

# Command opcodes (librtlsdr src/rtl_tcp.c command switch).
CMD_SET_FREQ = 0x01
CMD_SET_SAMPLE_RATE = 0x02
CMD_SET_GAIN_MODE = 0x03  # 0 = hardware AGC, 1 = manual
CMD_SET_GAIN = 0x04  # tenths of dB
CMD_SET_FREQ_CORRECTION = 0x05  # ppm, signed
CMD_SET_AGC_MODE = 0x08  # RTL2832 digital AGC

MAGIC = b"RTL0"

# Tuner type ids from the header (informational; gain tables differ).
TUNER_NAMES = {
    0: "UNKNOWN",
    1: "E4000",
    2: "FC0012",
    3: "FC0013",
    4: "FC2580",
    5: "R820T",
    6: "R828D",
}


def _pack_cmd(opcode: int, arg: int) -> bytes:
    """5-byte command frame: u8 opcode + u32 big-endian argument."""
    return struct.pack(">BI", opcode, arg & 0xFFFFFFFF)


@dataclass
class RtlTcpSource(SampleSource):
    """Stream cu8 IQ from an rtl_tcp server with live tuner control.

    Mirrors the reference's osmosdr source configuration surface
    (python/radio.py:186-199): center frequency, sample rate, gain
    (``None`` = hardware AGC, matching the reference's "no gain given"
    branch at :196-199), and ppm frequency correction.
    """

    host: str
    port: int
    sample_rate: float = 250e3
    freq_hz: float = 162.0e6
    gain_db: float | None = None
    ppm: int = 0
    timeout_s: float | None = None

    # Filled from the server header by connect().
    tuner_type: int = field(default=0, init=False)
    tuner_gain_count: int = field(default=0, init=False)
    _sock: socket.socket | None = field(default=None, init=False, repr=False)

    # -- connection ----------------------------------------------------

    def connect(self) -> None:
        """Open the TCP connection, validate the dongle header, and push
        the initial tuner configuration."""
        if self._sock is not None:
            return
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout_s
        )
        try:
            header = self._recv_exact(sock, 12)
            if header[:4] != MAGIC:
                raise RuntimeError(
                    f"not an rtl_tcp server: bad magic {header[:4]!r}"
                )
            self.tuner_type, self.tuner_gain_count = struct.unpack(
                ">II", header[4:12]
            )
            self._sock = sock
        except Exception:
            sock.close()
            raise
        # Order mirrors rtl_tcp clients: rate first (resets the dongle's
        # resampler), then correction, then tune, then gain.
        self.set_sample_rate(self.sample_rate)
        if self.ppm:
            self.set_ppm(self.ppm)
        self.set_freq(self.freq_hz)
        self.set_gain(self.gain_db)

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    @staticmethod
    def _recv_exact(sock: socket.socket, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("rtl_tcp server closed during header")
            buf += chunk
        return buf

    def _send(self, opcode: int, arg: int) -> None:
        if self._sock is None:
            raise RuntimeError("rtl_tcp source is not connected")
        self._sock.sendall(_pack_cmd(opcode, arg))

    # -- live tuner controls (reference pubsub equivalents,
    #    python/radio.py:93-98 "gain"/"rate" publish/subscribe) --------

    def set_freq(self, freq_hz: float) -> None:
        self.freq_hz = float(freq_hz)
        self._send(CMD_SET_FREQ, int(round(freq_hz)))

    def set_sample_rate(self, rate: float) -> None:
        self.sample_rate = float(rate)
        self._send(CMD_SET_SAMPLE_RATE, int(round(rate)))

    def set_gain(self, gain_db: float | None) -> None:
        """``None`` -> hardware AGC (gain mode 0 + RTL digital AGC),
        else manual mode + tuner gain in dB."""
        self.gain_db = gain_db
        if gain_db is None:
            self._send(CMD_SET_GAIN_MODE, 0)
            self._send(CMD_SET_AGC_MODE, 1)
        else:
            self._send(CMD_SET_GAIN_MODE, 1)
            self._send(CMD_SET_GAIN, int(round(float(gain_db) * 10.0)))

    def set_ppm(self, ppm: int) -> None:
        self.ppm = int(ppm)
        # Signed value rides the u32 two's-complement representation.
        self._send(CMD_SET_FREQ_CORRECTION, int(ppm))

    # -- streaming -----------------------------------------------------

    def chunks(self, chunk_len: int) -> Iterator[np.ndarray]:
        """Yield complex64 chunks of `chunk_len` samples until the
        server closes (2 wire bytes per sample, cu8)."""
        self.connect()
        assert self._sock is not None
        want = int(chunk_len) * 2
        pending = b""
        try:
            while True:
                try:
                    data = self._sock.recv(65536)
                except socket.timeout:
                    break
                if not data:
                    break
                pending += data
                while len(pending) >= want:
                    raw = np.frombuffer(pending[:want], dtype=np.uint8)
                    pending = pending[want:]
                    yield _convert(raw, "cu8")
            if len(pending) >= 2:
                raw = np.frombuffer(
                    pending[: len(pending) // 2 * 2], dtype=np.uint8
                )
                yield _convert(raw, "cu8")
        finally:
            self.close()


def parse_rtl_tcp_addr(spec: str) -> tuple[str, int]:
    """Accepts ``rtl_tcp:host:port``, ``rtl_tcp=host:port`` (the osmosdr
    device-string convention the reference's `-D` argument carries), and
    ``rtl_tcp://host:port``; host defaults to localhost, port to 1234."""
    body = spec
    for prefix in ("rtl_tcp://", "rtl_tcp=", "rtl_tcp:", "rtl_tcp"):
        if body.startswith(prefix):
            body = body[len(prefix) :]
            break
    if not body:
        return "127.0.0.1", 1234
    if ":" in body:
        host, port = body.rsplit(":", 1)
        return host or "127.0.0.1", int(port)
    return body, 1234
