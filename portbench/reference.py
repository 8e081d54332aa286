"""The plain reference that decides `correct`, and its lower-precision control.

Plain NumPy; it imports nothing of the program and takes nothing the
program made except the outputs it judges.

- `channel_outputs`: the channelizer's outputs at chosen indices, from
  the definition: y[c, m] = e^{j phi_c} sum_k h[k] s[mD + k]
  e^{-j 2 pi f_c (mD + k) / fs}, phi_c = -2 pi f_c pos / fs, with s the
  samples the wire stands for (`wire_samples`: a 1-bit sigma-delta wire's
  +-1 levels, or a complex integer wire's I, Q over its full scale) and h
  the low-pass rebuilt from the configuration (`modem.low_pass`), in
  float64.
- `k2_input`: K2's input rows from the same definition, worked out
  again end to end: a demod block of one channel's outputs (`block_len`
  outputs from block b x `core_len`), its feedforward AGC (the gain that
  brings the peak envelope over the `agc_window` samples ahead to
  `agc_reference`) and its square-and-FFT AFC (one estimate a chunk of
  `afc_fftlen` samples from the strongest pair of tones of the squared
  signal, chunks under `afc_gate_ratio` holding the nearest confident
  chunk's, the NCO's phase carried across chunks), in float64.  Where
  the reference finds an AFC decision within a hair of a tie, |corr|^2
  is not compared over the samples that rest on it (`compared`).
- `corr_mag2`: K2's |corr|^2 of those rows against the preamble rebuilt
  from the configuration (`modem.preamble`), in float64.
- `compare_packets`: the decoded packets against the transmitted ones,
  keyed by (step, channel, payload): a transmitted packet is matched by
  one decode of its exact payload on its channel within `tol` channel
  samples of its start, returned by its own step's call.

`precision="bf16"` computes the same with every operand rounded to
bfloat16 and float32 sums: the control, the reference in the program's
place one precision below the float32 the configuration states.
"""

from __future__ import annotations

import bisect

import numpy as np

import modem

_ROT = np.array([1, -1j, -1, 1j])  # (-j)^n


def bf16(x: np.ndarray) -> np.ndarray:
    """Round float32 values to bfloat16 (nearest, ties to even), as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _cbf16(z: np.ndarray) -> np.ndarray:
    return bf16(z.real) + 1j * bf16(z.imag).astype(np.complex64)


def wire_samples(fmt: str, wire: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """The complex samples at indices `pos` of a wire (complex128): cr1's
    real bits at the fs/4 IF, ci1's I, Q bits (MSB first), as +-1; ci16's
    little-endian int16 I, Q over 32768, ci8's int8 over 128, cu8's
    uint8 as (v - 127.5) / 127.5."""
    pos = np.asarray(pos, np.int64)
    if fmt == "ci16":
        def comp(b):
            v = wire[b].astype(np.int64) | (wire[b + 1].astype(np.int64) << 8)
            return (v - ((v >> 15) << 16)) / 32768.0
        return comp(4 * pos) + 1j * comp(4 * pos + 2)
    if fmt == "ci8":
        return (wire[2 * pos].view(np.int8) / 128.0
                + 1j * (wire[2 * pos + 1].view(np.int8) / 128.0))
    if fmt == "cu8":
        return (wire[2 * pos] - 127.5) / 127.5 + 1j * ((wire[2 * pos + 1] - 127.5) / 127.5)
    if fmt == "cr1":
        bit = (wire[pos >> 3] >> (7 - (pos & 7))) & 1
        return (2.0 * bit - 1.0) * _ROT[pos & 3]
    if fmt == "ci1":
        i, q = 2 * pos, 2 * pos + 1
        bi = (wire[i >> 3] >> (7 - (i & 7))) & 1
        bq = (wire[q >> 3] >> (7 - (q & 7))) & 1
        return (2.0 * bi - 1.0) + 1j * (2.0 * bq - 1.0)
    raise ValueError(f"no reference decoder for {fmt!r}")


def taps(cfg: dict) -> np.ndarray:
    return modem.low_pass(cfg["input_rate"], cfg["cutoff_hz"], cfg["transition_hz"])


def channel_outputs(cfg: dict, wire: np.ndarray, pos: int, idx: np.ndarray,
                    precision: str = "float64") -> np.ndarray:
    """(n_chan, len(idx)) channelizer outputs of the step at stream
    position `pos` (raw samples), computed from the wire bytes."""
    h = taps(cfg)
    ntaps, D, fs = h.size, int(cfg["decimation"]), float(cfg["input_rate"])
    k = np.arange(ntaps, dtype=np.int64)
    out = np.empty((len(cfg["offsets_hz"]), len(idx)), np.complex128)
    for c, off in enumerate(cfg["offsets_hz"]):
        phi = np.remainder(-2.0 * np.pi * off / fs * float(pos), 2.0 * np.pi)
        for lo in range(0, len(idx), 256):
            m = np.asarray(idx[lo: lo + 256], np.int64)
            n = m[:, None] * D + k
            s = wire_samples(cfg["wire_format"], wire, n)
            car = np.exp(1j * np.remainder(-2.0 * np.pi * off / fs * n + phi, 2.0 * np.pi))
            if precision == "float64":
                out[c, lo: lo + m.size] = (s * car) @ h
            elif precision == "bf16":
                prod = (s.astype(np.complex64) * _cbf16(car.astype(np.complex64)))
                out[c, lo: lo + m.size] = _cbf16(prod) @ bf16(h.astype(np.float32))
            else:
                raise ValueError(precision)
    return out


TIE = 1e-4  # an AFC decision nearer a tie than this share is not compared


def _block_outputs(cfg: dict, wire: np.ndarray, pos: int, chan: int, m0: int,
                   n: int) -> np.ndarray:
    """Channel `chan`'s outputs m0 .. m0 + n - 1 of the step at `pos`,
    by one FFT convolution of the mixed samples they span (float64)."""
    h = taps(cfg)
    ntaps, D, fs = h.size, int(cfg["decimation"]), float(cfg["input_rate"])
    off = float(cfg["offsets_hz"][chan])
    raw = np.arange(m0 * D, (m0 + n - 1) * D + ntaps, dtype=np.int64)
    phi = -2.0 * np.pi * off / fs * float(pos)
    u = wire_samples(cfg["wire_format"], wire, raw) * np.exp(
        1j * np.remainder(-2.0 * np.pi * off / fs * raw + phi, 2.0 * np.pi))
    size = 1 << int(raw.size + ntaps - 1).bit_length()
    full = np.fft.ifft(np.fft.fft(u, size) * np.fft.fft(h[::-1], size))
    return full[ntaps - 1: ntaps - 1 + (n - 1) * D + 1: D]


def _agc(x: np.ndarray, window: int, reference: float) -> np.ndarray:
    env = np.lib.stride_tricks.sliding_window_view(
        np.concatenate([np.abs(x), np.zeros(window - 1)]), window).max(axis=1)
    return x * (reference / np.maximum(env, 1e-12))


def _afc(x: np.ndarray, fs: float, bit_rate: float, fftlen: int, gate: float):
    """(derotated x, per sample: whether the AFC's estimate there rests
    on a decision within TIE of a tie).  A confident chunk whose two
    best pairs of tones read within TIE of each other (one strong tone,
    such as a sigma-delta idle tone, sits in both) is ambiguous, and so
    is every chunk that holds its estimate; a chunk within TIE of the
    gate makes the whole row ambiguous."""
    spec = np.abs(np.fft.fftshift(np.fft.fft((x * x).reshape(-1, fftlen), axis=1), axes=1))
    dc = fftlen // 2
    spec[:, dc - 1: dc + 2] = 0.0
    off = int(fftlen * (bit_rate / fs))
    pair = spec[:, : fftlen - off] + spec[:, off:]
    best = np.argmax(pair, axis=1)
    top = pair[np.arange(pair.shape[0]), best]
    second = np.partition(pair, -2, axis=1)[:, -2]
    est = (best + off // 2 - dc) * (fs / fftlen / 2.0)
    conf = top / np.maximum(2.0 * spec.mean(axis=1), 1e-30)
    ok = conf >= gate
    tie = ok & (top - second <= TIE * top)
    held, held_tie = np.zeros_like(est), np.zeros(est.size, bool)
    idx = np.nonzero(ok)[0]
    for i in range(est.size):  # the nearest confident chunk; the earlier on a tie
        if idx.size:
            j = idx[np.argmin(np.abs(idx - i) * 2 + (idx > i))]
            held[i], held_tie[i] = est[j], tie[j]
    if np.any(np.abs(conf - gate) <= TIE * gate):
        held_tie[:] = True
    phase = np.cumsum(np.repeat(held, fftlen) * (-2.0 * np.pi / fs))
    return x * np.exp(1j * phase), np.repeat(held_tie, fftlen)


def k2_input(cfg: dict, wire: np.ndarray, pos: int, rows, n_blocks: int) -> tuple:
    """(K2's input rows (len(rows), block_len), complex128; per sample,
    whether the AFC's estimate there is ambiguous).  Row r is block
    r % n_blocks of channel r // n_blocks, as the demod batches them."""
    d = cfg["demod"]
    fs = float(cfg["input_rate"]) / int(cfg["decimation"])
    out, ambiguous = [], []
    for r in rows:
        chan, b = divmod(int(r), n_blocks)
        y = _block_outputs(cfg, wire, pos, chan, b * int(cfg["core_len"]), int(cfg["block_len"]))
        a = _agc(y, int(d["agc_window"]), float(d["agc_reference"]))
        x, amb = _afc(a, fs, float(cfg["bit_rate"]), int(d["afc_fftlen"]),
                      float(d["afc_gate_ratio"]))
        out.append(x)
        ambiguous.append(amb)
    return np.stack(out), np.stack(ambiguous)


def compared(ambiguous: np.ndarray, length: int) -> np.ndarray:
    """The |corr|^2 positions whose `length`-sample window touches no
    ambiguous sample: there |corr|^2 does not depend on how a tie went
    (a constant phase before the window does not change it)."""
    c = np.concatenate([np.zeros((ambiguous.shape[0], 1), np.int64),
                        np.cumsum(ambiguous, axis=1)], axis=1)
    return (c[:, length:] - c[:, :-length]) == 0


def corr_mag2(x: np.ndarray, preamble: np.ndarray, precision: str = "float64") -> np.ndarray:
    """|sum_k conj(p[k]) x[b, i + k]|^2 for each row b, every valid i."""
    if precision == "float64":
        xs, p = np.asarray(x, np.complex128), np.asarray(preamble, np.complex128)
    elif precision == "bf16":
        xs = _cbf16(np.asarray(x, np.complex64))
        p = _cbf16(np.asarray(preamble, np.complex64))
    else:
        raise ValueError(precision)
    return np.stack([np.abs(np.correlate(row, p, "valid")) ** 2 for row in xs])


def chan_gap(got: np.ndarray, want: np.ndarray) -> float:
    """Widest gap over the sampled outputs, over the outputs' RMS."""
    rms = float(np.sqrt(np.mean(np.abs(want) ** 2))) or 1.0
    return float(np.max(np.abs(np.asarray(got) - want))) / rms


def corr_gap(got: np.ndarray, want: np.ndarray, mask: np.ndarray | None = None) -> float:
    """Widest gap of |corr|^2 on each row over that row's peak, the
    widest row; only at the positions `mask` keeps (inf where it keeps
    none)."""
    got, want = np.asarray(got), np.asarray(want)
    mask = np.ones(want.shape, bool) if mask is None else mask
    gaps = [float(np.max(np.abs(g[m] - w[m])) / max(float(np.max(np.abs(w[m]))), 1e-30))
            for g, w, m in zip(got, want, mask) if m.any()]
    return max(gaps) if gaps else float("inf")


def compare_packets(found, packets, steps, step_chan: int, decim: int,
                    designators, tol: int = 300) -> dict:
    """Decoded packets against the transmitted `packets` (`scene.Packet`)
    of every step in `steps`, each step the capture replayed `step_chan`
    channel samples on.  `found` holds (step, packet) pairs: the step
    whose call returned the packet, and a packet with `.payload`, `.abs_sample` and `.designator`.

    matched: transmitted and decoded once, exactly, by its own step's
    call; missed: transmitted and not matched; wrong: a decode within
    `tol` of a transmitted packet on its channel that is no match
    (another payload, a second decode, an off position, another step's
    call); spurious: a decode far from every transmitted packet (noise
    that passed the CRC)."""
    want = {}
    near = {}
    for p in packets:
        d = designators[p.channel]
        want[(d, p.payload)] = p.start // decim
        near.setdefault(d, []).append(p.start // decim)
    for d in near:
        near[d].sort()
    steps = set(int(s) for s in steps)
    got = set()
    wrong = spurious = 0
    for call, f in found:
        step, local = divmod(int(f.abs_sample), step_chan)
        key = (f.designator, bytes(f.payload))
        w = want.get(key)
        if (step in steps and w is not None and abs(local - w) < tol
                and (step, key) not in got and call == step):
            got.add((step, key))
            continue
        starts = near.get(f.designator, [])
        j = bisect.bisect_left(starts, local - tol + 1)
        if step in steps and j < len(starts) and abs(starts[j] - local) < tol:
            wrong += 1
        else:
            spurious += 1
    attempted = len(want) * len(steps)
    return {"attempted": attempted, "matched": len(got), "missed": attempted - len(got),
            "wrong": wrong, "spurious": spurious}
