"""Polyphase arbitrary-rate resampler, on the host in numpy.

Port of `ais_tpu/ops/resample.py` (`default_prototype`, `polyphase_bank`,
`pfb_arb_resample`, `PfbArbResampler`): the equivalent of GNU Radio's
`pfb_arb_resampler_ccf`.  A prototype low-pass sampled at `nfilts` x the
input rate is split into `nfilts` phase banks; output k sits at input
position k/rate, whose fractional part selects a bank, linearly
interpolated with the next one.

The reference keeps the streaming resampler on the host on purpose: it
runs at the channel rate (~50 ksps), where a device round trip per chunk
costs more than the FIR.  The port does the same; its own copy exists
because `ais_tpu.ops.resample` imports jax.
"""

from __future__ import annotations

import functools

import numpy as np

from ais_tpu_torch.ops.firdes import low_pass_2


@functools.lru_cache(maxsize=16)
def default_prototype(nfilts: int = 32, cutoff_frac: float = 0.4,
                      attenuation_db: float = 96.0) -> np.ndarray:
    """Prototype low-pass for near-unity rates: cutoff at `cutoff_frac`
    of the input Nyquist, unity DC gain per phase, 96 dB stopband (the
    reference flowgraph's `firdes.low_pass_2(..., 96)`).  Read-only."""
    return low_pass_2(float(nfilts), float(nfilts), cutoff_frac, 0.1, attenuation_db)


def polyphase_bank(taps: np.ndarray, nfilts: int) -> np.ndarray:
    """(nfilts, taps_per_phase) bank; bank[p] = taps[p::nfilts]."""
    taps = np.asarray(taps, dtype=np.float32)
    tpp = -(-taps.size // nfilts)
    padded = np.zeros(tpp * nfilts, dtype=np.float32)
    padded[: taps.size] = taps
    return padded.reshape(tpp, nfilts).T.copy()


def _bank_coeffs(bank: np.ndarray, pos: np.ndarray, base: np.ndarray) -> np.ndarray:
    """Per-output taps: the bank picked by pos's fraction, linearly
    interpolated with the next bank (clamped at the last)."""
    nfilts = bank.shape[0]
    phase_f = (pos - base) * nfilts
    p0 = np.floor(phase_f).astype(np.int64)
    w = (phase_f - p0).astype(np.float32)
    p1 = np.minimum(p0 + 1, nfilts - 1)
    return bank[p0] * (1.0 - w)[:, None] + bank[p1] * w[:, None]


def pfb_arb_resample(x: np.ndarray, rate: float, taps: np.ndarray | None = None,
                     nfilts: int = 32) -> np.ndarray:
    """Resample (n,) `x` by `rate` (out_rate / in_rate), stateless:
    floor((n - taps_per_phase) * rate) outputs."""
    if taps is None:
        taps = default_prototype(nfilts)
    bank = polyphase_bank(taps, nfilts)
    tpp = bank.shape[1]
    x = np.asarray(x, dtype=np.complex64)
    n_out = int(np.floor((x.size - tpp) * rate))
    if n_out <= 0:
        raise ValueError(f"input of {x.size} samples too short to resample")
    pos = np.arange(n_out, dtype=np.float64) / rate
    base = np.floor(pos).astype(np.int64)
    frames = np.lib.stride_tricks.sliding_window_view(x, tpp)[base]
    return (frames * _bank_coeffs(bank, pos, base)).sum(axis=-1).astype(np.complex64)


class PfbArbResampler:
    """Streaming resampler with exact state carry: it keeps the input
    tail no output has finished reading and the absolute output counter,
    so concatenated `process()` calls give the same samples as one call
    over the whole stream, for any chunking.  State dict keys as the
    reference's (`buf`, `buf_start`, `k`)."""

    def __init__(self, rate: float, taps: np.ndarray | None = None, nfilts: int = 32):
        if taps is None:
            taps = default_prototype(nfilts)
        self.rate = float(rate)
        self.nfilts = int(nfilts)
        self._bank = polyphase_bank(taps, nfilts)
        self.taps_per_phase = self._bank.shape[1]
        self._buf = np.zeros(0, dtype=np.complex64)
        self._buf_start = 0   # absolute input index of _buf[0]
        self._k = 0           # outputs emitted so far (absolute output index)

    @property
    def outputs_emitted(self) -> int:
        return self._k

    def process(self, x: np.ndarray) -> np.ndarray:
        """Consume a chunk; return every output now computable.  Output k
        (absolute) reads the input frame starting at floor(k / rate)."""
        x = np.asarray(x, dtype=np.complex64)
        if x.size:
            self._buf = np.concatenate([self._buf, x])
        tpp = self.taps_per_phase
        limit = self._buf_start + self._buf.size - tpp  # last usable frame start
        if limit < 0:
            return np.zeros(0, dtype=np.complex64)
        # floor(k / rate) <= limit  <=>  k < (limit + 1) * rate
        k_end = int(np.ceil((limit + 1) * self.rate - 1e-9))
        ks = np.arange(self._k, k_end, dtype=np.int64)
        pos = ks / self.rate
        base = np.floor(pos).astype(np.int64)
        good = base <= limit  # float-edge stragglers wait for the next chunk
        ks, pos, base = ks[good], pos[good], base[good]
        if ks.size == 0:
            return np.zeros(0, dtype=np.complex64)
        frames = np.lib.stride_tricks.sliding_window_view(self._buf, tpp)[base - self._buf_start]
        out = (frames * _bank_coeffs(self._bank, pos, base)).sum(axis=-1).astype(np.complex64)
        self._k = int(ks[-1]) + 1
        # Drop inputs no later output reads.
        drop = max(0, int(np.floor(self._k / self.rate)) - self._buf_start)
        if drop:
            self._buf = self._buf[drop:]
            self._buf_start += drop
        return out

    def get_state(self) -> dict:
        return {"buf": self._buf.copy(), "buf_start": self._buf_start, "k": self._k}

    def set_state(self, state: dict) -> None:
        self._buf = np.asarray(state["buf"], dtype=np.complex64).copy()
        self._buf_start = int(state["buf_start"])
        self._k = int(state["k"])
