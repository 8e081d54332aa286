"""CPM (continuous-phase modulation) decomposition utilities.

The capability of the reference's `fsm_utils.py` (reference:
python/fsm_utils.py:39-164 — base conversions, ISI tables, and the
Rimoldi decomposition `make_cpm_signals`), which it ships as the vestige
of an abandoned coherent/Viterbi demodulator.  Rebuilt here from the
Rimoldi tilted-phase formulation: a CPM with modulation index h = K/P,
alphabet size M, and frequency pulse of L symbols decomposes into a
P * M^(L-1)-state machine whose per-(state, symbol) waveforms span a
small orthonormal basis — the foundation for a coherent MLSE demod
(GMSK: M=2, h=1/2, Gaussian pulse).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ais_tpu_torch.ops.firdes import gaussian


def dec2base(num: int, base: int, ndigits: int) -> list[int]:
    """Digits of `num` in `base`, most-significant first, fixed width."""
    digits = []
    for _ in range(ndigits):
        digits.append(num % base)
        num //= base
    return list(reversed(digits))


def base2dec(digits, base: int) -> int:
    out = 0
    for d in digits:
        out = out * base + int(d)
    return out


class CpmDecomposition(NamedTuple):
    n_states: int          # P * M^(L-1)
    n_symbols: int         # M
    next_state: np.ndarray  # (n_states, M) int
    signals: np.ndarray     # (n_states, M, sps) complex waveforms (one symbol)
    basis: np.ndarray       # (n_basis, sps) orthonormal basis
    coeffs: np.ndarray      # (n_states, M, n_basis) projection coefficients
    energy_captured: float  # fraction of signal energy in the basis


def gmsk_frequency_pulse(sps: int, bt: float = 0.4, span: int = 4) -> np.ndarray:
    """GMSK frequency pulse with the standard CPM normalization
    q(inf) = integral = 1/2, so a full symbol advances phase by pi*h*a."""
    g = gaussian(1.0, sps, bt, span * sps).astype(np.float64)
    pulse = np.convolve(g, np.ones(sps))
    return pulse / (2.0 * pulse.sum())


def make_cpm_signals(
    M: int = 2,
    h_num: int = 1,
    h_den: int = 2,
    sps: int = 5,
    pulse: np.ndarray | None = None,
    L: int | None = None,
    basis_energy: float = 0.999,
) -> CpmDecomposition:
    """Rimoldi decomposition of a CPM signal set.

    State = (accumulated phase index in [0, 2*h_den), last L-1 symbols).
    For each state and input symbol, the one-symbol-long waveform is
    computed; an SVD across the whole signal set yields the orthonormal
    basis and coefficients (the reference's scipy.linalg step,
    python/fsm_utils.py:140-156, done with numpy's SVD).
    """
    if pulse is None:
        pulse = gmsk_frequency_pulse(sps)
    pulse = np.asarray(pulse, dtype=np.float64)
    if L is None:
        L = -(-pulse.size // sps)
    # Pad the pulse to exactly L symbols.
    padded = np.zeros(L * sps)
    padded[: pulse.size] = pulse
    h = h_num / h_den
    phase_mod = 2 * h_den  # accumulated phase is a multiple of pi*h

    n_mem = M ** (L - 1)
    n_states = phase_mod * n_mem
    next_state = np.zeros((n_states, M), dtype=np.int64)
    signals = np.zeros((n_states, M, sps), dtype=np.complex128)

    # Symbol alphabet +-1, +-3, ... (M-ary CPM convention).
    alphabet = 2 * np.arange(M) - (M - 1)

    cum = np.cumsum(padded)
    for state in range(n_states):
        phase_idx = state // n_mem
        mem = dec2base(state % n_mem, M, L - 1)  # previous L-1 symbol indices
        for sym in range(M):
            seq = mem + [sym]  # oldest ... newest, length L
            # Phase over this symbol interval: accumulated phase plus the
            # partial contributions of the last L symbols.
            t_phase = np.full(sps, np.pi * h * phase_idx)
            for k, s_idx in enumerate(seq):
                a = alphabet[s_idx]
                # Symbol k of the window entered (L-1-k) symbols ago; its
                # pulse segment for the current interval:
                seg = cum[(L - 1 - k) * sps : (L - k) * sps]
                t_phase = t_phase + 2 * np.pi * h * a * seg
            signals[state, sym] = np.exp(1j * t_phase)
            # Next state: the oldest symbol's full phase contribution is
            # absorbed into the accumulator.
            a_old = alphabet[seq[0]] if L > 1 else alphabet[sym]
            new_phase = (phase_idx + a_old) % phase_mod
            new_mem = base2dec(mem[1:] + [sym], M) if L > 1 else 0
            next_state[state, sym] = new_phase * n_mem + new_mem

    flat = signals.reshape(-1, sps)
    # SVD over [real; imag] stacked to get a real orthonormal basis for the
    # complex signal set's span.
    u, s, vh = np.linalg.svd(flat, full_matrices=False)
    total = float(np.sum(s**2))
    keep = 1
    while keep < s.size and float(np.sum(s[:keep] ** 2)) / total < basis_energy:
        keep += 1
    basis = vh[:keep]
    coeffs = flat @ basis.conj().T
    captured = float(np.sum(s[:keep] ** 2)) / total
    return CpmDecomposition(
        n_states=n_states,
        n_symbols=M,
        next_state=next_state,
        signals=signals,
        basis=basis,
        coeffs=coeffs.reshape(n_states, M, keep),
        energy_captured=captured,
    )
