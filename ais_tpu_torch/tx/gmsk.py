"""GMSK modulation: symbol vector -> complex baseband.

The capability of upstream `digital.gmsk_mod` + `digital.modulate_vector_bc`
(reference: python/ais_demod.py:37-38, lib/modulate_vector.cc:51-68, in-repo
but dead), rebuilt as plain vector math: zero-stuff symbols, filter with the
Gaussian*rect frequency pulse, integrate phase, complexify.  Used to
synthesize the matched-filter preamble waveform and to generate golden IQ
captures for tests/benchmarks.
"""

from __future__ import annotations

import numpy as np

from ais_tpu_torch.ops.firdes import gmsk_phase_taps


def modulate_symbols(
    symbols: np.ndarray,
    samples_per_symbol: int,
    bt: float = 0.4,
    phase0: float = 0.0,
) -> np.ndarray:
    """GMSK-modulate +-1 symbols. Output length = len(symbols) * sps.

    Causal: output is the filter's leading `len(symbols)*sps` samples, so
    the waveform begins with the Gaussian ramp-in exactly like the
    reference's interp-FIR + FM modulator chain.
    """
    sps = int(samples_per_symbol)
    symbols = np.asarray(symbols, dtype=np.float64)
    taps = gmsk_phase_taps(sps, bt).astype(np.float64)
    upsampled = np.zeros(symbols.size * sps)
    upsampled[::sps] = symbols
    freq = np.convolve(upsampled, taps)[: symbols.size * sps]
    sensitivity = (np.pi / 2.0) / sps
    phase = phase0 + np.cumsum(sensitivity * freq)
    return np.exp(1j * phase).astype(np.complex64)


def modulate_bits(
    bits: np.ndarray,
    samples_per_symbol: int,
    bt: float = 0.4,
    phase0: float = 0.0,
) -> np.ndarray:
    """GMSK-modulate unpacked {0,1} bits (0 -> -1, 1 -> +1).

    Equivalent of modulate_vector_bc(gmsk_mod(sps, bt), bits, [1])
    (reference: python/ais_demod.py:38).
    """
    symbols = 2.0 * np.asarray(bits, dtype=np.float64) - 1.0
    return modulate_symbols(symbols, samples_per_symbol, bt, phase0)


def preamble_waveform(samples_per_symbol: int, bt: float = 0.4) -> np.ndarray:
    """The correlator's reference waveform: GMSK of the NRZI'd training
    sequence [1,1,0,0]*7 (reference: python/ais_demod.py:36-38)."""
    from ais_tpu_torch.core.params import PREAMBLE_NRZI

    return modulate_bits(np.array(PREAMBLE_NRZI), samples_per_symbol, bt)
