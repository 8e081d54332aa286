"""FIR tap design: windowed-sinc low-pass and Gaussian pulse shaping.

Equivalents of the upstream `filter.firdes.low_pass` / `firdes.gaussian`
designs the reference instantiates (reference: python/radio.py:49,
python/ais_demod.py:37 via gmsk_mod).  These are classical textbook
designs re-derived here: Hamming-windowed sinc with the 53 dB attenuation
tap-count rule, and the normalized Gaussian pulse for GMSK's
bandwidth-time product.  Returns numpy float32 (taps are compile-time
constants for the jitted pipeline).
"""

from __future__ import annotations

import numpy as np

_HAMMING_ATTEN_DB = 53.0


def num_taps_low_pass(sample_rate: float, transition_hz: float) -> int:
    """Hamming-window tap-count heuristic; forced odd."""
    ntaps = int(_HAMMING_ATTEN_DB / (22.0 * transition_hz / sample_rate))
    return ntaps | 1


def low_pass(
    gain: float,
    sample_rate: float,
    cutoff_hz: float,
    transition_hz: float,
    ntaps: int | None = None,
) -> np.ndarray:
    """Hamming-windowed sinc low-pass, unity (x`gain`) response at DC."""
    if ntaps is None:
        ntaps = num_taps_low_pass(sample_rate, transition_hz)
    ntaps |= 1
    m = (ntaps - 1) // 2
    n = np.arange(-m, m + 1, dtype=np.float64)
    fw = 2.0 * np.pi * cutoff_hz / sample_rate
    taps = np.where(n == 0, fw / np.pi, np.sin(n * fw) / (n * np.pi + (n == 0)))
    window = np.hamming(ntaps)
    taps = taps * window
    # Normalize to unity gain at DC.
    taps = taps * (gain / taps.sum())
    return taps.astype(np.float32)


def _kaiser_beta(attenuation_db: float) -> float:
    """Kaiser's empirical beta for a target stopband attenuation."""
    a = float(attenuation_db)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def low_pass_2(
    gain: float,
    sample_rate: float,
    cutoff_hz: float,
    transition_hz: float,
    attenuation_db: float = 53.0,
    ntaps: int | None = None,
) -> np.ndarray:
    """Attenuation-parameterized low-pass (Kaiser-windowed sinc).

    Equivalent of upstream `firdes.low_pass_2`, which the reference's
    development flowgraph uses for the polyphase-resampler prototype at a
    96 dB stopband spec (reference: python/ais.grc:1523).  Tap count from
    Kaiser's rule `N = (A - 7.95) / (2.285 * dw)`; window beta from the
    standard attenuation formula.
    """
    if ntaps is None:
        dw = 2.0 * np.pi * transition_hz / sample_rate
        ntaps = int(np.ceil((attenuation_db - 7.95) / (2.285 * dw)))
    ntaps |= 1
    m = (ntaps - 1) // 2
    n = np.arange(-m, m + 1, dtype=np.float64)
    fw = 2.0 * np.pi * cutoff_hz / sample_rate
    taps = np.where(n == 0, fw / np.pi, np.sin(n * fw) / (n * np.pi + (n == 0)))
    taps = taps * np.kaiser(ntaps, _kaiser_beta(attenuation_db))
    taps = taps * (gain / taps.sum())
    return taps.astype(np.float32)


def gaussian(gain: float, samples_per_symbol: float, bt: float, ntaps: int) -> np.ndarray:
    """Gaussian pulse taps for GMSK, normalized to sum to `gain`.

    The pulse std follows from the -3 dB bandwidth-time product:
    sigma_t = sqrt(ln 2) / (2*pi*BT) in symbol units.
    """
    alpha = np.sqrt(np.log(2.0)) / (2.0 * np.pi * bt)
    t = (np.arange(ntaps, dtype=np.float64) - 0.5 * ntaps + 1.0) / samples_per_symbol
    taps = np.exp(-0.5 * (t / alpha) ** 2)
    taps = taps * (gain / taps.sum())
    return taps.astype(np.float32)


def gmsk_phase_taps(samples_per_symbol: int, bt: float, span_symbols: int = 4) -> np.ndarray:
    """Frequency-pulse taps for a GMSK modulator.

    Gaussian pulse convolved with the one-symbol rectangular pulse, as in
    the upstream `digital.gmsk_mod` construction
    (reference: python/ais_demod.py:37).  Total area == samples_per_symbol
    so that one +-1 symbol advances phase by +-pi/2 under sensitivity
    (pi/2)/sps.
    """
    sps = int(samples_per_symbol)
    g = gaussian(1.0, sps, bt, span_symbols * sps).astype(np.float64)
    taps = np.convolve(g, np.ones(sps))
    return taps.astype(np.float32)
