"""Port burst detection and feedforward timing against the JAX reference
(`ais_tpu/sync/corr.py`, `ais_tpu/sync/feedforward.py`).

Both sides get the same numpy inputs.  Detection: positions, validity
and counts exactly, the peak values to 1e-6 relative (the CFAR mean is a
sum in another order).  Timing: the estimate to 2e-3 samples, symbols
to 1e-4, the decoded bits exactly (from bit 2 on: see the test).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ais_tpu.tx.gmsk import modulate_bits, preamble_waveform
from ais_tpu_torch.ops.demod import quadrature_demod, slice_diff_invert
from ais_tpu_torch.ops.interp import interp_taps
from ais_tpu_torch.sync import corr as tcorr
from ais_tpu_torch.sync import feedforward as tff

torch.set_num_threads(1)


def _corr_rows(seed: int):
    """|corr| rows of a correlator run over noise + preambles, complex64."""
    rng = np.random.default_rng(seed)
    wf = preamble_waveform(5, 0.4).astype(np.complex64)
    n = 6000
    x = ((rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))) * 0.15).astype(np.complex64)
    for row, starts in enumerate([(400, 2500, 5200), (1000, 1150, 3000), ()]):
        for s in starts:
            x[row, s: s + wf.size] += wf * np.exp(1j * rng.uniform(0, 6.28))
    corr = np.stack([np.correlate(r, wf, mode="valid") for r in x]).astype(np.complex64)
    return corr, wf


@pytest.mark.parametrize("cfar_k,max_bursts,core_len", [(None, 4, 5000), (12.0, 4, 5000), (12.0, 1, 5861)])
def test_detect_bursts_matches_reference(cfar_k, max_bursts, core_len):
    from ais_tpu.sync.corr import autocorr_threshold, detect_bursts

    corr, wf = _corr_rows(4)
    thresh = autocorr_threshold(wf, 0.9)
    assert tcorr.autocorr_threshold(wf, 0.9) == thresh
    mag2 = (corr.real ** 2 + corr.imag ** 2).astype(np.float32)
    want = jax.vmap(lambda c, m: detect_bursts(
        c, thresh, 256, max_bursts, core_len, cfar_k=cfar_k, mag2=m))(jnp.asarray(corr), jnp.asarray(mag2))
    got = tcorr.detect_bursts(torch.from_numpy(corr), torch.from_numpy(mag2), thresh, 256,
                              max_bursts, core_len, cfar_k=cfar_k)
    np.testing.assert_array_equal(got.position.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(got.n_detected.numpy(), np.asarray(want[5]))
    np.testing.assert_allclose(got.center.numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.phase.numpy(), np.asarray(want[2]), atol=1e-6)
    np.testing.assert_allclose(got.mag.numpy(), np.asarray(want[3]), rtol=1e-6)
    assert got.valid.numpy().any()


def test_constants_match_reference():
    from ais_tpu.ops.interp import interp_taps as ref_bank
    from ais_tpu.sync.feedforward import _calibrate

    np.testing.assert_array_equal(interp_taps(), ref_bank())
    assert tff.ff_delta(5.0, 0.4) == _calibrate(5, 0.4)
    # A non-integer sps calibrates at the nearest whole one, as the
    # reference's `estimate_timing` does.
    assert tff.ff_delta(4.8, 0.4) == _calibrate(5, 0.4)
    assert tff.ff_delta(5.208, 0.4) == _calibrate(5, 0.4)


def _bursts(seed: int, n: int = 6, length: int = 4608):
    """GMSK bursts at 5 sps with random delays, carrier residue and noise."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, length), np.complex64)
    for i in range(n):
        d = int(rng.integers(0, 400))
        sig = modulate_bits(rng.integers(0, 2, 700), 5, 0.4)
        f = rng.uniform(-40, 40) / 48e3
        sig = sig * np.exp(2j * np.pi * f * np.arange(sig.size) + 1j * rng.uniform(0, 6.28))
        m = min(sig.size, length - d)
        out[i, d: d + m] = sig[:m]
        out[i] += ((rng.normal(size=length) + 1j * rng.normal(size=length)) * 0.05).astype(np.complex64)
    return out


def test_feedforward_matches_reference():
    from ais_tpu.ops.demod import slice_diff_invert as ref_slice
    from ais_tpu.ops.demod import quadrature_demod as ref_qd
    from ais_tpu.sync.feedforward import estimate_timing, feedforward_symbols_fir

    b = _bursts(5)
    n_sym = (4608 - 16) // 5
    delta = tff.ff_delta(5.0, 0.4)
    want_t = jax.vmap(lambda x: estimate_timing(x, 5.0))(jnp.asarray(b))
    got_t = tff.estimate_timing(torch.from_numpy(b), 5.0, delta)
    for g, w in zip(got_t, want_t):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-3)

    want_s, want_v = jax.vmap(lambda x: feedforward_symbols_fir(x, 5.0, n_sym))(jnp.asarray(b))
    got_s, got_v = tff.feedforward_symbols_fir(
        torch.from_numpy(b), 5.0, n_sym, delta, torch.from_numpy(interp_taps()))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)
    # Slice 0 is of arg(x0 * conj(x0)), zero in exact arithmetic: its sign
    # is a rounding artifact on either side, and it reaches bits 0 and 1
    # (diff decoding) — both ahead of the preamble.
    want_bits = np.asarray(ref_slice(ref_qd(want_s)))
    got_bits = slice_diff_invert(quadrature_demod(got_s)).numpy()
    np.testing.assert_array_equal(got_bits[:, 2:], want_bits[:, 2:])
