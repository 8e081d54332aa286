"""Port sample-rate ops against their JAX counterparts: framing, sliding
maxima, AGC, AFC (square-and-FFT estimate, gate-and-hold, derotation),
quadrature demod and bit slicing.  Inputs come from numpy with a seed.

Tolerances: index-valued and max-valued results exactly; the AGC to
1e-6 relative (|x| computed by different libraries); the derotated
signal to 2e-3 absolute, since its NCO phase is a float32 cumulative
sum over 16384 samples taken in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ais_tpu_torch.ops import agc, demod, framing, freq, window

torch.set_num_threads(1)


def _cplx(rng, *shape, scale=1.0):
    return ((rng.normal(size=shape) + 1j * rng.normal(size=shape)) * scale).astype(np.complex64)


@pytest.mark.parametrize("core,halo", [(8, 3), (8, 8), (4, 11)])
def test_framing_matches_reference(core, halo):
    from ais_tpu.ops.framing import frame_overlap, frame_overlap_big

    x = _cplx(np.random.default_rng(0), 2, 32)
    want = np.asarray(frame_overlap_big(jnp.asarray(x), core, halo))
    np.testing.assert_array_equal(framing.frame_overlap_big(torch.from_numpy(x), core, halo).numpy(), want)
    if halo <= core:
        want = np.asarray(frame_overlap(jnp.asarray(x), core, halo))
        np.testing.assert_array_equal(framing.frame_overlap(torch.from_numpy(x), core, halo).numpy(), want)


@pytest.mark.parametrize("w", [1, 2, 5, 64, 300])
def test_sliding_max_matches_reference(w):
    from ais_tpu.ops.window import sliding_max_centered, sliding_max_forward

    x = np.random.default_rng(w).normal(size=(3, 257)).astype(np.float32)
    np.testing.assert_array_equal(
        window.sliding_max_forward(torch.from_numpy(x), w).numpy(),
        np.asarray(sliding_max_forward(jnp.asarray(x), w)))
    np.testing.assert_array_equal(
        window.sliding_max_centered(torch.from_numpy(x), w).numpy(),
        np.asarray(sliding_max_centered(jnp.asarray(x), w)))


def test_agc_matches_reference():
    from ais_tpu.ops.agc import feedforward_agc

    rng = np.random.default_rng(1)
    x = _cplx(rng, 2, 4096, scale=0.01)
    x[0, 1000:2500] *= 300.0
    want = np.asarray(feedforward_agc(jnp.asarray(x), 512, 2.0))
    got = agc.feedforward_agc(torch.from_numpy(x), 512, 2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _afc_block(rng):
    """Two GMSK bursts with carrier offsets over noise, at 5 sps."""
    from ais_tpu.tx.gmsk import modulate_bits

    x = _cplx(rng, 2, 16384, scale=0.02)
    n = np.arange(3000)
    for row, (start, f) in enumerate([(2000, 310.0), (9000, -830.0)]):
        burst = modulate_bits(rng.integers(0, 2, 600), 5, 0.4)
        x[row, start: start + 3000] += (burst * np.exp(2j * np.pi * f / 48e3 * n)).astype(np.complex64)
    return x


def test_afc_matches_reference():
    from ais_tpu.ops.freq import freqest, gate_and_hold, square_and_fft_sync

    x = _afc_block(np.random.default_rng(2))
    chunks = (x * x).reshape(2, 16, 1024)
    want_e, want_c = freqest(jnp.asarray(chunks), 48e3, 9600.0)
    got_e, got_c = freq.freqest(torch.from_numpy(chunks), 48e3, 9600.0)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-4)

    want_y, want_est = square_and_fft_sync(jnp.asarray(x), 48e3, 9600.0, 1024, gate_ratio=6.0)
    got_y, got_est = freq.square_and_fft_sync(torch.from_numpy(x), 48e3, 9600.0, 1024, gate_ratio=6.0)
    np.testing.assert_array_equal(got_est.numpy(), np.asarray(want_est))
    assert np.any(got_est.numpy() != 0.0)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=2e-3)

    # Gate-and-hold on hand-made patterns: nearest confident chunk, ties
    # to the earlier one, zeros when nothing is confident.
    est = np.arange(1.0, 9.0, dtype=np.float32)[None].repeat(4, 0) * 100
    conf = np.zeros((4, 8), np.float32)
    conf[0, [2, 5]] = 10.0
    conf[1, [0]] = 10.0
    conf[2, [7]] = 10.0
    want = np.asarray(gate_and_hold(jnp.asarray(est), jnp.asarray(conf), 6.0))
    got = freq.gate_and_hold(torch.from_numpy(est), torch.from_numpy(conf), 6.0).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[3], 0.0)


def test_demod_ops_match_reference():
    from ais_tpu.ops.demod import quadrature_demod, slice_diff_invert

    x = _cplx(np.random.default_rng(3), 4, 300)
    want = np.array(quadrature_demod(jnp.asarray(x)))
    got = demod.quadrature_demod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    want_b = np.asarray(slice_diff_invert(jnp.asarray(want)))
    got_b = demod.slice_diff_invert(torch.from_numpy(want)).numpy()
    assert got_b.dtype == np.uint8
    np.testing.assert_array_equal(got_b, want_b)
