"""The port's PLL timing loop and its two leaf functions against the JAX
package on the CPU: `ops/interp.py:interpolate`, `ops/fir.py:fir_filter`
and `sync/timing.py:msk_timing_recovery`.

Inputs are made from a seed with numpy and go through both packages.
The loop is also held to the numpy transcription of the reference
block's equations in `tests/test_pll_trajectory.py` (`reference_loop`),
batched over bursts with different seeds and start indices.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_pll_trajectory import _test_burst, reference_loop  # noqa: E402

import ais_tpu.ops.fir as ref_fir  # noqa: E402
import ais_tpu.ops.interp as ref_interp  # noqa: E402
import ais_tpu.sync.timing as ref_timing  # noqa: E402
from ais_tpu_torch.ops.fir import fir_filter  # noqa: E402
from ais_tpu_torch.ops.firdes import low_pass  # noqa: E402
from ais_tpu_torch.ops.interp import NSTEPS, NTAPS, interp_taps, interpolate  # noqa: E402
from ais_tpu_torch.sync.timing import TimingResult, msk_timing_recovery  # noqa: E402

torch.set_num_threads(1)

SPS, GAIN, LIMIT = 5.0, 0.04, 0.01
MU0S = (-0.4, 0.0, 0.3, 0.7)


def _noise(rng, shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def test_interpolate_matches_reference():
    """Same bank row (exact, ties at k + 0.5 included) and the same value
    (1e-6) as the reference's scalar `interpolate`, row by row."""
    rng = np.random.default_rng(11)
    n, length = 96, 300
    x = _noise(rng, (n, length))
    index = rng.integers(0, length - NTAPS + 1, n)
    mu = rng.uniform(0, 1, n).astype(np.float32)
    # Exact half steps (round half to even) and the ends of the range.
    mu[:8] = (np.arange(8) + 0.5) / NSTEPS
    mu[8:12] = (0.0, 1.0, 127.5 / NSTEPS, 0.5 / NSTEPS)
    got = interpolate(torch.from_numpy(x), torch.from_numpy(index), torch.from_numpy(mu))
    want = jax.vmap(ref_interp.interpolate)(jnp.asarray(x), jnp.asarray(index, jnp.int32),
                                            jnp.asarray(mu))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # The row choice itself: the row that reproduces the port's value.
    rows = np.clip(np.round(mu * NSTEPS).astype(int), 0, NSTEPS)
    frames = x[np.arange(n)[:, None], index[:, None] + np.arange(NTAPS)]
    np.testing.assert_allclose(got.numpy(), (frames * interp_taps()[rows]).sum(-1), atol=1e-6)
    assert got.dtype == torch.complex64 and got.shape == (n,)


@pytest.mark.parametrize("decim,ntaps_spec", [(1, (48e3, 7e3, 3e3)), (5, (250e3, 11e3, 4e3)),
                                              (1, (48e3, 9e3, 12e3)), (5, (250e3, 9e3, 9e3))],
                         ids=["decim1", "decim5", "decim1_short", "decim5_short"])
def test_fir_filter_matches_reference(decim, ntaps_spec):
    rng = np.random.default_rng(12 + decim)
    taps = low_pass(1.0, *ntaps_spec)
    x = _noise(rng, (3, 2000 + decim))
    got = fir_filter(torch.from_numpy(x), taps, decim)
    want = np.asarray(ref_fir.fir_filter(jnp.asarray(x), taps, decim))
    assert got.shape == want.shape == (3, (x.shape[-1] - taps.size) // decim + 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # The orientation: y[j] = sum_k taps[k] * x[j*decim + k].
    j = 7
    direct = (taps * x[1, j * decim: j * decim + taps.size]).sum()
    assert abs(got[1, j].item() - direct) < 1e-5
    # One-dimensional input, and taps given as a tensor.
    one = fir_filter(torch.from_numpy(x[0]), torch.from_numpy(taps), decim)
    torch.testing.assert_close(one, got[0])


def _bursts():
    """One burst a seed mu0, padded to one length, each shifted to its
    own start index."""
    raw = [_test_burst(seed=int(abs(mu0) * 10)) for mu0 in MU0S]
    starts = np.array([1, 3, 2, 6])
    length = max(x.size + s for x, s in zip(raw, starts))
    out = np.zeros((len(raw), length), np.complex64)
    for row, x, s in zip(out, raw, starts):
        row[s - 1: s - 1 + x.size] = x
    return raw, out, starts


def test_pll_matches_numpy_loop_batched():
    """(symbols, err, mu) of every burst of a batch equal the numpy
    transcription's on that burst alone: rtol 1e-3, atol 2e-3 (float32
    accumulation across the feedback loop), at least 70 valid symbols."""
    raw, bursts, starts = _bursts()
    n_symbols = 80
    tr = msk_timing_recovery(torch.from_numpy(bursts), torch.tensor(MU0S), SPS, GAIN, LIMIT,
                             n_symbols, start_index=torch.from_numpy(starts))
    assert isinstance(tr, TimingResult)
    assert tr.symbols.shape == tr.valid.shape == tr.err.shape == tr.mu.shape == (4, n_symbols)
    assert tr.err.dtype == tr.mu.dtype == torch.float32 and tr.valid.dtype == torch.bool
    for b, (x, mu0) in enumerate(zip(raw, MU0S)):
        # The burst's own length bounds the numpy loop; the batch row is
        # longer (zero padded), so compare over the numpy loop's span.
        syms, errs, mus = reference_loop(x, mu0, SPS, GAIN, LIMIT, n_symbols)
        n = min(int(tr.valid[b].sum()), syms.size)
        assert n >= 70
        np.testing.assert_allclose(tr.err[b, :n].numpy(), errs[:n], rtol=1e-3, atol=2e-3)
        np.testing.assert_allclose(tr.mu[b, :n].numpy(), mus[:n], rtol=1e-3, atol=2e-3)
        np.testing.assert_allclose(tr.symbols[b, :n].numpy(), syms[:n], rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("mu0", MU0S)
def test_pll_matches_reference(mu0):
    """Against the JAX loop on the same burst: every output, `valid`
    exact, over the whole run (the burst ends inside it)."""
    x = _test_burst(seed=int(abs(mu0) * 10))
    n_symbols = 130   # more than the burst holds: `valid` goes False
    want = ref_timing.msk_timing_recovery(jnp.asarray(x), jnp.float32(mu0), SPS, GAIN, LIMIT,
                                          n_symbols)
    got = msk_timing_recovery(torch.from_numpy(x)[None], torch.tensor([mu0]), SPS, GAIN, LIMIT,
                              n_symbols)
    valid = np.asarray(want.valid)
    assert 70 <= valid.sum() < n_symbols
    np.testing.assert_array_equal(got.valid[0].numpy(), valid)
    n = int(valid.sum())
    np.testing.assert_allclose(got.err[0, :n].numpy(), np.asarray(want.err)[:n],
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(got.mu[0, :n].numpy(), np.asarray(want.mu)[:n],
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(got.symbols[0, :n].numpy(), np.asarray(want.symbols)[:n],
                               rtol=1e-3, atol=2e-3)


def test_pll_start_index_int_and_tensor_agree():
    raw, bursts, _ = _bursts()
    x = torch.from_numpy(np.stack([bursts[0], bursts[0]]))
    mu0 = torch.tensor([0.3, -0.2])
    a = msk_timing_recovery(x, mu0, SPS, GAIN, LIMIT, 40, start_index=1)
    b = msk_timing_recovery(x, mu0, SPS, GAIN, LIMIT, 40, start_index=torch.tensor([1, 1]))
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    # A negative seed starts one sample earlier with mu + 1: its first mu.
    assert a.mu[1, 0].item() == pytest.approx(0.8) and a.mu[0, 0].item() == pytest.approx(0.3)
