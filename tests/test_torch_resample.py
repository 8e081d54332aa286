"""The port's host resampler (`ais_tpu_torch/ops/resample.py`) against
`ais_tpu.ops.resample`.

Tolerances: the prototype, the bank and the streaming resampler are
the same numpy arithmetic as the reference's, so they must be equal
bit for bit; the stateless `pfb_arb_resample` sums its taps in numpy
where the reference sums them in XLA, so it is held to 1e-6 absolute
(inputs of unit scale).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ais_tpu.ops import resample as rr
from ais_tpu_torch.ops import resample as tr

torch.set_num_threads(1)


def _x(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


def test_prototype_and_bank_equal():
    np.testing.assert_array_equal(tr.default_prototype(32), rr.default_prototype(32))
    taps = np.random.default_rng(0).normal(size=101).astype(np.float32)
    np.testing.assert_array_equal(tr.polyphase_bank(taps, 8), rr.polyphase_bank(taps, 8))


@pytest.mark.parametrize("rate", [0.96, 250.0 / 48.0, 1.25])
def test_streaming_bit_exact_and_chunk_invariant(rate):
    """Whole stream and uneven chunks give the reference's samples
    exactly, and the same output counter."""
    x = _x(9000, 1)
    want = rr.PfbArbResampler(rate)
    w = want.process(x)
    got = tr.PfbArbResampler(rate)
    np.testing.assert_array_equal(got.process(x), w)
    chunked = tr.PfbArbResampler(rate)
    cuts = [0, 97, 1000, 1001, 4096, 7777, 9000]
    parts = [chunked.process(x[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
    np.testing.assert_array_equal(np.concatenate(parts), w)
    assert chunked.outputs_emitted == want.outputs_emitted == w.size


def test_stateless_matches_reference():
    x = _x(3000, 2)
    want = np.asarray(rr.pfb_arb_resample(jnp.asarray(x), 0.96))
    got = tr.pfb_arb_resample(x, 0.96)
    assert got.shape == want.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=1e-6)
    with pytest.raises(ValueError, match="too short"):
        tr.pfb_arb_resample(x[:10], 0.96)


def test_state_round_trip_across_packages():
    """A state dict taken from either package resumes in the other."""
    x = _x(5000, 3)
    ref = rr.PfbArbResampler(0.96)
    ref.process(x[:2500])
    tail = ref.process(x[2500:])
    for src, dst in ((rr.PfbArbResampler, tr.PfbArbResampler),
                     (tr.PfbArbResampler, rr.PfbArbResampler)):
        a = src(0.96)
        a.process(x[:2500])
        b = dst(0.96)
        b.set_state(a.get_state())
        np.testing.assert_array_equal(b.process(x[2500:]), tail)
