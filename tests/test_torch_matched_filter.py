"""Port K2 (preamble matched filter, fused |corr|^2) against the JAX
reference `ais_tpu/ops/pallas_corr.py:pallas_matched_filter`, run in
interpret mode on the CPU.

Tolerance: corr atol 2e-4 (`tests/test_pallas_corr.py`: 140-term fp32
sums in different orders at peaks of ~140); mag2 relative 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ais_tpu.tx.gmsk import preamble_waveform
from ais_tpu_torch.ops.matched_filter import (
    MatchedFilter,
    matched_filter,
    matched_filter_plain,
)

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def preamble():
    return preamble_waveform(5, 0.4).astype(np.complex64)


@pytest.fixture(scope="module")
def signal(preamble):
    rng = np.random.default_rng(0)
    x = ((rng.normal(size=(3, 4096)) + 1j * rng.normal(size=(3, 4096))) * 0.1).astype(np.complex64)
    x[0, 500: 640] += preamble
    x[2, 3950: 4090] += preamble
    return x


def test_plain_matches_pallas_kernel(signal, preamble):
    from ais_tpu.ops.pallas_corr import pallas_matched_filter

    want_c, want_m = pallas_matched_filter(jnp.asarray(signal), preamble,
                                           with_mag2=True, interpret=True)
    got_c, got_m = MatchedFilter(preamble, device="cpu")(torch.from_numpy(signal))
    assert got_c.shape == want_c.shape == (3, 4096 - 140 + 1)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=2e-4)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), rtol=1e-5, atol=1e-4)


def test_plain_matches_numpy_correlation(signal, preamble):
    pc = torch.from_numpy(np.conj(preamble))
    corr, mag2 = matched_filter_plain(torch.from_numpy(signal), pc)
    want = np.stack([np.correlate(row.astype(np.complex128), preamble.astype(np.complex128),
                                  mode="valid") for row in signal])
    np.testing.assert_allclose(corr.numpy(), want, atol=2e-4)
    np.testing.assert_allclose(mag2.numpy(), np.abs(corr.numpy()) ** 2, rtol=1e-6)
    peak = int(np.argmax(mag2.numpy()[0]))
    assert peak == 500


def test_dispatch_takes_plain_version_only_on_cpu(preamble):
    x = torch.zeros(2, 1000, dtype=torch.complex64, device="meta")
    pc = torch.zeros(140, dtype=torch.complex64, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        matched_filter(x, pc)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda, signal, preamble):
    x = torch.from_numpy(signal).to(cuda)
    pc = torch.from_numpy(np.conj(preamble)).to(cuda)
    corr, mag2 = matched_filter(x, pc)
    want_c, _ = matched_filter_plain(x, pc)
    assert float((corr - want_c).abs().max()) <= 2e-4
    assert torch.equal(mag2, corr.real * corr.real + corr.imag * corr.imag)


@pytest.mark.parametrize("n,taps_len", [(1024 + 139 + 37, 140), (2 * 1024 + 139, 140),
                                         (700, 140), (1300, 53)])
def test_row_lengths_off_the_kernel_tile(preamble, n, taps_len):
    """Row lengths that leave a partial, an exact and less than one tile
    of the kernel (1024 outputs a block: 8 a thread, 128 threads), and a
    tap count that is no multiple of 8: through the wrapper on the CPU,
    against the definition."""
    rng = np.random.default_rng(n)
    x = ((rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))) * 0.1).astype(np.complex64)
    p = preamble[:taps_len]
    x[1, n - taps_len - 3: n - 3] += p
    corr, mag2 = MatchedFilter(p, device="cpu")(torch.from_numpy(x))
    assert corr.shape == mag2.shape == (2, n - taps_len + 1)
    want = np.stack([np.correlate(row.astype(np.complex128), p.astype(np.complex128),
                                  mode="valid") for row in x])
    np.testing.assert_allclose(corr.numpy(), want, atol=2e-4)
    assert int(np.argmax(mag2.numpy()[1])) == n - taps_len - 3


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """The launch path's checks, reached without a card: the wrapper's
    CUDA branch on CPU tensors must raise before any launch."""
    from ais_tpu_torch import _build
    from ais_tpu_torch.ops.matched_filter import _matched_filter_cuda

    before = _build.MATCHED_FILTER.launches
    pc = torch.zeros(140, dtype=torch.complex64)
    with pytest.raises(ValueError, match="complex64"):
        _matched_filter_cuda(torch.zeros(2, 1000), pc)
    with pytest.raises(ValueError, match="complex64"):
        _matched_filter_cuda(torch.zeros(1000, dtype=torch.complex64), pc)
    with pytest.raises(ValueError, match="1-D complex64"):
        _matched_filter_cuda(torch.zeros(2, 1000, dtype=torch.complex64), pc.reshape(2, 70))
    with pytest.raises(ValueError, match="unsupported shape"):
        _matched_filter_cuda(torch.zeros(2, 100, dtype=torch.complex64), pc)
    assert _build.MATCHED_FILTER.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("n,taps_len", [(1024 + 139 + 37, 140), (700, 140), (1300, 53), (5000, 7)])
def test_kernel_matches_plain_off_the_tile_on_card(cuda, preamble, n, taps_len):
    rng = np.random.default_rng(n)
    x = ((rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))) * 0.1).astype(np.complex64)
    xt = torch.from_numpy(x).to(cuda)
    pc = torch.from_numpy(np.conj(preamble[:taps_len])).to(cuda)
    corr, mag2 = matched_filter(xt, pc)
    want_c, _ = matched_filter_plain(xt, pc)
    assert corr.shape == want_c.shape
    assert float((corr - want_c).abs().max()) <= 2e-4
    assert torch.equal(mag2, corr.real * corr.real + corr.imag * corr.imag)
