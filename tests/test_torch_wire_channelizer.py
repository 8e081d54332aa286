"""Port K1 (cr1 wire channelizer) and the cr1 wire format against the
JAX reference (`ais_tpu/ops/pallas_fir.py`, `ais_tpu/ops/convert.py`).

The reference's fused Pallas kernel runs in interpret mode on the CPU,
as its own tests run it; the port's wrapper takes its plain version
for a CPU tensor.  Tolerance for the channelizer: atol 2e-5 of the
output's full scale and rtol 2e-4 (`tests/test_pallas_fir.py`), since
the two sum 2891 fp32 products in different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ais_tpu.ops.firdes import low_pass
from ais_tpu_torch.ops import convert as tconvert
from ais_tpu_torch.ops.fir import fir_polyphase, mixer_phase
from ais_tpu_torch.ops.wire_channelizer import (
    WireChannelizer,
    carrier_table_period,
    rotate_carrier,
    wire_channelizer_cr1,
    wire_channelizer_cr1_plain,
    wire_channelizer_supported,
)

torch.set_num_threads(1)

RATE, DECIM, OFFSETS = 2.4e6, 50, (-25e3, 25e3)
TAPS = low_pass(1.0, RATE, 11e3, 2e3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _wire(n_in: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    iq = ((rng.normal(size=n_in) + 1j * rng.normal(size=n_in)) * 0.3).astype(np.complex64)
    return tconvert.host_bytes(iq, "cr1")


def test_cr1_decode_matches_reference():
    from ais_tpu.ops.convert import iq_from_bytes_cr1

    raw = np.random.default_rng(1).integers(0, 256, 125, dtype=np.uint8)
    for n in (1000, 997):
        want = np.asarray(iq_from_bytes_cr1(jnp.asarray(raw), n))
        got = tconvert.iq_from_bytes_cr1(torch.from_numpy(raw), n).numpy()
        np.testing.assert_array_equal(got, want)


def test_cr1_encoder_matches_reference():
    """The host encoder is bit-identical to the reference's, and its
    numpy twin to the native loop."""
    from ais_tpu import native
    from ais_tpu.ops.convert import host_bytes

    rng = np.random.default_rng(2)
    iq = ((rng.normal(size=4000) + 1j * rng.normal(size=4000)) * 0.2).astype(np.complex64)
    np.testing.assert_array_equal(tconvert.host_bytes(iq, "cr1"), host_bytes(iq, "cr1"))
    assert tconvert.CR1_A2 == pytest.approx(2.0 - 4.0 * np.cos(2 * np.pi * (0.25 - 25e3 / 2.4e6)) ** 2)
    assert tconvert.cr1_wire_nbytes(4001) == 501
    if native.available():
        np.testing.assert_array_equal(
            tconvert._sigma_delta_cr1_numpy(iq[:2000], 1.5, tconvert.CR1_A2),
            native.sigma_delta_cr1(iq[:2000], 1.5, tconvert.CR1_A2),
        )
    with pytest.raises(ValueError, match="unsupported format"):
        tconvert.host_bytes(iq, "cx3")


def test_mixer_phase_matches_reference():
    from ais_tpu.ops.fir import mixer_phase as ref_phase

    for off in OFFSETS:
        for at in (0, 777, 1_764_000, 123_456_789):
            assert mixer_phase(off, RATE, at) == ref_phase(off, RATE, at)


def test_fir_polyphase_matches_direct_convolution():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 1003)).astype(np.float32)
    taps = rng.normal(size=97).astype(np.float32)
    got = fir_polyphase(torch.from_numpy(x), torch.from_numpy(taps), 7).numpy()
    n_out = (1003 - 97) // 7 + 1
    want = np.array([[np.dot(taps, row[m * 7: m * 7 + 97]) for m in range(n_out)] for row in x])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_in", [80_000, 400_000])
def test_plain_matches_pallas_kernel(n_in):
    """K1's plain version against the reference kernel (interpret mode);
    400 000 samples spans more than one of the reference's tiles."""
    from ais_tpu.ops.pallas_fir import pallas_wire_channelizer, wire_channelizer_buffers

    raw = _wire(n_in, 17)
    phase0s = np.stack([mixer_phase(o, RATE, 777) for o in OFFSETS])
    car, h = wire_channelizer_buffers("cr1", TAPS, DECIM, OFFSETS, RATE)
    want = np.asarray(pallas_wire_channelizer(
        jnp.asarray(raw), jnp.asarray(phase0s), jnp.asarray(car), jnp.asarray(h),
        fmt="cr1", ntaps=TAPS.size, decim=DECIM, offsets=OFFSETS, rate=RATE,
        n_in=n_in, interpret=True,
    ))
    chan = WireChannelizer(TAPS, DECIM, OFFSETS, RATE, n_in)
    got = chan(torch.from_numpy(raw), torch.from_numpy(phase0s)).numpy()
    assert got.shape == want.shape == (2, chan.n_out)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=2e-4)


def test_supported_geometry():
    assert carrier_table_period(OFFSETS, RATE) == 96
    assert wire_channelizer_supported("cr1", TAPS.size, DECIM, OFFSETS, RATE, 1_998_200)
    assert wire_channelizer_supported("ci1", TAPS.size, DECIM, OFFSETS, RATE)
    assert not wire_channelizer_supported("cx3", TAPS.size, DECIM, OFFSETS, RATE)
    assert not wire_channelizer_supported("cr1", TAPS.size, DECIM, OFFSETS, RATE, 80_004)
    assert not wire_channelizer_supported("cr1", TAPS.size, DECIM, (np.pi * 1e4,), RATE)
    with pytest.raises(ValueError, match="unsupported"):
        WireChannelizer(TAPS, DECIM, OFFSETS, RATE, 80_004)


def test_dispatch_takes_plain_version_only_on_cpu():
    raw = torch.zeros(10_000, dtype=torch.uint8, device="meta")
    car = torch.zeros(2, 96, 2, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        wire_channelizer_cr1(raw, car, torch.zeros(TAPS.size, device="meta"),
                             decim=DECIM, n_in=80_000)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda):
    n_in = 400_000
    raw = torch.from_numpy(_wire(n_in, 5)).to(cuda)
    chan = WireChannelizer(TAPS, DECIM, OFFSETS, RATE, n_in, device=cuda)
    ph = torch.from_numpy(np.stack([mixer_phase(o, RATE, 999) for o in OFFSETS])).to(cuda)
    car = rotate_carrier(chan.carrier, ph)
    got = wire_channelizer_cr1(raw, car, chan.taps, decim=DECIM, n_in=n_in)
    want = wire_channelizer_cr1_plain(raw, car, chan.taps, DECIM, n_in)
    err = (got - want).abs()
    assert bool((err <= 2e-5 * want.abs().max() + 2e-4 * want.abs()).all())
