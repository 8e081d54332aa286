"""Port K5 (float channelizer), K3 (ci1) and K4 (ci2/ci4) wire
channelizers and K6 (probe) against the JAX reference.

The reference's Pallas kernels run in interpret mode on the CPU, as its
own tests run them (`tests/test_pallas_fir.py`); the port's wrappers
take their plain versions for a CPU tensor.  Tolerance: atol 2e-5 of the
output's full scale and rtol 2e-4 (`tests/test_pallas_fir.py`), since
the two sum 2891 fp32 products in different orders.  The `gpu` tests
hold each CUDA kernel against its plain version on the card, to the
same bound.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ais_tpu.ops.firdes import low_pass
from ais_tpu_torch.ops import channelizer as tch
from ais_tpu_torch.ops import convert as tconvert
from ais_tpu_torch.ops import wire_channelizer as twc
from ais_tpu_torch.ops.fir import mixer_phase
from ais_tpu_torch.ops.probe import SHAPE, probe, probe_plain

torch.set_num_threads(1)

RATE, DECIM, OFFSETS = 2.4e6, 50, (-25e3, 25e3)
TAPS = low_pass(1.0, RATE, 11e3, 2e3)
# tests/test_pallas_fir.py:87: P smaller than a lane group, a zero offset.
ALT = dict(rate=240e3, decim=5, offsets=(0.0, 60e3), taps=low_pass(1.0, 240e3, 20e3, 8e3))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _iq(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.3).astype(np.complex64)


def _phase0s(offsets, rate, at) -> np.ndarray:
    return np.stack([mixer_phase(o, rate, at) for o in offsets])


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=2e-4)


@pytest.mark.parametrize("geometry,start", [("bench", 0), ("bench", 12345), ("alt", 999)])
def test_k5_plain_matches_pallas_kernel(geometry, start):
    from ais_tpu.ops.cplx import to_planes
    from ais_tpu.ops.pallas_fir import PallasChannelizer

    if geometry == "bench":
        rate, decim, offsets, taps, n_in = RATE, DECIM, OFFSETS, TAPS, 80_000
    else:
        rate, decim, offsets, taps, n_in = ALT["rate"], ALT["decim"], ALT["offsets"], ALT["taps"], 20_000
    iq = _iq(n_in, 7)
    ph = _phase0s(offsets, rate, start)
    ref = PallasChannelizer(taps, decim, offsets, rate, n_in, interpret=True)
    want = np.asarray(ref(jnp.asarray(to_planes(iq)), jnp.asarray(ph)))
    chan = tch.Channelizer(taps, decim, offsets, rate, n_in, device="cpu")
    got = chan(torch.from_numpy(iq), torch.from_numpy(ph)).numpy()
    assert got.shape == (len(offsets), chan.n_out)
    _close(got, want)


@pytest.mark.parametrize("fmt", ["ci1", "ci2", "ci4"])
def test_k3_k4_plain_matches_pallas_kernel(fmt):
    """The ci1 (K3) and ci2/ci4 (K4) plain versions against the reference
    kernels on the same wire bytes; 400 000 samples span several of the
    reference's tiles."""
    from ais_tpu.ops.convert import host_bytes
    from ais_tpu.ops.pallas_fir import pallas_wire_channelizer, wire_channelizer_buffers

    n_in = 80_000 if fmt == "ci1" else 400_000
    raw = host_bytes(_iq(n_in, 17), fmt)
    ph = _phase0s(OFFSETS, RATE, 777)
    car, h = wire_channelizer_buffers(fmt, TAPS, DECIM, OFFSETS, RATE)
    want = np.asarray(pallas_wire_channelizer(
        jnp.asarray(raw), jnp.asarray(ph), jnp.asarray(car), jnp.asarray(h), fmt=fmt,
        ntaps=TAPS.size, decim=DECIM, offsets=OFFSETS, rate=RATE, n_in=n_in, interpret=True))
    chan = twc.PackedWireChannelizer(fmt, TAPS, DECIM, OFFSETS, RATE, n_in, device="cpu")
    got = chan(torch.from_numpy(raw), torch.from_numpy(ph)).numpy()
    _close(got, want)


def test_baseband_carrier_has_no_if_fold():
    """K5's table is the baseband mixer; K1's folds in cr1's fs/4 IF."""
    assert tch.carrier_table_period(OFFSETS, RATE) == 96
    car = tch.carrier_table(OFFSETS, RATE)
    n = np.arange(96)
    for c, off in enumerate(OFFSETS):
        want = np.exp(-2j * np.pi * off * n / RATE)
        np.testing.assert_allclose(car[c, :, 0] + 1j * car[c, :, 1], want, atol=1e-6)
    if_car = twc.carrier_table(OFFSETS, RATE)
    assert not np.allclose(car, if_car, atol=1e-3)
    assert tch.carrier_table_period((0.0, 60e3), 240e3) == 4


def test_support_predicates_accept_where_reference_accepts():
    """Same answers as `pallas_channelizer_supported` and the wire
    predicate wherever the reference accepts; the port also takes the
    geometries that only the MXU tiling refused."""
    from ais_tpu.ops import pallas_fir as rp

    geometries = [
        (TAPS.size, DECIM, OFFSETS, RATE),
        (ALT["taps"].size, ALT["decim"], ALT["offsets"], ALT["rate"]),
        (2891, 50, (25e3 * np.sqrt(2),), 2.4e6),     # irrational: no periodic carrier
        (2891, 48, OFFSETS, RATE),                   # decim % 4 == 0: ci1 refused by the TPU kernel
        (2891, 51, OFFSETS, RATE),                   # odd decim: ci2 refused by the TPU kernel
        (64 * 50 + 1, 50, OFFSETS, RATE),            # P = 65 > 64: refused by the MXU collapse
        (2891, 50, (-1e3, 1e3), RATE),               # q = 2400: beyond K1's table
    ]
    for ntaps, decim, offs, rate in geometries:
        ref = rp.pallas_channelizer_supported(ntaps, decim, offs, rate)
        got = tch.channelizer_supported(ntaps, decim, offs, rate)
        assert got or not ref, (ntaps, decim, offs)
        for fmt in ("ci1", "ci2", "ci4"):
            r = rp.wire_channelizer_supported(fmt, ntaps, decim, offs, rate)
            g = twc.wire_channelizer_supported(fmt, ntaps, decim, offs, rate)
            assert g or not r, (fmt, ntaps, decim, offs)
        # K1 stages its IF-folded table in shared memory (period <= 2048);
        # beyond it the receiver decodes cr1 and runs K5.
        r = rp.wire_channelizer_supported("cr1", ntaps, decim, offs, rate)
        g = twc.wire_channelizer_supported("cr1", ntaps, decim, offs, rate)
        assert g or got or not r, ("cr1", ntaps, decim, offs)
    assert not twc.wire_channelizer_supported("cr1", 2891, 50, (-1e3, 1e3), RATE)
    assert tch.channelizer_supported(TAPS.size, DECIM, OFFSETS, RATE, 1_998_200)
    assert tch.channelizer_supported(2891, 50, (25e3 * np.sqrt(2),), 2.4e6)  # full-length table
    assert tch.channelizer_supported(64 * 50 + 1, 50, OFFSETS, RATE)
    assert not tch.channelizer_supported(TAPS.size, DECIM, OFFSETS, RATE, 80_010)
    assert not twc.wire_channelizer_supported("ci1", TAPS.size, DECIM, OFFSETS, RATE, 80_050)
    assert twc.wire_channelizer_supported("ci2", TAPS.size, DECIM, OFFSETS, RATE, 80_000)
    # The plan search: 8 outputs a thread and a 120-output tile at the bench,
    # fewer outputs a thread where a tile would not fit otherwise.
    assert tch.kernel_plan(TAPS.size, DECIM, 2)[:3] == (8, 120, 768)
    assert tch.kernel_plan(TAPS.size, DECIM, 2).smem <= tch.MAX_SMEM_BYTES
    assert tch.kernel_plan(TAPS.size, 400, 4).outputs == 4
    assert tch.kernel_plan(TAPS.size, 1000, 4).outputs == 1
    assert tch.kernel_plan(TAPS.size, 4000, 4) is None


def test_unsupported_geometry_raises_naming_the_fft_formulation():
    """A carrier with no period (sqrt(2) x 25 kHz), once refused, now
    runs on K5 (and K4) with the full-length table: against the
    reference's FFT-mode channelizer on complex samples, and against its
    own float path on ci2 bytes.  Only a geometry with no tile raises."""
    from ais_tpu.ops.cplx import to_planes
    from ais_tpu.ops.fir import _mixer_carrier, freq_xlating_polyphase, polyphase_spectra

    offsets, n_in = (25e3 * np.sqrt(2), -25e3), 80_000
    iq = _iq(n_in, 21)
    ph = _phase0s(offsets, RATE, 4242)
    chan = tch.Channelizer(TAPS, DECIM, offsets, RATE, n_in, device="cpu")
    assert chan.full_table and chan.carrier.shape == (2, n_in, 2)
    n_out = (n_in - TAPS.size) // DECIM + 1
    car = np.concatenate([_mixer_carrier(o, RATE, n_in) for o in offsets])
    want = np.asarray(freq_xlating_polyphase(
        jnp.asarray(iq), jnp.asarray(to_planes(car)), jnp.asarray(ph), TAPS, DECIM,
        jnp.asarray(to_planes(polyphase_spectra(TAPS, DECIM, n_out)))))
    _close(chan(torch.from_numpy(iq), torch.from_numpy(ph)).numpy(), want)
    raw = tconvert.host_bytes(iq, "ci2")
    wire = twc.PackedWireChannelizer("ci2", TAPS, DECIM, offsets, RATE, n_in, device="cpu")
    got = wire(torch.from_numpy(raw), torch.from_numpy(ph)).numpy()
    _close(got, chan(tconvert.iq_from_bytes_ci2(torch.from_numpy(raw)),
                     torch.from_numpy(ph)).numpy())
    with pytest.raises(NotImplementedError, match="shared memory"):
        tch.Channelizer(TAPS, 4000, offsets * 2, RATE, 80_000, device="cpu")


def test_dispatch_takes_plain_version_only_on_cpu():
    x = torch.zeros(80_000, dtype=torch.complex64, device="meta")
    car = torch.zeros(2, 96, 2, device="meta")
    taps = torch.zeros(TAPS.size, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        tch.freq_xlating_polyphase(x, car, taps, decim=DECIM)
    raw = torch.zeros(20_000, dtype=torch.uint8, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        twc.wire_channelizer_packed("ci1", raw, car, taps, decim=DECIM, n_in=80_000)
    with pytest.raises(ValueError, match="bytes"):
        twc.wire_channelizer_packed("ci2", torch.zeros(10, dtype=torch.uint8), car, taps,
                                    decim=DECIM, n_in=80_000)
    x, y = torch.ones(SHAPE), torch.arange(1024.0).reshape(SHAPE)
    assert torch.equal(probe(x, y), 2 * x + y)


@pytest.mark.parametrize("module", ["Channelizer", "WireChannelizer", "PackedWireChannelizer",
                                    "MatchedFilter"])
def test_kernel_module_defaults_to_the_card(module, monkeypatch):
    """Each module that owns a kernel defaults to `cuda` and raises
    without a card, naming device='cpu'; it never lands on the CPU."""
    from ais_tpu_torch.ops.matched_filter import MatchedFilter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    geometry = (TAPS, DECIM, OFFSETS, RATE, 80_000)
    build = {
        "Channelizer": lambda **kw: tch.Channelizer(*geometry, **kw),
        "WireChannelizer": lambda **kw: twc.WireChannelizer(*geometry, **kw),
        "PackedWireChannelizer": lambda **kw: twc.PackedWireChannelizer("ci2", *geometry, **kw),
        "MatchedFilter": lambda **kw: MatchedFilter(np.ones(140, np.complex64), **kw),
    }[module]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
    assert next(iter(build(device="cpu").buffers())).device.type == "cpu"


def _kernel_vs_plain(cuda, fmt: str, n_in: int):
    ph = torch.from_numpy(_phase0s(OFFSETS, RATE, 123_456_789)).to(cuda)
    chan = tch.Channelizer(TAPS, DECIM, OFFSETS, RATE, n_in, device=cuda)
    car = tch.rotate_carrier(chan.carrier, ph)
    iq = _iq(n_in, 5)
    if fmt == "iq":
        x = torch.from_numpy(iq).to(cuda)
        got = tch.freq_xlating_polyphase(x, car, chan.taps, decim=DECIM)
        want = tch.freq_xlating_polyphase_plain(x, car, chan.taps, DECIM)
    else:
        raw = torch.from_numpy(tconvert.host_bytes(iq, fmt)).to(cuda)
        got = twc.wire_channelizer_packed(fmt, raw, car, chan.taps, decim=DECIM, n_in=n_in)
        want = twc.wire_channelizer_packed_plain(fmt, raw, car, chan.taps, DECIM)
    torch.cuda.synchronize()
    err = (got - want).abs()
    assert bool(torch.isfinite(got).all())
    assert bool((err <= 2e-5 * want.abs().max() + 2e-4 * want.abs()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["iq", "ci1", "ci2", "ci4"])
def test_kernel_matches_plain_on_card(cuda, fmt):
    _kernel_vs_plain(cuda, fmt, 400_000)


@pytest.mark.gpu
def test_probe_on_card(cuda):
    x = torch.randn(SHAPE, device=cuda)
    y = torch.randn(SHAPE, device=cuda)
    assert torch.equal(probe(x, y), probe_plain(x, y))


@pytest.mark.gpu
def test_full_table_kernel_matches_plain_on_card(cuda):
    """K5 on the full-length table (no carrier period) against its plain
    version, launched once through the module."""
    from ais_tpu_torch import _build

    offsets, n_in = (25e3 * np.sqrt(2), -25e3), 400_000
    chan = tch.Channelizer(TAPS, DECIM, offsets, RATE, n_in, device=cuda)
    assert chan.full_table and chan.carrier.shape == (2, n_in, 2)
    ph = torch.from_numpy(_phase0s(offsets, RATE, 987_654_321)).to(cuda)
    x = torch.from_numpy(_iq(n_in, 6)).to(cuda)
    _build.reset_launch_counts()
    got = chan(x, ph)
    assert _build.launch_counts()["channelizer"] == 1
    want = tch.freq_xlating_polyphase_plain(x, tch.rotate_carrier(chan.carrier, ph), chan.taps,
                                            DECIM)
    err = (got - want).abs()
    assert bool((err <= 2e-5 * want.abs().max() + 2e-4 * want.abs()).all())
