"""The port's timing modes against the JAX package on the CPU.

  - both `timing_mode`s through the port's `BasebandReceiver` over the
    impairment corpus of `tests/test_timing_modes.py`: each decode is the
    golden sentence and equals the reference's output;
  - `ff_path` "fft" and "bank" against the reference's
    `feedforward_symbols` with the same path forced: symbols atol 2e-4,
    `valid` exact, bits exact from bit 2 (symbol 0 of `quadrature_demod`
    is arg of a real number: its sign is rounding on either side);
  - a non-integer sps (5.208) on the bank path, and the dispatcher's rule
    that sends every path there;
  - the `ValueError`s for unknown modes, as the reference raises them;
  - a `timing_mode="pll"` slice through `WidebandReceiver.decode_wire`
    at 3 blocks, its packets equal to the reference's (the Pallas
    channelizer and correlator forced there, in interpret mode).
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_timing_modes import CORPUS, SENTENCE, _impair  # noqa: E402

import ais_tpu.sync.feedforward as ref_ff  # noqa: E402
from ais_tpu.core.params import DemodConfig  # noqa: E402
from ais_tpu.ops.demod import quadrature_demod as ref_qd  # noqa: E402
from ais_tpu.ops.demod import slice_diff_invert as ref_slice  # noqa: E402
from ais_tpu.tx.gmsk import modulate_bits  # noqa: E402
from ais_tpu_torch.ops.demod import quadrature_demod, slice_diff_invert  # noqa: E402
from ais_tpu_torch.ops.interp import interp_taps  # noqa: E402
from ais_tpu_torch.pipeline import api as tapi  # noqa: E402
from ais_tpu_torch.pipeline import receiver as trx  # noqa: E402
from ais_tpu_torch.pipeline import wideband as tw  # noqa: E402
from ais_tpu_torch.sync import feedforward as tff  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("impairment", CORPUS)
def test_feedforward_pll_packet_parity(impairment):
    """Both modes decode the golden sentence at every corpus point, and
    each equals the reference's output in that mode."""
    from ais_tpu.pipeline import BasebandReceiver as Ref

    iq = _impair(impairment)
    for mode in ("feedforward", "pll"):
        # The formulations the port implements, forced on the reference.
        cfg = DemodConfig(timing_mode=mode, corr_path="pallas", ff_path="fir")
        got = tapi.BasebandReceiver(demod=cfg, device="cpu").sentences(iq)
        assert got == [SENTENCE], f"{mode} failed at {impairment}"
        assert got == Ref(demod=cfg).sentences(iq), f"{mode} differs at {impairment}"


def _bursts(seed: int, sps: float, n: int = 5, length: int = 4608):
    """GMSK bursts with random delays, carrier residue, a clock offset
    and noise; at a non-integer `sps` modulated at 5 and resampled."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n, length), np.complex64)
    for i in range(n):
        d = int(rng.integers(0, 400))
        sig = np.asarray(modulate_bits(rng.integers(0, 2, 600), 5, 0.4))
        # Resample to `sps` samples a symbol with a clock error of up to
        # 50 ppm (linear interpolation on the 5 sps grid).
        step = (5.0 / sps) * (1.0 + rng.uniform(-50e-6, 50e-6))
        t = np.arange(int((sig.size - 1) / step)) * step
        sig = np.interp(t, np.arange(sig.size), sig.real) \
            + 1j * np.interp(t, np.arange(sig.size), sig.imag)
        f = rng.uniform(-40, 40) / 48e3
        sig = sig * np.exp(2j * np.pi * f * np.arange(sig.size) + 1j * rng.uniform(0, 6.28))
        m = min(sig.size, length - d)
        out[i, d: d + m] = sig[:m]
        out[i] += ((rng.normal(size=length) + 1j * rng.normal(size=length)) * 0.05).astype(
            np.complex64)
    return out


def _hold_path(b: np.ndarray, sps: float, path: str, ref_path: str) -> None:
    n_sym = int((b.shape[-1] - 16) // sps)
    want_s, want_v = jax.vmap(
        lambda x: ref_ff.feedforward_symbols(x, sps, n_sym, path=ref_path))(jnp.asarray(b))
    got_s, got_v = tff.feedforward_symbols(
        torch.from_numpy(b), sps, n_sym, tff.ff_delta(sps, 0.4),
        torch.from_numpy(interp_taps()), path=path)
    assert got_s.dtype == torch.complex64 and got_s.shape == (b.shape[0], n_sym)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_v.numpy().any()
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=2e-4)
    want_bits = np.asarray(ref_slice(ref_qd(want_s)))
    got_bits = slice_diff_invert(quadrature_demod(got_s)).numpy()
    np.testing.assert_array_equal(got_bits[:, 2:], want_bits[:, 2:])


@pytest.mark.parametrize("path", ["fft", "bank"])
def test_ff_path_matches_reference(path):
    _hold_path(_bursts(21, 5.0), 5.0, path, path)


@pytest.mark.parametrize("path", ["bank", "auto", "fir", "fft"])
def test_non_integer_sps_runs_the_bank(path):
    """At 5.208 samples a symbol (250 ksps / 5 over 9600 baud) every path
    is the bank interpolation, in both packages."""
    _hold_path(_bursts(22, 5.208, n=3), 5.208, path, "bank")


def test_auto_is_the_fir_comb_at_integer_sps():
    b = torch.from_numpy(_bursts(23, 5.0, n=2))
    bank = torch.from_numpy(interp_taps())
    delta = tff.ff_delta(5.0, 0.4)
    fir = tff.feedforward_symbols_fir(b, 5.0, 900, delta, bank)
    for path in ("auto", "fir"):
        got = tff.feedforward_symbols(b, 5.0, 900, delta, bank, path=path)
        assert torch.equal(got[0], fir[0]) and torch.equal(got[1], fir[1])
    with pytest.raises(ValueError, match="ff_path"):
        tff.feedforward_symbols(b, 5.0, 900, delta, bank, path="comb")


@pytest.mark.parametrize("change,match", [({"timing_mode": "bogus"}, "timing_mode"),
                                          ({"ff_path": "bogus"}, "ff_path"),
                                          ({"demod_mode": "bogus"}, "demod_mode")])
def test_unknown_mode_raises(change, match):
    """`ValueError` naming the field, as the reference raises for it."""
    with pytest.raises(ValueError, match=match):
        tapi.BasebandReceiver(demod=DemodConfig(**change), device="cpu")


def test_every_known_mode_builds():
    for change in ({"timing_mode": "pll"}, {"ff_path": "fft"}, {"ff_path": "bank"},
                   {"ff_path": "fir"}, {"timing_mode": "pll", "demod_mode": "mlse"}):
        rx = tapi.BasebandReceiver(demod=DemodConfig(**change), device="cpu")
        assert rx._demod.cfg == DemodConfig(**change)


def test_modes_reach_the_demodulator_unchanged():
    """`ChannelReceiver` rewrites only `samples_per_symbol`; `AisRadio` in
    both topologies and the overflow recovery's demodulator keep the
    receiver's timing mode."""
    from ais_tpu_torch.core.params import ChannelizerConfig, ReceiverConfig
    from ais_tpu_torch.pipeline.radio import AisRadio

    for change in ({"timing_mode": "pll"}, {"ff_path": "bank"}):
        demod = DemodConfig(**change)
        chan = tapi.ChannelReceiver(ReceiverConfig(
            channelizer=ChannelizerConfig(input_rate=250e3), demod=demod), device="cpu")
        assert chan.baseband._demod.cfg == dataclasses.replace(demod, samples_per_symbol=5.0)
        wide = AisRadio(sample_rate=2.4e6, demod=demod, fused_blocks=2, device="cpu").wideband
        assert wide.demod.cfg == demod
        assert wide._recover_demod(64).cfg == dataclasses.replace(demod, max_bursts_per_block=64)
        for path in AisRadio(sample_rate=250e3, demod=demod, device="cpu").rx_paths:
            assert path.baseband._demod.cfg == dataclasses.replace(demod, samples_per_symbol=5.0)


def test_mlse_ignores_timing_mode():
    """The coherent decision has its own timing: "pll" changes nothing."""
    iq = _impair("cfo300+ppm30")
    out = [tapi.BasebandReceiver(demod=DemodConfig(demod_mode="mlse", timing_mode=mode),
                                 device="cpu").process(iq) for mode in ("feedforward", "pll")]
    assert [p.nmea for p in out[0]] == [SENTENCE]
    assert [(p.nmea, p.abs_sample) for p in out[0]] == [(p.nmea, p.abs_sample) for p in out[1]]


def test_pll_slice_packets_identical():
    """cr1 wire -> packets at 3 blocks with `timing_mode="pll"`: the
    port's packets (content, channel, position) equal the reference's."""
    from ais_tpu.pipeline.wideband import WidebandConfig, WidebandReceiver, num_taps
    from ais_tpu_torch.ops.convert import host_bytes
    from ais_tpu_torch.tx import aivdm_payload_to_bytes
    from ais_tpu_torch.tx.scenario import Scenario, ScenarioPacket

    base = WidebandConfig()
    demod = dataclasses.replace(base.demod, max_bursts_per_block=24, timing_mode="pll",
                                corr_path="pallas")
    n48 = base.block_len + base.core_len * 2
    n_in = tw.aligned_n_in(tw.WidebandConfig(), (n48 - 1) * base.decimation + num_taps(base))
    raw = aivdm_payload_to_bytes("14eG;o@034o8sd<L9i:a;WF>062D")
    iq = Scenario(sample_rate=2.4e6, n_samples=n_in, noise=0.004, packets=[
        ScenarioPacket(raw, 200000, -25e3, phase=0.7),
        ScenarioPacket(raw, 700000, +25e3, amplitude=0.6, extra_freq_hz=140.0),
        ScenarioPacket(raw, 1200000, +25e3, phase=1.1),
        ScenarioPacket(raw, 1500000, -25e3, phase=2.0, extra_freq_hz=-90.0),
    ]).build()
    wire = host_bytes((iq * 0.7).astype(np.complex64), "cr1")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AIS_TPU_CHAN", "pallas")
        want = WidebandReceiver(base._replace(demod=demod, compact_lanes=84),
                                n_in=n_in).decode_wire(wire, "cr1")
    rx = tw.WidebandReceiver(tw.WidebandConfig()._replace(demod=demod, compact_lanes=84),
                             n_in=n_in, device="cpu")
    got = rx.decode_wire(wire, "cr1")
    key = lambda ps: [(p.nmea, p.designator, p.abs_sample) for p in ps]  # noqa: E731
    assert key(got) == key(want) and len(got) == 4
    assert isinstance(rx.demod, trx.BurstDemod) and rx.demod.cfg.timing_mode == "pll"
