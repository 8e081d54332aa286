"""`AisRadio` (`ais_tpu_torch/pipeline/radio.py`) against
`ais_tpu.pipeline.radio`, in both topologies, and K5's full-length
carrier table against the reference's FFT-mode channelizer.

The same capture goes through both packages' radios in the same chunks:
240 ksps takes the fused wideband receiver (2 blocks a call), 250 ksps
one ChannelReceiver a channel with the host resampler.  Packets must be
identical in (nmea, designator, abs_sample).  The reference's demod runs
its main-path formulations (`corr_path="pallas"`, `ff_path="fir"`); its
channelizer runs as it chooses on the CPU (the FFT mode's einsum), the
only route it has for a ppm-shifted carrier.  K5 is held to atol 2e-5 of
full scale and rtol 2e-4 (`tests/test_pallas_fir.py`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ais_tpu.core.params import DemodConfig
from ais_tpu.tx import aivdm_payload_to_bytes, make_packet_iq
from ais_tpu_torch.ops import channelizer as tch
from ais_tpu_torch.pipeline.radio import AisRadio, ppm_offset_hz
from ais_tpu_torch.pipeline.wideband import WidebandConfig
from ais_tpu_torch.scene import content_parity, full_load_scene

torch.set_num_threads(1)

DEMOD = DemodConfig(corr_path="pallas", ff_path="fir")
SENTENCE = "!AIVDM,1,1,,A,14eG;o@034o8sd<L9i:a;WF>062D,0*7D"
CHUNK = 90_001


def _key(packets):
    return [(p.nmea, p.designator, p.abs_sample) for p in packets]


def _run(radio, iq):
    """Packets of `iq` fed in CHUNK pieces, then flushed."""
    out = []
    for i in range(0, iq.size, CHUNK):
        out += radio.process(iq[i: i + CHUNK])
    return out + radio.flush()


def _scene(rate, ppm=0.0, seconds=1.4):
    n = int(rate * seconds)
    iq, tx = full_load_scene(WidebandConfig(input_rate=rate), n, n - int(rate * 0.05),
                             shift_hz=ppm_offset_hz(ppm), lead=int(rate * 0.02))
    return iq.astype(np.complex64), tx


def _reference(rate, **kw):
    from ais_tpu.pipeline.radio import AisRadio as Ref

    return Ref(sample_rate=rate, demod=DEMOD, **kw)


@pytest.mark.parametrize("rate,ppm,seconds", [(240e3, 0.0, 1.4), (240e3, 50.3, 1.4),
                                              (2.4e6, 50.0, 0.6), (250e3, 0.0, 1.4)])
def test_radio_matches_reference(rate, ppm, seconds):
    """Both topologies; at 50.3 ppm (240 ksps) and 50 ppm (2.4 Msps: period
    24 000) the shifted carriers have no period up to 2**14, so K5 runs
    its full-length table."""
    iq, tx = _scene(rate, ppm, seconds)
    radio = AisRadio(sample_rate=rate, demod=DEMOD, ppm=ppm, fused_blocks=2, device="cpu")
    assert radio.uses_fused_wideband == (rate != 250e3)
    got = _run(radio, iq)
    want = _run(_reference(rate, ppm=ppm, fused_blocks=2), iq)
    assert _key(got) == _key(want)
    if radio.uses_fused_wideband:
        assert radio.wideband.channelizer_for("iq").full_table == (ppm != 0.0)
    assert content_parity(got, tx, rate / 48e3) == 1.0


def _capture_with_ppm(ppm):
    """tests/test_streaming.py's capture: one packet on channel A as a
    device `ppm` high records it, at 240 ksps."""
    fs = 240e3
    burst = make_packet_iq(aivdm_payload_to_bytes("14eG;o@034o8sd<L9i:a;WF>062D"),
                           samples_per_symbol=25)
    t = np.arange(burst.size) / fs
    rng = np.random.default_rng(5)
    iq = ((rng.normal(size=int(fs)) + 1j * rng.normal(size=int(fs))) * 0.005).astype(
        np.complex64)
    appear_hz = -25e3 + 162.0e6 * ppm * 1e-6
    iq[20000: 20000 + burst.size] += (burst * np.exp(2j * np.pi * appear_hz * t)).astype(
        np.complex64)
    return iq


def test_ppm_corrected_against_uncorrected():
    assert ppm_offset_hz(50.0) == pytest.approx(8100.0)
    iq = _capture_with_ppm(50.0)
    got = AisRadio(sample_rate=240e3, ppm=50.0, device="cpu")
    found = got.process(iq) + got.flush()
    assert [p.nmea for p in found] == [SENTENCE] and abs(found[0].freq_est_hz) < 400
    want = _reference(240e3, ppm=50.0)
    assert _key(found) == _key(want.process(iq) + want.flush())
    raw = AisRadio(sample_rate=240e3, ppm=0.0, device="cpu")
    found0 = raw.process(iq) + raw.flush()
    if found0:  # the AFC may pull in the 8.1 kHz offset, and then shows it
        assert abs(found0[0].freq_est_hz - 8100.0) < 400


def test_set_threshold_keeps_the_stream_and_set_rate_rebuilds():
    iq, _ = _scene(240e3, seconds=1.0)
    half = iq.size // 2
    outs = []
    for radio in (AisRadio(sample_rate=240e3, demod=DEMOD, fused_blocks=2, device="cpu"),
                  _reference(240e3, fused_blocks=2)):
        out = radio.process(iq[:half])
        buf = radio.wideband._buf.size
        radio.set_threshold(0.85)
        assert radio.get_threshold() == 0.85 and radio.wideband._buf.size == buf
        outs.append(out + radio.process(iq[half:]) + radio.flush())
    assert _key(outs[0]) == _key(outs[1]) and len(outs[0]) > 20
    radio = AisRadio(sample_rate=2.4e6, fused_blocks=2, device="cpu")
    assert radio.set_rate(250e3) == 250e3 and radio.get_rate() == 250e3
    assert not radio.uses_fused_wideband and len(radio.rx_paths) == 2
    radio.set_threshold(0.7)
    assert radio.get_threshold() == 0.7
    assert radio.set_gain(12.5) == 12.5 and radio.get_gain() == 12.5
    single = AisRadio(sample_rate=2.4e6, single_channel=True, device="cpu")
    assert len(single.rx_paths) == 1 and single.rx_paths[0].config.channelizer.offset_hz == 0.0


@pytest.mark.parametrize("rate", [240e3, 250e3])
def test_state_round_trip_across_packages(rate):
    """A radio checkpoint taken mid-stream in the reference resumes on
    the port with the reference's packets, and the other way round."""
    iq, _ = _scene(rate, seconds=1.0)
    cut = iq.size // 2 + 333
    ref = _reference(rate, fused_blocks=2)
    ref.process(iq[:cut])
    state = ref.get_state()
    rest = ref.process(iq[cut:]) + ref.flush()
    port = AisRadio(sample_rate=rate, demod=DEMOD, fused_blocks=2, device="cpu")
    port.set_state(state)
    assert _key(port.process(iq[cut:]) + port.flush()) == _key(rest) and rest
    port = AisRadio(sample_rate=rate, demod=DEMOD, fused_blocks=2, device="cpu")
    port.process(iq[:cut])
    back = _reference(rate, fused_blocks=2)
    back.set_state(port.get_state())
    assert _key(back.process(iq[cut:]) + back.flush()) == _key(rest)
    other = AisRadio(sample_rate=250e3 if rate == 240e3 else 240e3, device="cpu")
    with pytest.raises(ValueError, match="checkpoint"):
        other.set_state(port.get_state())


def test_full_length_table_matches_reference_fft_mode():
    """K5 at 2.4 Msps with the 50 ppm radio's offsets (-16.9 and
    +33.1 kHz: period 24 000, past the periodic table) against the
    reference's `freq_xlating_polyphase` (full-length carriers)."""
    from ais_tpu.ops.cplx import to_planes
    from ais_tpu.ops.fir import _mixer_carrier, freq_xlating_polyphase, polyphase_spectra
    from ais_tpu.ops.firdes import low_pass
    from ais_tpu_torch.ops.fir import mixer_phase

    rate, decim, n_in = 2.4e6, 50, 120_000
    offsets = (-25e3 + ppm_offset_hz(50.0), 25e3 + ppm_offset_hz(50.0))
    assert tch.carrier_table_period(offsets, rate) is None
    taps = low_pass(1.0, rate, 11e3, 2e3)
    rng = np.random.default_rng(8)
    x = ((rng.normal(size=n_in) + 1j * rng.normal(size=n_in)) * 0.3).astype(np.complex64)
    ph = np.stack([mixer_phase(o, rate, 31_337) for o in offsets])
    n_out = (n_in - taps.size) // decim + 1
    car = np.concatenate([_mixer_carrier(o, rate, n_in) for o in offsets])
    want = np.asarray(freq_xlating_polyphase(
        jnp.asarray(x), jnp.asarray(to_planes(car)), jnp.asarray(ph), taps, decim,
        jnp.asarray(to_planes(polyphase_spectra(taps, decim, n_out)))))
    chan = tch.Channelizer(taps, decim, offsets, rate, n_in)
    assert chan.full_table and chan.carrier.shape == (2, n_in, 2)
    got = chan(torch.from_numpy(x), torch.from_numpy(ph)).numpy()
    assert got.shape == want.shape == (2, n_out)
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=2e-4)
