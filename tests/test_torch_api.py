"""The per-channel receivers (`ais_tpu_torch/pipeline/api.py`) against
`ais_tpu.pipeline.api`, and K5 with one channel
(`ops/fir.py:freq_xlating_fir_decimate`) against the reference's.

A full-load scene (a packet in every 26.67 ms slot of each channel) at
250 ksps (the reference's default: K5 to 50 ksps, then the host
resampler to 48 ksps; the packets 20 ms later than the benchmark's, as
a packet that starts a stream right at its first sample may be lost to
the front end's start-up) and at 240 ksps (K5 to 48 ksps) goes through one
`ChannelReceiver` a channel in each package, in the same uneven chunks;
the packets must be identical in (nmea, designator, abs_sample).  Both
run the main-path formulations (`corr_path="pallas"`, `ff_path="fir"`).
A state dict taken mid-stream in either package resumes in the other.
The decimator's output is held to atol 2e-5 of full scale and rtol 2e-4
(`tests/test_pallas_fir.py`): the two sum the taps in other orders.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ais_tpu.core.params import DemodConfig, dual_channel_configs
from ais_tpu_torch.pipeline import api as tapi
from ais_tpu_torch.pipeline.wideband import WidebandConfig
from ais_tpu_torch.scene import content_parity, full_load_scene

torch.set_num_threads(1)

DEMOD = DemodConfig(corr_path="pallas", ff_path="fir")
CUTS = (0, 37_000, 137_003, 140_000, 301_111)


def _configs(rate):
    return tuple(dataclasses.replace(c, demod=DEMOD) for c in dual_channel_configs(rate))


def _key(packets):
    return [(p.nmea, p.designator, p.abs_sample) for p in packets]


def _chunks(iq):
    cuts = [c for c in CUTS if c < iq.size] + [iq.size]
    return [iq[a:b] for a, b in zip(cuts[:-1], cuts[1:])]


@pytest.fixture(scope="module", params=[250e3, 240e3])
def run(request):
    from ais_tpu.pipeline.api import ChannelReceiver

    rate = request.param
    n = int(rate * 1.6)
    iq, tx = full_load_scene(WidebandConfig(input_rate=rate), n, n - int(rate * 0.05),
                             lead=int(rate * 0.02))
    iq = iq.astype(np.complex64)
    want, states, tails = [], [], []
    for cfg in _configs(rate):
        rx = ChannelReceiver(cfg)
        parts = _chunks(iq)
        got = [rx.process(parts[0]) + rx.process(parts[1])]
        states.append(rx.get_state())
        tails.append(sum((rx.process(p) for p in parts[2:]), []))
        want.append(got[0] + tails[-1])
    return dict(rate=rate, iq=iq, tx=tx, want=want, states=states, tails=tails)


def test_channel_receivers_match_reference(run):
    rate = run["rate"]
    found = []
    for cfg, want in zip(_configs(rate), run["want"]):
        rx = tapi.ChannelReceiver(cfg, device="cpu")
        assert (rx.resample_rate is None) == (rate == 240e3)
        got = sum((rx.process(p) for p in _chunks(run["iq"])), [])
        assert _key(got) == _key(want) and len(got) >= 20
        found += got
    # At full load a burst's AFC estimate can come from a chunk its
    # neighbour dominates; both packages then miss the same packet (one
    # of 114 at 250 ksps here).
    assert content_parity(found, run["tx"], rate / 48e3) >= 0.99


def test_state_round_trip_across_packages(run):
    """The reference's mid-stream state resumes on the port, and the
    port's on the reference, each giving the reference's packets."""
    from ais_tpu.pipeline.api import ChannelReceiver

    parts = _chunks(run["iq"])
    for cfg, state, tail in zip(_configs(run["rate"]), run["states"], run["tails"]):
        rx = tapi.ChannelReceiver(cfg, device="cpu")
        rx.set_state(state)
        assert _key(sum((rx.process(p) for p in parts[2:]), [])) == _key(tail)
        port = tapi.ChannelReceiver(cfg, device="cpu")
        port.process(parts[0])
        port.process(parts[1])
        pstate = port.get_state()
        assert set(pstate) == set(state) and pstate["next_start"] == state["next_start"]
        ref = ChannelReceiver(cfg)
        ref.set_state(pstate)
        assert _key(sum((ref.process(p) for p in parts[2:]), [])) == _key(tail)


def test_baseband_receiver_matches_reference():
    """48 ksps baseband in uneven chunks, the threshold changed mid-stream."""
    from ais_tpu.pipeline.api import BasebandReceiver as Ref
    from ais_tpu.tx import aivdm_payload_to_bytes, make_packet_iq

    burst = make_packet_iq(aivdm_payload_to_bytes("14eG;o@034o8sd<L9i:a;WF>062D"), 5)
    rng = np.random.default_rng(9)
    iq = ((rng.normal(size=60_000) + 1j * rng.normal(size=60_000)) * 0.02).astype(np.complex64)
    for at in (3000, 19_500, 41_000):
        iq[at: at + burst.size] += burst
    got, want = tapi.BasebandReceiver(DEMOD, device="cpu"), Ref(DEMOD)
    for rx in (got, want):
        rx.out = rx.process(iq[:20_000]) + rx.process(iq[20_000:20_001])
        rx.set_threshold(0.8)
        assert rx.get_threshold() == 0.8
        rx.out += rx.process(iq[20_001:])
    assert _key(got.out) == _key(want.out) and len(got.out) == 3
    st = got.get_state()
    assert set(st) == {"tail", "next_start", "dedup_recent"} and st["next_start"] == iq.size
    np.testing.assert_array_equal(st["tail"], want.get_state()["tail"])
    with pytest.raises(NotImplementedError, match="A.11"):
        tapi.BasebandReceiver(dataclasses.replace(DEMOD, samples_per_symbol=5.2), device="cpu")


@pytest.mark.parametrize("offset,n", [(-25e3, 50_003), (25e3 * np.sqrt(2), 50_000)])
def test_freq_xlating_fir_decimate_matches_reference(offset, n):
    """Periodic (-25 kHz: q = 10) and full-length (irrational) carriers,
    an input that is not whole decimation rows."""
    from ais_tpu.ops.fir import freq_xlating_fir_decimate as ref
    from ais_tpu.ops.firdes import low_pass
    from ais_tpu_torch.ops.fir import freq_xlating_fir_decimate, mixer_phase

    taps = low_pass(1.0, 250e3, 11e3, 1e3)
    rng = np.random.default_rng(2)
    x = ((rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.3).astype(np.complex64)
    ph = float(mixer_phase(offset, 250e3, 987_654))
    want = np.asarray(ref(jnp.asarray(x), taps, offset, 250e3, 5, phase0=ph))
    got = freq_xlating_fir_decimate(torch.from_numpy(x), taps, offset, 250e3, 5, ph).numpy()
    assert got.shape == want.shape == ((n - taps.size) // 5 + 1,)
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=2e-4)
