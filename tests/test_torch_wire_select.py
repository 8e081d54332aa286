"""The port's wire-format selection (`ops/convert.py:
wire_format_envelope`, `select_wire_format`) against the JAX package's on
the captures of `tests/test_wire_select.py`: the same format and the same
reason string from both, and the envelope's numbers to 1e-9 (the code is
a numpy copy, so they are in fact equal).  The fallback the guard picks
must also decode through the port's receiver on the CPU.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_wire_select import (  # noqa: E402
    PAYLOAD, SENTENCE_A, SENTENCE_B, _awgn_scene, _dual_scene,
)

import ais_tpu.ops.convert as ref_convert  # noqa: E402
from ais_tpu.tx import aivdm_payload_to_bytes  # noqa: E402
from ais_tpu.tx.scenario import Scenario, ScenarioPacket  # noqa: E402
from ais_tpu_torch.ops import convert  # noqa: E402
from ais_tpu_torch.pipeline import wideband as tw  # noqa: E402

torch.set_num_threads(1)

CFG = tw.WidebandConfig()
N_IN = tw.aligned_n_in(CFG, (CFG.block_len + CFG.core_len - 1) * CFG.decimation
                       + tw.num_taps(CFG))


def _with_interferer(iq):
    t = np.arange(iq.size) / 2.4e6
    return (iq + 8.0 * np.exp(2j * np.pi * 500e3 * t)).astype(np.complex64)


def _one_channel():
    raw = aivdm_payload_to_bytes(PAYLOAD)
    return Scenario(sample_rate=2.4e6, n_samples=N_IN, noise=0.004,
                    packets=[ScenarioPacket(raw, 300000, +25e3, amplitude=0.8)]).build()


def _separated_slots():
    raw = aivdm_payload_to_bytes(PAYLOAD)
    return Scenario(sample_rate=2.4e6, n_samples=N_IN, noise=1e-4, packets=[
        ScenarioPacket(raw, 200_000, +25e3, amplitude=0.8),
        ScenarioPacket(raw, 800_000, -25e3, amplitude=0.8 * 10 ** (-45 / 20), phase=0.9),
    ]).build()


# name -> (capture, preferred format, expected format, a word of the reason)
CASES = {
    "normal_scene_keeps_cr1": (lambda: _dual_scene(N_IN), "cr1", "cr1", "within envelope"),
    "normal_scene_keeps_ci1": (lambda: _dual_scene(N_IN), "ci1", "ci1", "within envelope"),
    "linear_format_passthrough": (lambda: _dual_scene(N_IN), "ci8", "ci8", "linear format"),
    "extreme_near_far_falls_back": (
        lambda: _dual_scene(N_IN, weak_amplitude=0.8 * 10 ** (-36 / 20)), "cr1", "ci8",
        "near-far"),
    "idle_channel_does_not_trip_near_far": (_one_channel, "cr1", "cr1", "within envelope"),
    "strong_interferer_falls_back": (
        lambda: _with_interferer(_dual_scene(N_IN)), "cr1", "ci8", "interferer"),
    "low_snr_falls_back_to_ci1": (lambda: _awgn_scene(N_IN, 16.0), "cr1", "ci1", "SNR"),
    "high_snr_keeps_cr1": (lambda: _awgn_scene(N_IN, 24.0), "cr1", "cr1", "within envelope"),
    "ci1_is_not_snr_gated": (lambda: _awgn_scene(N_IN, 16.0), "ci1", "ci1", "within envelope"),
    "far_vessel_in_own_slot_trips_near_far": (_separated_slots, "cr1", "ci8", "near-far"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_selection_matches_reference(name):
    make, preferred, want_fmt, word = CASES[name]
    iq = make()
    got = convert.select_wire_format(iq, preferred)
    assert got == ref_convert.select_wire_format(iq, preferred)
    assert got[0] == want_fmt and word in got[1], got
    env, ref_env = convert.wire_format_envelope(iq), ref_convert.wire_format_envelope(iq)
    assert sorted(env) == sorted(ref_env)
    assert env["channels_active"] == ref_env["channels_active"]
    for key in ("near_far_db", "interferer_db", "channel_snr_db"):
        np.testing.assert_allclose(env[key], ref_env[key], rtol=0, atol=1e-9)


def test_snr_proxy_tracks_ebn0():
    """channel_snr_db ~ Eb/N0 - 3.9 dB with unit slope over the decode
    range, the mapping `min_snr_db` is expressed in; equal in both
    packages."""
    for ebn0 in (12.0, 20.0, 28.0):
        iq = _awgn_scene(N_IN, ebn0)
        env = convert.wire_format_envelope(iq)
        assert env == ref_convert.wire_format_envelope(iq)
        act = [s for s, a in zip(env["channel_snr_db"], env["channels_active"]) if a]
        assert len(act) == 2, (ebn0, env)
        for s in act:
            assert abs(s - (ebn0 - 3.9)) < 1.5, (ebn0, act)


def test_ci8_decodes_the_interferer_scene():
    """The fallback works: the interferer scene, which sets the 1-bit
    scale 20 dB above the signals, decodes fully through the linear ci8
    wire on the port's receiver (the channelizer's stopband removes the
    carrier)."""
    iq = _with_interferer(_dual_scene(N_IN))
    iq = (iq / (np.abs(iq).max() + 1e-9) * 0.9).astype(np.complex64)
    fmt, _ = convert.select_wire_format(iq, "cr1")
    assert fmt == "ci8"
    rx = tw.WidebandReceiver(CFG, n_in=N_IN, device="cpu")
    got = rx.decode_wire(convert.host_bytes(iq, fmt), fmt)
    assert sorted(p.nmea for p in got) == [SENTENCE_A, SENTENCE_B]


def test_keyword_limits_are_the_reference_s():
    """The limits are arguments: a tighter near-far limit or a looser
    sensitivity margin changes the choice the same way in both."""
    iq = _dual_scene(N_IN)
    for kw in ({"near_far_limit_db": 1.0}, {"min_snr_db": 60.0}, {"interferer_limit_db": -50.0},
               {"rate": 2.4e6, "offsets": (-25e3,)}):
        assert convert.select_wire_format(iq, "cr1", **kw) \
            == ref_convert.select_wire_format(iq, "cr1", **kw), kw
    assert convert.select_wire_format(iq, "cr1", near_far_limit_db=1.0)[0] == "ci8"
    assert convert.select_wire_format(iq, "cr1", min_snr_db=60.0)[0] == "ci1"
