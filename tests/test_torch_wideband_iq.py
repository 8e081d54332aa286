"""The complex-IQ path (`process` / `decode` / `flush`), port against the
JAX reference.

One stream of complex samples goes through the reference
`WidebandReceiver.decode` (its main-path choices forced:
`AIS_TPU_CHAN=pallas`, so K5 runs in interpret mode, `corr_path="pallas"`,
`ff_path="fir"`, K=24) and through the port's, at a 2-block geometry:
one full step, then a short tail that `flush()` zero-pads into a second
step.  Packets must be identical in (nmea, designator, abs_sample).  A
state dict taken mid-stream (a non-empty sample buffer) from either
package resumes on the other with identical packets.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ais_tpu.tx import aivdm_payload_to_bytes
from ais_tpu.tx.scenario import Scenario, ScenarioPacket
from ais_tpu_torch.pipeline import wideband as tw

torch.set_num_threads(1)

PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"
N_BLOCKS = 2


def _configs():
    from ais_tpu.pipeline.wideband import WidebandConfig, num_taps

    base = WidebandConfig()
    demod = dataclasses.replace(base.demod, max_bursts_per_block=24,
                                corr_path="pallas", ff_path="fir")
    ref = base._replace(demod=demod)
    port = tw.WidebandConfig()._replace(demod=demod)
    n48 = base.block_len + base.core_len * (N_BLOCKS - 1)
    return ref, port, (n48 - 1) * base.decimation + num_taps(base)


def _key(packets):
    return [(p.nmea, p.designator, p.abs_sample) for p in packets]


@pytest.fixture(scope="module")
def run():
    """The reference's packets: the whole stream, and its continuation
    from the mid-stream state."""
    from ais_tpu.pipeline.wideband import WidebandReceiver

    rcfg, pcfg, n_in = _configs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AIS_TPU_CHAN", "pallas")
        rrx = WidebandReceiver(rcfg, n_in=n_in)
        n_in, step = rrx.n_in, rrx.step_raw
        raw = aivdm_payload_to_bytes(PAYLOAD)
        iq = Scenario(sample_rate=2.4e6, n_samples=n_in + step // 2, noise=0.004, packets=[
            ScenarioPacket(raw, 200_000, -25e3, phase=0.7),
            ScenarioPacket(raw, 700_000, +25e3, amplitude=0.6, extra_freq_hz=140.0),
            ScenarioPacket(raw, step + 150_000, -25e3, phase=2.0),
            ScenarioPacket(raw, step + 300_000, +25e3, phase=1.1, extra_freq_hz=-90.0),
        ]).build()
        parts = [iq[:n_in], iq[n_in:]]
        first = rrx.decode(parts[0])
        state = rrx.get_state()
        rest = rrx.decode(parts[1]) + rrx.flush()
    return dict(rrx=rrx, pcfg=pcfg, n_in=n_in, parts=parts, first=first, state=state,
                rest=rest)


def test_decode_and_flush_packets_identical(run):
    rx = tw.WidebandReceiver(run["pcfg"], n_in=run["n_in"], device="cpu")
    first = rx.decode(run["parts"][0])
    assert _key(first) == _key(run["first"]) and len(first) == 2
    assert rx.decode(run["parts"][1]) == []  # half a step: buffered, no device call
    tail = rx.flush()
    assert _key(tail) == _key(run["rest"]) and len(tail) == 2
    assert {p.designator for p in first + tail} == {"A", "B"}
    for g, w in zip(first + tail, run["first"] + run["rest"]):
        assert g.freq_est_hz == w.freq_est_hz
        assert g.corr_mag == pytest.approx(w.corr_mag, rel=1e-3)
        assert g.rssi == pytest.approx(w.rssi, rel=1e-4)
    assert rx.overflow_blocks == 0 and rx.flush() == []


def test_state_round_trip_across_packages(run):
    """The reference's mid-stream state (a non-empty sample buffer)
    resumes on the port, and the port's on the reference, each giving
    the reference's packets."""
    state = run["state"]
    assert state["buf"].size == run["n_in"] - run["rrx"].step_raw > 0
    rx = tw.WidebandReceiver(run["pcfg"], n_in=run["n_in"], device="cpu")
    rx.set_state(state)
    got = rx.decode(run["parts"][1]) + rx.flush()
    assert _key(got) == _key(run["rest"])

    port = tw.WidebandReceiver(run["pcfg"], n_in=run["n_in"], device="cpu")
    port.decode(run["parts"][0])
    pstate = port.get_state()
    np.testing.assert_array_equal(pstate["buf"], state["buf"])
    assert pstate["pos"] == state["pos"]
    rrx = run["rrx"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AIS_TPU_CHAN", "pallas")
        rrx.set_state(pstate)
        again = rrx.decode(run["parts"][1]) + rrx.flush()
    assert _key(again) == _key(run["rest"])


def test_constructor_builds_channelizers_lazily():
    """A geometry K1 cannot take still makes a receiver: the complex
    path runs on K5, and cr1 bytes are decoded, then run on K5.  A
    carrier with no period (an irrational offset) takes the full-length
    table on every path that uses it, built at first use."""
    cfg = tw.WidebandConfig(offsets_hz=(-1e3, 1e3))
    rx = tw.WidebandReceiver(cfg, n_in=900_000, device="cpu")
    assert rx._channelizers == {}
    assert rx._wire_route("cr1")[0] == "iq"
    rec = rx.device_step(np.zeros(rx.n_in, np.complex64), 0)
    assert not rec.valid.any() and set(rx._channelizers) == {"iq"}

    irr = tw.WidebandConfig(offsets_hz=(-25e3 * np.sqrt(2), 25e3))
    rx = tw.WidebandReceiver(irr, n_in=900_000, device="cpu")
    assert rx.decode(np.zeros(rx.n_in, np.complex64)) == []
    assert rx.decode_wire(np.zeros(rx.n_in // 2, np.uint8), "ci2") == []
    assert rx._wire_route("cr1")[0] == "iq"
    assert set(rx._channelizers) == {"iq", "ci2"}
    assert all(m.full_table and m.carrier.shape[1] == rx.n_in
               for m in rx._channelizers.values())
    assert rx.get_state()["pos"] == 2 * rx.step_raw
    with pytest.raises(ValueError, match="complex64"):
        rx.device_step(np.zeros(10, np.complex64), 0)


def test_prepare_builds_the_route_channelizer():
    """`prepare(fmt)` builds only the channelizer `fmt`'s bytes run
    through: cr1 on K1 where K1 takes the geometry, on K5 where it does
    not; ci8 always on K5; cu8 on K5's cu8 entry; an unknown format raises."""
    rx = tw.WidebandReceiver(tw.WidebandConfig(), n_in=900_000, device="cpu")
    assert rx.prepare("cr1") is rx.channelizer_for("cr1")
    assert set(rx._channelizers) == {"cr1"}
    assert rx.prepare("ci8") is rx.channelizer_for("iq")
    odd = tw.WidebandReceiver(tw.WidebandConfig(offsets_hz=(-1e3, 1e3)), n_in=900_000,
                              device="cpu")
    assert odd.prepare("cr1") is odd.channelizer_for("iq")
    assert set(odd._channelizers) == {"iq"}
    assert odd.prepare("cu8") is odd.channelizer_for("cu8")
    assert set(odd._channelizers) == {"iq", "cu8"}
    with pytest.raises(ValueError, match="unsupported wire format"):
        odd.prepare("cx3")


def test_overflow_raises_on_the_complex_path(run, caplog):
    """K = 1 cannot hold a block's bursts: the step re-demodulates the
    overflowed blocks with a larger table and decodes the reference's
    packets; with overflow_recovery off it is logged and packets drop."""
    cfg = run["pcfg"]._replace(
        demod=dataclasses.replace(run["pcfg"].demod, max_bursts_per_block=1))
    rx = tw.WidebandReceiver(cfg, n_in=run["n_in"], device="cpu")
    got = rx.decode(run["parts"][0])
    assert rx.overflow_blocks >= 1 and rx.recover_s > 0
    assert _key(got) == _key(run["first"])
    rx = tw.WidebandReceiver(cfg._replace(overflow_recovery=False), n_in=run["n_in"],
                             device="cpu")
    with caplog.at_level("WARNING", logger="ais_tpu_torch"):
        rx.decode(run["parts"][0])
    assert rx.overflow_blocks >= 1 and "overflow" in caplog.text
