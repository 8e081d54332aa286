"""`decode_wire` for every wire format, port against the JAX reference.

One scene (a packet on each channel, 1-block geometry) is encoded with
the port's `host_bytes` (byte-identical to the reference's,
tests/test_torch_convert.py) in each format and decoded by both
receivers from stream position 0, the reference with its main-path
choices forced (`AIS_TPU_CHAN=pallas`: ci16/ci8 decode then run K5,
ci2/ci4 run K4 and ci1/cd1 K3, all in interpret mode;
`corr_path="pallas"`, `ff_path="fir"`, K=24, compact lanes).  Packets
must be identical in (nmea, designator, abs_sample).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ais_tpu.tx import aivdm_payload_to_bytes
from ais_tpu.tx.scenario import Scenario, ScenarioPacket
from ais_tpu_torch.ops.convert import host_bytes
from ais_tpu_torch.pipeline import wideband as tw

torch.set_num_threads(1)

PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"
N_BLOCKS = 1
EMPTY = {"buf": np.zeros(0, np.complex64), "pos": 0, "dedup_recent": [[], []]}


def _key(packets):
    return [(p.nmea, p.designator, p.abs_sample) for p in packets]


@pytest.fixture(scope="module")
def scene():
    from ais_tpu.pipeline.wideband import WidebandConfig, WidebandReceiver, num_taps

    base = WidebandConfig()
    demod = dataclasses.replace(base.demod, max_bursts_per_block=24,
                                corr_path="pallas", ff_path="fir")
    cl = 14 * 2 * N_BLOCKS
    n48 = base.block_len + base.core_len * (N_BLOCKS - 1)
    n_in = (n48 - 1) * base.decimation + num_taps(base)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AIS_TPU_CHAN", "pallas")
        rrx = WidebandReceiver(base._replace(demod=demod, compact_lanes=cl), n_in=n_in)
    raw = aivdm_payload_to_bytes(PAYLOAD)
    iq = Scenario(sample_rate=2.4e6, n_samples=rrx.n_in, noise=0.004, packets=[
        ScenarioPacket(raw, 200_000, -25e3, phase=0.7),
        ScenarioPacket(raw, 420_000, +25e3, amplitude=0.6, extra_freq_hz=140.0),
    ]).build()
    pcfg = tw.WidebandConfig()._replace(demod=demod, compact_lanes=cl)
    return dict(rrx=rrx, pcfg=pcfg, iq=(iq * 0.7).astype(np.complex64))


def _port(scene, fmt):
    rx = tw.WidebandReceiver(scene["pcfg"], n_in=scene["rrx"].n_in, device="cpu")
    got = rx.decode_wire(host_bytes(scene["iq"], fmt), fmt)
    assert rx.overflow_blocks == 0 and rx.get_state()["pos"] == rx.step_raw
    return got, rx


@pytest.mark.parametrize("fmt", ["ci16", "ci8", "ci4", "ci2", "ci1", "cd1"])
def test_wire_format_packets_identical(scene, fmt):
    rrx = scene["rrx"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AIS_TPU_CHAN", "pallas")
        rrx.set_state(EMPTY)
        want = rrx.decode_wire(host_bytes(scene["iq"], fmt), fmt)
    got, rx = _port(scene, fmt)
    assert _key(got) == _key(want)
    assert len(got) == 2 and {p.designator for p in got} == {"A", "B"}
    kind = {"ci16": "iq", "ci8": "iq", "cd1": "ci1"}.get(fmt, fmt)
    assert set(rx._channelizers) == {kind}
    if fmt == "cd1":
        assert _key(got) == _key(_port(scene, "ci1")[0])
