"""Overflow recovery (`ais_tpu_torch/pipeline/recover.py` and its hooks
in `WidebandReceiver`) against `ais_tpu.pipeline.recover`.

A block with 6 packets on channel A and a burst table of 2 (3x
overflow, `tests/test_recover.py`'s scene) goes through both packages'
`WidebandReceiver` on the wire path (ci8 and cr1) and the complex path.
The port must decode every packet, and the same packets as the
reference, exactly in (nmea, designator, abs_sample).  The reference
runs its main-path choices (`AIS_TPU_CHAN=pallas`, `corr_path="pallas"`,
`ff_path="fir"`); its recovery pins its FFT correlator, the port's runs
K2's plain version here.  Recovery's wire decode must equal the
reference's `host_iq_from_wire` bit for bit.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from ais_tpu.core.params import DemodConfig
from ais_tpu.tx import aivdm_payload_to_bytes
from ais_tpu.tx.scenario import Scenario, ScenarioPacket
from ais_tpu_torch.ops import convert as tconv
from ais_tpu_torch.pipeline import recover as trec
from ais_tpu_torch.pipeline import wideband as tw

torch.set_num_threads(1)

PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"
DEMOD = DemodConfig(max_bursts_per_block=2, corr_path="pallas", ff_path="fir")


def _geometry():
    cfg = tw.WidebandConfig(demod=DEMOD)
    n48 = cfg.block_len + cfg.core_len  # 2 demod blocks a call
    return cfg, tw.aligned_n_in(cfg, (n48 - 1) * cfg.decimation + tw.num_taps(cfg))


def _overflow_scene(cfg, n_in):
    """Six distinct packets in block 0's core on channel A, 1800 channel
    samples apart: 3x the burst table."""
    raw = aivdm_payload_to_bytes(PAYLOAD)
    rng = np.random.default_rng(3)
    packets = []
    for k in range(6):
        p = bytearray(raw)
        p[1] = 10 + k
        packets.append(ScenarioPacket(
            payload=bytes(p), start_sample=(400 + k * 1800) * cfg.decimation,
            offset_hz=float(cfg.offsets_hz[0]), phase=float(rng.uniform(0, 2 * np.pi)),
            extra_freq_hz=float(rng.uniform(-100, 100))))
    iq = Scenario(sample_rate=cfg.input_rate, n_samples=n_in, packets=packets,
                  noise=0.004).build()
    return (iq * 0.7).astype(np.complex64), packets


def _key(packets):
    return [(p.nmea, p.designator, p.abs_sample) for p in packets]


@pytest.fixture(scope="module")
def run():
    from ais_tpu.pipeline.wideband import WidebandConfig, WidebandReceiver

    cfg, n_in = _geometry()
    iq, tx = _overflow_scene(cfg, n_in)
    wires = {fmt: tconv.host_bytes(iq, fmt) for fmt in ("ci8", "cr1")}
    want = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AIS_TPU_CHAN", "pallas")
        rcfg = WidebandConfig(demod=DEMOD)
        for fmt, wire in wires.items():
            want[fmt] = WidebandReceiver(rcfg, n_in=n_in).decode_wire(wire, fmt)
        want["iq"] = WidebandReceiver(rcfg, n_in=n_in).decode(iq)
    return dict(cfg=cfg, n_in=n_in, iq=iq, tx=tx, wires=wires, want=want)


@pytest.mark.parametrize("path", ["ci8", "cr1", "iq"])
def test_recovered_packets_equal_reference(run, path):
    """3x overflow: every packet decodes, each once, and the packet list
    is the reference's."""
    rx = tw.WidebandReceiver(run["cfg"], n_in=run["n_in"], device="cpu")
    got = rx.decode(run["iq"]) if path == "iq" else rx.decode_wire(run["wires"][path], path)
    assert sorted(p.payload for p in got) == sorted(p.payload for p in run["tx"])
    assert _key(got) == _key(run["want"][path])
    assert rx.overflow_blocks >= 1 and rx.recover_s > 0
    assert set(rx._recover_demods) == {trec.MIN_RECOVER_K}


def test_without_recovery_drops_and_logs(run, caplog):
    cfg = run["cfg"]._replace(overflow_recovery=False)
    rx = tw.WidebandReceiver(cfg, n_in=run["n_in"], device="cpu")
    with caplog.at_level(logging.WARNING, logger="ais_tpu_torch"):
        got = rx.decode_wire(run["wires"]["ci8"], "ci8")
    assert len(got) < len(run["tx"]) and rx.overflow_blocks >= 1
    assert "burst table overflow" in caplog.text
    assert rx.recover_s == 0 and not rx._recover_demods


def test_table_size_escalates_in_powers_of_two(caplog):
    assert [trec.recover_table_size(n) for n in (3, 64, 65, 300, 1024, 5000)] == [
        64, 64, 128, 512, 1024, 1024]
    from ais_tpu.pipeline.recover import _recover_demod

    demod = dataclasses.replace(DemodConfig(), samples_per_symbol=5.0)
    for n in (3, 65, 300, 5000):
        assert _recover_demod(demod, 16384, 11760, n)[1].max_bursts_per_block == \
            trec.recover_table_size(n)
    # Past 1024 detections the first 1024 are recovered, with a warning.
    cfg, n_in = _geometry()
    iq, _ = _overflow_scene(cfg, n_in)
    rx = tw.WidebandReceiver(cfg, n_in=n_in, device="cpu")
    with caplog.at_level(logging.WARNING, logger="ais_tpu_torch"):
        trec.recover_overflow_packets(iq, 0, cfg, rx.constants.taps, [(0, 1, 2000)],
                                      None, rx._recover_demod)
    assert "exceed even the escalated table (1024)" in caplog.text


@pytest.mark.parametrize("fmt", ["ci16", "ci8", "ci4", "ci2", "ci1", "cu8", "cr1", "cd1"])
def test_host_iq_from_wire_bit_exact(fmt):
    """Recovery's wire decode (`ops/convert.py:iq_from_bytes` on a CPU
    tensor) equals the reference's `host_iq_from_wire` bit for bit, on
    the same bytes (the reference's cr1/cd1 pad samples past n aside)."""
    from ais_tpu.pipeline.recover import host_iq_from_wire as ref_host_iq

    rng = np.random.default_rng(11)
    n = 512
    iq = (rng.normal(size=n, scale=0.3) + 1j * rng.normal(size=n, scale=0.3)).astype(np.complex64)
    if fmt == "cu8":
        wire = np.clip(np.round(np.stack([iq.real, iq.imag], -1) * 127.5 + 127.5), 0, 255)
        wire = wire.astype(np.uint8).reshape(-1)
    else:
        wire = tconv.host_bytes(iq, fmt)
    got = tconv.iq_from_bytes(torch.from_numpy(wire), fmt, n).numpy()
    assert got.dtype == np.complex64 and got.shape == (n,)
    np.testing.assert_array_equal(got, ref_host_iq(wire, fmt)[:n])
    with pytest.raises(ValueError, match="unsupported wire format"):
        tconv.iq_from_bytes(torch.from_numpy(wire), "cx3", n)


def test_host_channelize_span_matches_reference():
    from ais_tpu.pipeline.recover import _host_channelize_span

    rng = np.random.default_rng(5)
    iq = (rng.normal(size=30_000) + 1j * rng.normal(size=30_000)).astype(np.complex64)
    taps = tw.channel_taps(tw.WidebandConfig())
    got = trec.host_channelize_span(iq, taps, -25e3, 2.4e6, 50, 123_456)
    np.testing.assert_array_equal(got, _host_channelize_span(iq, taps, -25e3, 2.4e6, 50, 123_456))
