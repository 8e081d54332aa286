"""Streaming continuity, checkpoint and resume, long frames and lane
compaction on the port, on the CPU: the analogues of
`tests/test_streaming.py` (continuity, the 250 ksps resampler path,
`StageTimer`), `tests/test_checkpoint.py`, `tests/test_longframe.py` and
`tests/test_compact.py`, with the same scenes and the same expectations;
where a case has one answer in both packages it is compared with the
reference's too.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from oracle_modulator import make_oracle_packet  # noqa: E402
from test_checkpoint import _key, _small_cfg, _wideband_capture  # noqa: E402
from test_compact import _geometry, _scene  # noqa: E402

from ais_tpu_torch.core.params import (  # noqa: E402
    ChannelizerConfig, DeframerConfig, DemodConfig, ReceiverConfig, demod_for_max_frame,
)
from ais_tpu_torch.ops.resample import pfb_arb_resample  # noqa: E402
from ais_tpu_torch.pipeline import wideband as tw  # noqa: E402
from ais_tpu_torch.pipeline.api import BasebandReceiver, ChannelReceiver  # noqa: E402
from ais_tpu_torch.pipeline.radio import AisRadio  # noqa: E402
from ais_tpu_torch.tx import aivdm_payload_to_bytes, make_packet_iq  # noqa: E402

torch.set_num_threads(1)

PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"
SENTENCE = "!AIVDM,1,1,,A,14eG;o@034o8sd<L9i:a;WF>062D,0*7D"


def _noise(n, seed=0, scale=0.01):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=n) + 1j * rng.normal(size=n)) * scale).astype(np.complex64)


@pytest.fixture(scope="module")
def packet():
    return make_packet_iq(aivdm_payload_to_bytes(PAYLOAD), samples_per_symbol=5)


class TestStreamingContinuity:
    def test_packet_split_across_calls(self, packet):
        iq = _noise(40000)
        pos = 19500  # the 20k call boundary falls mid-packet
        iq[pos: pos + packet.size] += packet
        rx = BasebandReceiver(device="cpu")
        got = rx.process(iq[:20000]) + rx.process(iq[20000:])
        assert [p.nmea for p in got] == [SENTENCE]
        assert abs(got[0].abs_sample - pos) < 100

    def test_no_duplicates_when_fully_in_first_call(self, packet):
        iq = _noise(40000)
        iq[16000: 16000 + packet.size] += packet
        rx = BasebandReceiver(device="cpu")
        got = rx.process(iq[:20000]) + rx.process(iq[20000:])
        assert [p.nmea for p in got] == [SENTENCE]

    @pytest.mark.parametrize("mode", ["feedforward", "pll"])
    def test_many_small_chunks(self, packet, mode):
        iq = _noise(60000)
        for pos in (9000, 33000, 50000):
            iq[pos: pos + packet.size] += packet
        rx = BasebandReceiver(demod=DemodConfig(timing_mode=mode), device="cpu")
        got = []
        for i in range(0, 60000, 6000):
            got.extend(rx.process(iq[i: i + 6000]))
        assert [p.nmea for p in got] == [SENTENCE] * 3


class TestStreaming250k:
    """Continuous 250 ksps streaming: the fractional-rate resampler carries
    state across process() calls, so a boundary-straddling packet decodes
    exactly once."""

    CFG = ReceiverConfig(channelizer=ChannelizerConfig(input_rate=250e3, offset_hz=-25e3))

    @pytest.fixture(scope="class")
    def capture_250k(self):
        burst48 = make_packet_iq(aivdm_payload_to_bytes(PAYLOAD), samples_per_symbol=5)
        sig48 = np.zeros(60000, dtype=np.complex64)
        sig48[24000: 24000 + burst48.size] = burst48
        sig250 = pfb_arb_resample(sig48, 250.0 / 48.0)
        t = np.arange(sig250.size) / 250e3
        iq = _noise(sig250.size, seed=7)
        iq += (sig250 * np.exp(-2j * np.pi * 25e3 * t)).astype(np.complex64)
        return iq

    @pytest.mark.parametrize("chunk", [10000, 50000, 124000])
    def test_straddling_packet_decodes_exactly_once(self, capture_250k, chunk):
        rx = ChannelReceiver(self.CFG, device="cpu")
        assert rx.resample_rate == pytest.approx(0.96)
        got = []
        for i in range(0, capture_250k.size, chunk):
            got.extend(rx.process(capture_250k[i: i + chunk]))
        assert [p.nmea for p in got] == [SENTENCE]

    def test_checkpoint_resume_through_resampler(self, capture_250k):
        a = ChannelReceiver(self.CFG, device="cpu")
        got_a = list(a.process(capture_250k[:100000]))
        state = a.get_state()
        b = ChannelReceiver(self.CFG, device="cpu")
        b.set_state(state)
        got_a.extend(a.process(capture_250k[100000:]))
        got_b = list(b.process(capture_250k[100000:]))
        # The resumed receiver finishes the straddling packet too.
        assert [p.nmea for p in got_a] == [SENTENCE]
        assert [p.nmea for p in got_b] == [SENTENCE]


class TestProfiling:
    def test_stage_timer(self):
        from ais_tpu_torch.utils.profiling import StageTimer

        t = StageTimer()
        with t.stage("a"):
            pass
        with t.stage("a"):
            pass
        with pytest.raises(KeyError):
            with t.stage("b"):
                raise KeyError("still counted")
        assert t.counts["a"] == 2 and t.counts["b"] == 1
        assert "a:" in t.report() and "2 calls" in t.report()

    def test_trace_writes_a_chrome_trace(self, tmp_path, packet):
        import json

        from ais_tpu_torch.utils.profiling import trace

        iq = _noise(20000)
        iq[3000: 3000 + packet.size] += packet
        rx = BasebandReceiver(device="cpu")
        with trace(str(tmp_path / "prof")):
            got = rx.process(iq)
        assert [p.nmea for p in got] == [SENTENCE]
        (written,) = (tmp_path / "prof").glob("*.json")
        events = json.loads(written.read_text())["traceEvents"]
        assert any("fft" in str(e.get("name", "")) for e in events)


class TestCheckpoint:
    """The whole stream state is a small picklable dict: a killed receiver
    resumes exactly, packets straddling the snapshot included."""

    def test_wideband_kill_resume_exact(self):
        cfg, n_in = _small_cfg()
        cfg = tw.WidebandConfig(*cfg)
        rx_full = tw.WidebandReceiver(cfg, n_in=n_in, device="cpu")
        n = rx_full.step_raw * 4
        iq, tx = _wideband_capture(cfg, n)
        want = _key(rx_full.decode(iq) + rx_full.flush())
        assert len(want) >= len(tx) - 1  # the scene itself decodes

        cut = rx_full.step_raw + rx_full.n_in // 3   # not step-aligned
        rx_a = tw.WidebandReceiver(cfg, n_in=n_in, device="cpu")
        got = rx_a.decode(iq[:cut])
        blob = pickle.dumps(rx_a.get_state())
        del rx_a
        rx_b = tw.WidebandReceiver(cfg, n_in=n_in, device="cpu")
        rx_b.set_state(pickle.loads(blob))
        got += rx_b.decode(iq[cut:]) + rx_b.flush()
        assert _key(got) == want

    def test_radio_wideband_state_roundtrip(self):
        radio = AisRadio(sample_rate=2.4e6, fused_blocks=2, device="cpu")
        n = radio.wideband.step_raw * 2
        iq, _tx = _wideband_capture(radio.wideband.cfg, n)
        cut = n // 2 + 12_345
        r1 = AisRadio(sample_rate=2.4e6, fused_blocks=2, device="cpu")
        got = r1.process(iq[:cut])
        state = pickle.loads(pickle.dumps(r1.get_state()))
        r2 = AisRadio(sample_rate=2.4e6, fused_blocks=2, device="cpu")
        r2.set_state(state)
        got += r2.process(iq[cut:]) + r2.flush()
        want = radio.process(iq) + radio.flush()
        assert _key(got) == _key(want) and len(want) >= 4

    def test_radio_channel_path_state_roundtrip(self):
        """The 250 ksps fractional-rate path: resampler carry and baseband
        tail survive the snapshot."""
        burst48 = make_packet_iq(aivdm_payload_to_bytes(PAYLOAD), samples_per_symbol=5)
        sig48 = np.zeros(60_000, dtype=np.complex64)
        sig48[24_000: 24_000 + burst48.size] = burst48
        sig250 = pfb_arb_resample(sig48, 250.0 / 48.0)
        t = np.arange(sig250.size) / 250e3
        iq = _noise(sig250.size, seed=7, scale=0.02)
        iq += (sig250 * np.exp(-2j * np.pi * 25e3 * t)).astype(np.complex64)

        want = AisRadio(sample_rate=250e3, device="cpu").process(iq)
        assert len(want) == 1
        cut = 24_000 * 5 + 600  # mid-packet
        r1 = AisRadio(sample_rate=250e3, device="cpu")
        got = r1.process(iq[:cut])
        state = pickle.loads(pickle.dumps(r1.get_state()))
        r2 = AisRadio(sample_rate=250e3, device="cpu")
        r2.set_state(state)
        got += r2.process(iq[cut:])
        # The same split on one live receiver: resume is exact against it.
        rc = AisRadio(sample_rate=250e3, device="cpu")
        control = rc.process(iq[:cut]) + rc.process(iq[cut:])
        assert _key(got) == _key(control)
        assert [p.payload for p in got] == [p.payload for p in want]
        assert abs(got[0].abs_sample - want[0].abs_sample) <= 8

    def test_state_topology_mismatch_raises(self):
        r_chan = AisRadio(sample_rate=250e3, device="cpu")
        r_wide = AisRadio(sample_rate=2.4e6, fused_blocks=2, device="cpu")
        with pytest.raises(ValueError, match="wideband"):
            r_chan.set_state(r_wide.get_state())

    def test_set_rate_rebuilds_topology(self):
        radio = AisRadio(sample_rate=2.4e6, fused_blocks=2, device="cpu")
        assert radio.uses_fused_wideband
        radio.set_rate(250e3)
        assert radio.get_rate() == 250e3
        assert not radio.uses_fused_wideband and len(radio.rx_paths) == 2


class TestLongFrame:
    """The window's frame capacity is a property of the config; a config
    that cannot carry its deframer bound is refused; a scaled one decodes
    a long frame."""

    def test_default_window_carries_reference_bound(self):
        assert DemodConfig().max_frame_bytes >= 64

    def test_factory_inverts_capacity(self):
        for bound in (64, 128, 256, 1000):
            cfg = demod_for_max_frame(bound)
            assert cfg.max_frame_bytes >= bound
            assert cfg.burst_len <= demod_for_max_frame(bound + 64).burst_len

    def test_oversized_bound_rejected_baseband(self):
        with pytest.raises(ValueError, match="demod_for_max_frame"):
            BasebandReceiver(deframer=DeframerConfig(max_length_bytes=1000), device="cpu")

    def test_oversized_bound_rejected_wideband(self):
        with pytest.raises(ValueError, match="frame capacity"):
            tw.WidebandReceiver(
                tw.WidebandConfig(deframer=DeframerConfig(max_length_bytes=1000)), device="cpu")

    @staticmethod
    def _long_frame_capture():
        rng = np.random.default_rng(3)
        # 126 payload bytes + the 2-byte FCS: 128 on-air frame bytes.
        payload = bytes(rng.integers(0, 256, size=126, dtype=np.uint8))
        pkt = make_oracle_packet(payload, sps=5)
        iq = (rng.normal(size=30000) + 1j * rng.normal(size=30000)).astype(np.complex64) * 0.02
        iq[4000: 4000 + pkt.size] += pkt.astype(np.complex64)
        return payload, iq

    @pytest.mark.parametrize("mode", ["feedforward", "pll"])
    def test_128_byte_frame_decodes_with_scaled_config(self, mode):
        from ais_tpu.pipeline import BasebandReceiver as Ref

        payload, iq = self._long_frame_capture()
        demod = demod_for_max_frame(128, DemodConfig(timing_mode=mode))
        rx = BasebandReceiver(demod=demod, deframer=DeframerConfig(max_length_bytes=128),
                              block_len=16384, device="cpu")
        got = rx.process(iq)
        assert [p.payload for p in got] == [payload]
        import dataclasses

        ref = Ref(demod=dataclasses.replace(demod, corr_path="pallas", ff_path="fir"),
                  deframer=DeframerConfig(max_length_bytes=128), block_len=16384)
        assert [(p.payload, p.abs_sample) for p in ref.process(iq)] \
            == [(p.payload, p.abs_sample) for p in got]

    def test_default_config_truncates_long_frame(self):
        _, iq = self._long_frame_capture()
        rx = BasebandReceiver(
            deframer=DeframerConfig(max_length_bytes=DemodConfig().max_frame_bytes),
            device="cpu")
        assert [p.payload for p in rx.process(iq)] == []


class TestCompact:
    """Valid-lane compaction of the device-to-host buffer is transport
    only: the dense path's packets, and a directory too small for the
    step's lanes degrades to overflow recovery, never to loss."""

    @staticmethod
    def _decode(cfg, n_in, wire):
        rx = tw.WidebandReceiver(tw.WidebandConfig(*cfg), n_in=n_in, device="cpu")
        return rx.decode_wire(wire[: rx.n_in * 2], "ci8")

    def test_compact_matches_dense(self):
        cfg, n_in = _geometry()
        wire, tx = _scene(cfg, n_in + 8 * cfg.decimation)
        dense = _key(self._decode(cfg, n_in, wire))
        assert len(dense) >= len(tx) - 1
        assert _key(self._decode(cfg._replace(compact_lanes=64), n_in, wire)) == dense

    def test_compact_meta_roundtrip(self):
        cfg, n_in = _geometry()
        wire, _tx = _scene(cfg, n_in + 8 * cfg.decimation)
        pd = self._decode(cfg, n_in, wire)
        pc = self._decode(cfg._replace(compact_lanes=48), n_in, wire)
        key = lambda p: (p.abs_sample, p.designator)  # noqa: E731
        assert len(pd) == len(pc) >= 5
        for a, b in zip(sorted(pd, key=key), sorted(pc, key=key)):
            assert (a.payload, a.abs_sample, a.designator) == (b.payload, b.abs_sample,
                                                               b.designator)
            assert np.isclose(a.freq_est_hz, b.freq_est_hz, atol=1e-4)
            assert np.isclose(a.rssi, b.rssi, rtol=1e-5)
            assert np.isclose(a.corr_mag, b.corr_mag, rtol=1e-5)

    def test_compact_directory_overflow_recovers(self):
        cfg, n_in = _geometry()
        wire, tx = _scene(cfg, n_in + 8 * cfg.decimation, n_packets=8)
        dense = _key(self._decode(cfg, n_in, wire))
        assert len(dense) >= len(tx) - 1
        # 2 lanes: far below the ~8 valid lanes of the step.
        assert _key(self._decode(cfg._replace(compact_lanes=2), n_in, wire)) == dense
