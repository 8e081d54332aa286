"""The whole slice: cr1 wire bytes -> packets, port against the JAX reference.

The same cr1 wire bytes go through the reference `WidebandReceiver`
(its main-path choices forced: `AIS_TPU_CHAN=pallas`, the Pallas
kernels in interpret mode, `corr_path="pallas"`, `ff_path="fir"`, K=24,
compact lanes) and through the port's, at a 3-block geometry.  Packets
must be identical in (nmea, designator, abs_sample).  Burst records:
integer fields and bits exactly on valid lanes (bits from index 2, see
tests/test_torch_sync.py), float fields to the tolerances stated below.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ais_tpu.tx import aivdm_payload_to_bytes
from ais_tpu.tx.scenario import Scenario, ScenarioPacket
from ais_tpu_torch.ops.convert import host_bytes
from ais_tpu_torch.pipeline import wideband as tw

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"
N_BLOCKS = 3


def _configs():
    from ais_tpu.pipeline.wideband import WidebandConfig, num_taps

    base = WidebandConfig()
    demod = dataclasses.replace(base.demod, max_bursts_per_block=24,
                                corr_path="pallas", ff_path="fir")
    cl = 14 * 2 * N_BLOCKS
    ref = base._replace(demod=demod, compact_lanes=cl)
    port = tw.WidebandConfig()._replace(demod=demod, compact_lanes=cl)
    n48 = base.block_len + base.core_len * (N_BLOCKS - 1)
    return ref, port, (n48 - 1) * base.decimation + num_taps(base)


@pytest.fixture(scope="module")
def run():
    """Reference results on a two-step cr1 stream (step 0 decoded)."""
    from ais_tpu.ops.pallas_fir import pallas_wire_channelizer, wire_channelizer_buffers
    from ais_tpu.pipeline.wideband import WidebandReceiver, make_wideband_fns

    rcfg, pcfg, n_in = _configs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AIS_TPU_CHAN", "pallas")
        rrx = WidebandReceiver(rcfg, n_in=n_in)
        raw = aivdm_payload_to_bytes(PAYLOAD)
        step, n_in = rrx.step_raw, rrx.n_in
        core_raw = rrx.core_len * rcfg.decimation
        iq = Scenario(sample_rate=2.4e6, n_samples=step + n_in, noise=0.004, packets=[
            ScenarioPacket(raw, 200000, -25e3, phase=0.7),
            ScenarioPacket(raw, 700000, +25e3, amplitude=0.6, extra_freq_hz=140.0),
            ScenarioPacket(raw, step - 40000, +25e3, phase=1.1),
            ScenarioPacket(raw, step + core_raw // 2, -25e3, phase=2.0),
        ]).build()
        stream = host_bytes((iq * 0.7).astype(np.complex64), "cr1")
        wires = [stream[: n_in // 8], stream[step // 8: (step + n_in) // 8]]
        packets0 = rrx.decode_wire(wires[0], "cr1")
        state0 = rrx.get_state()

        taps = tw.channel_taps(rcfg)
        car, h = wire_channelizer_buffers("cr1", taps, rcfg.decimation, rcfg.offsets_hz,
                                          rcfg.input_rate)
        _, demod = make_wideband_fns(rcfg, n_in)
        records = jax.jit(lambda w, ph: demod(pallas_wire_channelizer(
            w, ph, jnp.asarray(car), jnp.asarray(h), fmt="cr1", ntaps=taps.size,
            decim=rcfg.decimation, offsets=rcfg.offsets_hz, rate=rcfg.input_rate,
            n_in=n_in)))
        phase0s = np.stack([tw.mixer_phase(o, rcfg.input_rate, 0) for o in rcfg.offsets_hz])
        rec0 = jax.tree.map(np.asarray, records(jnp.asarray(wires[0]), jnp.asarray(phase0s)))
    return dict(rrx=rrx, pcfg=pcfg, n_in=n_in, wires=wires, packets0=packets0,
                state0=state0, rec0=rec0, phase0s=phase0s)


def _key(packets):
    return [(p.nmea, p.designator, p.abs_sample) for p in packets]


def test_slice_packets_identical(run):
    rx = tw.WidebandReceiver(run["pcfg"], n_in=run["n_in"], device="cpu")
    got = rx.decode_wire(run["wires"][0], "cr1")
    assert _key(got) == _key(run["packets0"])
    assert len(got) == 3 and {p.designator for p in got} == {"A", "B"}
    for g, w in zip(got, run["packets0"]):
        assert g.freq_est_hz == w.freq_est_hz
        assert g.corr_mag == pytest.approx(w.corr_mag, rel=1e-3)
        assert g.rssi == pytest.approx(w.rssi, rel=1e-4)
    assert rx.overflow_blocks == 0


@pytest.mark.parametrize("deframer", ["batch", "per_lane", "numpy"])
def test_host_half_parts_give_the_references_packets(run, monkeypatch, deframer):
    """The port's back half in its two timed parts, `deframe_wire_records`
    then `emit_wire_frames`, against the reference's `decode_wire_records`
    on the same fetched records of both steps, each side with its own
    dedupers carried across the steps as the receivers carry them:
    through the native batched deframe, lane by lane with the native
    burst deframer, and lane by lane in numpy."""
    from ais_tpu import native as ref_native
    from ais_tpu.pipeline import host as ref_host
    from ais_tpu_torch import native as port_native
    from ais_tpu_torch.pipeline import host as port_host

    rx = tw.WidebandReceiver(run["pcfg"], n_in=run["n_in"], device="cpu")
    fetched = []
    rx.decode_fetched = lambda f: fetched.append(f) or []
    for wire in run["wires"]:
        rx.decode_wire(wire, "cr1")
    assert port_host.native_available() and ref_native.available()
    if deframer != "batch":
        monkeypatch.setattr(port_host, "native_available", lambda: False)
    if deframer == "numpy":
        monkeypatch.setattr(port_native, "available", lambda: False)
        monkeypatch.setattr(ref_native, "available", lambda: False)
    _, n_sym = tw.burst_table_geometry(rx.demod_cfg)
    designators = rx.cfg.designators
    port_dd = [port_host.PacketDeduper() for _ in designators]
    ref_dd = [ref_host.PacketDeduper() for _ in designators]
    n_packets = 0
    for flat_np, chan_start, *_ in fetched:
        rec, _ = tw.unpack_wire_compact(flat_np, rx.n_chan, rx.n_blocks,
                                        rx.demod_cfg.max_bursts_per_block, -(-n_sym // 8))
        lanes, triples = port_host.deframe_wire_records(rec, n_sym, chan_start, rx.core_len,
                                                        rx.cfg.deframer)
        got = port_host.emit_wire_frames(rec, lanes, triples, chan_start, rx.core_len,
                                         designators, port_dd, rx.cfg.sps)
        want = ref_host.decode_wire_records(rec, n_sym, chan_start, rx.core_len, designators,
                                            ref_dd, rx.cfg.deframer, rx.cfg.sps)
        assert [(p.payload, p.abs_sample, p.designator, p.nmea) for p in got] == [
            (p.payload, p.abs_sample, p.designator, p.nmea) for p in want]
        n_packets += len(got)
    assert n_packets >= 4


def _fetches(cfg, run) -> list:
    """What `decode_fetched` is given for each step of the run's stream."""
    rx = tw.WidebandReceiver(cfg, n_in=run["n_in"], device="cpu")
    fetched = []
    rx.decode_fetched = lambda f: fetched.append(f) or []
    for wire in run["wires"]:
        rx.decode_wire(wire, "cr1")
    return fetched


def _full_key(packets):
    return [(p.payload, p.abs_sample, p.designator, p.corr_mag, p.freq_est_hz, p.rssi)
            for p in packets]


@pytest.mark.parametrize("case", ["steps", "directory_overflow", "table_overflow"])
def test_compact_rows_give_the_references_packets(run, monkeypatch, case):
    """`decode_fetched` reading the compact rows in place: the packets of
    the reference's `decode_wire_records` on `unpack_wire_compact`'s
    records (recovery off, image ghosts dropped as the receiver drops
    them), each side with its dedupers carried across the steps; and,
    recovery on, the packets, dropped blocks and `overflow_blocks` of the
    dense path (the native library patched away).  Cases: both steps as
    fetched; a directory of one lane (total_valid > l_max); a block whose
    burst table overflowed (n_det > K, written into the fetch)."""
    from ais_tpu.pipeline import host as ref_host
    from ais_tpu.pipeline import wideband as ref_wideband
    from ais_tpu_torch import native as port_native

    cfg = run["pcfg"]._replace(compact_lanes=1) if case == "directory_overflow" else run["pcfg"]
    fetched = _fetches(cfg, run)
    K = cfg.demod.max_bursts_per_block
    if case == "table_overflow":
        buf = fetched[0][0].copy()
        buf[16 + 4 * 1: 16 + 4 * 2] = np.frombuffer(np.int32(K + 2).tobytes(), np.uint8)
        fetched[0] = (buf, *fetched[0][1:])
    assert port_native.available()
    rx = tw.WidebandReceiver(cfg._replace(overflow_recovery=False), n_in=run["n_in"],
                             device="cpu")
    _, n_sym = tw.burst_table_geometry(rx.demod_cfg)
    n_pack = -(-n_sym // 8)
    ref_dd = [ref_host.PacketDeduper() for _ in cfg.designators]
    n_packets, n_dropped = 0, 0
    for flat_np, chan_start, *_ in fetched:
        got = rx.decode_fetched((flat_np, chan_start, *_))
        rec, dropped = tw.unpack_wire_compact(flat_np, rx.n_chan, rx.n_blocks, K, n_pack)
        rows, rows_dropped = tw.parse_wire_compact(flat_np, rx.n_chan, rx.n_blocks, K, n_pack)
        assert rows_dropped == dropped == ref_wideband.unpack_wire_compact(
            flat_np, rx.n_chan, rx.n_blocks, K, n_pack)[1]
        np.testing.assert_array_equal(rows.n_det, rec.meta_i[:, :, 0, 3])
        want = ref_host.suppress_image_ghosts(ref_host.decode_wire_records(
            rec, n_sym, chan_start, rx.core_len, cfg.designators, ref_dd, cfg.deframer,
            cfg.sps))
        assert _key(got) == _key(want)
        n_packets += len(got)
        n_dropped += len(dropped)
    assert rx.collect_stats["row_steps"] == 2
    assert n_packets >= (2 if case == "directory_overflow" else 3)
    assert (n_dropped > 0) == (case == "directory_overflow")
    assert (rx.overflow_blocks > 0) == (case != "steps")

    in_place = tw.WidebandReceiver(cfg, n_in=run["n_in"], device="cpu")
    dense = tw.WidebandReceiver(cfg, n_in=run["n_in"], device="cpu")
    for f in fetched:
        got = in_place.decode_fetched(f)
        with monkeypatch.context() as m:
            m.setattr(port_native, "available", lambda: False)
            want = dense.decode_fetched(f)
        assert _full_key(got) == _full_key(want) and got
    assert in_place.overflow_blocks == dense.overflow_blocks == rx.overflow_blocks
    assert (in_place.collect_stats["row_steps"], dense.collect_stats["row_steps"]) == (2, 0)
    for key in ("lanes", "frames"):
        assert in_place.collect_stats[key] == dense.collect_stats[key] > 0


@pytest.mark.parametrize("layout", ["compact", "flat", "no_native"])
def test_row_steps_counts_the_steps_read_in_place(run, monkeypatch, layout):
    """`row_steps` equals `steps` when the compact fetch is read in place,
    and stays 0 on the flat layout and without the native library."""
    from ais_tpu_torch import native as port_native

    cfg = run["pcfg"]._replace(compact_lanes=0) if layout == "flat" else run["pcfg"]
    if layout == "no_native":
        monkeypatch.setattr(port_native, "available", lambda: False)
    rx = tw.WidebandReceiver(cfg, n_in=run["n_in"], device="cpu")
    got = [rx.decode_wire(wire, "cr1") for wire in run["wires"]]
    st = rx.collect_stats
    assert st["steps"] == 2 and st["row_steps"] == (2 if layout == "compact" else 0)
    assert _key(got[0]) == _key(run["packets0"])
    rx.reset_collect_stats()
    assert rx.collect_stats["row_steps"] == 0


@pytest.mark.parametrize("case", ["steps", "table_overflow"])
def test_flat_rows_give_the_references_packets(run, monkeypatch, case):
    """The flat layout (compact_lanes=0) through the row deframe
    (`parse_wire_flat`, plane at byte 0): the packets of the reference's
    `decode_wire_records` on `unpack_wire_flat`'s records (recovery off),
    dedupers carried across the steps; and, recovery on, the packets,
    `overflow_blocks`, lanes and frames of the dense path (the native
    library patched away).  Cases: both steps as fetched; a block whose
    burst table overflowed (n_det > K written into each of its lanes)."""
    from ais_tpu.pipeline import host as ref_host
    from ais_tpu.pipeline import wideband as ref_wideband
    from ais_tpu_torch import native as port_native

    cfg = run["pcfg"]._replace(compact_lanes=0)
    fetched = _fetches(cfg, run)
    K = cfg.demod.max_bursts_per_block
    if case == "table_overflow":
        buf = fetched[0][0].copy()
        for lane in range(K, 2 * K):  # channel 0, block 1
            at = 4 * (6 * lane + 3)
            buf[at: at + 4] = np.frombuffer(np.int32(K + 2).tobytes(), np.uint8)
        fetched[0] = (buf, *fetched[0][1:])
    assert port_native.available()
    rx = tw.WidebandReceiver(cfg._replace(overflow_recovery=False), n_in=run["n_in"],
                             device="cpu")
    _, n_sym = tw.burst_table_geometry(rx.demod_cfg)
    n_pack = -(-n_sym // 8)
    ref_dd = [ref_host.PacketDeduper() for _ in cfg.designators]
    n_packets = 0
    for flat_np, chan_start, *_ in fetched:
        got = rx.decode_fetched((flat_np, chan_start, *_))
        rec = ref_wideband.unpack_wire_flat(flat_np, rx.n_chan, rx.n_blocks, K, n_pack)
        want = ref_host.suppress_image_ghosts(ref_host.decode_wire_records(
            rec, n_sym, chan_start, rx.core_len, cfg.designators, ref_dd, cfg.deframer,
            cfg.sps))
        assert _key(got) == _key(want)
        n_packets += len(got)
    assert n_packets >= 3
    assert rx.collect_stats["row_steps"] == 0 and rx.collect_stats["frames"] >= n_packets
    assert (rx.overflow_blocks > 0) == (case == "table_overflow")

    rows = tw.WidebandReceiver(cfg, n_in=run["n_in"], device="cpu")
    dense = tw.WidebandReceiver(cfg, n_in=run["n_in"], device="cpu")
    for f in fetched:
        got = rows.decode_fetched(f)
        with monkeypatch.context() as m:
            m.setattr(port_native, "available", lambda: False)
            want = dense.decode_fetched(f)
        assert _full_key(got) == _full_key(want) and got
    assert rows.overflow_blocks == dense.overflow_blocks == rx.overflow_blocks
    for key in ("lanes", "frames"):
        assert rows.collect_stats[key] == dense.collect_stats[key] > 0


@pytest.mark.parametrize("layout", ["compact", "flat"])
def test_missing_native_library_is_logged_once(run, monkeypatch, caplog, layout):
    """Without the native library the back half falls back to the dense
    records and numpy: one warning, at the first fetch, on either layout;
    none while the library loads."""
    from ais_tpu_torch import native as port_native

    cfg = run["pcfg"]._replace(compact_lanes=0) if layout == "flat" else run["pcfg"]
    fetched = _fetches(cfg, run)
    said = "native library unavailable"
    rx = tw.WidebandReceiver(cfg, n_in=run["n_in"], device="cpu")
    with caplog.at_level("WARNING", logger="ais_tpu_torch"):
        for f in fetched:
            rx.decode_fetched(f)
    assert said not in caplog.text
    monkeypatch.setattr(port_native, "available", lambda: False)
    rx = tw.WidebandReceiver(cfg, n_in=run["n_in"], device="cpu")
    caplog.clear()
    with caplog.at_level("WARNING", logger="ais_tpu_torch"):
        for f in fetched + fetched:
            rx.decode_fetched(f)
    assert caplog.text.count(said) == 1
    assert rx.collect_stats["lanes"] > 0


def test_slice_burst_records(run):
    """Integer fields, the AFC table and bits exactly; centre to 1e-3,
    phase to 2e-3 rad, |corr|^2 to 1e-3 and RSSI to 1e-4 relative (the
    AGC, AFC and correlator sum in other orders than the reference)."""
    rx = tw.WidebandReceiver(run["pcfg"], n_in=run["n_in"], device="cpu")
    got = rx.wire_records(torch.from_numpy(run["wires"][0]), torch.from_numpy(run["phase0s"]),
                          "cr1")
    want = run["rec0"]
    got = [t.numpy() for t in got]
    pos, center, phase, mag, valid, bits, bit_valid, freq_est, n_det, win_start, rssi = got
    np.testing.assert_array_equal(valid, want.valid)
    np.testing.assert_array_equal(n_det, want.n_detected)
    np.testing.assert_array_equal(freq_est, want.freq_est)
    v = valid
    assert v.sum() >= 3
    np.testing.assert_array_equal(pos[v], want.position[v])
    np.testing.assert_array_equal(win_start[v], want.win_start[v])
    np.testing.assert_array_equal(bit_valid[v], want.bit_valid[v])
    np.testing.assert_array_equal(bits[v][:, 2:], want.bits[v][:, 2:])
    np.testing.assert_allclose(center[v], want.center[v], atol=1e-3)
    dphi = np.angle(np.exp(1j * (phase[v] - want.phase[v])))
    assert np.abs(dphi).max() < 2e-3
    np.testing.assert_allclose(mag[v], want.mag[v], rtol=1e-3)
    np.testing.assert_allclose(rssi[v], want.rssi[v], rtol=1e-4)


def _random_records(seed: int, C=2, B=3, K=5, n_sym=918, n_chunks=16):
    rng = np.random.default_rng(seed)
    valid = rng.random((C, B, K)) < 0.5
    first = rng.integers(0, 20, (C, B, K))
    count = rng.integers(0, n_sym - 20, (C, B, K))
    idx = np.arange(n_sym)
    return dict(
        position=rng.integers(1, 16000, (C, B, K)).astype(np.int32),
        center=rng.uniform(-1, 1, (C, B, K)).astype(np.float32),
        phase=rng.uniform(-3, 3, (C, B, K)).astype(np.float32),
        mag=rng.uniform(0, 1e4, (C, B, K)).astype(np.float32),
        valid=valid,
        bits=rng.integers(0, 2, (C, B, K, n_sym)).astype(np.uint8),
        bit_valid=(idx >= first[..., None]) & (idx < (first + count)[..., None]),
        freq_est=rng.uniform(-900, 900, (C, B, n_chunks)).astype(np.float32),
        n_detected=rng.integers(0, 2 * K, (C, B)).astype(np.int32),
        win_start=(rng.integers(0, 24, (C, B, K)) * 512).astype(np.int32),
        rssi=rng.uniform(0, 2, (C, B, K)).astype(np.float32),
    )


@pytest.mark.parametrize("l_max", [0, 7, 12, 30])
def test_pack_wire_bytes_identical(l_max):
    """The packed device-to-host buffer is byte-identical to the
    reference's for the same records (l_max 0: the flat layout)."""
    from ais_tpu.pipeline import receiver as rr
    from ais_tpu.pipeline import wideband as rw

    fields = _random_records(l_max)
    ref_rec = rr.BurstRecords(**{k: jnp.asarray(v) for k, v in fields.items()})
    port_rec = tw.BurstRecords(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in fields.items()})
    n_pack = -(-918 // 8)
    if l_max:
        want = np.asarray(rw.pack_wire_compact(ref_rec, 1024, l_max))
        got = tw.pack_wire_compact(port_rec, 1024, l_max).numpy()
        np.testing.assert_array_equal(got, want)
        (g, gd), (w, wd) = (tw.unpack_wire_compact(got, 2, 3, 5, n_pack),
                            rw.unpack_wire_compact(want, 2, 3, 5, n_pack))
        assert gd == wd
    else:
        want = np.asarray(rw.pack_wire_flat(ref_rec, 1024))
        got = tw.pack_wire_flat(port_rec, 1024).numpy()
        np.testing.assert_array_equal(got, want)
        g, w = tw.unpack_wire_flat(got, 2, 3, 5, n_pack), rw.unpack_wire_flat(want, 2, 3, 5, n_pack)
    for a, b in zip(g, w):
        np.testing.assert_array_equal(a, b)


def test_constants_from_reference():
    """The reference's constant arrays carried over equal the port's own
    build, field by field."""
    from ais_tpu.ops.firdes import low_pass
    from ais_tpu.ops.interp import interp_taps
    from ais_tpu.sync.feedforward import _calibrate
    from ais_tpu.tx.gmsk import preamble_waveform

    cfg = tw.WidebandConfig()
    got = tw.constants_from_reference(
        low_pass(1.0, 2.4e6, 11e3, 2e3), preamble_waveform(5, 0.4), interp_taps(),
        _calibrate(5, 0.4))
    own = tw.default_constants(cfg)
    for a, b in zip(got, own):
        np.testing.assert_array_equal(a, b)
    rx = tw.WidebandReceiver(cfg, device="cpu", constants=got)
    np.testing.assert_array_equal(rx.channelizer_for("cr1").taps.numpy(), own.taps)
    np.testing.assert_array_equal(rx.demod.matched_filter.taps_conj.numpy(), np.conj(own.preamble))
    np.testing.assert_array_equal(rx.demod.interp_bank.numpy(), own.interp_bank)
    assert rx.demod.ff_delta == own.ff_delta
    with pytest.raises(ValueError, match="interp_bank"):
        tw.constants_from_reference(own.taps, own.preamble, own.interp_bank[:5], own.ff_delta)


def test_state_carries_a_stream_across(run):
    """A stream decoded by the reference for one step continues on the
    port: the port resumes from the reference's state dict and finds what
    the reference finds in step 1 (the step-1 packet only: the seam
    packet was owned, and deduplicated, by step 0)."""
    rrx = run["rrx"]
    rx = tw.WidebandReceiver(run["pcfg"], n_in=run["n_in"], device="cpu")
    rx.set_state(run["state0"])
    got = rx.decode_wire(run["wires"][1], "cr1")
    rrx.set_state(run["state0"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AIS_TPU_CHAN", "pallas")
        want = rrx.decode_wire(run["wires"][1], "cr1")
    assert _key(got) == _key(want) and len(got) == 1
    st = rx.get_state()
    assert st["pos"] == 2 * rx.step_raw
    rrx.set_state(st)  # the reference takes the port's dict back
    assert rrx.get_state()["pos"] == st["pos"]
    rx.set_state({**st, "buf": np.ones(4, np.complex64)})  # the complex path's buffer
    np.testing.assert_array_equal(rx.get_state()["buf"], np.ones(4, np.complex64))


def test_last_collect_seconds(run):
    """`last_collect_s` is (0, 0) before any step and (exec + fetch, host)
    seconds of the last `collect` after it, as the reference keeps it;
    `collect_stats` goes on accumulating the same three times."""
    rx = tw.WidebandReceiver(run["pcfg"], n_in=run["n_in"], device="cpu")
    assert rx.last_collect_s == (0.0, 0.0)
    rx.decode_wire(run["wires"][0], "cr1")
    first = rx.last_collect_s
    st = dict(rx.collect_stats)
    assert len(first) == 2 and first[0] >= 0.0 and first[1] > 0.0
    assert first[0] == pytest.approx(st["exec_s"] + st["fetch_s"])
    assert first[1] == pytest.approx(st["host_s"])
    rx.decode_wire(run["wires"][1], "cr1")
    second, st2 = rx.last_collect_s, rx.collect_stats
    assert second != first and st2["steps"] == 2
    assert second[1] == pytest.approx(st2["host_s"] - st["host_s"])
    assert second[0] == pytest.approx(st2["exec_s"] + st2["fetch_s"] - st["exec_s"] - st["fetch_s"])
    assert len(run["rrx"].last_collect_s) == 2       # the reference's, after its steps


def test_overflow_is_never_silent(run, caplog):
    """A lane directory too small for the step's valid lanes: the blocks
    it dropped are re-demodulated from the step's wire bytes, giving the
    reference's packets; with overflow_recovery off it is logged."""
    cfg = run["pcfg"]._replace(compact_lanes=1)
    rx = tw.WidebandReceiver(cfg, n_in=run["n_in"], device="cpu")
    got = rx.decode_wire(run["wires"][0], "cr1")
    assert rx.overflow_blocks >= 1 and rx.recover_s > 0
    assert _key(got) == _key(run["packets0"])
    rx = tw.WidebandReceiver(cfg._replace(overflow_recovery=False), n_in=run["n_in"], device="cpu")
    with caplog.at_level("WARNING", logger="ais_tpu_torch"):
        got = rx.decode_wire(run["wires"][0], "cr1")
    assert rx.overflow_blocks >= 1 and "dropped" in caplog.text
    assert len(got) == 1


def test_wire_contract_checks():
    rx = tw.WidebandReceiver(tw.WidebandConfig(), device="cpu")
    assert rx.n_in % 200 == 0 and rx.wire_overlap_samples == rx.n_in - rx.step_raw
    with pytest.raises(ValueError, match="unsupported wire format"):
        rx.submit_wire(np.zeros(10, np.uint8), "cx3")
    for fmt in tw.WIRE_FORMATS:
        with pytest.raises(ValueError, match="bytes"):
            rx.submit_wire(np.zeros(10, np.uint8), fmt)
    # Every timing formulation of the reference builds, and reaches the
    # demodulator unchanged; an unknown one is refused as the reference
    # refuses it.
    for change in ({"timing_mode": "pll"}, {"ff_path": "fft"}, {"ff_path": "bank"}):
        demod = dataclasses.replace(tw.WidebandConfig().demod, **change)
        built = tw.WidebandReceiver(tw.WidebandConfig(demod=demod), device="cpu")
        assert built.demod.cfg == demod
    for change, match in (({"timing_mode": "bogus"}, "timing_mode"), ({"ff_path": "fir2"}, "ff_path")):
        bad = dataclasses.replace(tw.WidebandConfig().demod, **change)
        with pytest.raises(ValueError, match=match):
            tw.WidebandReceiver(tw.WidebandConfig(demod=bad), device="cpu")
    mlse = dataclasses.replace(tw.WidebandConfig().demod, demod_mode="mlse")
    assert tw.WidebandReceiver(tw.WidebandConfig(demod=mlse), device="cpu").demod.trellis


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke.py, import with jax and
    the JAX package (`ais_tpu`) blocked, and no source file of the port
    imports either (tests/test_torch_standalone.py drives more)."""
    code = (
        "import sys, importlib, pkgutil\n"
        "BLOCKED = ('jax', 'jaxlib', 'ais_tpu')\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError(name + ' is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "import ais_tpu_torch\n"
        "for m in pkgutil.walk_packages(ais_tpu_torch.__path__, 'ais_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "chip_smoke.bench_geometry()\n"
        "import ais_tpu_torch.cli.ais_rx as cli\n"
        "cli.build_parser().parse_args(['-s', 'x.cf32'])\n"
        "assert not [k for k in sys.modules if k.split('.')[0] in BLOCKED]\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for src in (REPO / "ais_tpu_torch").rglob("*.py"):
        for line in src.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"]) and len(words) > 1
                        and words[1].split(".")[0] in ("jax", "jaxlib", "ais_tpu")), (src, line)
