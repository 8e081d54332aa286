"""The port's sharded decode (`ais_tpu_torch/parallel/`) on CPU shards.

Counterparts of `tests/test_parallel.py`'s classes, on
`make_time_mesh(8, device="cpu")`: the sharded, halo-exchange and
stream x time demods bit for bit against the port's single-device
`make_burst_demod`, and the sharded wire program's packet set against
the single-device stream.  Then the port against the JAX package on the
same numpy inputs made from a seed: `make_sharded_demod` against
`ais_tpu.parallel.make_sharded_demod` on the 8 virtual JAX devices
(`tests/conftest.py`) — `valid` and `position` equal, `bits` equal from
bit 2 (the reference's symbol-0 rounding, ROADMAP C), the same packets —
and the sharded wire rows against `make_sharded_wire_pipeline`'s: the
same packets.  Both packages run the main path's formulations
(`corr_path="pallas"`, `ff_path="fir"`).  Also: the shard placement
rule, the reference's `ValueError`s, and the demodulator's `cuda`
default, which raises without a card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ais_tpu_torch.core.params import DemodConfig
from ais_tpu_torch.ops.convert import host_bytes
from ais_tpu_torch.ops.fir import mixer_phase
from ais_tpu_torch.parallel import (
    make_halo_exchange_demod,
    make_sharded_demod,
    make_sharded_stream_demod,
    make_sharded_wire_pipeline,
    make_stream_time_mesh,
    make_time_mesh,
)
from ais_tpu_torch.parallel.dryrun import dryrun_multichip
from ais_tpu_torch.pipeline.api import frame_stream
from ais_tpu_torch.pipeline.host import (
    PacketDeduper,
    decode_block_records,
    deframe_records,
)
from ais_tpu_torch.pipeline.receiver import BurstDemod, BurstRecords, make_burst_demod
from ais_tpu_torch.pipeline.wideband import WidebandConfig, WidebandReceiver, num_taps
from ais_tpu_torch.tx import aivdm_payload_to_bytes, make_packet_iq
from ais_tpu_torch.tx.scenario import Scenario, ScenarioPacket

torch.set_num_threads(1)

PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"
SENTENCE = "!AIVDM,1,1,,A,14eG;o@034o8sd<L9i:a;WF>062D,0*7D"
CFG = DemodConfig(corr_path="pallas", ff_path="fir")
BLOCK, CORE = 16384, 11264


def _stream_with_packets(offsets, n, seed=0):
    rng = np.random.default_rng(seed)
    iq = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64) * 0.01
    pkt = make_packet_iq(aivdm_payload_to_bytes(PAYLOAD), samples_per_symbol=5)
    for off in offsets:
        iq[off: off + pkt.size] += pkt
    return iq


def _numpy(rec) -> BurstRecords:
    return BurstRecords(*(np.asarray(t) for t in rec))


def _packets(rec):
    """Host decode of records with a leading block axis, one deduper."""
    return deframe_records(rec, 0, CORE, deduper=PacketDeduper())


def _assert_records_equal(got, want):
    for name, a, b in zip(BurstRecords._fields, got, want):
        assert torch.equal(a, b), name


@pytest.fixture(scope="module")
def mesh8():
    return make_time_mesh(8, device="cpu")


def test_sharded_matches_single_device_and_decodes(mesh8):
    offsets = [5000, 30000, 55000, 80000]
    blocks = frame_stream(_stream_with_packets(offsets, CORE * 8), BLOCK, CORE)
    assert blocks.shape[0] == 8
    sharded = make_sharded_demod(CFG, BLOCK, CORE, mesh8)(blocks)
    single = make_burst_demod(CFG, BLOCK, CORE, device="cpu")(torch.from_numpy(blocks.copy()))
    _assert_records_equal(sharded, single)
    packets = _packets(sharded)
    got = sorted(p.abs_sample for p in packets)
    assert len(got) == len(offsets)
    assert all(abs(g - o) < 100 for g, o in zip(got, offsets))
    assert all(p.nmea == SENTENCE for p in packets)


def test_halo_exchange_matches_duplication(mesh8):
    """Disjoint cores in, each shard's last halo from its neighbour: bit
    for bit the duplication path, the stream head zeroed so that the
    ring's wrap (shard 0's head) equals the duplication path's zero
    tail."""
    offsets = [6000, 30000, 55000, 80000, CORE * 7 - 2000]
    iq = _stream_with_packets(offsets, CORE * 8)
    iq[: BLOCK - CORE] = 0
    dup = make_sharded_demod(CFG, BLOCK, CORE, mesh8)(frame_stream(iq, BLOCK, CORE))
    exch = make_halo_exchange_demod(CFG, BLOCK, CORE, mesh8, n_blocks=8)(iq.reshape(8, CORE))
    _assert_records_equal(exch, dup)
    packets = _packets(exch)
    assert len(packets) == len(offsets)
    assert all(p.nmea == SENTENCE for p in packets)


def test_deframe_records_is_the_block_loop(mesh8):
    """`deframe_records` over a block axis equals `decode_block_records`
    block by block through one deduper, from a stream offset and for the
    first n blocks, on tensors and on host arrays alike."""
    offsets = [5000, 30000, 55000, 80000]
    blocks = frame_stream(_stream_with_packets(offsets, CORE * 8, seed=5), BLOCK, CORE)
    rec = make_sharded_demod(CFG, BLOCK, CORE, mesh8)(blocks)
    host = _numpy(rec)
    for n, start in ((8, 0), (5, 123_456)):
        deduper, want = PacketDeduper(), []
        for b in range(n):
            want += decode_block_records(BurstRecords(*(a[b] for a in host)),
                                         start + b * CORE, designator="B", deduper=deduper)
        for records in (rec, host):
            got = deframe_records(records, start, CORE, "B", PacketDeduper(), n)
            assert got == want
    assert len(want) == 3 and all(p.designator == "B" for p in want)


def test_stream_time_two_streams_times_four_blocks():
    mesh = make_stream_time_mesh(2, 4, device="cpu")
    assert (mesh.shape, mesh.n_shards, mesh.n_physical) == ((2, 4), 8, 1)
    n = CORE * 4
    s0 = _stream_with_packets([5000], n, seed=0)
    s1 = _stream_with_packets([20000, 40000], n, seed=1)
    blocks = np.stack([frame_stream(s0, BLOCK, CORE), frame_stream(s1, BLOCK, CORE)])
    rec = make_sharded_stream_demod(CFG, BLOCK, CORE, mesh)(blocks)
    assert rec.bits.shape[:2] == (2, 4)
    single = make_burst_demod(CFG, BLOCK, CORE, device="cpu")(
        torch.from_numpy(blocks.reshape(8, BLOCK)))
    _assert_records_equal(BurstRecords(*(t.reshape(8, *t.shape[2:]) for t in rec)), single)
    counts = []
    for s in range(2):
        found = _packets(rec._make(t[s] for t in rec))
        assert all(p.nmea == SENTENCE for p in found)
        counts.append(len(found))
    assert counts == [1, 2]


def _wire_scene(fmt, n_shards=4, demod=CFG):
    """A 4-step wire scene (one packet a shard, alternating channels) and
    its per-shard spans, at a wider transition band (fewer taps)."""
    cfg = WidebandConfig(transition_hz=12e3, demod=demod)._replace(compact_lanes=48)
    rx = WidebandReceiver(cfg, n_in=(cfg.block_len - 1) * cfg.decimation + num_taps(cfg),
                          device="cpu")
    n_in, step_raw = rx.n_in, rx.step_raw
    assert step_raw % 8 == 0 and n_in % 8 == 0
    raw = aivdm_payload_to_bytes(PAYLOAD)
    packets = [ScenarioPacket(raw, 40_000 + d * step_raw + 11_000 * d, cfg.offsets_hz[d % 2],
                              phase=0.3 * d) for d in range(n_shards)]
    iq = Scenario(sample_rate=cfg.input_rate, n_samples=step_raw * n_shards + n_in - step_raw,
                  packets=packets, noise=0.004).build()
    wire = host_bytes((iq * 0.7).astype(np.complex64), fmt)
    num, den = {"cr1": (1, 8), "ci8": (2, 1)}[fmt]  # wire bytes a sample
    spans = [np.array(wire[d * step_raw * num // den: (d * step_raw + n_in) * num // den])
             for d in range(n_shards)]
    ph = np.stack([np.stack([mixer_phase(off, cfg.input_rate, d * step_raw)
                             for off in cfg.offsets_hz]) for d in range(n_shards)])
    return cfg, rx, spans, ph


def _key(packets):
    return sorted((p.payload, p.abs_sample, p.designator) for p in packets)


def _decode_rows(rx, rows, spans, fmt):
    step_raw, decim = rx.step_raw, rx.cfg.decimation
    got = []
    for d, row in enumerate(rows):
        got.extend(rx.decode_fetched((np.asarray(row), d * step_raw // decim, spans[d], fmt,
                                      d * step_raw)))
    return got


@pytest.mark.parametrize("fmt", ["cr1", "ci8"])
def test_sharded_wire_program_packet_set(fmt):
    """The wire program sharded over 4 shards, one overlap-save step a
    shard, decodes the single-device stream's packets over the same spans."""
    cfg, rx, spans, ph = _wire_scene(fmt)
    want = []
    for span in spans:
        want.extend(rx.decode_wire(span, fmt))
    assert len(want) >= 4
    mesh = make_time_mesh(4, device="cpu")
    out = make_sharded_wire_pipeline(cfg, rx.n_in, mesh, fmt=fmt)(np.stack(spans), ph)
    assert out.dtype == torch.uint8 and out.shape[0] == 4
    rx2 = WidebandReceiver(cfg, n_in=rx.n_in, device="cpu")
    assert _key(_decode_rows(rx2, out.numpy(), spans, fmt)) == _key(want)


def test_sharded_demod_matches_jax_reference(mesh8):
    from ais_tpu.core.params import DemodConfig as RefDemodConfig
    from ais_tpu.parallel import make_sharded_demod as ref_sharded_demod
    from ais_tpu.parallel import make_time_mesh as ref_time_mesh
    from ais_tpu.pipeline.host import PacketDeduper as RefDeduper
    from ais_tpu.pipeline.host import decode_block_records as ref_decode

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual JAX devices")
    offsets = [5000, 30000, 55000, 80000]
    blocks = frame_stream(_stream_with_packets(offsets, CORE * 8, seed=3), BLOCK, CORE).copy()
    ref_cfg = RefDemodConfig(corr_path="pallas", ff_path="fir")
    mesh = ref_time_mesh(8)
    want = jax.tree.map(np.asarray, ref_sharded_demod(ref_cfg, BLOCK, CORE, mesh)(
        jax.device_put(jnp.asarray(blocks), NamedSharding(mesh, P("time")))))
    got = _numpy(make_sharded_demod(CFG, BLOCK, CORE, mesh8)(blocks))
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_array_equal(got.position, want.position)
    v = got.valid
    assert v.sum() >= len(offsets)
    np.testing.assert_array_equal(got.bits[v][:, 2:], want.bits[v][:, 2:])
    deduper, ref_packets = RefDeduper(), []
    for b in range(8):
        ref_packets.extend(ref_decode(jax.tree.map(lambda a: a[b], want), b * CORE,
                                      deduper=deduper))
    assert len(ref_packets) == len(offsets)
    assert _key(_packets(got)) == _key(ref_packets)


def test_sharded_wire_rows_match_jax_reference():
    """The port's sharded wire rows and the reference's
    `make_sharded_wire_pipeline` rows on the same cr1 spans decode to the
    same packets, each through its own package's `decode_fetched`."""
    from ais_tpu.core.params import DemodConfig as RefDemodConfig
    from ais_tpu.parallel import make_sharded_wire_pipeline as ref_wire_pipeline
    from ais_tpu.parallel import make_time_mesh as ref_time_mesh
    from ais_tpu.pipeline import wideband as rw

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual JAX devices")
    cfg, rx, spans, ph = _wire_scene("cr1")
    got = _decode_rows(rx, make_sharded_wire_pipeline(cfg, rx.n_in, make_time_mesh(
        4, device="cpu"), fmt="cr1")(np.stack(spans), ph).numpy(), spans, "cr1")

    ref_cfg = rw.WidebandConfig(transition_hz=12e3, demod=RefDemodConfig(
        corr_path="pallas", ff_path="fir"))._replace(compact_lanes=48)
    mesh = ref_time_mesh(4)
    car, hf = rw.channelizer_buffers(ref_cfg, rx.n_in)
    shard = NamedSharding(mesh, P("time"))
    rows = np.asarray(ref_wire_pipeline(ref_cfg, rx.n_in, mesh, fmt="cr1")(
        jax.device_put(np.stack(spans), shard), jax.device_put(ph, shard),
        jax.device_put(car), jax.device_put(hf)))
    ref_rx = rw.WidebandReceiver(ref_cfg, n_in=rx.n_in)
    want = _decode_rows(ref_rx, rows, spans, "cr1")
    assert len(want) >= 4
    assert _key(got) == _key(want)


@pytest.mark.parametrize("case", ["demod_blocks", "halo_blocks", "halo_too_long", "wire_fmt",
                                  "wire_bytes", "grid_blocks"])
def test_value_errors(case, mesh8):
    with pytest.raises(ValueError):
        if case == "demod_blocks":
            make_sharded_demod(CFG, BLOCK, CORE, mesh8)(np.zeros((7, BLOCK), np.complex64))
        elif case == "halo_blocks":
            make_halo_exchange_demod(CFG, BLOCK, CORE, mesh8, n_blocks=12)
        elif case == "halo_too_long":
            make_halo_exchange_demod(CFG, BLOCK, 4096, mesh8, n_blocks=8)
        elif case == "wire_fmt":
            make_sharded_wire_pipeline(WidebandConfig(), 1 << 20, mesh8, fmt="ci4")
        elif case == "wire_bytes":
            cfg = WidebandConfig(transition_hz=12e3)
            n_in = (cfg.block_len - 1) * cfg.decimation + num_taps(cfg)
            fn = make_sharded_wire_pipeline(cfg, n_in, make_time_mesh(2, device="cpu"))
            fn(np.zeros((2, n_in // 8 - 1), np.uint8), np.zeros((2, 2), np.float32))
        else:
            make_sharded_stream_demod(CFG, BLOCK, CORE, make_stream_time_mesh(
                2, 4, device="cpu"))(np.zeros((2, 3, BLOCK), np.complex64))


def test_shard_placement(monkeypatch):
    """Shard i on cuda:{i % cards}; "cuda:k" puts every shard on card k;
    the CPU gives logical shards.  (torch.device needs no card.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_time_mesh(5)
    assert [d.index for d in mesh.devices] == [0, 1, 0, 1, 0]
    assert (mesh.n_shards, mesh.n_physical) == (5, 2)
    assert make_time_mesh().n_shards == 2
    assert {d.index for d in make_time_mesh(3, device="cuda:1").devices} == {1}
    grid = make_stream_time_mesh(2)
    assert grid.shape == (2, 1) and [d.index for d in grid.devices] == [0, 1]
    cpu = make_time_mesh(3, device="cpu")
    assert (cpu.n_shards, cpu.n_physical, cpu.physical) == (3, 1, (torch.device("cpu"),))


def test_cuda_default_raises_without_a_card(monkeypatch):
    """Every entry point defaults to the card and raises without one; it
    never lands on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        make_time_mesh(2)
    with pytest.raises(RuntimeError):
        make_burst_demod(CFG, BLOCK, CORE)
    pre = np.ones(140, np.complex64)
    with pytest.raises(RuntimeError):
        BurstDemod(CFG, BLOCK, CORE, preamble=pre, interp_bank=np.zeros((129, 8), np.float32),
                   ff_delta=0.0)
    with pytest.raises(RuntimeError):
        dryrun_multichip(2)


def test_make_burst_demod_takes_constants():
    """Carried-across constants (here the defaults, rebuilt by hand) give
    the same demodulator as the defaults."""
    from ais_tpu_torch.pipeline.receiver import demod_constants

    x = torch.from_numpy(frame_stream(_stream_with_packets([5000], CORE, seed=2), BLOCK, CORE)
                         .copy())
    a = make_burst_demod(CFG, BLOCK, CORE, device="cpu")(x)
    b = make_burst_demod(CFG, BLOCK, CORE, device="cpu", constants=demod_constants(CFG))(x)
    _assert_records_equal(a, b)
    assert int(a.valid.sum()) >= 1


@pytest.mark.parametrize("n", [1, 4])
def test_dryrun_multichip_on_cpu_shards(n):
    out = dryrun_multichip(n, device="cpu")
    assert out["n_shards"] == n and out["n_physical"] == 1
    assert out["time"][0] == n and out["wire"][0] == n
    assert ("stream_time" in out) == (n % 2 == 0)


def test_replicas_shared_on_one_device(mesh8):
    """One demodulator a physical device: eight CPU shards share one."""
    from ais_tpu_torch.parallel.pipeline import _demods

    shards = _demods(CFG, BLOCK, CORE, mesh8)
    assert len(shards.replicas) == 1 and shards.streams == [None] * 8
