"""The wire path's counters and span log (`collect_stats`, `utils/profiling.SPANS`).

A two-step cr1 stream at a 3-block geometry through the port's
`WidebandReceiver` on the CPU: the per-part counters, the spans of each
step, the garbage collector's spans and the log's off state.  Three
tests need a card: a span and the device work it waits for, under
`torch.profiler`, on one clock; the pinned ring's fill and copy spans
inside their stage; its counters zeroed by `reset_collect_stats`.
"""

import dataclasses
import gc
import time

import numpy as np
import pytest
import torch

from ais_tpu_torch.ops.convert import host_bytes
from ais_tpu_torch.pipeline import ingest
from ais_tpu_torch.pipeline import wideband as tw
from ais_tpu_torch.pipeline.host import deframe_wire_records
from ais_tpu_torch.tx import aivdm_payload_to_bytes
from ais_tpu_torch.tx.scenario import Scenario, ScenarioPacket
from ais_tpu_torch.utils.profiling import SPANS, SpanLog

torch.set_num_threads(1)

N_BLOCKS = 3
PARTS = ("unpack_s", "deframe_s", "emit_s", "recover_s")
HOST = ("rx.host.unpack", "rx.host.deframe", "rx.host.emit")
DISPATCH = ("rx.dispatch.channelize", "rx.dispatch.demod", "rx.dispatch.pack")
PINNED = ("pinned_steps", "fill_s")


@pytest.fixture(scope="module")
def stream():
    """(config, n_in, two consecutive cr1 wires with four packets)."""
    base = tw.WidebandConfig()
    demod = dataclasses.replace(base.demod, max_bursts_per_block=24, ff_path="fir")
    cfg = base._replace(demod=demod, compact_lanes=14 * 2 * N_BLOCKS)
    n48 = base.block_len + base.core_len * (N_BLOCKS - 1)
    rx = tw.WidebandReceiver(cfg, n_in=(n48 - 1) * base.decimation + tw.num_taps(base),
                             device="cpu")
    step, n_in = rx.step_raw, rx.n_in
    raw = aivdm_payload_to_bytes("14eG;o@034o8sd<L9i:a;WF>062D")
    iq = Scenario(sample_rate=2.4e6, n_samples=step + n_in, noise=0.004, packets=[
        ScenarioPacket(raw, 200000, -25e3, phase=0.7),
        ScenarioPacket(raw, 700000, +25e3, amplitude=0.6, extra_freq_hz=140.0),
        ScenarioPacket(raw, step - 40000, +25e3, phase=1.1),
        ScenarioPacket(raw, step + rx.core_len * base.decimation // 2, -25e3, phase=2.0),
    ]).build()
    wire = host_bytes((iq * 0.7).astype(np.complex64), "cr1")
    return cfg, n_in, [wire[: n_in // 8], wire[step // 8: (step + n_in) // 8]]


@pytest.fixture
def spans():
    """The process's log, on with the collector's spans, off and empty after."""
    SPANS.clear()
    SPANS.enable(gc=True)
    try:
        yield SPANS
    finally:
        SPANS.disable()
        SPANS.clear()


def _decode(stream, device="cpu", **changes):
    cfg, n_in, wires = stream
    rx = tw.WidebandReceiver(cfg._replace(**changes), n_in=n_in, device=device)
    got = [rx.decode_wire(w, "cr1") for w in wires]
    return rx, got


def _names(arrays, idx):
    return [str(arrays["names"][arrays["name"][i]]) for i in idx]


def test_log_off_records_nothing_and_the_counters_still_count(stream):
    assert not SPANS.on and SPANS._on_gc not in gc.callbacks
    rx, got = _decode(stream)
    gc.collect()
    assert len(SPANS.arrays()["name"]) == 0 and SPANS._on_gc not in gc.callbacks
    st = rx.collect_stats
    assert st["steps"] == 2 and st["lanes"] > 0 and st["frames"] > 0
    for key in ("exec_s", "fetch_s", "host_s", "dispatch_s", "unpack_s", "deframe_s", "emit_s"):
        assert st[key] > 0, key
    assert SPANS.span("a", 0) is SPANS.span("b", 1)  # the one shared no-op


@pytest.mark.parametrize("compact_lanes", [None, 1])
def test_host_parts_within_the_host_half(stream, compact_lanes):
    """The four parts are each >= 0 and together at most `host_s`;
    recovery takes time only where the lane directory overflows."""
    changes = {} if compact_lanes is None else {"compact_lanes": compact_lanes}
    rx, _ = _decode(stream, **changes)
    st = rx.collect_stats
    assert all(st[p] >= 0 for p in PARTS)
    assert sum(st[p] for p in PARTS) <= st["host_s"]
    assert (st["recover_s"] > 0) == (compact_lanes == 1)
    assert (rx.recover_s > 0) == (rx.overflow_blocks > 0) == (compact_lanes == 1)


def test_lanes_frames_packets(stream):
    rx, got = _decode(stream)
    st = rx.collect_stats
    assert st["lanes"] >= st["frames"] >= sum(len(g) for g in got) == 4


@pytest.mark.parametrize("native", [True, False])
def test_lanes_and_frames_are_counted(stream, monkeypatch, native):
    """`lanes` is the fetch's valid lanes and `frames` the deframer's
    frames before dedup, through the native batched deframe and lane by
    lane (the packets themselves are held against the reference's in
    `test_torch_wideband.py`)."""
    cfg, n_in, wires = stream
    if not native:
        monkeypatch.setattr("ais_tpu_torch.pipeline.host.native_available", lambda: False)
    rx = tw.WidebandReceiver(cfg, n_in=n_in, device="cpu")
    seen = []
    orig = rx.decode_fetched
    rx.decode_fetched = lambda fetched: seen.append(fetched) or orig(fetched)
    got = rx.decode_wire(wires[0], "cr1")
    flat_np, chan_start, *_ = seen[0]
    _, n_sym = tw.burst_table_geometry(rx.demod_cfg)
    rec, _ = tw.unpack_wire_compact(flat_np, rx.n_chan, rx.n_blocks,
                                    rx.demod_cfg.max_bursts_per_block, -(-n_sym // 8))
    _, triples = deframe_wire_records(rec, n_sym, chan_start, rx.core_len)
    assert rx.collect_stats["lanes"] == int(rec.meta_i[..., 2].sum())
    assert rx.collect_stats["frames"] == len(triples) >= len(got) == 3


def test_each_step_has_its_spans_nested(stream, spans):
    rx, _ = _decode(stream)
    a = spans.arrays()
    steps = a["at"] >= 0
    assert set(np.unique(a["at"][steps])) == {0, rx.step_raw}
    for at in (0, rx.step_raw):
        mine = np.nonzero(a["at"] == at)[0]
        names = _names(a, mine)
        assert set(names) >= {"rx.stage", "rx.dispatch", *DISPATCH, "rx.wait", "rx.fetch",
                              "rx.host", *HOST}
        assert names.count("rx.host") == names.count("rx.dispatch") == 1
    starts, ends = a["start_ns"], a["end_ns"]
    assert (ends >= starts).all()
    for i in np.nonzero(a["parent"] >= 0)[0]:
        p = a["parent"][i]
        assert starts[p] <= starts[i] and ends[i] <= ends[p]
        assert a["thread"][p] == a["thread"][i]
        if a["at"][i] >= 0:
            assert a["at"][p] == a["at"][i]
    for i in np.nonzero(np.isin(a["name"], [list(a["names"]).index(n) for n in HOST]))[0]:
        assert _names(a, [a["parent"][i]]) == ["rx.host"]
    for i in np.nonzero(np.isin(a["name"], [list(a["names"]).index(n) for n in DISPATCH]))[0]:
        assert _names(a, [a["parent"][i]]) == ["rx.dispatch"]


def test_spans_and_counters_share_their_readings(stream, spans):
    """A part's counter is the sum of its spans' lengths: one pair of
    readings feeds both."""
    rx, _ = _decode(stream)
    a = spans.arrays()
    length = (a["end_ns"] - a["start_ns"]) * 1e-9
    names = list(a["names"])
    st = rx.collect_stats
    for span, key in [("rx.stage", "stage_s"), ("rx.wait", "exec_s"), ("rx.fetch", "fetch_s"),
                      ("rx.host", "host_s"),
                      ("rx.dispatch", "dispatch_s"), ("rx.host.unpack", "unpack_s"),
                      ("rx.host.deframe", "deframe_s"), ("rx.host.emit", "emit_s")]:
        assert length[a["name"] == names.index(span)].sum() == pytest.approx(st[key], rel=1e-9)


def test_stage_counts_its_seconds_and_wire_bytes(stream):
    """`stage_s` and `wire_bytes` count each staged step: n_in/8 bytes
    rounded up on cr1, 2 n_in on cu8; `reset_collect_stats` zeroes them."""
    cfg, n_in, wires = stream
    rx, _ = _decode(stream)
    st = rx.collect_stats
    assert st["wire_bytes"] == 2 * -(-n_in // 8) == sum(w.size for w in wires)
    assert 0 < st["stage_s"] and st["steps"] == 2
    cu8 = tw.WidebandReceiver(cfg, n_in=n_in, device="cpu")
    wire = np.random.default_rng(2).integers(0, 256, 2 * n_in, dtype=np.uint8)
    t0 = time.perf_counter()
    cu8.collect(cu8.dispatch_wire(cu8.stage_wire(wire, "cu8")))
    elapsed = time.perf_counter() - t0
    st = cu8.collect_stats
    assert st["wire_bytes"] == 2 * n_in and st["steps"] == 1
    assert 0 < st["stage_s"] < elapsed
    cu8.reset_collect_stats()
    assert cu8.collect_stats["stage_s"] == 0.0 and cu8.collect_stats["wire_bytes"] == 0


def _inside_stage(a, name: str) -> list:
    """The `at` of each span `name`, checked to lie inside its step's
    `rx.stage`."""
    idx = np.nonzero(a["name"] == list(a["names"]).index(name))[0]
    for i in idx:
        p = a["parent"][i]
        assert _names(a, [p]) == ["rx.stage"] and a["at"][p] == a["at"][i]
        assert a["start_ns"][p] <= a["start_ns"][i] <= a["end_ns"][i] <= a["end_ns"][p]
    return sorted(a["at"][idx].tolist())


def test_the_copy_lies_inside_its_stage(stream, spans):
    """One `rx.stage.copy` a step, inside that step's `rx.stage`, with its
    `at`; on the CPU no pinned ring, so no `rx.stage.fill`."""
    rx, _ = _decode(stream)
    a = spans.arrays()
    assert _inside_stage(a, "rx.stage.copy") == [0, rx.step_raw]
    assert "rx.stage.fill" not in list(a["names"])


@pytest.mark.gpu
def test_the_fill_and_copy_lie_inside_their_stage_on_card(stream, spans):
    """On the card each chunk of a step has its `rx.stage.fill` and its
    `rx.stage.copy` (the enqueue), inside that step's `rx.stage`; the
    fill spans sum to `fill_s`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned ring runs on the card only")
    rx, _ = _decode(stream, device="cuda")
    a = spans.arrays()
    n_chunks = len(ingest.chunk_plan(stream[2][0].size, ingest.chunk_bytes(stream[2][0].size)))
    want = [0] * n_chunks + [rx.step_raw] * n_chunks
    assert _inside_stage(a, "rx.stage.fill") == want == _inside_stage(a, "rx.stage.copy")
    fills = a["name"] == list(a["names"]).index("rx.stage.fill")
    length = (a["end_ns"][fills] - a["start_ns"][fills]) * 1e-9
    assert length.sum() == pytest.approx(rx.collect_stats["fill_s"], rel=1e-9)
    assert rx.collect_stats["pinned_steps"] == 2


def test_a_collection_is_a_span_and_disable_unhooks_it(spans):
    gc.collect()
    a = spans.arrays()
    full = np.nonzero(a["name"] == list(a["names"]).index("gc2"))[0]
    assert full.size >= 1 and (a["at"][full] == -1).all()
    assert (a["end_ns"][full] > a["start_ns"][full]).all()
    assert spans._on_gc in gc.callbacks
    spans.disable()
    assert spans._on_gc not in gc.callbacks
    n = len(spans.arrays()["name"])
    gc.collect()
    assert len(spans.arrays()["name"]) == n


def test_a_log_of_its_own():
    """begin / end / add nest by thread; a span left open stays open
    (end -1); readings of `time.perf_counter_ns()` are stamped on
    `time.time_ns()` by the offset taken at `enable`; arrays are empty
    before any span."""
    log = SpanLog()
    assert log.begin("x", 0, 1) == -1 and len(log.arrays()["name"]) == 0
    log.enable()
    outer = log.begin("outer", 7, 10)
    log.add("leaf", 7, 11, 12)
    log.begin("left_open", 7, 13)
    log.end(outer, 20)
    log.add("after", 8, 21, 22)
    a = log.arrays()
    assert list(a["names"]) == ["outer", "leaf", "left_open", "after"]
    assert a["parent"].tolist() == [-1, 0, 0, -1]
    off = log.offset_ns  # the readings, on the wall clock
    assert (a["start_ns"] - off).tolist() == [10, 11, 13, 21]
    assert (a["end_ns"] - off).tolist() == [20, 12, -1 - off, 22] and a["at"].tolist() == [7, 7, 7, 8]
    assert abs(off + time.perf_counter_ns() - time.time_ns()) < 50_000_000
    log.clear()
    assert len(log.arrays()["name"]) == 0


def _reset_zeroes_every_key(stream, device):
    rx, _ = _decode(stream, device=device, compact_lanes=1)
    st = rx.collect_stats
    assert set(st) == {"exec_s", "fetch_s", "host_s", "steps", "dispatch_s", *PARTS, "lanes",
                       "frames", "row_steps", "stage_s", "wire_bytes", *PINNED}
    on_card = device == "cuda"
    assert all(v > 0 for k, v in st.items() if on_card or k not in PINNED)
    assert on_card or not any(st[k] for k in PINNED)  # no pinned ring on the CPU
    rx.reset_collect_stats()
    assert set(rx.collect_stats) == set(st) and not any(rx.collect_stats.values())
    assert rx.recover_s > 0 and rx.overflow_blocks >= 1  # lifetime, not reset


def test_reset_zeroes_every_key(stream):
    _reset_zeroes_every_key(stream, "cpu")


@pytest.mark.gpu
def test_reset_zeroes_every_key_on_card(stream):
    """As on the CPU, with the pinned ring's `pinned_steps` and `fill_s`
    counted, then zeroed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned ring runs on the card only")
    _reset_zeroes_every_key(stream, "cuda")


@pytest.mark.gpu
def test_spans_share_the_profilers_clock():
    """A span around >= 20 ms of device work and its synchronize holds
    the kernel's device interval, as `torch.profiler` stamps it, within
    1 ms at either end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    a = torch.randn(12288, 12288, device=dev)
    torch.mm(a, a)
    torch.cuda.synchronize(dev)
    log = SpanLog()
    log.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with log.span("work", 0):
            torch.mm(a, a)
            torch.cuda.synchronize(dev)
    events = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    k0, k1 = max(events, key=lambda e: e[1] - e[0])
    s = log.arrays()
    s0, s1 = int(s["start_ns"][0]), int(s["end_ns"][0])
    assert k1 - k0 >= 20_000_000
    assert s0 - 1_000_000 <= k0 and k1 <= s1 + 1_000_000
