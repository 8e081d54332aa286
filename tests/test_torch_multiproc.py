"""The port's multi-process wire fan (pipeline/multiproc.py) on the CPU.

Workers are spawned children on `device="cpu"` (OMP_NUM_THREADS=1 in the
environment they inherit).  Analogues of the reference's five tests
(tests/test_multiproc.py) at its geometry, 2 demod blocks a step: the
fan's packet set equals the single-process stream's, through a shared
queue, late joiners, the parent pump, abandoned windows and the exec
lock's toggle.  Against the JAX reference: its single-process
`WidebandReceiver.decode_wire` over the same steps (its main-path choices
forced as in tests/test_torch_wideband.py: `AIS_TPU_CHAN=pallas`, the
Pallas kernels in interpret mode, `corr_path="pallas"`,
`ff_path="fir"`), for ci8 steps of one capture and for one cr1 wire
replayed at step positions, as chip_smoke.py's `fan` phase replays the
bench wire.  Every start and drain has a bounded timeout; every fan is
closed in `finally`.
"""

import dataclasses
import multiprocessing.context
import time

import numpy as np
import pytest
import torch

from ais_tpu_torch.ops.convert import host_bytes
from ais_tpu_torch.pipeline import wideband as tw
from ais_tpu_torch.pipeline.multiproc import MultiProcessWideband, wire_steps
from ais_tpu_torch.tx import aivdm_payload_to_bytes
from ais_tpu_torch.tx.scenario import Scenario, ScenarioPacket

torch.set_num_threads(1)

PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"
READY_S, DRAIN_S = 120.0, 120.0


@pytest.fixture(autouse=True)
def one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _geometry(cfg, blocks: int = 2) -> int:
    n48 = cfg.block_len + cfg.core_len * (blocks - 1)
    return (n48 - 1) * cfg.decimation + tw.num_taps(cfg)


def _reference_demod():
    """The port's DemodConfig with the reference's main-path formulations."""
    return dataclasses.replace(tw.WidebandConfig().demod, corr_path="pallas", ff_path="fir")


def _capture(cfg, n_samples: int, fmt: str = "ci8"):
    """Packets sprinkled across both channels (tests/test_multiproc.py)."""
    raw = aivdm_payload_to_bytes(PAYLOAD)
    rng = np.random.default_rng(9)
    packets = []
    for ci, off in enumerate(cfg.offsets_hz):
        for k in range(4):
            p = bytearray(raw)
            p[1] = (7 * k + ci) % 256
            start = 40_000 + k * (n_samples - 120_000) // 4 + ci * 31_000
            packets.append(ScenarioPacket(
                payload=bytes(p), start_sample=start, offset_hz=float(off),
                phase=float(rng.uniform(0, 2 * np.pi)),
                extra_freq_hz=float(rng.uniform(-150, 150))))
    iq = Scenario(sample_rate=cfg.input_rate, n_samples=n_samples, packets=packets,
                  noise=0.004).build()
    return host_bytes((iq * 0.7).astype(np.complex64), fmt), packets


def _key(packets):
    return sorted((p.payload, p.abs_sample, p.designator) for p in packets)


def _fan_and_wire(cfg, n_workers: int, n_steps: int, **kw):
    fan = MultiProcessWideband(cfg, n_in=_geometry(cfg), n_workers=n_workers, device="cpu",
                               **kw)
    total = fan.step_raw * n_steps + (fan.n_in - fan.step_raw)
    wire, tx = _capture(cfg, total)
    return fan, wire, tx


def _single_process(cfg, fan, wire) -> list:
    rx = tw.WidebandReceiver(cfg, n_in=fan.n_in, device="cpu")
    want = []
    for _i, step in wire_steps(wire, fan.n_in, fan.step_raw):
        want.extend(rx.decode_wire(step, "ci8"))
    return want


def _reference_steps(n_in: int, steps, fmt: str) -> list:
    """The JAX reference's single-process decode of (pos, wire) steps."""
    from ais_tpu.pipeline.wideband import WidebandConfig, WidebandReceiver

    out = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AIS_TPU_CHAN", "pallas")
        rrx = WidebandReceiver(WidebandConfig()._replace(demod=_reference_demod()), n_in=n_in)
        for pos, wire in steps:
            out.extend(rrx.collect(rrx.submit_wire(wire, fmt, pos=pos)))
    return out


def test_fan_matches_single_process_and_the_reference():
    """2 workers over 5 ci8 steps: the port's single-process stream's
    packets, and the JAX reference's; every step reports a full split,
    and each worker one h2d probe."""
    n_workers, n_steps = 2, 5
    cfg = tw.WidebandConfig()._replace(demod=_reference_demod())
    fan, wire, tx = _fan_and_wire(cfg, n_workers, n_steps)
    want = _single_process(cfg, fan, wire)
    assert len(want) >= len(tx) - 1  # the scene itself decodes
    try:
        fan.start(timeout=READY_S)
        for i, step in wire_steps(wire, fan.n_in, fan.step_raw):
            fan.submit(i, np.array(step))
        got = fan.drain(timeout=DRAIN_S)
    finally:
        fan.close()
    assert _key(got) == _key(want)
    ref = _reference_steps(fan.n_in, [(i * fan.step_raw, s) for i, s in
                                      wire_steps(wire, fan.n_in, fan.step_raw)], "ci8")
    assert _key(got) == _key(ref)

    st = fan.collect_stats
    assert st["steps"] == n_steps
    assert st["wire_bytes"] == n_steps * fan.n_in * 2  # ci8: 2 B/sample
    assert st["exec_s"] > 0 and st["host_s"] > 0
    assert st["launches"] == {}  # the CPU runs the plain versions, no kernel
    assert len(fan.h2d_mbps) == n_workers
    assert not fan.worker_errors
    fan.reset_collect_stats()
    assert fan.collect_stats["steps"] == 0 and fan.collect_stats["launches"] == {}


def test_fan_min_ready_late_joiners():
    """start(min_ready=1) may return before every worker is warm; the
    fan still decodes exactly, absorbing stragglers' late 'ready'
    messages inside collect()."""
    cfg = tw.WidebandConfig()
    fan, wire, _tx = _fan_and_wire(cfg, 3, 6)
    want = _single_process(cfg, fan, wire)
    try:
        ready = fan.start(timeout=READY_S, min_ready=1)
        assert 1 <= ready <= 3
        for i, step in wire_steps(wire, fan.n_in, fan.step_raw):
            fan.submit(i, np.array(step))
        got = fan.drain(timeout=DRAIN_S)
        deadline = time.monotonic() + 60.0
        while fan._ready < 3 and time.monotonic() < deadline:
            fan.wait_ready(timeout=1.0, min_ready=3)
    finally:
        fan.close()
    assert _key(got) == _key(want)
    assert fan.collect_stats["steps"] == 6
    assert not fan.worker_errors
    assert fan._ready == 3 and len(fan.h2d_mbps) == 3


def test_fan_parent_pump_and_wait_ready():
    """launch() does not block and wait_ready() never raises;
    hold_exec()/release_exec() keep the worker's warm-up behind the
    parent's; parent_pump() makes the caller's thread one more worker
    over its own receiver, and the combined set equals the single-process
    decode, with valid-lane compaction on."""
    cfg = tw.WidebandConfig()._replace(compact_lanes=48)
    fan, wire, _tx = _fan_and_wire(cfg, 1, 6)
    want = _single_process(cfg, fan, wire)
    rx = tw.WidebandReceiver(cfg, n_in=fan.n_in, device="cpu")  # the parent's receiver
    try:
        fan.hold_exec()
        fan.launch()
        rx.decode_wire(np.zeros(fan.n_in * 2, dtype=np.uint8), "ci8")
        fan.release_exec()
        assert fan.wait_ready(timeout=0.0, min_ready=1) in (0, 1)  # no raise
        for i, step in wire_steps(wire, fan.n_in, fan.step_raw):
            fan.submit(i, np.array(step))
        pumped = fan.parent_pump(rx, idle_timeout=1.0)
        got = fan.drain(timeout=DRAIN_S)
    finally:
        fan.close()
    assert _key(got) == _key(want)
    assert fan.collect_stats["steps"] == 6
    assert pumped >= 1
    assert fan.abandon_outstanding() == 0


def test_fan_epoch_isolation_after_abandon():
    """A step in flight when its window is abandoned comes back tagged
    with the old epoch; the next window's drain skips it."""
    cfg = tw.WidebandConfig()
    fan, wire, _tx = _fan_and_wire(cfg, 1, 4)
    steps = [np.array(s) for _i, s in wire_steps(wire, fan.n_in, fan.step_raw)]
    try:
        fan.start(timeout=READY_S)
        fan.submit(0, steps[0])
        got1 = fan.drain(timeout=DRAIN_S)
        assert fan.collect_stats["steps"] == 1

        fan.submit(1, steps[1])
        assert fan.abandon_outstanding() == 1

        fan.reset_collect_stats()
        fan.submit(2, steps[2])
        fan.submit(3, steps[3])
        got2 = fan.drain(timeout=DRAIN_S)
    finally:
        fan.close()
    assert fan.collect_stats["steps"] == 2
    lo = 2 * fan.step_raw // cfg.decimation
    assert all(p.abs_sample >= lo - 400 for p in got2), [p.abs_sample for p in got2]
    assert got1


def test_fan_unlock_toggle_matches_single_process():
    """set_serialize_exec(False) mid-run, then back on: the packet set
    still equals the single-process stream's across both transitions."""
    cfg = tw.WidebandConfig()
    n_steps = 6
    fan, wire, _tx = _fan_and_wire(cfg, 2, n_steps)
    want = _single_process(cfg, fan, wire)
    steps = list(wire_steps(wire, fan.n_in, fan.step_raw))
    got = []
    try:
        fan.start(timeout=READY_S)
        for i, step in steps[: n_steps // 2]:
            fan.submit(i, np.array(step))
        got.extend(fan.drain(timeout=DRAIN_S))
        fan.set_serialize_exec(False)
        for i, step in steps[n_steps // 2:]:
            fan.submit(i, np.array(step))
        got.extend(fan.drain(timeout=DRAIN_S))
        fan.set_serialize_exec(True)
        assert fan._lock_flag.value == 1
    finally:
        fan.close()
    assert _key(got) == _key(want)


def test_fan_cr1_replays_one_wire_at_step_positions():
    """One cr1 wire of n_in samples replayed at i * step_raw (pos=), with
    fresh step indices for a second window on the same workers: each
    window's set is the single-process stream's over the same positions
    and the JAX reference's; each step holds the one-step packets shifted
    by i * step_raw / decimation."""
    cfg = tw.WidebandConfig()._replace(demod=_reference_demod())
    n_steps = 4
    fan = MultiProcessWideband(cfg, n_in=_geometry(cfg), n_workers=2, fmt="cr1", device="cpu")
    wire, _tx = _capture(cfg, fan.n_in, "cr1")
    step_chan = fan.step_raw // cfg.decimation
    rx = tw.WidebandReceiver(cfg, n_in=fan.n_in, device="cpu")
    one = rx.collect(rx.submit_wire(wire, "cr1", pos=0))
    assert len(one) >= 6
    rx.reset_dedup()
    want = []
    for i in range(2 * n_steps):
        want.extend(rx.collect(rx.submit_wire(wire, "cr1", pos=i * fan.step_raw)))
    shifted = sorted((p.payload, p.abs_sample + i * step_chan, p.designator)
                     for i in range(2 * n_steps) for p in one)
    assert _key(want) == shifted
    got = []
    try:
        fan.start(timeout=READY_S)
        for base in (0, n_steps):
            for i in range(base, base + n_steps):
                fan.submit(i, wire)
            got.extend(fan.drain(timeout=DRAIN_S))
    finally:
        fan.close()
    assert _key(got) == _key(want)
    ref = _reference_steps(fan.n_in, [(i * fan.step_raw, wire) for i in range(2 * n_steps)],
                           "cr1")
    assert _key(got) == _key(ref)
    assert fan.collect_stats["steps"] == 2 * n_steps


def test_wire_steps_and_geometry_match_the_reference():
    """`wire_steps` yields the reference's views of the same bytes, and
    the fan's n_in, step_raw and block count are the reference's, at the
    bench geometry, the default and the tests' 2 blocks."""
    import chip_smoke
    from ais_tpu.pipeline.multiproc import MultiProcessWideband as RefFan
    from ais_tpu.pipeline.multiproc import wire_steps as ref_wire_steps

    raw = np.random.default_rng(3).integers(0, 256, 2 * 10_000 + 7, dtype=np.uint8)
    for bps in (1, 2, 4):
        got = list(wire_steps(raw, 1_000, 700, bytes_per_sample=bps))
        want = list(ref_wire_steps(raw, 1_000, 700, bytes_per_sample=bps))
        assert [i for i, _ in got] == [i for i, _ in want] and len(got) > 1
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)

    bench_cfg, bench_n_in = chip_smoke.bench_geometry()
    base = tw.WidebandConfig()
    for cfg, n_in in ((bench_cfg, bench_n_in), (base, None), (base, _geometry(base))):
        port = MultiProcessWideband(cfg, n_in=n_in, n_workers=1, fmt="cr1", device="cpu")
        ref = RefFan(cfg, n_in=n_in, n_workers=1, fmt="cr1", platform="cpu")
        assert (port.n_in, port.step_raw, port.n_blocks, port.core_len) == \
            (ref.n_in, ref.step_raw, ref.n_blocks, ref.core_len)
        assert port.n_in == tw.aligned_n_in(cfg, n_in)
    assert port._procs and not port._launched  # constructing starts nothing


def test_cuda_default_raises_without_a_card_before_any_child(monkeypatch):
    def no_spawn(self):
        raise AssertionError("a child process was started")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(multiprocessing.context.SpawnProcess, "start", no_spawn)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiProcessWideband(tw.WidebandConfig(), n_in=_geometry(tw.WidebandConfig()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiProcessWideband(device="cuda:1")


def test_worker_failures_reach_the_parent(monkeypatch):
    """No failure is hidden: a warm-up that raises is named in the ready
    message and fails `start` (run in this process, the worker's code
    with a failing decode), and a step that raises kills its worker and
    fails `drain` (a spawned worker, a wire of the wrong size)."""
    import queue

    from ais_tpu_torch.pipeline import multiproc

    cfg = tw.WidebandConfig()
    n_in = _geometry(cfg)

    def broken(self, raw_u8, fmt="ci8"):
        raise RuntimeError("kernel failed")

    in_q, out_q = queue.Queue(), queue.Queue()
    in_q.put(None)
    with monkeypatch.context() as mp:
        mp.setattr(tw.WidebandReceiver, "decode_wire", broken)
        multiproc._worker_main(cfg, n_in, "ci8", "cpu", None, in_q, out_q)
    kind, _, payload = out_q.get_nowait()
    assert kind == "ready" and "kernel failed" in payload["warmup_error"]
    fan = MultiProcessWideband(cfg, n_in=n_in, n_workers=1, device="cpu")
    fan._launched = True  # the message above stands in for a child's
    fan._out_q.put((kind, None, payload))
    with pytest.raises(RuntimeError, match="kernel failed"):
        fan.start(timeout=READY_S)
    assert fan.worker_errors == [payload["warmup_error"]]

    fan = MultiProcessWideband(cfg, n_in=n_in, n_workers=1, device="cpu")
    try:
        fan.start(timeout=READY_S)
        fan.submit(0, np.zeros(fan.n_in, np.uint8))  # ci8 needs 2 bytes a sample
        with pytest.raises(RuntimeError, match="fan worker failed: ValueError"):
            fan.drain(timeout=DRAIN_S)
    finally:
        fan.close()
