"""The wire ingest's pinned chunk ring (`pipeline/ingest.py`) and its fill.

On the CPU: the native `copy_bytes` bit for bit against its numpy twin
(sizes 0, 1, odd, over a chunk; misaligned ends; 1-8 threads; many
callers at once; a forked child), the chunk
plan over the benchmark's cr1 and cu8 steps, and `stage_wire` on a CPU
device as it was (the device bytes are the wire, no ring).  On the card
(`gpu`, skipped here): three random steps staged back to back, two in
flight, each step's device bytes its source's; the current stream's
later events covering the copies (the fan's use); `decode_wire`'s
packets through the ring equal to the pageable copy's on a cu8 and a
cr1 scene, `pinned_steps` counting every step.  The file imports no JAX,
so that its card tests run where there is none
(`python -m pytest --noconftest -m gpu tests/test_torch_ingest.py`).
"""

import logging
import os
import signal
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ais_tpu_torch import native
from ais_tpu_torch.core.params import DemodConfig
from ais_tpu_torch.ops.convert import host_bytes
from ais_tpu_torch.pipeline import ingest
from ais_tpu_torch.pipeline import wideband as tw
from ais_tpu_torch.tx import aivdm_payload_to_bytes
from ais_tpu_torch.tx.scenario import Scenario, ScenarioPacket

torch.set_num_threads(1)

PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"
# The benchmark's step (384 blocks): n_in 226 026 200 samples.
BENCH_N_IN = 226_026_200


def _receiver(blocks: int, device="cpu") -> tw.WidebandReceiver:
    cfg = tw.WidebandConfig(demod=DemodConfig(max_bursts_per_block=24, ff_path="fir"),
                            compact_lanes=14 * 2 * blocks)
    n48 = cfg.block_len + cfg.core_len * (blocks - 1)
    n_in = tw.aligned_n_in(cfg, (n48 - 1) * cfg.decimation + tw.num_taps(cfg))
    return tw.WidebandReceiver(cfg, n_in=n_in, device=device)


@pytest.mark.skipif(not native.available(), reason="the port's native library did not build")
@pytest.mark.parametrize("threads", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("n", [0, 1, 4097, 2 * ingest.CHUNK_MIN + 13])
def test_copy_bytes_matches_its_numpy_twin(n, threads):
    """`native.copy_bytes` writes exactly `src` into `dst`, at aligned and
    misaligned addresses, and nothing beside it."""
    rng = np.random.default_rng([n, threads])
    for s_off, d_off in [(0, 0), (3, 5), (7, 1)]:
        src = rng.integers(0, 256, n + 16, dtype=np.uint8)[s_off: s_off + n]
        want = np.zeros(n + 16, np.uint8)
        got = want.copy()
        np.copyto(want[d_off: d_off + n], src)
        native.copy_bytes(got[d_off: d_off + n], src, threads)
        assert got.tobytes() == want.tobytes()


def test_copy_bytes_from_many_threads_at_once():
    """More callers than cores, each copying sizes that need the pool's
    workers and sizes that do not, with a short switch interval: every
    copy is its own source's bytes, and every caller ends in time."""
    if not native.available():
        pytest.skip("the port's native library did not build")
    bad = []

    def caller(seed):
        rng = np.random.default_rng(seed)
        for _ in range(20):
            n = int(rng.integers(0, 6 * ingest.CHUNK_MIN))
            src = rng.integers(0, 256, n, dtype=np.uint8)
            dst = np.empty_like(src)
            native.copy_bytes(dst, src, int(rng.integers(1, 9)))
            if dst.tobytes() != src.tobytes():
                bad.append((seed, n))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        workers = [threading.Thread(target=caller, args=(i,)) for i in range(2 * os.cpu_count())]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers) and not bad


def test_copy_bytes_in_a_forked_child():
    """A child forked after the pool's workers started (it has none of
    them) still copies, with a pool of its own, and exits in time."""
    if not native.available():
        pytest.skip("the port's native library did not build")
    src = np.random.default_rng(4).integers(0, 256, 4 * ingest.CHUNK_MIN, dtype=np.uint8)
    dst = np.empty_like(src)
    native.copy_bytes(dst, src, 4)  # the parent's workers exist now
    pid = os.fork()
    if pid == 0:
        try:
            dst[:] = 0
            native.copy_bytes(dst, src, 4)
            os._exit(0 if dst.tobytes() == src.tobytes() else 1)
        finally:
            os._exit(2)
    deadline = time.monotonic() + 60
    while True:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    if not done:
        os.kill(pid, signal.SIGKILL)
        os.waitpid(pid, 0)
    assert done and os.WIFEXITED(status) and os.WEXITSTATUS(status) == 0


def test_fill_without_the_native_library(monkeypatch):
    """`ingest.fill` falls back to numpy and gives the same bytes."""
    src = np.random.default_rng(3).integers(0, 256, 3 * ingest.CHUNK_MIN + 1, dtype=np.uint8)
    got = [np.zeros_like(src), np.zeros_like(src)]
    ingest.fill(got[0], src, 4)
    monkeypatch.setattr(native, "available", lambda: False)
    ingest.fill(got[1], src, 4)
    assert got[0].tobytes() == got[1].tobytes() == src.tobytes()


def test_copy_bytes_refuses_what_it_cannot_copy():
    if not native.available():
        pytest.skip("the port's native library did not build")
    src = np.zeros(16, np.uint8)
    with pytest.raises(ValueError):
        native.copy_bytes(np.zeros(15, np.uint8), src, 2)
    with pytest.raises(ValueError):
        native.copy_bytes(np.zeros(16, np.int16)[::2].view(np.uint8)[:16], src, 2)
    ro = np.zeros(16, np.uint8)
    ro.flags.writeable = False
    with pytest.raises(ValueError):
        native.copy_bytes(ro, src, 2)


@pytest.mark.parametrize("fmt", ["cr1", "cu8", "ci8", "ci1"])
@pytest.mark.parametrize("n_in", [BENCH_N_IN, 822_050, 1000])
def test_chunk_plan_covers_the_step_once(fmt, n_in):
    """The chunks of a step's wire tile [0, n) in order, each at most the
    chunk size; the size lies within its bounds and gives at least four
    chunks to a wire over four minimum chunks."""
    n = tw.wire_nbytes(fmt, n_in)
    chunk = ingest.chunk_bytes(n)
    assert ingest.CHUNK_MIN <= chunk <= ingest.CHUNK_MAX and chunk % 4096 == 0
    plan = ingest.chunk_plan(n, chunk)
    ends = [0] + [off + size for off, size in plan]
    assert [off for off, _ in plan] == ends[:-1] and ends[-1] == n
    assert all(0 < size <= chunk for _, size in plan)
    if n > ingest.SLOTS * ingest.CHUNK_MIN:
        assert len(plan) >= ingest.SLOTS
    if n <= ingest.SLOTS * ingest.CHUNK_MAX:
        assert len(plan) <= ingest.SLOTS


def test_bench_steps_chunk_sizes():
    """The benchmark's cu8 step is fourteen chunks of 32 MiB at most; its
    cr1 step four of 7 065 600 bytes at most."""
    cu8 = tw.wire_nbytes("cu8", BENCH_N_IN)
    cr1 = tw.wire_nbytes("cr1", BENCH_N_IN)
    assert (cu8, cr1) == (452_052_400, 28_253_275)
    assert ingest.chunk_bytes(cu8) == 32 << 20 and len(ingest.chunk_plan(cu8, 32 << 20)) == 14
    assert ingest.chunk_bytes(cr1) == 7_065_600 and len(ingest.chunk_plan(cr1, 7_065_600)) == 4


def test_fill_threads_follow_the_affinity(monkeypatch):
    for cores, want in [(1, 1), (3, 3), (8, 8), (32, 8)]:
        monkeypatch.setattr(os, "sched_getaffinity", lambda _pid, c=cores: set(range(c)))
        assert ingest.fill_threads() == want


@pytest.mark.parametrize("fmt", ["cu8", "cr1"])
def test_stage_on_the_cpu_is_the_wire(fmt):
    """On a CPU device `stage_wire` hands on the wire's bytes and the
    step's phases as before: no ring, `pinned_steps` and `fill_s` 0."""
    rx = _receiver(1)
    wire = np.random.default_rng(8).integers(0, 256, tw.wire_nbytes(fmt, rx.n_in),
                                             dtype=np.uint8)
    raw, ph, at, got_fmt, raw_u8 = rx.stage_wire(wire, fmt, pos=3 * rx.step_raw)
    assert raw.device.type == "cpu" and raw.dtype == torch.uint8
    assert raw.numpy().tobytes() == wire.tobytes()
    assert torch.equal(ph, torch.from_numpy(rx._phase0s(3 * rx.step_raw)))
    assert (at, got_fmt, raw_u8) == (3 * rx.step_raw, fmt, wire)
    assert rx._ring is None
    st = rx.collect_stats
    assert st["pinned_steps"] == 0 and st["fill_s"] == 0.0 and st["stage_s"] > 0


# -- on the card -------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ring's copies run on the card only")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("nbytes", [1_600_001, 113_052_400, 452_052_400])
def test_ring_stages_three_steps_two_in_flight(cuda, nbytes):
    """Three random wires staged back to back, each source overwritten as
    soon as `stage` returns; while the third stages the first two are
    still held.  An event recorded on the current stream after each
    stage finds the ring's copy stream done, and each step's device bytes
    and phase rows are its own."""
    rng = np.random.default_rng(nbytes)
    rows = [rng.uniform(0, 6.28, 2).astype(np.float32) for _ in range(3)]
    ring = ingest.PinnedRing(cuda, ingest.chunk_bytes(nbytes), rows[0])
    held, want = [], []
    for k in range(3):
        src = rng.integers(0, 256, nbytes, dtype=np.uint8)
        want.append(src.copy())
        raw, ph, fill_ns = ring.stage(src, rows[k], k)
        src[:] = 0  # the caller's bytes have been read
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(cuda))
        ev.synchronize()
        assert ring.stream.query() and fill_ns > 0
        held.append((raw, ph))
        if len(held) > 2:
            held.pop(0)
        assert len(held) <= 2
        assert raw.cpu().numpy().tobytes() == want[k].tobytes()
        assert ph.cpu().numpy().tolist() == rows[k].tolist()


def _scene(rx, fmt: str) -> np.ndarray:
    raw = aivdm_payload_to_bytes(PAYLOAD)
    iq = Scenario(sample_rate=2.4e6, n_samples=rx.n_in, noise=0.004, packets=[
        ScenarioPacket(raw, 200_000, -25e3, phase=0.7),
        ScenarioPacket(raw, 420_000, +25e3, amplitude=0.6, extra_freq_hz=140.0),
    ]).build()
    return host_bytes((iq * 0.7).astype(np.complex64), fmt)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["cu8", "cr1"])
def test_ring_packets_equal_the_pageable_copys(cuda, fmt, monkeypatch, caplog):
    """Three steps of a scene through `decode_wire`: through the ring
    (`pinned_steps` 3), then with pinned memory refused (one warning, the
    pageable copy, `pinned_steps` 0): the same packets, step by step."""
    wire = None
    got = {}
    for mode in ("ring", "pageable"):
        if mode == "pageable":
            def refuse(*args, **kwargs):
                raise RuntimeError("pinned memory refused")
            monkeypatch.setattr(tw, "PinnedRing", refuse)
        rx = _receiver(1, device=cuda)
        wire = _scene(rx, fmt) if wire is None else wire
        with caplog.at_level(logging.WARNING, logger="ais_tpu_torch"):
            caplog.clear()
            got[mode] = [[(p.nmea, p.designator, p.abs_sample)
                          for p in rx.decode_wire(wire, fmt)] for _ in range(3)]
        warned = [r for r in caplog.records if "pinned" in r.getMessage()]
        st = rx.collect_stats
        assert st["steps"] == 3
        if mode == "ring":
            assert st["pinned_steps"] == 3 and st["fill_s"] > 0 and not warned
        else:
            assert st["pinned_steps"] == 0 and st["fill_s"] == 0.0 and len(warned) == 1
    assert got["ring"] == got["pageable"]
    assert len(got["ring"][0]) == 2
