#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ais_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's paths — cr1 wire bytes, complex IQ, and every other
wire format, to AIS packets through `WidebandReceiver.decode_wire` and
`WidebandReceiver.decode` — at the benchmark geometry (96 demod blocks
a call, K = 24, compact_lanes = 2688) on the full-load TDMA scene, then
the `ais_rx` receive path (`AisRadio` in both topologies, MLSE,
overflow recovery, the CLI), in phases, one result line each:

  1. environment: the card (nvidia-smi name and power limit), torch and
     CUDA versions, the TF32 flags, and whether the native host library
     (the deframer) loaded: the run fails if it did not;
  2. build: nvcc builds the kernels of `ais_tpu_torch/csrc/` (sm_90a);
  3. probe: K6 (2x + y on one tile) against its plain version;
  4. K1 (cr1 wire channelizer), K2 (matched filter), K3 (ci1 wire
     channelizer), K4 (ci2, ci4 wire channelizers) and K5 (float
     channelizer), each against its plain PyTorch version at the
     paths' shapes, with the median time of each, its bound (the least
     time the card could take) and a library call's time where one
     PyTorch call computes the same function; K1 also at 1, 3 and 4
     channels, K2 also at rows off its tile and odd tap counts; k5_full: K5 with the full-length carrier table of a 50
     ppm radio at the bench n_in; fir_only: the channelizers' yardstick;
  5. main path (cr1): a warm-up decode whose packets must match the
     transmitted ones (content parity 1.0), then timed steps, then the
     time of each stage;
  6. complex_iq: `decode` of the same scene as complex64 samples
     (parity 1.0), its step time and stages;
  7. wire_formats: one `decode_wire` per format (ci16, ci8, ci4, ci2,
     ci1, cd1) of the same scene: parity 1.0 for ci16, ci8 and ci1,
     cd1's packets equal to ci1's, at least 0.99 for ci4 and ci2;
  8. radio_wideband_ppm: `AisRadio(sample_rate=2.4e6, ppm=50)` (8-block
     steps) runs the scene as a device 50 ppm high records it, in
     1 << 20-sample chunks: every K5 launch on the full-length table;
  9. mlse: the complex path with `demod_mode="mlse"` (threshold 0.4),
     the MLSE stage timed apart; its packets must be the JAX
     reference's on the same scene (`tests/test_torch_reference_packets.json`);
 10. overflow: the cr1 path at 8 blocks with K = 3 (3x overflow), every
     overflowed block recovered;
 11. radio_channels: `AisRadio(sample_rate=250e3)` (one ChannelReceiver
     a channel: K5 with one channel, the host resampler, the baseband
     demod) over a 250 ksps full-load scene of 21 s; its packets must be
     the JAX reference's (`tests/test_torch_reference_packets.json`);
 12. ais_rx: `python -m ais_tpu_torch.cli.ais_rx` on a 250 ksps cf32
     capture must print the golden sentence.

Each path runs with every launch count set to 0 just before it and
reads them just after: each kernel of the path must have launched, and
no block may overflow its burst table or the lane directory (but in the
overflow phase, where every block must and is recovered).  Any
failed check raises, so the script exits non-zero and prints no
result.  The second-to-last line is a JSON object with one entry per
kernel; the last line is {"ok": true, "device": {...}}.  It needs one
CUDA device and exits non-zero without one.

A kernel's row: `ms` is the median device time of one launch through
its wrapper, one event pair a launch (so it includes the wrapper's host
time before the launch), `ms_back_to_back` the time a launch of many in
a row; `plain_ms` the plain PyTorch version; `bound_ms` the larger of
its operations over the card's fp32 rate outside the tensor cores and
its bytes (each input once, each output once) over the memory rate,
`bound_by` which of the two; `library_ms` one PyTorch call for the same
function (`library_call` names it; for the channelizers it is the FIR
alone, less than the kernel's function); `launches_per_step` the
launches a step on the path that uses the kernel.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_BLOCKS = 96
# Published peaks of an H100 SXM: fp32 outside the tensor cores, dense
# fp16 in them, device memory.
PEAK_FP32_FLOPS = 67e12
PEAK_FP16_TENSOR_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
FIR_ONLY = "FIR only: F.conv1d(stride=D) on pre-mixed planes (less than the kernel's function)"
TIMED_STEPS = 5
PATH_STEPS = 3  # timed steps of the complex path and of each wire format
SEED = 7
TOLERANCE = "|err| <= 2e-5*max|y| + 2e-4*|y|"
WIRE_FORMATS = ("ci16", "ci8", "ci4", "ci2", "ci1", "cd1")
RADIO_PPM = 50.0           # LO error of the ppm radio phase
OVERFLOW_BLOCKS, OVERFLOW_K = 8, 3
CHANNELS_RATE, CHANNELS_SECONDS = 250e3, 21.0
BURST_SPAN_2P4M = 64500    # the scene's packet span at 2.4 Msps
REPO = Path(__file__).resolve().parent
# The JAX reference's packets on the mlse and radio_channels scenes,
# where it does not decode the whole content either (ROADMAP C):
# written on the CPU by tests/test_torch_reference_packets.py.
REFERENCE_PACKETS = REPO / "tests" / "test_torch_reference_packets.json"


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def packet_keys(packets) -> list:
    """Packets as sorted [designator, abs_sample, payload hex] entries."""
    return sorted([p.designator, int(p.abs_sample), p.payload.hex()] for p in packets)


def reference_packets(scene: str) -> list:
    return json.loads(REFERENCE_PACKETS.read_text())[scene]


def packet_diff(found, want: list) -> dict:
    """The packets only the port decoded, and those only the reference did."""
    got = {tuple(k) for k in packet_keys(found)}
    ref = {tuple(k) for k in want}
    return {"only_port": sorted(got - ref), "only_reference": sorted(ref - got)}


def bench_geometry():
    """The benchmark's receiver geometry: 96 blocks, K = 24, 14 valid
    lanes per (channel, block) in the compact directory; n_in aligned as
    the receiver aligns it."""
    import dataclasses

    from ais_tpu_torch.pipeline.wideband import WidebandConfig, aligned_n_in, num_taps

    cfg = WidebandConfig()
    cfg = cfg._replace(
        demod=dataclasses.replace(cfg.demod, max_bursts_per_block=24),
        compact_lanes=14 * 2 * N_BLOCKS,
    )
    n48 = cfg.block_len + cfg.core_len * (N_BLOCKS - 1)
    return cfg, aligned_n_in(cfg, (n48 - 1) * cfg.decimation + num_taps(cfg))


def cuda_ms(fn, reps: int) -> float:
    """Median device time of `fn()` in ms, one event pair per run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_ms_back_to_back(fn, launches: int, reps: int = 5) -> float:
    """Median device time of one `fn()` among `launches` in a row between
    one event pair: the queue stays full, so no host time is in it."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def bound(flop: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the fp32 rate and the bytes over the memory rate."""
    t_ops, t_bytes = flop / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return {"flop": flop, "bytes": nbytes, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def channelizer_bound(n_in: int, n_out: int, ntaps: int, n_chan: int, in_bytes: float,
                      table_entries: int, mix_flop_per_sample: int) -> dict:
    """A channelizer's work: 2 real FIRs a channel (4 flop a tap and
    output), the mix (6 flop a complex sample and channel; none for K1,
    whose samples are +-1), and input, carrier table, taps and output
    once each."""
    flop = 4.0 * n_chan * ntaps * n_out + mix_flop_per_sample * n_chan * n_in
    nbytes = in_bytes + 8.0 * n_chan * table_entries + 4.0 * ntaps + 8.0 * n_chan * n_out
    return bound(flop, nbytes)


def phase_environment() -> dict:
    import torch

    import ais_tpu_torch  # noqa: F401  (sets the TF32 flags)
    from ais_tpu_torch.pipeline.host import native_available

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke run needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    env = {
        "card": smi,
        "device_name": torch.cuda.get_device_name(0),
        "device_count": torch.cuda.device_count(),
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "native_available": native_available(),
    }
    log("environment", **env)
    if env["matmul_allow_tf32"] or env["cudnn_allow_tf32"]:
        raise RuntimeError("TF32 is on; the port requires full fp32")
    if not env["native_available"]:
        # A step timed on the numpy deframer would not be the card's path.
        raise RuntimeError("the native host library (deframer) did not build or load (needs g++)")
    return env


def phase_build() -> None:
    from ais_tpu_torch import _build

    lib_t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    ptxas = [ln.strip() for ln in info["log"].splitlines() if "ptxas info" in ln]
    log("build", seconds=round(time.perf_counter() - lib_t0, 3),
        library=info["path"], ptxas=ptxas)


def phase_probe() -> dict:
    import torch

    from ais_tpu_torch import _build
    from ais_tpu_torch.ops.probe import SHAPE, probe, probe_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(SHAPE, device="cuda", generator=gen)
    y = torch.randn(SHAPE, device="cuda", generator=gen)
    _build.reset_launch_counts()
    got = probe(x, y)
    torch.cuda.synchronize()
    launches = _build.PROBE.launches
    max_err = float((got - probe_plain(x, y)).abs().max())
    row = {
        "name": "probe", "route": "cuda", "source": "ais_tpu_torch/csrc/probe.cu",
        "replaces": "tools/tpu_pallas_probe.py:37", "max_abs_err": max_err,
        "ms": cuda_ms(lambda: probe(x, y), 50),
        "ms_back_to_back": cuda_ms_back_to_back(lambda: probe(x, y), 200),
        "plain_ms": cuda_ms(lambda: probe_plain(x, y), 50), "launches": launches,
        **bound(2.0 * x.numel(), 12.0 * x.numel()),
        "library_ms": cuda_ms(lambda: torch.add(y, x, alpha=2), 50),
        "library_call": "torch.add(y, x, alpha=2)",
        # No receive path launches the probe.
        "launches_per_step": 0,
    }
    log("probe", shape=list(SHAPE), tolerance="exact (2x + y in fp32)", **row)
    if max_err != 0.0 or launches != 1:
        raise RuntimeError(f"K6 disagrees with 2x + y: max|err| {max_err}, launches {launches}")
    return row


def channelizer_error(got, ref) -> tuple[float, bool]:
    """max |err| of a channelizer against its plain version, and whether
    every output is finite and within TOLERANCE."""
    import torch

    err = (got - ref).abs()
    limit = 2e-5 * ref.abs().max() + 2e-4 * ref.abs()
    return float(err.max()), bool(torch.isfinite(got).all()) and bool((err <= limit).all())


def hold_channelizer(phase: str, kernel, plain, row: dict, **fields) -> dict:
    """Hold a channelizer kernel against its plain version on the same
    inputs (TOLERANCE), then time both; returns the kernels-line row."""
    import torch

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    max_err, ok = channelizer_error(got, ref)
    del got, ref
    row = {**row, "route": "cuda", "max_abs_err": max_err,
           "ms": cuda_ms(kernel, 20), "ms_back_to_back": cuda_ms_back_to_back(kernel, 20),
           "plain_ms": cuda_ms(plain, 5)}
    log(phase, tolerance=TOLERANCE, within=ok, **fields, **row)
    if not ok:
        raise RuntimeError(f"{row['name']} disagrees with its plain version: max|err| {max_err}")
    return row


def phase0s_at(cfg, at: int):
    """The mixer's start phases at stream position `at`, on the card."""
    import torch

    from ais_tpu_torch.ops.fir import mixer_phase

    ph = np.stack([mixer_phase(o, cfg.input_rate, at) for o in cfg.offsets_hz])
    return torch.from_numpy(ph).to("cuda")


def random_phase0s(cfg, rng):
    return phase0s_at(cfg, int(rng.integers(0, 1 << 40)))


K1_SMALL_N_IN = 400_000
K1_OTHER_OFFSETS = ((-25e3,), (-25e3, 25e3, 0.0), (-25e3, 25e3, 0.0, 50e3))


def phase_k1(cfg, n_in: int) -> dict:
    """K1 at the bench geometry on random wire bytes, through the module's
    folded taps as the main path launches it; then at 1, 3 and 4
    channels (the kernel's other column widths) at a small n_in."""
    import torch

    from ais_tpu_torch.ops.wire_channelizer import (
        WireChannelizer, n_column_tiles, n_super_steps, rotate_carrier, wire_channelizer_cr1,
        wire_channelizer_cr1_plain,
    )
    from ais_tpu_torch.pipeline.wideband import channel_taps

    dev = torch.device("cuda")
    taps = channel_taps(cfg)
    rng = np.random.default_rng(SEED)
    for offsets in K1_OTHER_OFFSETS:
        small = WireChannelizer(taps, cfg.decimation, offsets, cfg.input_rate, K1_SMALL_N_IN,
                                device=dev)
        raw = torch.from_numpy(rng.integers(0, 256, K1_SMALL_N_IN // 8, dtype=np.uint8)).to(dev)
        ph = torch.from_numpy(rng.uniform(0, 2 * math.pi, len(offsets)).astype(np.float32)).to(dev)
        got = small(raw, ph)
        ref = wire_channelizer_cr1_plain(raw, rotate_carrier(small.carrier, ph), small.taps,
                                         small.decim, K1_SMALL_N_IN)
        max_err, ok = channelizer_error(got, ref)
        log("k1_channels", n_chan=len(offsets), n_in=K1_SMALL_N_IN, tolerance=TOLERANCE,
            max_abs_err=max_err, within=ok)
        if not ok:
            raise RuntimeError(f"K1 at {len(offsets)} channels disagrees with its plain version")
    chan = WireChannelizer(taps, cfg.decimation, cfg.offsets_hz, cfg.input_rate,
                           n_in, device=dev)
    raw = torch.from_numpy(rng.integers(0, 256, n_in // 8, dtype=np.uint8)).to(dev)
    car = rotate_carrier(chan.carrier, phase0s_at(cfg, 123_456_789))
    n_chan, q = car.shape[0], car.shape[1]
    # The tensor-core passes the kernel really runs: one m16n8k16 (4096
    # flop) for every 16 outputs, k-step of the padded taps and n-tile.
    mma_flop = 4096.0 * -(-chan.n_out // 16) * n_super_steps(taps.size) * 8 * n_column_tiles(n_chan)
    row = hold_channelizer(
        "k1",
        lambda: wire_channelizer_cr1(raw, car, chan.taps, decim=chan.decim, n_in=n_in,
                                     folded=chan.folded),
        lambda: wire_channelizer_cr1_plain(raw, car, chan.taps, chan.decim, n_in),
        {"name": "wire_channelizer_cr1", "source": "ais_tpu_torch/csrc/wire_channelizer.cu",
         "replaces": "ais_tpu/ops/pallas_fir.py:630",
         **channelizer_bound(n_in, chan.n_out, taps.size, n_chan, n_in / 8, q, 0),
         "tensor_core_flop": mma_flop},
        shape=[n_chan, chan.n_out], n_in=n_in)
    # The bound is the fp32 rate outside the tensor cores (the contract is
    # an fp32 result); the sum itself runs in them, in fp16 passes.
    row["tensor_core_share_of_fp16_peak"] = (
        mma_flop / PEAK_FP16_TENSOR_FLOPS * 1e3 / row["ms_back_to_back"])
    return row


def phase_fir_only(cfg, n_in: int) -> float:
    """The channelizers' yardstick: the strided FIR alone as one
    `F.conv1d(stride=D)` over pre-mixed planes (re and im of every
    channel), at the bench geometry.  No decode and no mix: less than
    any channelizer's function.  Timed here, called nowhere in the port."""
    import torch

    from ais_tpu_torch.pipeline.wideband import channel_taps

    taps = torch.from_numpy(channel_taps(cfg)).to("cuda")
    planes = 2 * len(cfg.offsets_hz)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.randn((1, planes, n_in), device="cuda", generator=gen)
    weight = taps.expand(planes, 1, -1).contiguous()
    ms = cuda_ms(lambda: torch.nn.functional.conv1d(x, weight, stride=cfg.decimation,
                                                    groups=planes), 5)
    log("fir_only", call=FIR_ONLY, planes=planes, n_in=n_in, ntaps=taps.numel(), library_ms=ms)
    del x
    torch.cuda.empty_cache()
    return ms


def phase_k3_k4_k5(cfg, n_in: int) -> list:
    """K3 (ci1), K4 (ci2, ci4) on random wire bytes and K5 on random
    complex64 samples, at the bench n_in, with random start phases."""
    import torch

    from ais_tpu_torch.ops.channelizer import (
        Channelizer, freq_xlating_polyphase, freq_xlating_polyphase_plain, rotate_carrier,
    )
    from ais_tpu_torch.ops.wire_channelizer import (
        PACKED, wire_channelizer_packed, wire_channelizer_packed_plain,
    )
    from ais_tpu_torch.pipeline.wideband import channel_taps

    dev = torch.device("cuda")
    chan = Channelizer(channel_taps(cfg), cfg.decimation, cfg.offsets_hz, cfg.input_rate,
                       n_in, device=dev)
    taps, decim = chan.taps, chan.decim
    rng = np.random.default_rng(SEED + 1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    shape = [len(cfg.offsets_hz), chan.n_out]
    rows = []
    for phase, fmt, replaces in (("k3", "ci1", ":707"), ("k4_ci2", "ci2", ":784"),
                                 ("k4_ci4", "ci4", ":784")):
        raw = torch.randint(0, 256, (n_in // PACKED[fmt].samples_per_byte,), device=dev,
                            dtype=torch.uint8, generator=gen)
        car = rotate_carrier(chan.carrier, random_phase0s(cfg, rng))
        rows.append(hold_channelizer(
            phase,
            lambda: wire_channelizer_packed(fmt, raw, car, taps, decim=decim, n_in=n_in),
            lambda: wire_channelizer_packed_plain(fmt, raw, car, taps, decim),
            {"name": f"wire_channelizer_{fmt}", "source": "ais_tpu_torch/csrc/channelizer.cu",
             "replaces": "ais_tpu/ops/pallas_fir.py" + replaces,
             **channelizer_bound(n_in, chan.n_out, taps.numel(), shape[0], raw.numel(),
                                 car.shape[1], 6)},
            shape=shape, n_in=n_in, fmt=fmt))
        del raw
    x = torch.complex(torch.randn(n_in, device=dev, generator=gen),
                      torch.randn(n_in, device=dev, generator=gen)) * 0.3
    car = rotate_carrier(chan.carrier, random_phase0s(cfg, rng))
    rows.append(hold_channelizer(
        "k5",
        lambda: freq_xlating_polyphase(x, car, taps, decim=decim),
        lambda: freq_xlating_polyphase_plain(x, car, taps, decim),
        {"name": "channelizer", "source": "ais_tpu_torch/csrc/channelizer.cu",
         "replaces": "ais_tpu/ops/pallas_fir.py:171",
         **channelizer_bound(n_in, chan.n_out, taps.numel(), shape[0], 8.0 * n_in,
                             car.shape[1], 6)},
        shape=shape, n_in=n_in, input_mb=x.numel() * 8 / 1e6))
    del x
    torch.cuda.empty_cache()
    return rows


def phase_k2() -> dict:
    import torch

    from ais_tpu_torch import _build
    from ais_tpu_torch.ops.matched_filter import (
        MatchedFilter, matched_filter, matched_filter_plain,
    )
    from ais_tpu_torch.pipeline.wideband import WidebandConfig, default_constants

    dev = torch.device("cuda")
    batch, n = 2 * N_BLOCKS, 16384
    pre = default_constants(WidebandConfig()).preamble
    mf = MatchedFilter(pre, device=dev)
    rng = np.random.default_rng(SEED)
    # AGC scale: noise well below the unit-envelope preambles (the AGC
    # drives a burst's envelope to its reference level).
    x = ((rng.normal(size=(batch, n)) + 1j * rng.normal(size=(batch, n))) * 0.1)
    x = x.astype(np.complex64)
    for b in range(batch):
        for s in rng.integers(0, n - pre.size, 4):
            x[b, s: s + pre.size] += pre
    xt = torch.from_numpy(x).to(dev)

    def kernel():
        return matched_filter(xt, mf.taps_conj)

    def plain():
        return matched_filter_plain(xt, mf.taps_conj)

    (corr, mag2), (rc, _) = kernel(), plain()
    torch.cuda.synchronize()
    max_err = float((corr - rc).abs().max())
    mag2_err = float(((mag2 - (corr.real ** 2 + corr.imag ** 2)).abs()
                      / (mag2.abs() + 1e-30)).max())
    # The plain version's conv1d is cuDNN's in fp32; the same function in
    # float64 says how much of max_err is the kernel's own.
    ref64, _ = matched_filter_plain(xt.to(torch.complex128), mf.taps_conj.to(torch.complex128))
    err64 = float((corr.to(torch.complex128) - ref64).abs().max())
    del ref64
    ok = bool(torch.isfinite(corr).all()) and max_err <= 2e-4 and mag2_err <= 1e-6
    # Rows that end inside a block's tile of 1024 outputs, fill one exactly
    # or are shorter than one, and tap counts that are no multiple of the
    # 8 a thread takes at a time: against the float64 plain version.
    for rows, length, ntap in ((3, 1200, 140), (2, 1163, 140), (3, 700, 140), (3, 1300, 53),
                               (2, 5000, 7)):
        xs = torch.from_numpy((rng.normal(size=(rows, length))
                               + 1j * rng.normal(size=(rows, length))).astype(np.complex64)).to(dev)
        pc = mf.taps_conj[:ntap].contiguous()
        got_c, got_m = matched_filter(xs, pc)
        want_c, _ = matched_filter_plain(xs.to(torch.complex128), pc.to(torch.complex128))
        err = float((got_c.to(torch.complex128) - want_c).abs().max())
        exact = torch.equal(got_m, got_c.real * got_c.real + got_c.imag * got_c.imag)
        log("k2_shapes", shape=[rows, length], taps=ntap, tolerance="atol 2e-4 against float64",
            max_abs_err=err, mag2_exact=exact)
        if got_c.shape != want_c.shape or err > 2e-4 or not exact:
            raise RuntimeError(f"K2 at {(rows, length)}, {ntap} taps disagrees: max|err| {err}")
    t_kernel = cuda_ms(kernel, 50)
    t_plain = cuda_ms(plain, 20)
    # The library call: the one conv1d of the plain version, on planes
    # and weights stacked beforehand.
    tc = mf.taps_conj
    weight = torch.stack([torch.stack([tc.real, -tc.imag]), torch.stack([tc.imag, tc.real])])
    planes = torch.stack([xt.real, xt.imag], dim=1)
    n_out, taps_len = corr.shape[1], tc.numel()
    row = {
        "name": "matched_filter", "route": "cuda",
        "source": "ais_tpu_torch/csrc/matched_filter.cu",
        "replaces": "ais_tpu/ops/pallas_corr.py:145",
        "max_abs_err": max_err, "ms": t_kernel,
        "ms_back_to_back": cuda_ms_back_to_back(kernel, 100), "plain_ms": t_plain,
        # 4 FMAs a tap and output, 3 flop for |corr|^2; x and the taps
        # read, corr and mag2 written.
        **bound((8.0 * taps_len + 3.0) * batch * n_out,
                8.0 * batch * n + 8.0 * taps_len + 12.0 * batch * n_out),
        "library_ms": cuda_ms(lambda: torch.nn.functional.conv1d(planes, weight), 20),
        "library_call": "F.conv1d (TF32 off) on stacked planes; |corr|^2 not included",
    }
    log("k2", shape=list(corr.shape), tolerance="corr atol 2e-4; mag2 = |corr|^2 rtol 1e-6",
        mag2_rel_err=mag2_err, max_abs_err_vs_float64=err64, within=ok,
        launches=_build.MATCHED_FILTER.launches, **row)
    if not ok:
        raise RuntimeError(f"K2 disagrees with its plain version: max|err| {max_err}")
    return row


def path_launches(launches: dict, names) -> dict:
    """The path's kernels' counts; raises if one never launched."""
    got = {k: launches[k] for k in names}
    if min(got.values()) <= 0:
        raise RuntimeError(f"a kernel of the path never launched: {launches}")
    return got


def phase_main_path(cfg, n_in: int, card: str, iq: np.ndarray, tx_packets) -> dict:
    import torch

    from ais_tpu_torch import _build
    from ais_tpu_torch.ops.convert import host_bytes
    from ais_tpu_torch.pipeline.wideband import WidebandReceiver
    from ais_tpu_torch.scene import content_parity

    rx = WidebandReceiver(cfg, n_in=n_in, device="cuda")
    t0 = time.perf_counter()
    wire = host_bytes((iq * 0.7).astype(np.complex64), "cr1")
    encode_s = time.perf_counter() - t0

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    found = rx.decode_wire(wire, "cr1")
    warm_s = time.perf_counter() - t0
    parity = content_parity(found, tx_packets, cfg.decimation)
    rx.reset_collect_stats()
    step_s, n_found = [], []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        n_found.append(len(rx.decode_wire(wire, "cr1")))
        step_s.append(time.perf_counter() - t0)
    launches = _build.launch_counts()
    steps = 1 + TIMED_STEPS
    st = rx.collect_stats
    med = statistics.median(step_s)
    out = {
        "card": card, "n_in": rx.n_in, "step_raw": rx.step_raw, "steps": steps,
        "blocks": rx.n_blocks, "tx_packets": len(tx_packets),
        "decoded_warmup": len(found), "decoded_timed": n_found,
        "content_parity": parity, "overflow_blocks": rx.overflow_blocks,
        "launches": launches, "encode_s": encode_s, "warmup_s": warm_s,
        "step_ms": [s * 1e3 for s in step_s], "step_ms_median": med * 1e3,
        "msamples_per_s": rx.n_in / med / 1e6,
        "exec_ms_per_step": st["exec_s"] / st["steps"] * 1e3,
        "fetch_ms_per_step": st["fetch_s"] / st["steps"] * 1e3,
        "host_ms_per_step": st["host_s"] / st["steps"] * 1e3,
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
    }
    log("main_path", **out)
    if parity != 1.0:
        raise RuntimeError(f"content parity {parity} != 1.0")
    if rx.overflow_blocks:
        raise RuntimeError(f"{rx.overflow_blocks} blocks overflowed")
    on_path = path_launches(launches, ("wire_channelizer_cr1", "matched_filter"))
    if any(n != steps for n in on_path.values()):
        raise RuntimeError(f"K1 and K2 should launch once a step: {on_path} in {steps} steps")
    if min(n_found) != max(n_found) or n_found[0] < len(tx_packets):
        raise RuntimeError(f"timed steps decoded {n_found} packets")
    log("stages", card=card, **stage_breakdown(rx, wire))
    return out


def phase_complex_iq(cfg, n_in: int, card: str, iq: np.ndarray, tx_packets) -> dict:
    """`decode(iq)` of one n_in-sample step of complex64 samples through
    K5: parity, step time (median of PATH_STEPS, the stream state reset
    before each), the step's stages and its host-to-device copy."""
    import torch

    from ais_tpu_torch import _build
    from ais_tpu_torch.pipeline.wideband import WidebandReceiver
    from ais_tpu_torch.scene import content_parity

    rx = WidebandReceiver(cfg, n_in=n_in, device="cuda")
    fresh = rx.get_state()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    found = rx.decode(iq)
    warm_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    parity = content_parity(found, tx_packets, cfg.decimation)
    step_s, n_found = [], []
    for _ in range(PATH_STEPS):
        rx.set_state(fresh)
        t0 = time.perf_counter()
        n_found.append(len(rx.decode(iq)))
        step_s.append(time.perf_counter() - t0)
    med = statistics.median(step_s)
    out = {
        "card": card, "n_in": rx.n_in, "input_mb": iq.nbytes / 1e6,
        "tx_packets": len(tx_packets), "decoded_warmup": len(found),
        "decoded_timed": n_found, "content_parity": parity,
        "overflow_blocks": rx.overflow_blocks, "launches": launches, "warmup_s": warm_s,
        "step_ms": [s * 1e3 for s in step_s], "step_ms_median": med * 1e3,
        "msamples_per_s": rx.n_in / med / 1e6,
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
        **complex_stages(rx, iq),
    }
    log("complex_iq", **out)
    if parity != 1.0:
        raise RuntimeError(f"complex path: content parity {parity} != 1.0")
    if rx.overflow_blocks:
        raise RuntimeError(f"complex path: {rx.overflow_blocks} blocks overflowed")
    if min(n_found) != max(n_found) or n_found[0] != len(found):
        raise RuntimeError(f"complex path: timed steps decoded {n_found} packets")
    out["launches"] = path_launches(launches, ("channelizer", "matched_filter"))
    return out


def complex_stages(rx, iq: np.ndarray, reps: int = PATH_STEPS) -> dict:
    """Median time of each stage of one complex step: the device stages
    between CUDA events, the host half (deframe block by block, dedup) on
    the host clock."""
    import torch

    from ais_tpu_torch.pipeline.receiver import BurstRecords

    names = ("h2d", "channelizer_k5", "demod", "d2h")
    ph = torch.from_numpy(rx._phase0s(0)).to("cuda")
    chan = rx.channelizer_for("iq")
    runs, host = [], []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        x = torch.from_numpy(iq).to("cuda")
        ev[1].record()
        chans = chan(x, ph)
        ev[2].record()
        rec = rx.demod_channels(chans)
        ev[3].record()
        rec_np = BurstRecords(*(t.cpu().numpy() for t in rec))
        ev[4].record()
        ev[4].synchronize()
        runs.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))])
        del x, chans, rec
        rx.reset_dedup()
        t0 = time.perf_counter()
        rx._host_decode(rec_np, 0, iq)
        host.append((time.perf_counter() - t0) * 1e3)
    out = {f"{n}_ms": statistics.median(col) for n, col in zip(names, zip(*runs))}
    out["host_half_ms"] = statistics.median(host)
    return out


def phase_wire_formats(cfg, n_in: int, card: str, iq: np.ndarray, tx_packets) -> dict:
    """One `decode_wire` per format of the scene encoded with the port's
    `host_bytes` (iq * 0.7, as the cr1 path); returns each format's
    launch counts."""
    import torch

    from ais_tpu_torch import _build
    from ais_tpu_torch.ops.convert import host_bytes
    from ais_tpu_torch.pipeline.wideband import WidebandReceiver
    from ais_tpu_torch.scene import content_parity

    kernel_of = {"ci16": "channelizer", "ci8": "channelizer", "ci4": "wire_channelizer_ci4",
                 "ci2": "wire_channelizer_ci2", "ci1": "wire_channelizer_ci1",
                 "cd1": "wire_channelizer_ci1"}
    scaled = (iq * 0.7).astype(np.complex64)
    rx = WidebandReceiver(cfg, n_in=n_in, device="cuda")
    fresh = rx.get_state()
    launches, keys = {}, {}
    for fmt in WIRE_FORMATS:
        t0 = time.perf_counter()
        wire = host_bytes(scaled, fmt)
        encode_s = time.perf_counter() - t0
        rx.set_state(fresh)
        _build.reset_launch_counts()
        found = rx.decode_wire(wire, fmt)
        counts = _build.launch_counts()
        parity = content_parity(found, tx_packets, cfg.decimation)
        keys[fmt] = [(p.payload, p.designator, p.abs_sample) for p in found]
        step_s = []
        for _ in range(PATH_STEPS):
            rx.set_state(fresh)
            t0 = time.perf_counter()
            rx.decode_wire(wire, fmt)
            step_s.append(time.perf_counter() - t0)
        med = statistics.median(step_s)
        out = {"card": card, "fmt": fmt, "wire_mb": wire.nbytes / 1e6, "encode_s": encode_s,
               "tx_packets": len(tx_packets), "decoded": len(found), "content_parity": parity,
               "overflow_blocks": rx.overflow_blocks, "launches": counts,
               "step_ms": [s * 1e3 for s in step_s], "step_ms_median": med * 1e3,
               "msamples_per_s": rx.n_in / med / 1e6}
        if parity < 1.0 and fmt in ("ci4", "ci2"):
            out["kernel_vs_plain_on_these_bytes"] = packed_error(rx, wire, fmt)
        log(f"wire_{fmt}", **out)
        need = 0.99 if fmt in ("ci4", "ci2") else 1.0
        if fmt != "cd1" and parity < need:
            raise RuntimeError(f"{fmt}: content parity {parity} < {need}")
        if fmt == "cd1" and keys["cd1"] != keys["ci1"]:
            raise RuntimeError("cd1 decoded other packets than ci1")
        if rx.overflow_blocks:
            raise RuntimeError(f"{fmt}: {rx.overflow_blocks} blocks overflowed")
        launches[fmt] = path_launches(counts, (kernel_of[fmt], "matched_filter"))
        del wire
    torch.cuda.empty_cache()
    return launches


def packed_error(rx, wire: np.ndarray, fmt: str) -> dict:
    """K4 against its plain version on one format's wire bytes."""
    import torch

    from ais_tpu_torch.ops.channelizer import rotate_carrier
    from ais_tpu_torch.ops.wire_channelizer import (
        wire_channelizer_packed, wire_channelizer_packed_plain,
    )

    chan = rx.channelizer_for(fmt)
    raw = torch.from_numpy(wire).to("cuda")
    car = rotate_carrier(chan.carrier, torch.from_numpy(rx._phase0s(0)).to("cuda"))
    got = wire_channelizer_packed(fmt, raw, car, chan.taps, decim=chan.decim, n_in=chan.n_in)
    ref = wire_channelizer_packed_plain(fmt, raw, car, chan.taps, chan.decim)
    err = (got - ref).abs()
    within = bool((err <= 2e-5 * ref.abs().max() + 2e-4 * ref.abs()).all())
    return {"max_abs_err": float(err.max()), "scale": float(ref.abs().max()),
            "tolerance": TOLERANCE, "within": within}


def stage_breakdown(rx, wire: np.ndarray, reps: int = 5) -> dict:
    """Median time of each stage of one step: device stages between CUDA
    events, the host back half (unpack, deframe, dedup) on the host clock."""
    import torch

    names = ("h2d", "channelizer_k1", "demod", "pack", "d2h")
    runs, host = [], []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        ev[0].record()
        raw, ph, at, _, _ = rx.stage_wire(wire, "cr1")
        ev[1].record()
        chans = rx.wire_channels(raw, ph, "cr1")
        ev[2].record()
        rec = rx.demod_channels(chans)
        ev[3].record()
        flat = rx.pack_records(rec)
        ev[4].record()
        flat_np = flat.cpu().numpy()
        ev[5].record()
        ev[5].synchronize()
        runs.append([ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))])
        t0 = time.perf_counter()
        rx.decode_fetched((flat_np, at // rx.cfg.decimation, wire, "cr1", at))
        host.append((time.perf_counter() - t0) * 1e3)
    out = {f"{n}_ms": statistics.median(col) for n, col in zip(names, zip(*runs))}
    out["host_back_half_ms"] = statistics.median(host)
    return out


class ArraySource:
    """An in-memory capture as an `ais_tpu_torch.io.sources.SampleSource`."""

    def __init__(self, iq: np.ndarray, sample_rate: float):
        self.iq = iq
        self.sample_rate = sample_rate

    def chunks(self, chunk_len: int):
        for i in range(0, self.iq.size, chunk_len):
            yield self.iq[i: i + chunk_len]


def phase_k5_full(cfg, n_in: int, row: dict) -> None:
    """K5 with the full-length table (the 50 ppm radio's offsets, period
    24 000, at the bench n_in) against its plain version; the times go
    into K5's kernels-line row as full_table_*."""
    import torch

    from ais_tpu_torch.ops.channelizer import (
        Channelizer, freq_xlating_polyphase, freq_xlating_polyphase_plain, rotate_carrier,
    )
    from ais_tpu_torch.pipeline.radio import ppm_offset_hz
    from ais_tpu_torch.pipeline.wideband import channel_taps

    dev = torch.device("cuda")
    shifted = cfg._replace(offsets_hz=tuple(o + ppm_offset_hz(RADIO_PPM) for o in cfg.offsets_hz))
    chan = Channelizer(channel_taps(cfg), cfg.decimation, shifted.offsets_hz, cfg.input_rate,
                       n_in, device=dev)
    if not chan.full_table:
        raise RuntimeError("the 50 ppm offsets should take the full-length table")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.complex(torch.randn(n_in, device=dev, generator=gen),
                      torch.randn(n_in, device=dev, generator=gen)) * 0.3
    ph = random_phase0s(shifted, np.random.default_rng(SEED + 2))
    car = rotate_carrier(chan.carrier, ph)
    full = hold_channelizer(
        "k5_full",
        lambda: freq_xlating_polyphase(x, car, chan.taps, decim=chan.decim),
        lambda: freq_xlating_polyphase_plain(x, car, chan.taps, chan.decim),
        {"name": "channelizer", "source": "ais_tpu_torch/csrc/channelizer.cu",
         "replaces": "ais_tpu/ops/pallas_fir.py:171",
         **channelizer_bound(n_in, chan.n_out, chan.taps.numel(), car.shape[0], 8.0 * n_in,
                             car.shape[1], 6)},
        shape=[len(cfg.offsets_hz), chan.n_out], n_in=n_in, offsets_hz=list(shifted.offsets_hz),
        table_mb=chan.carrier.numel() * 4 / 1e6,
        rotate_ms=cuda_ms(lambda: rotate_carrier(chan.carrier, ph), 5))
    row.update(full_table_ms=full["ms"], full_table_ms_back_to_back=full["ms_back_to_back"],
               full_table_plain_ms=full["plain_ms"],
               full_table_max_abs_err=full["max_abs_err"],
               full_table_bound_ms=full["bound_ms"], full_table_bound_by=full["bound_by"])
    del x, car, chan
    torch.cuda.empty_cache()


def shift_capture(iq: np.ndarray, shift_hz: float, rate: float) -> np.ndarray:
    """The capture as a device whose LO is off by -shift_hz records it:
    every carrier moved by +shift_hz (float64 phase, on the card)."""
    import torch

    x = torch.from_numpy(iq).to("cuda")
    n = torch.arange(x.numel(), dtype=torch.float64, device="cuda")
    ph = torch.remainder((2.0 * math.pi * shift_hz / rate) * n, 2.0 * math.pi).to(torch.float32)
    out = (x * torch.polar(torch.ones_like(ph), ph)).cpu().numpy()
    del x, n, ph
    return out


def run_radio(radio, iq: np.ndarray, rate: float) -> tuple[list, float]:
    """Packets of `AisRadio.run` over an in-memory capture in 1 << 20-sample
    chunks, and the wall seconds (the card idle at the end)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    found = list(radio.run(ArraySource(iq, rate), chunk_len=1 << 20))
    torch.cuda.synchronize()
    return found, time.perf_counter() - t0


def phase_radio_wideband_ppm(card: str, iq: np.ndarray, tx_packets) -> dict:
    """`AisRadio(2.4 Msps, ppm=50)` at its defaults (block 16384, 8 fused
    blocks) over the bench scene as a device 50 ppm high records it (the
    channels at -16.9 and +33.1 kHz: period 24 000, so K5's full-length
    table)."""
    import dataclasses

    import torch

    from ais_tpu_torch import _build
    from ais_tpu_torch.pipeline.radio import AisRadio, ppm_offset_hz
    from ais_tpu_torch.scene import content_parity

    shift = ppm_offset_hz(RADIO_PPM)
    t0 = time.perf_counter()
    shifted = shift_capture(iq, shift, 2.4e6)
    shift_s = time.perf_counter() - t0
    tx = [dataclasses.replace(p, offset_hz=p.offset_hz + shift) for p in tx_packets]
    radio = AisRadio(sample_rate=2.4e6, ppm=RADIO_PPM, device="cuda")
    rx = radio.wideband
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    found, wall = run_radio(radio, shifted, 2.4e6)
    launches = _build.launch_counts()
    # The radio's one K5 module: every channelizer launch of this run
    # went through its table, so all of them were full-length when it is.
    chan = rx.channelizer_for("iq")
    full = chan.full_table and chan.carrier.shape[1] == rx.n_in
    parity = content_parity(found, tx, rx.cfg.decimation)
    steps = launches["channelizer"]
    out = {"card": card, "offsets_hz": list(rx.cfg.offsets_hz), "n_in": rx.n_in,
           "step_raw": rx.step_raw, "blocks": rx.n_blocks,
           "table_mb": chan.carrier.numel() * 4 / 1e6,
           "input_samples": int(shifted.size), "shift_s": shift_s,
           "tx_packets": len(tx), "decoded": len(found), "content_parity": parity,
           "overflow_blocks": rx.overflow_blocks, "launches": launches,
           "full_length_table": full, "steps": steps, "wall_s": wall,
           "ms_per_step": wall / max(steps, 1) * 1e3, "msamples_per_s": shifted.size / wall / 1e6,
           "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20}
    log("radio_wideband_ppm", **out)
    if parity != 1.0:
        raise RuntimeError(f"ppm radio: content parity {parity} != 1.0")
    if rx.overflow_blocks:
        raise RuntimeError(f"ppm radio: {rx.overflow_blocks} blocks overflowed")
    if not full or steps < 1:
        raise RuntimeError(f"ppm radio: {steps} K5 launches, full-length table: {full}")
    return path_launches(launches, ("channelizer", "matched_filter"))


def phase_mlse(cfg, n_in: int, card: str, iq: np.ndarray, tx_packets) -> dict:
    """The complex path at the bench geometry with the coherent MLSE
    decision (threshold 0.4); the decision stage timed apart, against
    the discriminator's on the same bursts.  The packets must be the JAX
    reference's on this scene, packet for packet (at full load MLSE
    decodes ~80 % of it in both packages, ROADMAP C)."""
    import dataclasses

    import torch

    from ais_tpu_torch import _build
    from ais_tpu_torch.pipeline.receiver import BurstDemod
    from ais_tpu_torch.pipeline.wideband import WidebandReceiver
    from ais_tpu_torch.scene import content_parity

    mcfg = cfg._replace(demod=dataclasses.replace(cfg.demod, demod_mode="mlse",
                                                  corr_threshold=0.4))
    rx = WidebandReceiver(mcfg, n_in=n_in, device="cuda")
    fresh = rx.get_state()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    found = rx.decode(iq)
    warm_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    parity = content_parity(found, tx_packets, cfg.decimation)
    rx.set_state(fresh)
    t0 = time.perf_counter()
    n_again = len(rx.decode(iq))
    step_s = time.perf_counter() - t0

    # Stage times on one step: front (AGC ... derotated bursts), then the
    # MLSE decision and the discriminator's on the same bursts.
    x = torch.from_numpy(iq).to("cuda")
    chans = rx.channelizer_for("iq")(x, torch.from_numpy(rx._phase0s(0)).to("cuda"))
    blocks = chans.unfold(-1, cfg.block_len, rx.core_len)[:, : rx.n_blocks].reshape(
        rx.n_chan * rx.n_blocks, cfg.block_len)
    del x
    c = rx.constants
    disc = BurstDemod(dataclasses.replace(rx.demod_cfg, demod_mode="discriminator"),
                      cfg.block_len, rx.core_len, preamble=c.preamble,
                      interp_bank=c.interp_bank, ff_delta=c.ff_delta, device="cuda")
    runs = []
    for _ in range(PATH_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        front = rx.demod.front(blocks)
        ev[1].record()
        rx.demod.decide(front.bursts, front.offsets)
        ev[2].record()
        disc.decide(front.bursts, front.offsets)
        ev[3].record()
        ev[3].synchronize()
        runs.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
        del front
    front_ms, mlse_ms, disc_ms = (statistics.median(c) for c in zip(*runs))
    del blocks, chans
    torch.cuda.empty_cache()

    want = reference_packets("mlse_bench")
    diff = packet_diff(found, want)
    out = {"card": card, "n_in": rx.n_in, "bursts_per_call": rx.n_chan * rx.n_blocks *
           mcfg.demod.max_bursts_per_block, "tx_packets": len(tx_packets),
           "decoded": len(found), "content_parity": parity,
           "reference_decoded": len(want), **diff,
           "overflow_blocks": rx.overflow_blocks, "recover_s": rx.recover_s,
           "launches": launches, "warmup_ms": warm_s * 1e3, "step_ms": step_s * 1e3,
           "decoded_again": n_again, "front_ms": front_ms, "mlse_decide_ms": mlse_ms,
           "discriminator_decide_ms": disc_ms,
           "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20}
    log("mlse", **out)
    if diff["only_port"] or diff["only_reference"] or n_again != len(found):
        raise RuntimeError(f"mlse: the packets differ from the reference's: {diff}")
    return path_launches(launches, ("channelizer", "matched_filter"))


def phase_overflow(cfg, card: str, iq: np.ndarray, tx_packets) -> dict:
    """The cr1 wire path at 8 blocks with a burst table of 3, a third of
    the scene's ~9 bursts a block and channel: every block overflows and
    is re-demodulated on the host side with a larger table."""
    import dataclasses

    from ais_tpu_torch import _build
    from ais_tpu_torch.ops.convert import host_bytes
    from ais_tpu_torch.pipeline.wideband import WidebandReceiver, aligned_n_in, num_taps
    from ais_tpu_torch.scene import content_parity

    ocfg = cfg._replace(demod=dataclasses.replace(cfg.demod, max_bursts_per_block=OVERFLOW_K),
                        compact_lanes=14 * 2 * OVERFLOW_BLOCKS)
    n48 = ocfg.block_len + ocfg.core_len * (OVERFLOW_BLOCKS - 1)
    rx = WidebandReceiver(ocfg, n_in=aligned_n_in(ocfg, (n48 - 1) * ocfg.decimation
                                                  + num_taps(ocfg)), device="cuda")
    tx = [p for p in tx_packets if p.start_sample + BURST_SPAN_2P4M < rx.step_raw]
    wire = host_bytes((iq[: rx.n_in] * 0.7).astype(np.complex64), "cr1")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    found = rx.decode_wire(wire, "cr1")
    step_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    parity = content_parity(found, tx, ocfg.decimation)
    out = {"card": card, "n_in": rx.n_in, "blocks": rx.n_blocks, "K": OVERFLOW_K,
           "tx_packets": len(tx), "decoded": len(found), "content_parity": parity,
           "overflow_blocks": rx.overflow_blocks, "recover_ms": rx.recover_s * 1e3,
           "recover_tables": sorted(rx._recover_demods), "step_ms": step_s * 1e3,
           "launches": launches}
    log("overflow", **out)
    if parity != 1.0 or rx.overflow_blocks < 1:
        raise RuntimeError(f"overflow: parity {parity}, {rx.overflow_blocks} overflowed blocks")
    return path_launches(launches, ("wire_channelizer_cr1", "matched_filter"))


def phase_radio_channels(card: str) -> dict:
    """`AisRadio(sample_rate=250e3)`: one ChannelReceiver a channel (K5
    with one channel, the host resampler to 48 ksps, the baseband demod)
    over a 250 ksps full-load scene, in 1 << 20-sample chunks."""
    from ais_tpu_torch import _build
    from ais_tpu_torch.pipeline.radio import AisRadio
    from ais_tpu_torch.pipeline.wideband import WidebandConfig
    from ais_tpu_torch.scene import content_parity, full_load_scene

    rate = CHANNELS_RATE
    n = int(rate * CHANNELS_SECONDS)
    t0 = time.perf_counter()
    iq, tx = full_load_scene(WidebandConfig(input_rate=rate), n, n - int(rate * 0.1),
                             seed=SEED, lead=int(rate * 0.05))
    scene_s = time.perf_counter() - t0
    radio = AisRadio(sample_rate=rate, device="cuda")
    _build.reset_launch_counts()
    found, wall = run_radio(radio, iq, rate)
    launches = _build.launch_counts()
    parity = content_parity(found, tx, rate / 48e3)
    want = reference_packets("radio_channels")
    diff = packet_diff(found, want)
    out = {"card": card, "rate": rate, "air_s": n / rate, "scene_s": scene_s,
           "resample_rate": radio.rx_paths[0].resample_rate, "tx_packets": len(tx),
           "decoded": len(found), "content_parity": parity,
           "reference_decoded": len(want), **diff,
           "launches": launches, "wall_s": wall, "realtime_x": n / rate / wall,
           "msamples_per_s": n / wall / 1e6}
    log("radio_channels", **out)
    if diff["only_port"] or diff["only_reference"]:
        raise RuntimeError(f"250 ksps radio: the packets differ from the reference's: {diff}")
    return path_launches(launches, ("channelizer", "matched_filter"))


def phase_ais_rx(card: str) -> dict:
    """The CLI on a 250 ksps cf32 capture: in this process (launch
    counts), then as `python -m ais_tpu_torch.cli.ais_rx` in a child."""
    from ais_tpu_torch import _build
    from ais_tpu_torch.cli import ais_rx
    from ais_tpu_torch.scene import GOLDEN_SENTENCE, golden_capture

    path = REPO / "build" / "chip_smoke" / "golden_250k.cf32"
    path.parent.mkdir(parents=True, exist_ok=True)
    golden_capture(250e3).tofile(path)
    argv = ["-s", str(path), "-r", "250000"]
    _build.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ais_rx.main(argv)
    launches = _build.launch_counts()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ais_tpu_torch.cli.ais_rx", *argv],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    out = {"card": card, "in_process": buf.getvalue().splitlines(),
           "stdout": proc.stdout.splitlines(), "rc": proc.returncode,
           "subprocess_s": time.perf_counter() - t0, "launches": launches}
    log("ais_rx", **out)
    if proc.returncode != 0 or out["stdout"] != [GOLDEN_SENTENCE] \
            or out["in_process"] != [GOLDEN_SENTENCE]:
        raise RuntimeError(f"ais_rx printed {out['stdout']} (rc {proc.returncode}): "
                           f"{proc.stderr[-2000:]}")
    return path_launches(launches, ("channelizer", "matched_filter"))


def phase_scene(cfg, n_in: int):
    """The full-load scene of one step, synthesized once for every path."""
    from ais_tpu_torch.pipeline.wideband import wideband_geometry
    from ais_tpu_torch.scene import full_load_scene

    _, n_blocks, core_len = wideband_geometry(cfg, n_in)
    t0 = time.perf_counter()
    iq, tx_packets = full_load_scene(cfg, n_in, n_blocks * core_len * cfg.decimation,
                                     seed=SEED)
    iq = iq.astype(np.complex64)
    log("scene", n_in=n_in, tx_packets=len(tx_packets), seconds=time.perf_counter() - t0)
    return iq, tx_packets


def main() -> int:
    env = phase_environment()
    phase_build()
    rows = [phase_probe()]
    cfg, n_in = bench_geometry()
    rows += [phase_k1(cfg, n_in), phase_k2(), *phase_k3_k4_k5(cfg, n_in)]
    phase_k5_full(cfg, n_in, rows[-1])
    fir_only_ms = phase_fir_only(cfg, n_in)
    iq, tx_packets = phase_scene(cfg, n_in)
    card = env["card"]
    main_path = phase_main_path(cfg, n_in, card, iq, tx_packets)
    complex_path = phase_complex_iq(cfg, n_in, card, iq, tx_packets)["launches"]
    formats = phase_wire_formats(cfg, n_in, card, iq, tx_packets)
    # Launches a step on the path that uses each kernel: the cr1 path's
    # counts over its steps; the other paths' counts are of one step.
    per_step = {k: main_path["launches"][k] / main_path["steps"]
                for k in ("wire_channelizer_cr1", "matched_filter")}
    per_step["channelizer"] = complex_path["channelizer"]
    for fmt in ("ci1", "ci2", "ci4"):
        per_step[f"wire_channelizer_{fmt}"] = formats[fmt][f"wire_channelizer_{fmt}"]
    paths = [main_path["launches"], complex_path, *formats.values(),
             phase_radio_wideband_ppm(card, iq, tx_packets),
             phase_mlse(cfg, n_in, card, iq, tx_packets),
             phase_overflow(cfg, card, iq, tx_packets)]
    del iq
    paths += [phase_radio_channels(card), phase_ais_rx(card)]
    # Each kernel's launches over the paths that drive it (the probe's
    # over its own phase).
    for row in rows:
        if row["name"] != "probe":
            row["launches"] = sum(counts.get(row["name"], 0) for counts in paths)
            row["launches_per_step"] = per_step[row["name"]]
        if "channelizer" in row["name"]:
            row["library_ms"], row["library_call"] = fir_only_ms, FIR_ONLY
    if min(row["launches"] for row in rows) <= 0:
        raise RuntimeError(f"a kernel was never launched: {rows}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["device_name"], "count": env["device_count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
