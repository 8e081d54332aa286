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
     channelizer, in its 1-bit tensor-core form through the module's
     fragments), K4 (ci2, ci4 wire channelizers) and K5 (float
     channelizer), each against its plain PyTorch version at the
     paths' shapes, with the median time of each, its bound (the least
     time the card could take) and a library call's time where one
     PyTorch call computes the same function; K1 also at 1, 3 and 4
     channels, K2 also at rows off its tile and odd tap counts; k5_full:
     K5 with the full-length carrier table of a 50 ppm radio at the bench
     n_in; k3_template: K3's other kernel (the channelizer template's ci1
     instantiation, which takes the geometries the 1-bit form refuses) on
     a full-length table at the shape of the wire_ci1_ppm path; k5_shapes:
     K5, K4 and both kernels of K3 off the bench geometry (other channel
     counts and decimations, short taps, a tile that ends inside n_out,
     a wire that ends inside a word, every count of outputs a thread),
     K5 timed at the 250 ksps path's one channel and D = 5, and at D = 1;
     fir_only: the channelizers' yardstick;
  5. main path (cr1): a warm-up decode whose packets must match the
     transmitted ones (content parity 1.0), then timed steps, then the
     time of each stage; fan: the main path's wire replayed at 16 stream
     positions, through the main path's receiver alone, then through
     `MultiProcessWideband` (2 workers and the parent's pump with the
     exec lock on, 4 with it on, the same 4 with it off): each window
     must give the single process's packets, packet for packet, with K1
     and K2 once a step summed over the processes, every worker warm
     within 180 s and no worker error; each window's wall (submit and
     pump, then drain), Msps beside the single process's, per-step phase
     split and h2d probes;
  6. complex_iq: `decode` of the same scene as complex64 samples
     (parity 1.0), its step time and stages;
  7. wire_formats: one `decode_wire` per format (ci16, ci8, ci4, ci2,
     ci1, cd1) of the same scene: parity 1.0 for ci16, ci8 and ci1,
     cd1's packets equal to ci1's, at least 0.99 for ci4 and ci2; ci1
     and cd1 launch K3's 1-bit form once a step and the template never;
     wire_ci1_ppm: `decode_wire(raw, "ci1")` with the channels of a
     device 50 ppm high (8-block steps): no periodic carrier, so K3's
     template kernel on the full-length table, parity 1.0;
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
     capture must print the golden sentence;
 13. pll, ff_fft, ff_bank: the cr1 main path at the bench geometry with
     `timing_mode="pll"`, `ff_path="fft"` and `ff_path="bank"`: a warm-up
     decode and one timed step each, the decision stage timed against the
     FIR comb's on the same bursts.  pll's packets must be the JAX
     reference's (`pll_bench` of the reference packets file; at most 2
     may differ either way, and parity may not fall below the
     reference's); fft and bank must reach parity 1.0;
 14. wire_select: `select_wire_format(iq, "cr1")` on the scene and on the
     scene under a +500 kHz carrier at 10x a packet's amplitude must give
     the reference's format and reason (`wire_select_bench` of the same
     file; the second must be ci8 for an interferer); each chosen format
     then decodes 8 blocks of its capture with parity 1.0;
 15. debug_taps: `make_debug_taps` on one 16384-sample block: one K2
     launch, `corr_mag2` against the plain version;
 16. modem_bench: `python -m ais_tpu_torch.cli.modem_bench` in a child
     process, the three chains at a clean and a noisy point: every clean
     trial must decode in each chain;
 17. ais_scope: `compute_panels` on the golden 250 ksps capture: the
     correlator peak inside the packet's span, the threshold equal to
     `autocorr_threshold`'s; the PNG only where matplotlib is installed;
 18. the mesh (`ais_tpu_torch.parallel`) over the cards there are, shard
     i on cuda:{i % device_count} (on one card: logical shards, a CUDA
     stream each); every line prints n_shards and n_physical.
     sharded_wire: the bench wire as 4 shards of 24 blocks (K = 24,
     compact_lanes = 14*2*24) through `make_sharded_wire_pipeline`, whose
     spans cover the bench step exactly: its packets must be the main
     path's, packet for packet, with one K1 and one K2 launch a shard
     step; its wall ms beside the single-device step's.  sharded_demod,
     halo_exchange, stream_sharded: channel A (and B, on a 2 x 4 grid) of
     the bench step at 48 ksps, 96 blocks over 8 shards: each packet set
     must be the single-device `BasebandReceiver`'s on the same stream;
     halo_exchange also against the duplication path, lane by lane.
     distributed_stream: `DistributedStreamDecoder` over channel A in
     70 001-sample chunks, 48 blocks a call: the one-shot
     `DistributedBlockDecoder`'s packets.  two_process: two
     `python -m ais_tpu_torch.parallel.worker` children in one gloo group
     (rank r on cuda:{r % device_count}): both must write the packets
     one process decodes.  dryrun_multichip: `dryrun_multichip(4)`.

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
import types
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
WIRE_FORMATS = ("ci16", "ci8", "cu8", "ci4", "ci2", "ci1", "cd1")
RADIO_PPM = 50.0           # LO error of the ppm radio phase
OVERFLOW_BLOCKS, OVERFLOW_K = 8, 3
PPM_WIRE_BLOCKS = 8        # blocks a step of the wire_ci1_ppm path
# The other timing formulations on the cr1 main path: phase -> DemodConfig fields.
TIMING_MODES = {"pll": {"timing_mode": "pll"}, "ff_fft": {"ff_path": "fft"},
                "ff_bank": {"ff_path": "bank"}}
PLL_MAY_DIFFER = 2         # packets the pll phase may differ from the reference's, either way
CHANNELS_RATE, CHANNELS_SECONDS = 250e3, 21.0
BURST_SPAN_2P4M = 64500    # the scene's packet span at 2.4 Msps
# The out-of-band carrier of the wire_select phase: +500 kHz, at 10x the
# amplitude of a packet of the scene (whose packets have amplitude 1).
INTERFERER_HZ, INTERFERER_GAIN = 500e3, 10.0
WIRE_SELECT_BLOCKS = 8     # blocks a step of the wire_select decodes
MESH_WIRE_SHARDS = 4       # shards of the sharded_wire phase, N_BLOCKS / 4 blocks each
MESH_SHARDS = 8            # shards of the mesh phases at 48 ksps
DIST_CHUNK, DIST_BLOCKS_PER_CALL = 70_001, 48  # the rolling decoder's chunks and calls
# The fan phase: steps a window, its windows (workers, exec lock on), the
# bounded wait for every worker to be warm, and how long the parent's pump
# waits on an empty queue before it leaves the rest to drain().
FAN_STEPS = 16
FAN_WINDOWS = ((2, True), (4, True), (4, False))
FAN_READY_S = 180.0
FAN_PUMP_IDLE_S = 0.1
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


def with_interferer(iq: np.ndarray, rate: float = 2.4e6) -> np.ndarray:
    """The capture plus a carrier at INTERFERER_HZ of amplitude
    INTERFERER_GAIN (float64 phase, in pieces)."""
    out = np.empty_like(iq)
    step = 1 << 22
    for i in range(0, iq.size, step):
        n = np.arange(i, min(i + step, iq.size), dtype=np.float64)
        ph = 2.0 * np.pi * np.remainder(INTERFERER_HZ / rate * n, 1.0)
        out[i: i + n.size] = iq[i: i + n.size] + (INTERFERER_GAIN * np.exp(1j * ph)).astype(
            np.complex64)
    return out


def bench_geometry(blocks: int = N_BLOCKS):
    """The benchmark's receiver geometry: 96 blocks (or `blocks`), K = 24,
    14 valid lanes per (channel, block) in the compact directory; n_in
    aligned as the receiver aligns it."""
    import dataclasses

    from ais_tpu_torch.pipeline.wideband import WidebandConfig, aligned_n_in, num_taps

    cfg = WidebandConfig()
    cfg = cfg._replace(
        demod=dataclasses.replace(cfg.demod, max_bursts_per_block=24),
        compact_lanes=14 * 2 * blocks,
    )
    n48 = cfg.block_len + cfg.core_len * (blocks - 1)
    return cfg, aligned_n_in(cfg, (n48 - 1) * cfg.decimation + num_taps(cfg))


def ppm_shifted(cfg):
    """`cfg` with its channels where a device RADIO_PPM high sees them."""
    from ais_tpu_torch.pipeline.radio import ppm_offset_hz

    return cfg._replace(offsets_hz=tuple(o + ppm_offset_hz(RADIO_PPM) for o in cfg.offsets_hz))


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

    from ais_tpu_torch import _build

    _build.reset_launch_counts()
    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    launched = {k: n for k, n in _build.launch_counts().items() if n}
    if launched != {row["name"]: 1}:
        raise RuntimeError(f"{phase}: launched {launched}, not {row['name']} once")
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
         "replaces": "ais_tpu/ops/pallas_fir.py:630", "n_in": n_in,
         **channelizer_bound(n_in, chan.n_out, taps.size, n_chan, n_in / 8, q, 0),
         "tensor_core_flop": mma_flop},
        shape=[n_chan, chan.n_out])
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
    """K3 (ci1), K4 (ci2, ci4), K5's cu8 entry on random wire bytes and
    K5 on random complex64 samples, at the bench n_in, with random start
    phases."""
    import torch

    from ais_tpu_torch.ops.channelizer import (
        Channelizer, freq_xlating_polyphase, freq_xlating_polyphase_plain, rotate_carrier,
    )
    from ais_tpu_torch.ops.wire_channelizer import (
        PACKED, PackedWireChannelizer, n_column_tiles, n_super_steps, wire_channelizer_packed,
        wire_channelizer_packed_plain,
    )
    from ais_tpu_torch.pipeline.wideband import channel_taps

    dev = torch.device("cuda")
    chan = Channelizer(channel_taps(cfg), cfg.decimation, cfg.offsets_hz, cfg.input_rate,
                       n_in, device=dev)
    taps, decim = chan.taps, chan.decim
    rng = np.random.default_rng(SEED + 1)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    shape = [len(cfg.offsets_hz), chan.n_out]
    # K3 as the ci1 and cd1 paths launch it: the module's bit-stream taps.
    ci1 = PackedWireChannelizer("ci1", channel_taps(cfg), decim, cfg.offsets_hz, cfg.input_rate,
                                n_in, device=dev)
    if ci1.folded is None:
        raise RuntimeError("the bench geometry should take K3's 1-bit form")
    # Its tensor-core passes: one m16n8k16 (4096 flop) for every 16 outputs,
    # k-step of the padded 2*ntaps bit-stream taps and n-tile.
    mma_flop = (4096.0 * -(-chan.n_out // 16) * n_super_steps(2 * taps.numel()) * 8
                * n_column_tiles(shape[0]))
    rows = []
    for phase, fmt, name, source, replaces, folded in (
            ("k3", "ci1", "wire_channelizer_ci1_mma", "wire_channelizer.cu", ":707", ci1.folded),
            ("k4_ci2", "ci2", "wire_channelizer_ci2", "channelizer.cu", ":784", None),
            ("k4_ci4", "ci4", "wire_channelizer_ci4", "channelizer.cu", ":784", None),
            # K5 decoding rtl_sdr's bytes (the reference decodes them first).
            ("k5_cu8", "cu8", "wire_channelizer_cu8", "channelizer.cu", ":171", None)):
        raw = torch.randint(0, 256, (PACKED[fmt].nbytes(n_in),), device=dev,
                            dtype=torch.uint8, generator=gen)
        car = rotate_carrier(chan.carrier, random_phase0s(cfg, rng))
        rows.append(hold_channelizer(
            phase,
            lambda: wire_channelizer_packed(fmt, raw, car, taps, decim=decim, n_in=n_in,
                                            folded=folded),
            lambda: wire_channelizer_packed_plain(fmt, raw, car, taps, decim),
            {"name": name, "source": "ais_tpu_torch/csrc/" + source,
             "replaces": "ais_tpu/ops/pallas_fir.py" + replaces, "n_in": n_in,
             **channelizer_bound(n_in, chan.n_out, taps.numel(), shape[0], raw.numel(),
                                 car.shape[1], 6),
             **({"tensor_core_flop": mma_flop} if fmt == "ci1" else {})},
            shape=shape, fmt=fmt))
        del raw
    k3 = rows[0]
    k3["tensor_core_share_of_fp16_peak"] = (
        mma_flop / PEAK_FP16_TENSOR_FLOPS * 1e3 / k3["ms_back_to_back"])
    log("k3_share", name=k3["name"], share_of_bound=k3["bound_ms"] / k3["ms_back_to_back"],
        tensor_core_share_of_fp16_peak=k3["tensor_core_share_of_fp16_peak"])
    x = torch.complex(torch.randn(n_in, device=dev, generator=gen),
                      torch.randn(n_in, device=dev, generator=gen)) * 0.3
    car = rotate_carrier(chan.carrier, random_phase0s(cfg, rng))
    rows.append(hold_channelizer(
        "k5",
        lambda: freq_xlating_polyphase(x, car, taps, decim=decim),
        lambda: freq_xlating_polyphase_plain(x, car, taps, decim),
        {"name": "channelizer", "source": "ais_tpu_torch/csrc/channelizer.cu",
         "replaces": "ais_tpu/ops/pallas_fir.py:171", "n_in": n_in,
         **channelizer_bound(n_in, chan.n_out, taps.numel(), shape[0], 8.0 * n_in,
                             car.shape[1], 6)},
        shape=shape, input_mb=x.numel() * 8 / 1e6))
    del x
    torch.cuda.empty_cache()
    return rows


def phase_k3_template() -> dict:
    """K3's other kernel, the channelizer template's ci1 instantiation, at
    the shape the wire_ci1_ppm path gives it: 8-block steps, the channels
    of a device 50 ppm high, so no periodic carrier and a full-length
    table, which the 1-bit form refuses."""
    import torch

    from ais_tpu_torch.ops.channelizer import rotate_carrier
    from ais_tpu_torch.ops.wire_channelizer import (
        PackedWireChannelizer, wire_channelizer_packed, wire_channelizer_packed_plain,
    )
    from ais_tpu_torch.pipeline.wideband import channel_taps

    dev = torch.device("cuda")
    cfg, n_in = bench_geometry(PPM_WIRE_BLOCKS)
    cfg = ppm_shifted(cfg)
    chan = PackedWireChannelizer("ci1", channel_taps(cfg), cfg.decimation, cfg.offsets_hz,
                                 cfg.input_rate, n_in, device=dev)
    if chan.folded is not None or not chan.full_table:
        raise RuntimeError("the 50 ppm offsets should take the template on a full-length table")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    raw = torch.randint(0, 256, (n_in // 4,), device=dev, dtype=torch.uint8, generator=gen)
    car = rotate_carrier(chan.carrier, random_phase0s(cfg, np.random.default_rng(SEED + 5)))
    return hold_channelizer(
        "k3_template",
        lambda: wire_channelizer_packed("ci1", raw, car, chan.taps, decim=chan.decim, n_in=n_in),
        lambda: wire_channelizer_packed_plain("ci1", raw, car, chan.taps, chan.decim),
        {"name": "wire_channelizer_ci1", "source": "ais_tpu_torch/csrc/channelizer.cu",
         "replaces": "ais_tpu/ops/pallas_fir.py:707", "n_in": n_in,
         **channelizer_bound(n_in, chan.n_out, chan.taps.numel(), car.shape[0], raw.numel(),
                             car.shape[1], 6)},
        shape=[car.shape[0], chan.n_out], offsets_hz=list(cfg.offsets_hz),
        table_mb=chan.carrier.numel() * 4 / 1e6)


K5_SHAPES = (
    # name, kernel ("iq" or a packed format), taps (cutoff, transition or None for the bench's),
    # rate, decim, offsets, n_in
    ("1_channel", "iq", None, 2.4e6, 50, (-25e3,), 400_000),
    ("3_channels", "iq", None, 2.4e6, 50, (-25e3, 25e3, 0.0), 400_000),
    ("4_channels", "iq", None, 2.4e6, 50, (-25e3, 25e3, 0.0, 50e3), 400_000),
    ("ends_inside_a_tile", "iq", None, 2.4e6, 50, (-25e3, 25e3), 400_000),
    ("d5_1_channel", "iq", (11e3, 4e3), 250e3, 5, (25e3,), 1_048_575),
    ("d1_1_channel", "iq", (11e3, 4e3), 48e3, 1, (6e3,), 200_000),
    ("7_taps", "iq", 7, 2.4e6, 50, (-25e3, 25e3), 400_000),
    ("140_taps", "iq", 140, 2.4e6, 50, (-25e3, 25e3), 400_000),
    ("full_table_1_channel", "iq", None, 2.4e6, 50, (25e3 * math.sqrt(2),), 400_000),
    ("d1000_4_channels_1_output_a_thread", "iq", None, 2.4e6, 1000,
     (-25e3, 25e3, 0.0, 50e3), 300_000),
    ("d1800_2_channels_1_output_a_thread", "iq", None, 2.4e6, 1800, (-25e3, 25e3), 360_000),
    ("ci2_3_channels", "ci2", None, 2.4e6, 50, (-25e3, 25e3, 0.0), 400_000),
    ("ci4_d5_1_channel", "ci4", (11e3, 4e3), 250e3, 5, (25e3,), 1_048_575),
    # K5's cu8 entry: an odd n_in, whose wire ends inside a 32-bit word; 3 channels.
    ("cu8_d51_partial_last_word", "cu8", None, 2.4e6, 51, (-25e3, 25e3), 400_095),
    ("cu8_3_channels", "cu8", None, 2.4e6, 50, (-25e3, 25e3, 0.0), 400_000),
    # K3's 1-bit form (the fragments derived from the table): odd
    # decimation and a wire that ends inside a 32-bit word; 1, 3, 4 channels.
    ("ci1_d51_partial_last_word", "ci1", None, 2.4e6, 51, (-25e3, 25e3), 400_044),
    ("ci1_1_channel", "ci1", None, 2.4e6, 50, (-25e3,), 400_000),
    ("ci1_3_channels", "ci1", None, 2.4e6, 50, (-25e3, 25e3, 0.0), 400_000),
    ("ci1_4_channels", "ci1", None, 2.4e6, 50, (-25e3, 25e3, 0.0, 50e3), 400_000),
    # A geometry the 1-bit form refuses (no periodic carrier): the template's ci1.
    ("ci1_template_full_table_1_channel", "ci1", None, 2.4e6, 50, (25e3 * math.sqrt(2),), 400_000),
)
# K5 as the 250 ksps path launches it (one channel, D = 5) and at D = 1: timed too.
K5_TIMED_SHAPES = ("d5_1_channel", "d1_1_channel")


def phase_k5_shapes(cfg) -> None:
    """K5 off the bench geometry (1, 3 and 4 channels; D = 5 and D = 1 with
    one channel; an n_out that ends inside a tile; short taps; a full-
    length table; decimations that leave room for only 1 or 2 outputs a
    thread, and more items than threads) and K3/K4 at some of them, each
    against its plain version: every instantiation the plan can pick is
    launched and compared.  The ci1 cases must launch the kernel their
    geometry asks for: the 1-bit form, or the template where it refuses."""
    import torch

    from ais_tpu_torch import _build
    from ais_tpu_torch.ops.channelizer import (
        Channelizer, freq_xlating_polyphase, freq_xlating_polyphase_plain, kernel_plan,
        rotate_carrier,
    )
    from ais_tpu_torch.ops.firdes import low_pass
    from ais_tpu_torch.ops.wire_channelizer import (
        PACKED, wire_channelizer_packed, wire_channelizer_packed_plain,
    )
    from ais_tpu_torch.pipeline.wideband import channel_taps

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 4)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    seen = set()
    for name, kind, tap_spec, rate, decim, offsets, n_in in K5_SHAPES:
        if tap_spec is None:
            taps = channel_taps(cfg)
        elif isinstance(tap_spec, int):
            taps = channel_taps(cfg)[:tap_spec]
        else:
            taps = low_pass(1.0, rate, *tap_spec)
        chan = Channelizer(taps, decim, offsets, rate, n_in, device=dev)
        ph = torch.from_numpy(rng.uniform(0, 2 * math.pi, len(offsets)).astype(np.float32)).to(dev)
        car = rotate_carrier(chan.carrier, ph)
        timed = {}
        _build.reset_launch_counts()
        if kind == "iq":
            x = torch.complex(torch.randn(n_in, device=dev, generator=gen),
                              torch.randn(n_in, device=dev, generator=gen)) * 0.3
            got = freq_xlating_polyphase(x, car, chan.taps, decim=decim)
            ref = freq_xlating_polyphase_plain(x, car, chan.taps, decim)
            if name in K5_TIMED_SHAPES:
                planes = torch.view_as_real(x).T.contiguous()[None]        # (1, 2, n_in)
                weight = chan.taps.expand(2, 1, -1).contiguous()
                timed = {"ms_back_to_back": cuda_ms_back_to_back(
                    lambda: freq_xlating_polyphase(x, car, chan.taps, decim=decim), 50),
                    "plain_ms": cuda_ms(
                        lambda: freq_xlating_polyphase_plain(x, car, chan.taps, decim), 20),
                    "library_ms": cuda_ms(lambda: torch.nn.functional.conv1d(
                        planes, weight, stride=decim, groups=2), 20),
                    "library_call": FIR_ONLY,
                    **channelizer_bound(n_in, chan.n_out, chan.taps.numel(), len(offsets),
                                        8.0 * n_in, car.shape[1], 6)}
                del planes
        else:
            raw = torch.randint(0, 256, (PACKED[kind].nbytes(n_in),), device=dev,
                                dtype=torch.uint8, generator=gen)
            got = wire_channelizer_packed(kind, raw, car, chan.taps, decim=decim, n_in=n_in)
            ref = wire_channelizer_packed_plain(kind, raw, car, chan.taps, decim)
        torch.cuda.synchronize()
        launched = sorted(k for k, n in _build.launch_counts().items() if n)
        max_err, ok = channelizer_error(got, ref)
        plan = kernel_plan(chan.taps.numel(), decim, len(offsets))
        if launched != ["wire_channelizer_ci1_mma"]:     # the template ran, under this plan
            seen.add((len(offsets), plan.outputs))
        log("k5_shapes", case=name, kernel=kind, launched=launched, n_chan=len(offsets),
            decim=decim, ntaps=chan.taps.numel(), n_in=n_in, n_out=chan.n_out,
            period=chan.carrier.shape[1], plan=plan._asdict(), tolerance=TOLERANCE,
            max_abs_err=max_err, within=ok, **timed)
        if got.shape != ref.shape or not ok:
            raise RuntimeError(f"{kind} at {name} disagrees with its plain version: {max_err}")
        if kind == "ci1":
            want_kernel = "wire_channelizer_ci1" + ("" if "template" in name else "_mma")
            if launched != [want_kernel]:
                raise RuntimeError(f"{name} launched {launched}, not {want_kernel}")
    want = {(1, 8), (2, 8), (3, 4), (4, 4), (4, 1), (2, 1)}
    if not want <= seen:
        raise RuntimeError(f"k5_shapes did not launch every instantiation: {sorted(seen)}")


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
    out.update(rx=rx, packets=found)
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
    out["wire"] = wire
    return out


def phase_fan(card: str, main_path: dict) -> list:
    """The multi-process wire fan (`MultiProcessWideband`, cr1) on this
    card at the main path's geometry: the main path's wire replayed at
    FAN_STEPS stream positions (pos = i * step_raw), first through the main
    path's receiver alone (the yardstick), then in FAN_WINDOWS, each with
    the parent's pump as one more worker and fresh step indices.  Every
    window must decode the yardstick's packets, packet for packet (each
    step the main path's shifted by i * step_raw / decimation), with K1 and
    K2 once a step summed over the processes and no worker error.  Returns
    the yardstick's and each window's launch counts."""
    import os

    from ais_tpu_torch import _build
    from ais_tpu_torch.pipeline.multiproc import PHASES, MultiProcessWideband

    rx, wire, steps = main_path["rx"], main_path["wire"], FAN_STEPS
    cfg = rx.cfg
    step_chan = rx.step_raw // cfg.decimation
    one = packet_keys(main_path["packets"])

    def shifted(keys: list, by_steps: int) -> list:
        return sorted([d, a + by_steps * step_chan, h] for d, a, h in keys)

    def full(counts: dict) -> dict:
        return {name: counts.get(name, 0) for name in _build.launch_counts()}

    rx.reset_dedup()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    single = []
    for i in range(steps):
        single.extend(rx.collect(rx.submit_wire(wire, "cr1", pos=i * rx.step_raw)))
    single_s = time.perf_counter() - t0
    paths = [_build.launch_counts()]
    want = packet_keys(single)
    if want != sorted(k for i in range(steps) for k in shifted(one, i)):
        raise RuntimeError("fan: the single-process steps are not the main path's packets "
                           "shifted step by step")
    single_msps = rx.n_in * steps / single_s / 1e6
    host_cpus = len(os.sched_getaffinity(0))
    fan, startup_s = None, None
    try:
        for w, (n_workers, locked) in enumerate(FAN_WINDOWS):
            if fan is None or fan.n_workers != n_workers:
                if fan is not None:
                    fan.close()
                t0 = time.perf_counter()
                fan = MultiProcessWideband(cfg, n_in=rx.n_in, n_workers=n_workers, fmt="cr1",
                                           device="cuda")
                fan.start(timeout=FAN_READY_S)  # raises on a worker error or a timeout
                startup_s = time.perf_counter() - t0
            fan.set_serialize_exec(locked)
            fan.reset_collect_stats()
            rx.reset_dedup()
            base = w * steps
            t0 = time.perf_counter()
            for i in range(steps):
                fan.submit(base + i, wire)
            pumped = fan.parent_pump(rx, idle_timeout=FAN_PUMP_IDLE_S)
            t_pump = time.perf_counter()
            got = fan.drain(timeout=FAN_READY_S)
            wall = time.perf_counter() - t0
            st = fan.collect_stats
            launches = full(st["launches"])
            keys = shifted(packet_keys(got), -base)
            only_fan = len({tuple(k) for k in keys} - {tuple(k) for k in want})
            only_single = len({tuple(k) for k in want} - {tuple(k) for k in keys})
            log("fan", card=card, n_workers=n_workers, locked=locked, steps=st["steps"],
                pumped=pumped, startup_s=startup_s, host_cpus=host_cpus, ready=fan._ready,
                packets=len(got), single_process_packets=len(want),
                packets_per_step=len(one), only_fan=only_fan, only_single=only_single,
                wall_ms=wall * 1e3, pump_ms=(t_pump - t0) * 1e3,
                drain_ms=(t0 + wall - t_pump) * 1e3, msamples_per_s=rx.n_in * steps / wall / 1e6,
                single_process_wall_ms=single_s * 1e3,
                single_process_msamples_per_s=single_msps,
                per_step_ms={k[:-2]: st[k] / max(st["steps"], 1) * 1e3 for k in PHASES},
                h2d_mbps=fan.h2d_mbps, worker_errors=fan.worker_errors,
                kernels=mesh_kernels(launches))
            if keys != want:
                raise RuntimeError(f"fan ({n_workers} workers, locked={locked}): the packets "
                                   f"differ from the single process's ({only_fan} only in the "
                                   f"fan, {only_single} only in the single process)")
            if fan.worker_errors:
                raise RuntimeError(f"fan: worker errors {fan.worker_errors}")
            on_path = path_launches(launches, ("wire_channelizer_cr1", "matched_filter"))
            if st["steps"] != steps or any(n != steps for n in on_path.values()):
                raise RuntimeError(f"fan: K1 and K2 should launch once a step: {on_path} in "
                                   f"{st['steps']} steps of {steps}")
            paths.append(launches)
    finally:
        if fan is not None:
            fan.close()
    return paths


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
    if any(n != 1 for n in out["launches"].values()):
        raise RuntimeError(f"K5 and K2 should launch once a step: {out['launches']} in one step")
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
                 "ci2": "wire_channelizer_ci2", "ci1": "wire_channelizer_ci1_mma",
                 "cd1": "wire_channelizer_ci1_mma", "cu8": "wire_channelizer_cu8"}
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
        if any(n != 1 for n in launches[fmt].values()):
            raise RuntimeError(f"{fmt}: its channelizer and K2 should launch once a step: "
                               f"{launches[fmt]} in one step")
        if counts["wire_channelizer_ci1"]:
            raise RuntimeError(f"{fmt}: the template's ci1 kernel launched at the bench "
                               f"geometry: {counts}")
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
    from ais_tpu_torch.pipeline.wideband import channel_taps

    dev = torch.device("cuda")
    shifted = ppm_shifted(cfg)
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


def phase_wire_ci1_ppm(card: str, iq: np.ndarray, tx_packets) -> dict:
    """`decode_wire(raw, "ci1")` of the scene's first 8 blocks as a device
    50 ppm high records them, on a receiver whose channels carry that
    correction: the carriers have no period, so K3 runs as the template's
    ci1 kernel on a full-length table, and the 1-bit form never."""
    import dataclasses

    from ais_tpu_torch import _build
    from ais_tpu_torch.ops.convert import host_bytes
    from ais_tpu_torch.pipeline.radio import ppm_offset_hz
    from ais_tpu_torch.pipeline.wideband import WidebandReceiver
    from ais_tpu_torch.scene import content_parity

    cfg, n_in = bench_geometry(PPM_WIRE_BLOCKS)
    cfg = ppm_shifted(cfg)
    shift = ppm_offset_hz(RADIO_PPM)
    rx = WidebandReceiver(cfg, n_in=n_in, device="cuda")
    tx = [dataclasses.replace(p, offset_hz=p.offset_hz + shift) for p in tx_packets
          if p.start_sample + BURST_SPAN_2P4M < rx.step_raw]
    wire = host_bytes((shift_capture(iq[: rx.n_in], shift, 2.4e6) * 0.7).astype(np.complex64),
                      "ci1")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    found = rx.decode_wire(wire, "ci1")
    step_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    parity = content_parity(found, tx, cfg.decimation)
    chan = rx.channelizer_for("ci1")
    out = {"card": card, "offsets_hz": list(cfg.offsets_hz), "n_in": rx.n_in,
           "blocks": rx.n_blocks, "table_mb": chan.carrier.numel() * 4 / 1e6,
           "full_length_table": chan.full_table, "tx_packets": len(tx), "decoded": len(found),
           "content_parity": parity, "overflow_blocks": rx.overflow_blocks,
           "launches": launches, "step_ms": step_s * 1e3}
    log("wire_ci1_ppm", **out)
    if parity != 1.0 or rx.overflow_blocks:
        raise RuntimeError(f"ci1 at 50 ppm: parity {parity}, {rx.overflow_blocks} overflows")
    if not chan.full_table or launches["wire_channelizer_ci1_mma"]:
        raise RuntimeError(f"ci1 at 50 ppm should run the template on a full table: {launches}")
    on_path = path_launches(launches, ("wire_channelizer_ci1", "matched_filter"))
    if any(n != 1 for n in on_path.values()):
        raise RuntimeError(f"ci1 at 50 ppm: the template and K2 should launch once: {on_path}")
    return on_path


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
        rx.demod.decide(front.bursts, front.offsets, front.det.center)
        ev[2].record()
        disc.decide(front.bursts, front.offsets, front.det.center)
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


def phase_overflow(card: str, iq: np.ndarray, tx_packets) -> dict:
    """The cr1 wire path at 8 blocks with a burst table of 3, a third of
    the scene's ~9 bursts a block and channel: every block overflows and
    is re-demodulated on the host side with a larger table."""
    import dataclasses

    from ais_tpu_torch import _build
    from ais_tpu_torch.ops.convert import host_bytes
    from ais_tpu_torch.pipeline.wideband import WidebandReceiver
    from ais_tpu_torch.scene import content_parity

    ocfg, n_in = bench_geometry(OVERFLOW_BLOCKS)
    ocfg = ocfg._replace(demod=dataclasses.replace(ocfg.demod, max_bursts_per_block=OVERFLOW_K))
    rx = WidebandReceiver(ocfg, n_in=n_in, device="cuda")
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
           "msamples_per_s": n / wall / 1e6,
           # A step of this path is one 1 << 20-sample chunk: K5 once a channel.
           "channelizer_launches_per_chunk": launches["channelizer"] / -(-n // (1 << 20))}
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


def phase_timing_mode(phase: str, cfg, n_in: int, card: str, wire: np.ndarray,
                      tx_packets) -> dict:
    """The cr1 main path at the bench geometry with another timing
    formulation (TIMING_MODES[phase]): a warm-up decode, one timed step,
    then the decision stage timed against the FIR comb's on the same
    bursts.  "pll" is held to the JAX reference's packets on this scene;
    the feedforward formulations to content parity 1.0."""
    import dataclasses

    import torch

    from ais_tpu_torch import _build
    from ais_tpu_torch.pipeline.receiver import BurstDemod
    from ais_tpu_torch.pipeline.wideband import WidebandReceiver
    from ais_tpu_torch.scene import content_parity

    tcfg = cfg._replace(demod=dataclasses.replace(cfg.demod, **TIMING_MODES[phase]))
    rx = WidebandReceiver(tcfg, n_in=n_in, device="cuda")
    fresh = rx.get_state()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    found = rx.decode_wire(wire, "cr1")
    warm_s = time.perf_counter() - t0
    rx.set_state(fresh)
    t0 = time.perf_counter()
    n_again = len(rx.decode_wire(wire, "cr1"))
    step_s = time.perf_counter() - t0
    launches = _build.launch_counts()
    parity = content_parity(found, tx_packets, cfg.decimation)

    # The decision stage alone, on one step's bursts: this formulation's
    # and the FIR comb's, between event pairs.
    raw, ph, _, _, _ = rx.stage_wire(wire, "cr1", pos=0)
    chans = rx.wire_channels(raw, ph, "cr1")
    blocks = chans.unfold(-1, cfg.block_len, rx.core_len)[:, : rx.n_blocks].reshape(
        rx.n_chan * rx.n_blocks, cfg.block_len)
    c = rx.constants
    comb = BurstDemod(dataclasses.replace(rx.demod_cfg, timing_mode="feedforward", ff_path="fir"),
                      cfg.block_len, rx.core_len, preamble=c.preamble,
                      interp_bank=c.interp_bank, ff_delta=c.ff_delta, device="cuda")
    front = rx.demod.front(blocks)
    runs = []
    for _ in range(PATH_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        rx.demod.decide(front.bursts, front.offsets, front.det.center)
        ev[1].record()
        comb.decide(front.bursts, front.offsets, front.det.center)
        ev[2].record()
        ev[2].synchronize()
        runs.append([ev[i].elapsed_time(ev[i + 1]) for i in range(2)])
    decide_ms, comb_ms = (statistics.median(col) for col in zip(*runs))
    n_bursts = front.bursts.shape[0]
    del front, blocks, chans, raw
    torch.cuda.empty_cache()

    out = {"card": card, "demod": TIMING_MODES[phase], "n_in": rx.n_in, "blocks": rx.n_blocks,
           "bursts_per_call": n_bursts, "tx_packets": len(tx_packets), "decoded": len(found),
           "decoded_again": n_again, "content_parity": parity,
           "overflow_blocks": rx.overflow_blocks, "launches": launches,
           "warmup_ms": warm_s * 1e3, "step_ms": step_s * 1e3,
           f"{phase}_decide_ms": decide_ms, "feedforward_decide_ms": comb_ms}
    if phase == "pll":
        want = reference_packets("pll_bench")
        diff = packet_diff(found, want)
        ref_parity = content_parity(
            [types.SimpleNamespace(designator=d, abs_sample=a, payload=bytes.fromhex(h))
             for d, a, h in want], tx_packets, cfg.decimation)
        out.update(reference_decoded=len(want), reference_parity=ref_parity, **diff)
    log(phase, **out)
    if rx.overflow_blocks or n_again != len(found):
        raise RuntimeError(f"{phase}: {rx.overflow_blocks} blocks overflowed; decoded "
                           f"{len(found)} then {n_again}")
    if phase == "pll":
        if max(len(diff["only_port"]), len(diff["only_reference"])) > PLL_MAY_DIFFER \
                or parity < ref_parity:
            raise RuntimeError(f"pll: parity {parity} (reference {ref_parity}); the packets "
                               f"differ from the reference's: {diff}")
    elif parity != 1.0:
        raise RuntimeError(f"{phase}: content parity {parity} != 1.0")
    on_path = path_launches(launches, ("wire_channelizer_cr1", "matched_filter"))
    if any(n != 2 for n in on_path.values()):
        raise RuntimeError(f"{phase}: K1 and K2 should launch once a step: {on_path} in 2 steps")
    return on_path


def phase_wire_select(card: str, iq: np.ndarray, tx_packets) -> list:
    """`select_wire_format(iq, "cr1")` on the scene and on the scene under
    an out-of-band carrier: each answer must be the JAX reference's on the
    same capture, and the format it names must then decode its capture's
    first WIRE_SELECT_BLOCKS blocks with parity 1.0.  Returns the launch
    counts of the two decodes."""
    from ais_tpu_torch import _build
    from ais_tpu_torch.ops.convert import host_bytes, select_wire_format
    from ais_tpu_torch.pipeline.wideband import WidebandReceiver
    from ais_tpu_torch.scene import content_parity

    want = reference_packets("wire_select_bench")
    kernel_of = {"cr1": "wire_channelizer_cr1", "ci8": "channelizer"}
    cfg, n_in = bench_geometry(WIRE_SELECT_BLOCKS)
    paths = []
    for case in ("scene", "interferer"):
        capture = iq if case == "scene" else with_interferer(iq)
        t0 = time.perf_counter()
        fmt, reason = select_wire_format(capture, "cr1")
        select_ms = (time.perf_counter() - t0) * 1e3
        rx = WidebandReceiver(cfg, n_in=n_in, device="cuda")
        tx = [p for p in tx_packets if p.start_sample + BURST_SPAN_2P4M < rx.step_raw]
        # Into the format's grid, as a front end's gain control would:
        # the main path's 0.7, or the carrier's peak to 0.9.
        head = capture[: rx.n_in]
        scale = 0.7 if case == "scene" else 0.9 / float(np.abs(head).max())
        wire = host_bytes((head * scale).astype(np.complex64), fmt)
        _build.reset_launch_counts()
        found = rx.decode_wire(wire, fmt)
        launches = _build.launch_counts()
        parity = content_parity(found, tx, cfg.decimation)
        log("wire_select", card=card, case=case, samples=int(capture.size), format=fmt,
            reason=reason, reference=want[case], wire_select_ms=select_ms, blocks=rx.n_blocks,
            wire_mb=wire.nbytes / 1e6, tx_packets=len(tx), decoded=len(found),
            content_parity=parity, overflow_blocks=rx.overflow_blocks, launches=launches)
        if [fmt, reason] != want[case]:
            raise RuntimeError(f"wire_select ({case}): {[fmt, reason]}, the reference gives "
                               f"{want[case]}")
        if case == "interferer" and (fmt != "ci8" or "interferer" not in reason):
            raise RuntimeError(f"wire_select: the interferer scene chose {fmt}: {reason}")
        if parity != 1.0 or rx.overflow_blocks:
            raise RuntimeError(f"wire_select ({case}, {fmt}): parity {parity}, "
                               f"{rx.overflow_blocks} overflows")
        paths.append(path_launches(launches, (kernel_of[fmt], "matched_filter")))
        del capture, head
    return paths


def phase_debug_taps(card: str) -> dict:
    """`make_debug_taps` on one 16384-sample channel-rate block holding the
    golden packet: K2 launches once, and `corr_mag2` is the plain
    version's |corr|^2 of the same derotated block within K2's tolerance
    (corr atol 2e-4, so |mag2 - plain| <= 4e-4 |corr| + 4e-8)."""
    import torch

    from ais_tpu_torch import _build
    from ais_tpu_torch.core.params import DemodConfig
    from ais_tpu_torch.ops.matched_filter import MatchedFilter, matched_filter_plain
    from ais_tpu_torch.pipeline.receiver import make_debug_taps, preamble_waveform
    from ais_tpu_torch.scene import BASE_PAYLOAD
    from ais_tpu_torch.tx import aivdm_payload_to_bytes, make_packet_iq

    cfg, block_len, at = DemodConfig(), 16384, 5000
    rng = np.random.default_rng(SEED)
    x = ((rng.normal(size=block_len) + 1j * rng.normal(size=block_len)) * 0.02)
    burst = make_packet_iq(aivdm_payload_to_bytes(BASE_PAYLOAD), 5)
    x[at: at + burst.size] += burst
    taps_fn = make_debug_taps(cfg, block_len, device="cuda")
    _build.reset_launch_counts()
    taps = taps_fn(x.astype(np.complex64))
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    mf = MatchedFilter(preamble_waveform(cfg).astype(np.complex64), device="cuda")
    plain, _ = matched_filter_plain(taps["derotated"][None], mf.taps_conj)
    plain_mag2 = (plain.real ** 2 + plain.imag ** 2)[0]
    err = (taps["corr_mag2"] - plain_mag2).abs()
    within = bool((err <= 4e-4 * plain_mag2.sqrt() + 4e-8).all())
    peak = int(taps["corr_mag2"].argmax())
    out = {"card": card, "block_len": block_len, "packet_at": at, "peak": peak,
           "shapes": {k: list(v.shape) for k, v in taps.items()},
           "devices": sorted({str(v.device) for v in taps.values()}),
           "tolerance": "|mag2 - plain| <= 4e-4*|corr| + 4e-8", "max_abs_err": float(err.max()),
           "within": within, "launches": launches}
    log("debug_taps", **out)
    if launches["matched_filter"] != 1 or not within or abs(peak - at) > 64:
        raise RuntimeError(f"debug_taps: K2 launched {launches['matched_filter']} times, "
                           f"within tolerance: {within}, peak {peak} for a packet at {at}")
    return path_launches(launches, ("matched_filter",))


def phase_modem_bench(card: str) -> dict:
    """The loopback modem bench: one trial in this process (launch
    counts), then `python -m ais_tpu_torch.cli.modem_bench` in a child on
    the card: the three chains at a clean point (20 dB) and a noisy one
    (9 dB).  Every clean trial must decode in each chain."""
    from ais_tpu_torch import _build
    from ais_tpu_torch.cli import modem_bench

    _build.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        modem_bench.main(["--demod", "pll", "--snr-db", "20", "--trials", "1", "--json"])
    launches = _build.launch_counts()
    argv = ["--demod", "all", "--snr-db", "20", "9", "--trials", "3", "--json"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ais_tpu_torch.cli.modem_bench", *argv],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    points = json.loads(lines[-1])["points"] if proc.returncode == 0 and lines else []
    log("modem_bench", card=card, argv=argv, rc=proc.returncode, subprocess_s=seconds,
        points=points, launches=launches)
    clean = [p for p in points if p["snr_db"] == 20.0]
    if proc.returncode != 0 or sorted(p["demod"] for p in clean) != ["feedforward", "mlse", "pll"] \
            or any(p["decoded"] != p["trials"] for p in clean):
        raise RuntimeError(f"modem_bench (rc {proc.returncode}): {points} {proc.stderr[-2000:]}")
    return path_launches(launches, ("matched_filter",))


def phase_ais_scope(card: str) -> dict:
    """`ais_scope`'s panel data on the golden 250 ksps capture, computed on
    the card: channel A through the `ChannelReceiver` front end (K5, the
    resampler), then the taps block by block (K2).  The correlator peak
    must lie at the packet (24 000 channel samples in, less the front
    end's delay) and the drawn threshold must be `autocorr_threshold`'s.
    The PNG is rendered only where matplotlib is installed."""
    import importlib.util

    from ais_tpu_torch import _build
    from ais_tpu_torch.cli import ais_scope
    from ais_tpu_torch.pipeline.receiver import preamble_waveform
    from ais_tpu_torch.scene import golden_capture
    from ais_tpu_torch.sync.corr import autocorr_threshold

    rate, packet_at, threshold = 250e3, 24_000, 0.9
    iq = golden_capture(rate)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    baseband, cfg = ais_scope.scoped_baseband(iq, rate, "A", "cuda")
    panels = ais_scope.compute_panels(iq, baseband, cfg, threshold, rate, device="cuda")
    seconds = time.perf_counter() - t0
    launches = _build.launch_counts()
    want_thr = autocorr_threshold(preamble_waveform(cfg), threshold)
    peak, thr = panels["peak"], panels["thr"]
    rendered = importlib.util.find_spec("matplotlib") is not None
    if rendered:
        png = REPO / "build" / "chip_smoke" / "scope.png"
        png.parent.mkdir(parents=True, exist_ok=True)
        ais_scope.render(iq, baseband, cfg, threshold, str(png), rate, device="cuda")
        rendered = png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    log("ais_scope", card=card, rate=rate, baseband_samples=int(baseband.size), peak=peak,
        packet_at=packet_at, corr2_at_peak=float(panels["corr2"][peak]), thr=float(thr),
        autocorr_threshold=float(want_thr), freq_chunks=int(panels["freq_est_hz"].size),
        seconds=seconds, rendered=rendered, launches=launches)
    if not packet_at - 256 <= peak <= packet_at + 256 or thr != want_thr \
            or panels["corr2"][peak] <= thr:
        raise RuntimeError(f"ais_scope: peak {peak} (packet at {packet_at}), thr {thr} "
                           f"(autocorr_threshold {want_thr})")
    return path_launches(launches, ("channelizer", "matched_filter"))


def mesh_fields(mesh) -> dict:
    return {"n_shards": mesh.n_shards, "n_physical": mesh.n_physical}


def mesh_kernels(launches: dict) -> dict:
    """K1, K2 and K5's counts, as every mesh phase prints them."""
    return {k: launches[k] for k in ("wire_channelizer_cr1", "matched_filter", "channelizer")}


def record_packets(rec, demod_cfg, core_len: int, designator: str) -> list:
    """Host decode of burst records with a leading block axis, block b at
    channel sample b * core_len, one deduper."""
    from ais_tpu_torch.pipeline.host import PacketDeduper, deframe_records

    return deframe_records(rec, 0, core_len, designator, PacketDeduper(),
                           fftlen=demod_cfg.fftlen,
                           samples_per_symbol=demod_cfg.samples_per_symbol)


def phase_sharded_wire(card: str, main_path: dict, tx_packets) -> dict:
    """The main path split over MESH_WIRE_SHARDS shards of the time mesh:
    one overlap-save wire step of N_BLOCKS / MESH_WIRE_SHARDS blocks a
    shard (K = 24, 14 lanes a (channel, block)), whose spans cover the
    bench step's blocks and n_in exactly; its packets must be the single-
    device step's, packet for packet."""
    from ais_tpu_torch import _build
    from ais_tpu_torch.parallel import make_sharded_wire_pipeline, make_time_mesh
    from ais_tpu_torch.pipeline.wideband import WidebandReceiver
    from ais_tpu_torch.scene import content_parity

    shards = MESH_WIRE_SHARDS
    cfg, n_in = bench_geometry(N_BLOCKS // shards)
    rx = WidebandReceiver(cfg, n_in=n_in, device="cuda")
    step_raw, single = rx.step_raw, main_path["rx"]
    if shards * step_raw != single.step_raw or (shards - 1) * step_raw + n_in != single.n_in:
        raise RuntimeError(f"{shards} steps of {step_raw} do not cover the bench step")
    wire = main_path["wire"]
    spans = np.stack([wire[d * step_raw // 8: (d * step_raw + n_in) // 8]
                      for d in range(shards)])
    ph = np.stack([rx._phase0s(d * step_raw) for d in range(shards)])
    mesh = make_time_mesh(shards)
    fn = make_sharded_wire_pipeline(cfg, n_in, mesh, fmt="cr1")

    def step():
        rx.reset_dedup()
        t0 = time.perf_counter()
        rows = fn(spans, ph).cpu().numpy()
        t1 = time.perf_counter()
        packets = []
        for d in range(shards):
            packets.extend(rx.decode_fetched((rows[d], d * step_raw // cfg.decimation,
                                              spans[d], "cr1", d * step_raw)))
        return packets, t1 - t0, time.perf_counter() - t1

    _build.reset_launch_counts()
    found, _, _ = step()
    times = [step()[1:] for _ in range(TIMED_STEPS)]
    launches = _build.launch_counts()
    steps = 1 + TIMED_STEPS
    diff = packet_diff(found, packet_keys(main_path["packets"]))
    wall = [(a + b) * 1e3 for a, b in times]
    out = {"card": card, **mesh_fields(mesh), "blocks_per_shard": rx.n_blocks,
           "n_in_per_shard": n_in, "step_raw_per_shard": step_raw,
           "compact_lanes": cfg.compact_lanes, "packets": len(found),
           "single_device_packets": len(main_path["packets"]),
           "content_parity": content_parity(found, tx_packets, cfg.decimation),
           "overflow_blocks": rx.overflow_blocks, "steps": steps,
           "wall_ms": wall, "wall_ms_median": statistics.median(wall),
           "device_and_fetch_ms_median": statistics.median(a * 1e3 for a, _ in times),
           "host_ms_median": statistics.median(b * 1e3 for _, b in times),
           "single_device_step_ms_median": main_path["step_ms_median"],
           "single_device_host_ms": main_path["host_ms_per_step"],
           "kernels": mesh_kernels(launches), "differ": diff}
    log("sharded_wire", **out)
    if diff["only_port"] or diff["only_reference"] or out["content_parity"] != 1.0:
        raise RuntimeError(f"sharded wire: the packets differ from the single-device step's: "
                           f"{ {k: len(v) for k, v in diff.items()} }")
    if rx.overflow_blocks:
        raise RuntimeError(f"sharded wire: {rx.overflow_blocks} blocks overflowed")
    on_path = path_launches(launches, ("wire_channelizer_cr1", "matched_filter"))
    if any(n != shards * steps for n in on_path.values()):
        raise RuntimeError(f"K1 and K2 should launch once a shard step: {on_path} in {steps} "
                           f"steps of {shards} shards")
    return launches


def phase_mesh_demods(card: str, main_path: dict) -> tuple[list, np.ndarray]:
    """sharded_demod, halo_exchange and stream_sharded on the bench step's
    channels at 48 ksps (K1 on its wire bytes): 96 blocks over
    MESH_SHARDS shards, each packet set held to the single-device
    `BasebandReceiver` on the same stream.  Returns the phases' launch
    counts and channel A's stream."""
    import torch

    from ais_tpu_torch import _build
    from ais_tpu_torch.parallel import (
        make_halo_exchange_demod, make_sharded_demod, make_sharded_stream_demod,
        make_stream_time_mesh, make_time_mesh,
    )
    from ais_tpu_torch.pipeline.api import BasebandReceiver

    rx = main_path["rx"]
    cfg, core, block = rx.demod_cfg, rx.core_len, rx.cfg.block_len
    halo = block - core
    raw = torch.from_numpy(main_path["wire"]).to("cuda")
    chans = rx.wire_channels(raw, torch.from_numpy(rx._phase0s(0)).to("cuda"), "cr1")
    blocks = chans.unfold(-1, block, core)[:, : rx.n_blocks]           # (2, 96, block)
    names = rx.cfg.designators

    def single(stream: np.ndarray, designator: str) -> tuple[list, float]:
        t0 = time.perf_counter()
        found = BasebandReceiver(demod=cfg, designator=designator, device="cuda").process(stream)
        return found, (time.perf_counter() - t0) * 1e3

    def check(phase: str, mesh, packets: list, want: list, wall_ms: float, single_ms: float,
              launches: dict, **extra) -> dict:
        diff = packet_diff(packets, packet_keys(want))
        log(phase, card=card, **mesh_fields(mesh), blocks=int(blocks.shape[1]),
            packets=len(packets), single_device_packets=len(want), wall_ms=wall_ms,
            single_device_ms=single_ms, kernels=mesh_kernels(launches), **extra,
            differ=diff)
        if diff["only_port"] or diff["only_reference"] or not packets:
            raise RuntimeError(f"{phase}: the packets differ from one device's: {diff}")
        if launches["matched_filter"] != mesh.n_shards:
            raise RuntimeError(f"{phase}: K2 launched {launches['matched_filter']} times "
                               f"for {mesh.n_shards} shards")
        return launches

    streams = [chans[c].cpu().numpy() for c in range(2)]
    wants = [single(streams[c], names[c]) for c in range(2)]
    mesh = make_time_mesh(MESH_SHARDS)
    out = []

    fn = make_sharded_demod(cfg, block, core, mesh)
    fn(blocks[0])  # warm-up: the replicas' first launches
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    found = record_packets(fn(blocks[0]), cfg, core, names[0])
    wall = (time.perf_counter() - t0) * 1e3
    out.append(check("sharded_demod", mesh, found, wants[0][0], wall, wants[0][1],
                     _build.launch_counts()))

    # Halo exchange against duplication on one stream: the head zeroed
    # and the tail padded with zeros, so the ring's wrap (shard 0's
    # head) is what the duplication path sees after the last block.
    s = chans[0, : rx.n_blocks * core].clone()
    s[:halo] = 0
    dup = fn(torch.cat([s, torch.zeros(halo, dtype=s.dtype, device=s.device)])
             .unfold(0, block, core))
    exch = make_halo_exchange_demod(cfg, block, core, mesh, rx.n_blocks)
    exch(s.reshape(rx.n_blocks, core))
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rec = exch(s.reshape(rx.n_blocks, core))
    found = record_packets(rec, cfg, core, names[0])
    wall = (time.perf_counter() - t0) * 1e3
    launches = _build.launch_counts()
    lanes = torch.zeros(rec.valid.shape, dtype=torch.bool, device=rec.valid.device)
    for name in ("position", "center", "phase", "mag", "valid", "bits", "bit_valid",
                 "win_start", "rssi"):
        a, b = getattr(rec, name), getattr(dup, name)
        lanes |= (a != b).reshape(*lanes.shape, -1).any(-1)
    identical = all(torch.equal(a, b) for a, b in zip(rec, dup))
    dup_packets = record_packets(dup, cfg, core, names[0])
    want, single_ms = single(s.cpu().numpy(), names[0])
    if packet_keys(dup_packets) != packet_keys(want):
        raise RuntimeError("halo_exchange: the duplication path's packets differ from one device's")
    out.append(check("halo_exchange", mesh, found, want, wall, single_ms, launches,
                     bit_identical_to_duplication=identical,
                     lanes_differing=int(lanes.sum()), duplication_packets=len(dup_packets)))

    grid = make_stream_time_mesh(2, MESH_SHARDS // 2)
    fn2 = make_sharded_stream_demod(cfg, block, core, grid)
    fn2(blocks)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rec = fn2(blocks)
    found = [record_packets(rec._make(t[c] for t in rec), cfg, core, names[c]) for c in range(2)]
    wall = (time.perf_counter() - t0) * 1e3
    launches = _build.launch_counts()
    for c in range(2):
        diff = packet_diff(found[c], packet_keys(wants[c][0]))
        if diff["only_port"] or diff["only_reference"]:
            raise RuntimeError(f"stream_sharded: channel {names[c]} differs from one device's")
    out.append(check("stream_sharded", grid, found[0] + found[1], wants[0][0] + wants[1][0],
                     wall, wants[0][1] + wants[1][1], launches, grid=list(grid.shape),
                     packets_per_stream=[len(f) for f in found]))
    return out, streams[0]


def phase_distributed_stream(card: str, main_path: dict, stream: np.ndarray) -> dict:
    """`DistributedStreamDecoder` over channel A of the bench step in
    unaligned chunks of DIST_CHUNK samples, DIST_BLOCKS_PER_CALL blocks a
    call over MESH_SHARDS shards: the one-shot `DistributedBlockDecoder`'s
    packets, packet for packet."""
    from ais_tpu_torch import _build
    from ais_tpu_torch.parallel.distributed import (
        DistributedBlockDecoder, DistributedStreamDecoder,
    )

    cfg = main_path["rx"].demod_cfg
    one_shot = DistributedBlockDecoder(cfg, n_devices=MESH_SHARDS)
    want = one_shot.decode_stream(stream)
    sd = DistributedStreamDecoder(cfg, n_devices=MESH_SHARDS,
                                  blocks_per_call=DIST_BLOCKS_PER_CALL)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    found = []
    for lo in range(0, stream.size, DIST_CHUNK):
        found.extend(sd.process(stream[lo: lo + DIST_CHUNK]))
    found.extend(sd.flush())
    wall = (time.perf_counter() - t0) * 1e3
    launches = _build.launch_counts()
    diff = packet_diff(found, packet_keys(want))
    log("distributed_stream", card=card, **mesh_fields(sd.block.mesh),
        world_size=sd.block.world_size, chunk=DIST_CHUNK, blocks_per_call=sd.blocks_per_call,
        calls=sd._pos // sd.step, packets=len(found), one_shot_packets=len(want),
        wall_ms=wall, kernels=mesh_kernels(launches), differ=diff)
    if diff["only_port"] or diff["only_reference"] or not found:
        raise RuntimeError(f"distributed_stream: the packets differ from one-shot's: {diff}")
    return launches


def phase_two_process(card: str) -> dict:
    """Two `python -m ais_tpu_torch.parallel.worker` children in one gloo
    group, rank r on card r % device_count, 4 shards each: both must
    write the packets one process decodes (the 4 of the synthesized
    capture).  Returns the children's launch counts, summed."""
    import socket
    import tempfile

    from ais_tpu_torch.parallel.distributed import DistributedBlockDecoder
    from ais_tpu_torch.parallel.worker import synthesize

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{s.getsockname()[1]}"
    with tempfile.TemporaryDirectory() as tmp:
        outs = [Path(tmp) / f"rank{r}.json" for r in range(2)]
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "ais_tpu_torch.parallel.worker", coordinator, "2", str(r),
             str(outs[r])],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        try:
            errors = [p.communicate(timeout=300)[1] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        wall = time.perf_counter() - t0
        if any(p.returncode for p in procs):
            raise RuntimeError(f"two_process: a worker failed: {[e[-2000:] for e in errors]}")
        results = [json.loads(path.read_text()) for path in outs]
    dec = DistributedBlockDecoder(n_devices=8)
    want = [{"nmea": p.nmea, "abs_sample": p.abs_sample}
            for p in dec.decode_stream(synthesize(dec.core_len * 8))]
    launches = {k: sum(r["launches"][k] for r in results) for k in results[0]["launches"]}
    log("two_process", card=card, n_processes=results[0]["n_processes"],
        n_shards=results[0]["n_shards"], n_physical=len({r["device"] for r in results}),
        devices=[r["device"] for r in results], packets=[len(r["packets"]) for r in results],
        one_process_packets=len(want), wall_s=wall,
        decode_ms=[r["decode_s"] * 1e3 for r in results], kernels=mesh_kernels(launches))
    if results[0]["packets"] != results[1]["packets"] or results[0]["packets"] != want \
            or len(want) != 4:
        raise RuntimeError(f"two_process: packets {results[0]['packets']} / "
                           f"{results[1]['packets']}, one process {want}")
    return launches


def phase_dryrun_multichip(card: str) -> dict:
    """`dryrun_multichip(4)`: each sharded program once on tiny shapes."""
    from ais_tpu_torch import _build
    from ais_tpu_torch.parallel.dryrun import dryrun_multichip

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = dryrun_multichip(4)
    wall = (time.perf_counter() - t0) * 1e3
    launches = _build.launch_counts()
    log("dryrun_multichip", card=card, **out, packets=0, wall_ms=wall,
        kernels=mesh_kernels(launches))
    path_launches(launches, ("wire_channelizer_cr1", "matched_filter"))
    return launches


def phase_mesh(card: str, main_path: dict, tx_packets) -> list:
    """The mesh, on this process's cards, and two processes in one group:
    each phase's launch counts."""
    paths = [phase_sharded_wire(card, main_path, tx_packets)]
    mesh_paths, stream_a = phase_mesh_demods(card, main_path)
    return paths + [*mesh_paths, phase_distributed_stream(card, main_path, stream_a),
                    phase_two_process(card), phase_dryrun_multichip(card)]


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
    rows.append(phase_k3_template())
    phase_k5_shapes(cfg)
    # The yardstick at each n_in a channelizer's row was timed at.
    fir_only_ms = {n: phase_fir_only(cfg, n)
                   for n in sorted({row["n_in"] for row in rows if "n_in" in row})}
    iq, tx_packets = phase_scene(cfg, n_in)
    card = env["card"]
    main_path = phase_main_path(cfg, n_in, card, iq, tx_packets)
    fan_paths = phase_fan(card, main_path)
    complex_path = phase_complex_iq(cfg, n_in, card, iq, tx_packets)["launches"]
    formats = phase_wire_formats(cfg, n_in, card, iq, tx_packets)
    # Launches a step on the path that uses each kernel: the cr1 path's
    # counts over its steps; the other paths' counts are of one step.
    per_step = {k: main_path["launches"][k] / main_path["steps"]
                for k in ("wire_channelizer_cr1", "matched_filter")}
    per_step["channelizer"] = complex_path["channelizer"]
    for fmt in ("ci2", "ci4", "cu8"):
        per_step[f"wire_channelizer_{fmt}"] = formats[fmt][f"wire_channelizer_{fmt}"]
    per_step["wire_channelizer_ci1_mma"] = formats["ci1"]["wire_channelizer_ci1_mma"]
    ci1_ppm = phase_wire_ci1_ppm(card, iq, tx_packets)
    per_step["wire_channelizer_ci1"] = ci1_ppm["wire_channelizer_ci1"]
    paths = [main_path["launches"], *fan_paths, complex_path, *formats.values(), ci1_ppm,
             phase_radio_wideband_ppm(card, iq, tx_packets),
             phase_mlse(cfg, n_in, card, iq, tx_packets),
             phase_overflow(card, iq, tx_packets)]
    # This slice's paths: the other timing formulations on the cr1 main
    # path, wire-format selection, the debug taps and the two CLIs.
    paths += [phase_timing_mode(phase, cfg, n_in, card, main_path["wire"], tx_packets)
              for phase in TIMING_MODES]
    paths += phase_wire_select(card, iq, tx_packets)
    del iq
    paths += phase_mesh(card, main_path, tx_packets)
    paths += [phase_radio_channels(card), phase_ais_rx(card), phase_debug_taps(card),
              phase_modem_bench(card), phase_ais_scope(card)]
    # Each kernel's launches over the paths that drive it (the probe's
    # over its own phase).
    for row in rows:
        if row["name"] != "probe":
            row["launches"] = sum(counts.get(row["name"], 0) for counts in paths)
            row["launches_per_step"] = per_step[row["name"]]
        if "channelizer" in row["name"]:
            row["library_ms"], row["library_call"] = fir_only_ms[row["n_in"]], FIR_ONLY
    if min(row["launches"] for row in rows) <= 0:
        raise RuntimeError(f"a kernel was never launched: {rows}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["device_name"], "count": env["device_count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
