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
     CUDA versions, the TF32 flags, the native host library;
  2. build: nvcc builds the kernels of `ais_tpu_torch/csrc/` (sm_90a);
  3. probe: K6 (2x + y on one tile) against its plain version;
  4. K1 (cr1 wire channelizer), K2 (matched filter), K3 (ci1 wire
     channelizer), K4 (ci2, ci4 wire channelizers) and K5 (float
     channelizer), each against its plain PyTorch version at the
     paths' shapes, with the median time of each; k5_full: K5 with the
     full-length carrier table of a 50 ppm radio at the bench n_in;
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
        "plain_ms": cuda_ms(lambda: probe_plain(x, y), 50), "launches": launches,
    }
    log("probe", shape=list(SHAPE), tolerance="exact (2x + y in fp32)", **row)
    if max_err != 0.0 or launches != 1:
        raise RuntimeError(f"K6 disagrees with 2x + y: max|err| {max_err}, launches {launches}")
    return row


def hold_channelizer(phase: str, kernel, plain, row: dict, **fields) -> dict:
    """Hold a channelizer kernel against its plain version on the same
    inputs (TOLERANCE), then time both; returns the kernels-line row."""
    import torch

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = (got - ref).abs()
    bound = 2e-5 * ref.abs().max() + 2e-4 * ref.abs()
    max_err = float(err.max())
    ok = bool(torch.isfinite(got).all()) and bool((err <= bound).all())
    del got, ref, err, bound
    row = {**row, "route": "cuda", "max_abs_err": max_err,
           "ms": cuda_ms(kernel, 20), "plain_ms": cuda_ms(plain, 5)}
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


def phase_k1(cfg, n_in: int) -> dict:
    import torch

    from ais_tpu_torch.ops.wire_channelizer import (
        WireChannelizer, rotate_carrier, wire_channelizer_cr1,
        wire_channelizer_cr1_plain,
    )
    from ais_tpu_torch.pipeline.wideband import channel_taps

    dev = torch.device("cuda")
    taps = channel_taps(cfg)
    chan = WireChannelizer(taps, cfg.decimation, cfg.offsets_hz, cfg.input_rate,
                           n_in, device=dev)
    rng = np.random.default_rng(SEED)
    raw = torch.from_numpy(rng.integers(0, 256, n_in // 8, dtype=np.uint8)).to(dev)
    car = rotate_carrier(chan.carrier, phase0s_at(cfg, 123_456_789))
    return hold_channelizer(
        "k1",
        lambda: wire_channelizer_cr1(raw, car, chan.taps, decim=chan.decim, n_in=n_in),
        lambda: wire_channelizer_cr1_plain(raw, car, chan.taps, chan.decim, n_in),
        {"name": "wire_channelizer_cr1", "source": "ais_tpu_torch/csrc/wire_channelizer.cu",
         "replaces": "ais_tpu/ops/pallas_fir.py:630"},
        shape=[len(cfg.offsets_hz), chan.n_out], n_in=n_in)


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
             "replaces": "ais_tpu/ops/pallas_fir.py" + replaces},
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
         "replaces": "ais_tpu/ops/pallas_fir.py:171"},
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
    ok = bool(torch.isfinite(corr).all()) and max_err <= 2e-4 and mag2_err <= 1e-6
    t_kernel = cuda_ms(kernel, 50)
    t_plain = cuda_ms(plain, 20)
    row = {
        "name": "matched_filter", "route": "cuda",
        "source": "ais_tpu_torch/csrc/matched_filter.cu",
        "replaces": "ais_tpu/ops/pallas_corr.py:145",
        "max_abs_err": max_err, "ms": t_kernel, "plain_ms": t_plain,
    }
    log("k2", shape=list(corr.shape), tolerance="corr atol 2e-4; mag2 = |corr|^2 rtol 1e-6",
        mag2_rel_err=mag2_err, within=ok, launches=_build.MATCHED_FILTER.launches, **row)
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
    st = rx.collect_stats
    med = statistics.median(step_s)
    out = {
        "card": card, "n_in": rx.n_in, "step_raw": rx.step_raw,
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
    path_launches(launches, ("wire_channelizer_cr1", "matched_filter"))
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
    """An in-memory capture as an `ais_tpu.io.sources.SampleSource`."""

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
         "replaces": "ais_tpu/ops/pallas_fir.py:171"},
        shape=[len(cfg.offsets_hz), chan.n_out], n_in=n_in, offsets_hz=list(shifted.offsets_hz),
        table_mb=chan.carrier.numel() * 4 / 1e6,
        rotate_ms=cuda_ms(lambda: rotate_carrier(chan.carrier, ph), 5))
    row.update(full_table_ms=full["ms"], full_table_plain_ms=full["plain_ms"],
               full_table_max_abs_err=full["max_abs_err"])
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
    from ais_tpu_torch.pipeline.host import native_available
    from ais_tpu_torch.pipeline.wideband import wideband_geometry
    from ais_tpu_torch.scene import full_load_scene

    if not native_available():
        raise RuntimeError("the native host library did not build (needs g++)")
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
    iq, tx_packets = phase_scene(cfg, n_in)
    card = env["card"]
    paths = [phase_main_path(cfg, n_in, card, iq, tx_packets)["launches"],
             phase_complex_iq(cfg, n_in, card, iq, tx_packets)["launches"],
             *phase_wire_formats(cfg, n_in, card, iq, tx_packets).values(),
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
    if min(row["launches"] for row in rows) <= 0:
        raise RuntimeError(f"a kernel was never launched: {rows}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["device_name"], "count": env["device_count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
