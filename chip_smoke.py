#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`ais_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Drives the port's main path — cr1 wire bytes to AIS packets through
`WidebandReceiver.decode_wire` — at the benchmark geometry (96 demod
blocks a call, K = 24, compact_lanes = 2688) on the full-load TDMA
scene, in phases, one result line each:

  1. environment: the card (nvidia-smi name and power limit), torch and
     CUDA versions, the TF32 flags, the native host library;
  2. build: nvcc builds the kernels of `ais_tpu_torch/csrc/` (sm_90a);
  3. K1 (wire channelizer) against its plain PyTorch version at the
     main path's shapes, with the median time of each;
  4. K2 (matched filter) against its plain version, likewise;
  5. main path: a warm-up decode whose packets must match the
     transmitted ones (content parity 1.0), then timed steps; both
     kernels' launch counts over this phase must be > 0 and no block
     may overflow its burst table or the lane directory.

Any failed check raises, so the script exits non-zero and prints no
result.  The second-to-last line is a JSON object with one entry per
kernel; the last line is {"ok": true, "device": {...}}.  It needs one
CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N_BLOCKS = 96
TIMED_STEPS = 5
SEED = 7


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def phase_k1(cfg, n_in: int) -> dict:
    import torch

    from ais_tpu_torch import _build
    from ais_tpu_torch.ops.fir import mixer_phase
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
    ph = np.stack([mixer_phase(o, cfg.input_rate, 123_456_789) for o in cfg.offsets_hz])
    car = rotate_carrier(chan.carrier, torch.from_numpy(ph).to(dev))

    def kernel():
        return wire_channelizer_cr1(raw, car, chan.taps, decim=chan.decim, n_in=n_in)

    def plain():
        return wire_channelizer_cr1_plain(raw, car, chan.taps, chan.decim, n_in)

    got, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = (got - ref).abs()
    bound = 2e-5 * ref.abs().max() + 2e-4 * ref.abs()
    max_err = float(err.max())
    ok = bool(torch.isfinite(got).all()) and bool((err <= bound).all())
    t_kernel = cuda_ms(kernel, 20)
    t_plain = cuda_ms(plain, 5)
    row = {
        "name": "wire_channelizer_cr1", "route": "cuda",
        "source": "ais_tpu_torch/csrc/wire_channelizer.cu",
        "replaces": "ais_tpu/ops/pallas_fir.py:630",
        "max_abs_err": max_err, "ms": t_kernel, "plain_ms": t_plain,
    }
    log("k1", shape=list(got.shape), n_in=n_in, scale=float(ref.abs().max()),
        tolerance="|err| <= 2e-5*max|y| + 2e-4*|y|", within=ok,
        launches=_build.WIRE_CHANNELIZER_CR1.launches, **row)
    if not ok:
        raise RuntimeError(f"K1 disagrees with its plain version: max|err| {max_err}")
    return row


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


def phase_main_path(cfg, n_in: int, card: str) -> dict:
    import torch

    from ais_tpu_torch import _build
    from ais_tpu_torch.ops.convert import host_bytes
    from ais_tpu_torch.pipeline.host import native_available
    from ais_tpu_torch.pipeline.wideband import WidebandReceiver
    from ais_tpu_torch.scene import content_parity, full_load_scene

    if not native_available():
        raise RuntimeError("the native host library did not build (needs g++)")
    rx = WidebandReceiver(cfg, n_in=n_in, device="cuda")
    t0 = time.perf_counter()
    iq, tx_packets = full_load_scene(cfg, rx.n_in, rx.step_raw, seed=SEED)
    wire = host_bytes((iq * 0.7).astype(np.complex64), "cr1")
    del iq
    scene_s = time.perf_counter() - t0

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
        "launches": launches, "scene_s": scene_s, "warmup_s": warm_s,
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
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel of the main path never launched: {launches}")
    if min(n_found) != max(n_found) or n_found[0] < len(tx_packets):
        raise RuntimeError(f"timed steps decoded {n_found} packets")
    log("stages", card=card, **stage_breakdown(rx, wire))
    return out


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
        chans = rx.channelizer(raw, ph)
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


def main() -> int:
    env = phase_environment()
    phase_build()
    cfg, n_in = bench_geometry()
    rows = [phase_k1(cfg, n_in), phase_k2()]
    main_path = phase_main_path(cfg, n_in, env["card"])
    for row in rows:
        row["launches"] = main_path["launches"][row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": env["device_name"], "count": env["device_count"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
