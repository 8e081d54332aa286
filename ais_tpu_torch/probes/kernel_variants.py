"""The kernels on the card: this tree's against another checkout's, and
against variants of themselves.

    python3 -m ais_tpu_torch.probes.kernel_variants [--other DIR] [--no-variants]
                                                    [--only k1k2|channelizer] [--sass FILE]

Needs one CUDA device and nvcc.  Every time is the median, over 5 runs,
of one launch among many in a row between one CUDA event pair (no host
time in it), at the benchmark geometry (K1: n_in = 56 682 200, D = 50,
2891 taps, 2 channels; K2: 192 rows of 16384, L = 140; K3, K4, K5: the
same n_in, D, taps and channels as K1, random wire bytes or complex64
samples, K5 also on the full-length table of a 50 ppm radio), on seeded
inputs.  One JSON line a measurement; the first names the card.

  --other DIR   a second checkout of this repository (for example the
                parent commit, unpacked with `git archive` into a
                directory that .gitignore lists).  Its K1 and K2 run in a
                child process on the same inputs, in turns with this
                tree's (other, this, this, other); K2's corr and mag2 are
                compared bit for bit, K1's outputs by max |difference|.
                K3, K4 (ci2, ci4), K5 and K5 on the full-length table run
                the same way through the wrappers both trees have (K3 in
                the form the ci1 path runs: with the module's bit-stream
                taps where the tree has the 1-bit form); each child also
                reports max |err| against its plain version.
  variants      copies of csrc/wire_channelizer.cu and
                csrc/matched_filter.cu with one constant changed (warps a
                block, 16-row tiles a warp, threads a block, blocks a
                multiprocessor), built with nvcc into
                build/ais_tpu_torch/variants/ and launched through
                ctypes; each must reproduce this tree's output exactly.
                `a_four_positions` is timing only: it builds K1's A
                operand from four bit positions a shift (the sign and
                three exponent bits of an fp16) without the B operand to
                match, to see what the integer pipe costs.
                K3's 1-bit form (the same source, its own constants) under
                other warps a block and tiles a warp, and with B read
                through the L1 cache instead of staged in shared memory
                (more blocks a multiprocessor); two timing-only variants
                leave out the A operand's integer work or the mma.  They
                run with `--only channelizer`; `--match k3_` picks them
                alone.
                The channelizer template (K3, K4, K5) takes its outputs a
                thread, tile and threads at run time, so those variants
                call this tree's library with another plan; the compile-
                time ones change the launch bounds (the register cap), the
                blocks a multiprocessor asked for, or drop the compile-time
                decimation.  Each must reproduce this tree's output bit
                for bit (an output's sum has the same order in all);
                three more, timing only, leave out one stage each.  Before
                them `fma_peak` times a kernel of fp32 FMAs alone, with
                the SM clock nvidia-smi reports under that load and under
                K5: the ceiling the card really offers the walk.
  --sass FILE   write the SASS of K5's benchmark instantiation (cuobjdump)
                to FILE and print its opcode counts.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

SEED = 7
REPO = Path(__file__).resolve().parents[2]


def out(**fields) -> None:
    print(json.dumps(fields), flush=True)


def back_to_back_ms(fn, launches: int, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def bench_geometry():
    """The benchmark's receiver geometry (as chip_smoke.py drives it)."""
    from ais_tpu_torch.pipeline.wideband import WidebandConfig, aligned_n_in, num_taps

    cfg = WidebandConfig()
    n48 = cfg.block_len + cfg.core_len * 95
    return cfg, aligned_n_in(cfg, (n48 - 1) * cfg.decimation + num_taps(cfg))


def inputs():
    """K1's module, wire bytes and rotated carrier; K2's rows and taps."""
    import torch

    from ais_tpu_torch.ops.fir import mixer_phase
    from ais_tpu_torch.ops.matched_filter import MatchedFilter
    from ais_tpu_torch.ops.wire_channelizer import WireChannelizer, rotate_carrier
    from ais_tpu_torch.pipeline.wideband import channel_taps, default_constants

    dev = torch.device("cuda")
    cfg, n_in = bench_geometry()
    chan = WireChannelizer(channel_taps(cfg), cfg.decimation, cfg.offsets_hz, cfg.input_rate,
                           n_in, device=dev)
    rng = np.random.default_rng(SEED)
    raw = torch.from_numpy(rng.integers(0, 256, n_in // 8, dtype=np.uint8)).to(dev)
    ph = np.stack([mixer_phase(o, cfg.input_rate, 123_456_789) for o in cfg.offsets_hz])
    car = rotate_carrier(chan.carrier, torch.from_numpy(ph).to(dev)).contiguous()
    pre = default_constants(cfg).preamble
    x = ((rng.normal(size=(192, 16384)) + 1j * rng.normal(size=(192, 16384))) * 0.1)
    x = x.astype(np.complex64)
    for row in x:
        for s in rng.integers(0, row.size - pre.size, 4):
            row[s: s + pre.size] += pre
    return chan, raw, car, MatchedFilter(pre, device=dev), torch.from_numpy(x).to(dev), n_in


RADIO_PPM = 50.0
CHANNELIZER_KERNELS = ("k3", "k4_ci2", "k4_ci4", "k5", "k5_full")


def channelizer_inputs(name: str):
    """(kernel, plain) closures of one of K3, K4, K5 at the bench geometry
    on seeded inputs, through the wrappers."""
    import torch

    from ais_tpu_torch.ops import channelizer as ch
    from ais_tpu_torch.ops import wire_channelizer as wc
    from ais_tpu_torch.ops.fir import mixer_phase
    from ais_tpu_torch.pipeline.radio import ppm_offset_hz
    from ais_tpu_torch.pipeline.wideband import channel_taps, wire_nbytes

    dev = torch.device("cuda")
    cfg, n_in = bench_geometry()
    offsets = cfg.offsets_hz
    if name == "k5_full":
        offsets = tuple(o + ppm_offset_hz(RADIO_PPM) for o in offsets)
    chan = ch.Channelizer(channel_taps(cfg), cfg.decimation, offsets, cfg.input_rate, n_in,
                          device=dev)
    ph = np.stack([mixer_phase(o, cfg.input_rate, 123_456_789) for o in offsets])
    car = ch.rotate_carrier(chan.carrier, torch.from_numpy(ph).to(dev)).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(SEED + len(name))
    if name.startswith("k5"):
        x = torch.complex(torch.randn(n_in, device=dev, generator=gen),
                          torch.randn(n_in, device=dev, generator=gen)) * 0.3
        return (lambda: ch.freq_xlating_polyphase(x, car, chan.taps, decim=chan.decim),
                lambda: ch.freq_xlating_polyphase_plain(x, car, chan.taps, chan.decim))
    fmt = {"k3": "ci1", "k4_ci2": "ci2", "k4_ci4": "ci4"}[name]
    raw = torch.randint(0, 256, (wire_nbytes(fmt, n_in),), device=dev,
                        dtype=torch.uint8, generator=gen)
    extra = {}
    if fmt == "ci1" and hasattr(wc, "ci1_mma_supported"):
        # As the ci1 path launches K3: the module's bit-stream taps.  (A
        # checkout from before the 1-bit form runs the template.)
        extra["folded"] = wc.PackedWireChannelizer(
            "ci1", channel_taps(cfg), cfg.decimation, offsets, cfg.input_rate, n_in,
            device=dev).folded
    return (lambda: wc.wire_channelizer_packed(fmt, raw, car, chan.taps, decim=chan.decim,
                                               n_in=n_in, **extra),
            lambda: wc.wire_channelizer_packed_plain(fmt, raw, car, chan.taps, chan.decim))


def run_channelizers(save_to: str | None) -> dict:
    """Time K3, K4, K5 through this checkout's wrappers, with max |err|
    against the plain version; optionally save the outputs."""
    import torch

    res = {}
    for name in CHANNELIZER_KERNELS:
        kernel, plain = channelizer_inputs(name)
        y, ref = kernel(), plain()
        torch.cuda.synchronize()
        res[f"{name}_max_abs_err_vs_plain"] = float((y - ref).abs().max())
        del ref
        if save_to:
            np.save(f"{save_to}_{name}.npy", y.cpu().numpy())
        del y
        res[f"{name}_ms"] = back_to_back_ms(kernel, 20)
        del kernel, plain
        torch.cuda.empty_cache()
    return res


def run_wrappers(save_to: str | None) -> dict:
    """Time K1 and K2 through this checkout's wrappers; optionally save
    their outputs as .npy files with the prefix `save_to`."""
    import torch

    from ais_tpu_torch.ops.matched_filter import matched_filter
    from ais_tpu_torch.ops.wire_channelizer import wire_channelizer_cr1

    chan, raw, car, mf, x, n_in = inputs()
    # A checkout from before the folded taps has no such argument.
    extra = {"folded": chan.folded} if hasattr(chan, "folded") else {}

    def k1():
        return wire_channelizer_cr1(raw, car, chan.taps, decim=chan.decim, n_in=n_in, **extra)

    def k2():
        return matched_filter(x, mf.taps_conj)

    y, (corr, mag2) = k1(), k2()
    torch.cuda.synchronize()
    if save_to:
        for name, t in (("k1", y), ("corr", corr), ("mag2", mag2)):
            np.save(f"{save_to}_{name}.npy", t.cpu().numpy())
    return {"k1_ms": back_to_back_ms(k1, 30), "k2_ms": back_to_back_ms(k2, 100)}


def compare_with(other: Path, only: str | None) -> None:
    which = [w for w in ("k1k2", "channelizer") if only in (None, w)]
    with tempfile.TemporaryDirectory() as tmp:
        for label, cwd in (("other", other), ("this", REPO), ("this", REPO), ("other", other)):
            for what in which:
                # This file, run as a script from the checkout's root: there
                # `ais_tpu_torch` is the checkout's own package.
                proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                                       f"{tmp}/{label}", "--only", what], cwd=cwd,
                                      capture_output=True, text=True)
                lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
                if proc.returncode or not lines:
                    raise RuntimeError(f"{label} ({cwd}) failed:\n{proc.stdout[-2000:]}\n"
                                       f"{proc.stderr[-2000:]}")
                out(checkout=label, path=str(cwd), **json.loads(lines[0][7:]))
        pair = lambda name: (np.load(f"{tmp}/{w}_{name}.npy") for w in ("other", "this"))  # noqa: E731
        if "k1k2" in which:
            same = {}
            for name in ("corr", "mag2"):
                a, b = pair(name)
                same[f"k2_{name}_bit_identical"] = bool(
                    (a.view(np.uint32) == b.view(np.uint32)).all())
            a, b = pair("k1")
            out(compare="this against other", **same,
                k1_max_abs_difference=float(np.abs(a - b).max()), k1_max_abs=float(np.abs(a).max()))
        if "channelizer" in which:
            diff = {}
            for name in CHANNELIZER_KERNELS:
                a, b = pair(name)
                diff[f"{name}_max_abs_difference"] = float(np.abs(a - b).max())
                diff[f"{name}_max_abs"] = float(np.abs(a).max())
            out(compare="this against other", **diff)


A_FOUR_POSITIONS = '''
          const uint32_t w0 = win[mt][0] << (4 * (j >> 1)), w1 = win[mt][1] << (4 * (j >> 1));
          if ((j & 1) == 0) {
            a[0] = and_xor(w0, sign_mask, minus_one); a[1] = and_xor(w1, sign_mask, minus_one);
            a[2] = w0 & 0x40004000u; a[3] = w1 & 0x40004000u;
          } else {
            a[0] = w0 & 0x20002000u; a[1] = w1 & 0x20002000u;
            a[2] = w0 & 0x10001000u; a[3] = w1 & 0x10001000u;
          }
'''
K1_VARIANTS = {
    # name: (warps a block, 16-row tiles a warp, other substitutions)
    "as_built": (4, 4, ()),
    "warps4_mtiles2": (4, 2, ()),
    "warps8_mtiles2": (8, 2, ()),
    "warps8_mtiles1": (8, 1, ()),
    "warps2_mtiles4": (2, 4, ()),
    "warps8_mtiles4": (8, 4, ()),
    "a_four_positions": (4, 4, ((r"\n +a\[0\] = and_xor.*?a\[3\] = [^\n]*\n", A_FOUR_POSITIONS),)),
}
K2_VARIANTS = {
    # name: (threads a block, blocks a multiprocessor asked of the compiler)
    "as_built": (128, 8), "threads64": (64, 16), "threads256": (256, 4),
    "threads128_any_occupancy": (128, None),
}


A_CONSTANT = """
          a[0] = win[mt][0]; a[1] = win[mt][1]; a[2] = win[mt][0] ^ j; a[3] = win[mt][1] ^ j;
"""
_A_BUILD = r"\n +a\[0\] = and_xor.*?a\[3\] = [^\n]*\n"
K3_VARIANTS = {
    # name: (warps a block, 16-row tiles a warp, B staged in shared memory, other substitutions)
    "k3_as_built": (12, 2, True, ()),
    "k3_warps12_mtiles1": (12, 1, True, ()),
    "k3_warps12_mtiles3": (12, 3, True, ()),
    "k3_warps8_mtiles2": (8, 2, True, ()),
    "k3_warps8_mtiles4": (8, 4, True, ()),
    "k3_warps4_mtiles4": (4, 4, True, ()),
    "k3_warps4_mtiles2": (4, 2, True, ()),
    "k3_warps16_mtiles2": (16, 2, True, ()),
    "k3_warps16_mtiles1": (16, 1, True, ()),
    "k3_b_through_l1_warps4_mtiles4": (4, 4, False, ()),
    "k3_b_through_l1_warps12_mtiles2": (12, 2, False, ()),
    "k3_as_built_again": (12, 2, True, ()),
    # Timing only (their outputs are wrong): one stage left out.
    "k3_timing_only_a_without_shift_and_lop3": (12, 2, True, ((_A_BUILD, A_CONSTANT),)),
    "k3_timing_only_no_mma": (12, 2, True, (
        (r"for \(int nt = 0; nt < NT; \+\+nt\) mma_m16n8k16\(c\[mt\]\[nt\], a, b\[nt\]\.x, b\[nt\]\.y\);",
         "for (int nt = 0; nt < NT; ++nt) c[mt][nt][0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3]) "
         "& b[nt].x & b[nt].y);"),)),
}


def k3_variants(match: str = "") -> None:
    """K3's 1-bit form at the bench geometry under other block shapes and
    with B unstaged; each output-preserving one must reproduce this
    tree's output bit for bit (an output's sum has the same order in all)."""
    import torch

    from ais_tpu_torch import _build
    from ais_tpu_torch.ops import channelizer as ch
    from ais_tpu_torch.ops import wire_channelizer as wc
    from ais_tpu_torch.pipeline.wideband import channel_taps

    picked = {k: v for k, v in K3_VARIANTS.items() if re.search(match, k)}
    if not picked:
        return
    started = [start_variant(_build.CSRC / "wire_channelizer.cu", (
        (r"constexpr int kCi1Warps = \d+;", f"constexpr int kCi1Warps = {warps};"),
        (r"constexpr int kCi1MTiles = \d+;", f"constexpr int kCi1MTiles = {mtiles};"),
        (r"constexpr bool kStageB = \w+;", f"constexpr bool kStageB = {str(staged).lower()};"),
        *subs), name) for name, (warps, mtiles, staged, subs) in picked.items()]
    dev = torch.device("cuda")
    cfg, n_in = bench_geometry()
    mod = wc.PackedWireChannelizer("ci1", channel_taps(cfg), cfg.decimation, cfg.offsets_hz,
                                   cfg.input_rate, n_in, device=dev)
    car = ch.rotate_carrier(mod.carrier, torch.tensor([0.4, 2.9], device=dev)).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    raw = torch.randint(0, 256, (n_in // 4,), device=dev, dtype=torch.uint8, generator=gen)
    ref = wc.wire_channelizer_packed("ci1", raw, car, mod.taps, decim=mod.decim, n_in=n_in,
                                     folded=mod.folded)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream().cuda_stream
    bit_taps, n_chan = 2 * mod.taps.numel(), car.shape[0]
    for start, (name, (warps, mtiles, staged, _)) in zip(started, picked.items()):
        lib, regs, _ = finish_variant(start)
        fn = lib.ais_wire_channelizer_ci1_mma
        fn.argtypes = _build.WIRE_CHANNELIZER_CI1_MMA.argtypes
        fn.restype = ctypes.c_int
        tile = warps * 16 * mtiles
        words = wc.tile_words(bit_taps, 2 * mod.decim, tile)
        got = torch.empty_like(ref)

        def k3():
            rc = fn(raw.data_ptr(), car.data_ptr(), mod.frags.data_ptr(),
                    torch.view_as_real(got).data_ptr(), raw.numel(), mod.n_out,
                    wc.n_super_steps(bit_taps), words, tile, mod.decim, car.shape[1], n_chan,
                    mod.unscale, stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        try:
            ms = back_to_back_ms(k3, 20)
        except RuntimeError as err:          # a shape the card refuses: say so and go on
            out(kernel="K3", variant=name, outputs_a_tile=tile, registers=regs, refused=str(err))
            continue
        smem = (wc.kernel_smem_bytes(bit_taps, 2 * mod.decim, n_chan, tile) if staged
                else 4 * words)
        out(kernel="K3", variant=name, outputs_a_tile=tile, b_staged=staged, smem=smem,
            registers=regs, ms=ms, equals_as_built=bool(torch.equal(got, ref)))


def start_variant(source: Path, subs, name: str):
    """Start nvcc on a copy of `source` with regex substitutions."""
    from ais_tpu_torch import _build

    text = source.read_text()
    for pattern, replacement in subs:
        text, n = re.subn(pattern, lambda _m: replacement, text, flags=re.S)
        if n < 1:
            raise RuntimeError(f"{name}: {pattern!r} not found in {source.name}")
    vdir = _build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    cu, so = vdir / f"{source.stem}_{name}.cu", vdir / f"{source.stem}_{name}.so"
    cu.write_text(text)
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return name, proc, so


def finish_variant(started):
    """(library, ptxas's register counts) of a started build."""
    name, proc, so = started
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed:\n{log}")
    return ctypes.CDLL(str(so)), [int(r) for r in re.findall(r"Used (\d+) registers", log)], log


def build_variant(source: Path, subs, name: str):
    """nvcc a copy of `source` with regex substitutions; (library, registers)."""
    lib, regs, _ = finish_variant(start_variant(source, subs, name))
    return lib, regs


# The channelizer template's plan at run time: (R outputs a thread, T
# outputs a tile, threads a block); its shared memory follows.
PLAN_VARIANTS = {
    "as_planned": None,
    "r8_tile104_threads672": (8, 104, 672),
    "r8_tile112_threads704": (8, 112, 704),
    "r8_tile96_threads608": (8, 96, 608),
    "r8_tile64_threads416": (8, 64, 416),
    "r8_tile48_threads320_two_blocks_fit": (8, 48, 320),
    "r8_tile32_threads224_two_blocks_fit": (8, 32, 224),
    "r4_tile60_threads768": (4, 60, 768),
    "r4_tile32_threads416_two_blocks_fit": (4, 32, 416),
    "r1_tile15_threads768": (1, 15, 768),
}
# Compile-time: (substitutions, plan or None for this tree's).
_BOUNDS = r"constexpr int kMaxThreads = \d+;"
_BLOCKS = r"__launch_bounds__\(kMaxThreads, 1\)"
SOURCE_VARIANTS = {
    "rebuilt_as_is": ((), None),
    "bounds640_96_registers_tile96": (((_BOUNDS, "constexpr int kMaxThreads = 640;"),), (8, 96, 608)),
    "bounds1024_64_registers": (((_BOUNDS, "constexpr int kMaxThreads = 1024;"),), None),
    "bounds320_two_blocks_asked_tile48": (
        ((_BOUNDS, "constexpr int kMaxThreads = 320;"),
         (_BLOCKS, "__launch_bounds__(kMaxThreads, 2)")), (8, 48, 320)),
    # 25 warps (7, 6, 6, 6 on the schedulers) for 16 whole output groups.
    "bounds832_tile128_threads800": (((_BOUNDS, "constexpr int kMaxThreads = 832;"),), (8, 128, 800)),
    "a_block_a_tile": (((r"const int blocks = n_tiles < sms \* resident \? n_tiles : sms \* resident;",
                         "const int blocks = n_tiles;"),), None),
    "prologue_loop_left_by_whole_warps": (((r"\(S == 1 \? u : u - lane\) < n_units",
                                            "u - lane < n_units"),), None),
    # 16 outputs a thread: half the sample loads an FMA, 512 threads of up to 128 registers.
    "r16_tile160_threads512": (
        ((_BOUNDS, "constexpr int kMaxThreads = 512;"),
         (r"    case 8:\n", "    case 16:\n      if constexpr (NCH <= 2) return "
          "launch_decim<Decode, NCH, 16>(src, car, taps, out, g, stream);\n    case 8:\n")),
        (16, 160, 512)),
    "decimation_at_run_time": (((r"if \(g\.decim == 50\)", "if (false)"),), None),
    # Timing only (their outputs are wrong): one stage of the kernel left out.
    "timing_only_no_prologue": (((r"const int n_units = [^;]*;", "const int n_units = 0;"),), None),
    "timing_only_no_walk": (((r"const bool live = item < n_items;",
                              "const bool live = item < n_items && n_out < 0;"),), None),
    "timing_only_walk_without_sample_loads": (
        ((r"load_z<NCH>\(zp \+ u \* row_stride, z\);",
          "for (int c = 0; c < NCH; ++c) z[c] = make_float2(c + 1.0f, c + 1.5f);"),), None),
    "timing_only_walk_without_tap_loads": (((r"= hp\[u \* D\];", "= 0.5f + u;"),), None),
    "timing_only_launch_and_taps": (
        ((r"const int n_units = [^;]*;", "const int n_units = 0;"),
         (r"const bool live = item < n_items;", "const bool live = item < n_items && n_out < 0;"),
         (r"for \(int ph = 0; ph < D; \+\+ph\)", "for (int ph = 0; ph < 1; ++ph)")), None),
    "timing_only_no_phase_sum": (((r"for \(int ph = 0; ph < D; \+\+ph\)",
                                   "for (int ph = 0; ph < 1; ++ph)"),), None),
}


def channelizer_variants(match: str = "") -> None:
    """K5 (and K4 ci2 on the plan variants) at the bench geometry under
    other plans and other builds of csrc/channelizer.cu."""
    import torch

    from ais_tpu_torch import _build
    from ais_tpu_torch.ops import channelizer as ch
    from ais_tpu_torch.pipeline.wideband import channel_taps

    dev = torch.device("cuda")
    cfg, n_in = bench_geometry()
    chan = ch.Channelizer(channel_taps(cfg), cfg.decimation, cfg.offsets_hz, cfg.input_rate,
                          n_in, device=dev)
    car = ch.rotate_carrier(chan.carrier, torch.zeros(2, device=dev)).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.complex(torch.randn(n_in, device=dev, generator=gen),
                      torch.randn(n_in, device=dev, generator=gen)) * 0.3
    raw = torch.randint(0, 256, (n_in // 2,), device=dev, dtype=torch.uint8, generator=gen)
    stream = torch.cuda.current_stream().cuda_stream
    ntaps, decim, n_chan, q = chan.taps.numel(), chan.decim, car.shape[0], car.shape[1]
    planned = ch.kernel_plan(ntaps, decim, n_chan)
    source_variants = {k: v for k, v in SOURCE_VARIANTS.items() if re.search(match, k)}
    started = [start_variant(_build.CSRC / "channelizer.cu", subs, name)
               for name, (subs, _) in source_variants.items()]
    _build.library()

    def runner(lib, symbol, src, plan, got):
        fn = getattr(lib, symbol)
        fn.argtypes = _build.CHANNELIZER.argtypes
        fn.restype = ctypes.c_int

        def run():
            rc = fn(src.data_ptr(), car.data_ptr(), chan.taps.data_ptr(),
                    torch.view_as_real(got).data_ptr(), n_in, chan.n_out, ntaps, decim, q, n_chan,
                    *plan, stream)
            if rc:
                raise RuntimeError(f"{symbol} {plan}: CUDA error {rc}")
        return run

    sources = (("K5", "ais_channelizer_f32", torch.view_as_real(x).reshape(-1)),
               ("K4 ci2", "ais_wire_channelizer_ci2", raw))
    refs = {}
    for kernel, symbol, src in sources:
        refs[kernel] = torch.empty((n_chan, chan.n_out), dtype=torch.complex64, device=dev)
        runner(_build.library(), symbol, src, planned[:3], refs[kernel])()
    torch.cuda.synchronize()
    for name, plan in PLAN_VARIANTS.items():
        if not re.search(match, name):
            continue
        plan = plan or planned[:3]
        for kernel, symbol, src in sources:
            got = torch.empty_like(refs[kernel])
            ms = back_to_back_ms(runner(_build.library(), symbol, src, plan, got), 20)
            out(kernel=kernel, variant=name, plan=list(plan),
                smem=ch.smem_bytes(*plan, ntaps, decim, n_chan), ms=ms,
                equals_as_built=bool(torch.equal(torch.view_as_real(got),
                                                 torch.view_as_real(refs[kernel]))))
    for start, (name, (_, plan)) in zip(started, source_variants.items()):
        lib, _, log = finish_variant(start)
        regs = re.findall(r"channelizer_kernelINS_9DecodeF32ELi2ELi8ELi\d+E.*?Used (\d+) registers",
                          log, flags=re.S)
        spills = re.findall(r"channelizer_kernelINS_9DecodeF32ELi2ELi8ELi\d+E.*?(\d+) bytes spill "
                            r"stores", log, flags=re.S)
        plan = plan or planned[:3]
        got = torch.empty_like(refs["K5"])
        ms = back_to_back_ms(runner(lib, "ais_channelizer_f32", sources[0][2], plan, got), 20)
        out(kernel="K5", variant=name, plan=list(plan), registers_r8_2ch=regs,
            spill_store_bytes_r8_2ch=spills, ms=ms,
            equals_as_built=bool(torch.equal(torch.view_as_real(got),
                                             torch.view_as_real(refs["K5"]))))


FMA_PEAK_SOURCE = """
#include <cuda_runtime.h>
// 32 independent fp32 FMA chains a thread and nothing else: the rate the
// card's FMA pipes reach at the clocks it holds under that load.
__global__ void __launch_bounds__(1024, 1) fma_peak(float* out, int iters, float a) {
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = threadIdx.x + i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = fmaf(acc[i], a, 1.0f);
  }
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s += acc[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int ais_fma_peak(void* out, int blocks, int threads, int iters, void* stream) {
  fma_peak<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters, 0.999f);
  return static_cast<int>(cudaGetLastError());
}
"""


def fma_peak() -> None:
    """The fp32 FMA rate this card reaches on a kernel that is FMAs alone
    (25 warps a multiprocessor, as K5's plan, and 32), with the SM clock
    nvidia-smi reports while it runs: the ceiling K5's walk is held to."""
    import torch

    from ais_tpu_torch import _build

    vdir = _build.BUILD_DIR / "variants"
    vdir.mkdir(parents=True, exist_ok=True)
    (vdir / "fma_peak.cu").write_text(FMA_PEAK_SOURCE)
    lib, _, _ = finish_variant(start_variant(vdir / "fma_peak.cu", (), "built"))
    fn = lib.ais_fma_peak
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.empty(sms * 1024, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    iters = 20_000
    for threads in (768, 800, 1024):
        def run():
            rc = fn(buf.data_ptr(), sms, threads, iters, stream)
            if rc:
                raise RuntimeError(f"fma_peak: CUDA error {rc}")
        ms = back_to_back_ms(run, 20)
        # Sample the clock while the card is under the same load.
        for _ in range(200):
            run()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
        torch.cuda.synchronize()
        flop = 2.0 * 32 * iters * threads * sms
        out(kernel="fma_peak", threads_a_multiprocessor=threads, ms=ms,
            tflops=flop / ms / 1e9, under_load=smi)


def clocks_under_k5() -> None:
    """The SM clock and power nvidia-smi reports while K5 runs back to back."""
    import torch

    kernel, _ = channelizer_inputs("k5")
    kernel()
    torch.cuda.synchronize()
    for _ in range(400):
        kernel()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    torch.cuda.synchronize()
    out(kernel="K5", under_load=smi)


def sass_report(path: Path) -> None:
    """The SASS of K5's benchmark instantiation (F32, 2 channels, R = 8,
    D = 50) into `path`, and its opcode counts."""
    from ais_tpu_torch import _build

    _build.library()
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", _build.build_info["path"]], capture_output=True,
                          text=True, check=True).stdout
    parts = [f for f in text.split("Function : ") if "DecodeF32ELi2ELi8ELi50E" in f.split("\n")[0]]
    if not parts:
        raise RuntimeError("K5's benchmark instantiation is not in the library")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(parts[0])
    ops = re.findall(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)", parts[0], flags=re.M)
    counts = {}
    for op in ops:
        counts[op.split(".")[0]] = counts.get(op.split(".")[0], 0) + 1
    out(sass=str(path), opcodes=len(ops),
        counts=dict(sorted(counts.items(), key=lambda kv: -kv[1])),
        build_log=[ln for ln in _build.build_info["log"].splitlines()
                   if "DecodeF32ELi2ELi8ELi50E" in ln or "spill" in ln][:12])


def variants() -> None:
    import torch

    from ais_tpu_torch import _build
    from ais_tpu_torch.ops import wire_channelizer as wc
    from ais_tpu_torch.ops.matched_filter import matched_filter

    chan, raw, car, mf, x, n_in = inputs()
    stream = torch.cuda.current_stream().cuda_stream
    ntaps, n_chan = chan.taps.numel(), car.shape[0]
    ref = wc.wire_channelizer_cr1(raw, car, chan.taps, decim=chan.decim, n_in=n_in,
                                  folded=chan.folded)
    ref_corr, ref_mag2 = matched_filter(x, mf.taps_conj)
    torch.cuda.synchronize()
    integer = ctypes.c_int

    for name, (warps, mtiles, subs) in K1_VARIANTS.items():
        lib, regs = build_variant(_build.CSRC / "wire_channelizer.cu", (
            (r"constexpr int kWarps = \d+;", f"constexpr int kWarps = {warps};"),
            (r"constexpr int kMTiles = \d+;", f"constexpr int kMTiles = {mtiles};"), *subs), name)
        fn = lib.ais_wire_channelizer_cr1
        fn.argtypes = _build.WIRE_CHANNELIZER_CR1.argtypes
        fn.restype = integer
        tile = warps * 16 * mtiles
        words = (((tile - 1) * chan.decim + 96 + (wc.n_super_steps(ntaps) - 1) * wc.SUPER_TAPS) >> 5) + 2
        got = torch.empty_like(ref)

        def k1():
            rc = fn(raw.data_ptr(), car.data_ptr(), chan.frags.data_ptr(),
                    torch.view_as_real(got).data_ptr(), raw.numel(), chan.n_out,
                    wc.n_super_steps(ntaps), words, chan.decim, car.shape[1], n_chan,
                    chan.unscale, stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        ms = back_to_back_ms(k1, 30)
        out(kernel="K1", variant=name, outputs_a_tile=tile, registers=regs, ms=ms,
            equals_as_built=bool(torch.equal(got, ref)))

    for name, (threads, blocks) in K2_VARIANTS.items():
        bounds = f"__launch_bounds__(kThreads, {blocks})" if blocks else "__launch_bounds__(kThreads)"
        lib, regs = build_variant(_build.CSRC / "matched_filter.cu", (
            (r"constexpr int kThreads = \d+;", f"constexpr int kThreads = {threads};"),
            (r"__launch_bounds__\(kThreads, \d+\)", bounds)), name)
        fn = lib.ais_matched_filter
        fn.argtypes = _build.MATCHED_FILTER.argtypes
        fn.restype = integer
        corr, mag2 = torch.empty_like(ref_corr), torch.empty_like(ref_mag2)
        taps = torch.view_as_real(mf.taps_conj)

        def k2():
            rc = fn(torch.view_as_real(x).data_ptr(), taps.data_ptr(),
                    torch.view_as_real(corr).data_ptr(), mag2.data_ptr(), x.shape[0], x.shape[1],
                    ref_corr.shape[1], mf.taps_conj.numel(), stream)
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        ms = back_to_back_ms(k2, 100)
        same = torch.equal(torch.view_as_real(corr), torch.view_as_real(ref_corr)) \
            and torch.equal(mag2, ref_mag2)
        out(kernel="K2", variant=name, threads=threads, registers=regs, ms=ms,
            equals_as_built=bool(same))


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path, help="a second checkout to run in turns with this one")
    parser.add_argument("--no-variants", action="store_true")
    parser.add_argument("--only", choices=("k1k2", "channelizer"),
                        help="K1 and K2 alone, or K3, K4 and K5 alone")
    parser.add_argument("--match", default="", help="only the channelizer variants whose name "
                        "matches this regular expression")
    parser.add_argument("--sass", type=Path, help="write K5's SASS here and count its opcodes")
    parser.add_argument("--child", metavar="PREFIX", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        run = run_channelizers if args.only == "channelizer" else run_wrappers
        print("RESULT", json.dumps(run(args.child)), flush=True)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out(card=card, torch=torch.__version__, cuda=torch.version.cuda)
    if args.sass:
        sass_report(args.sass.resolve())
    if args.other:
        compare_with(args.other.resolve(), args.only)
    if not args.no_variants:
        if args.only in (None, "k1k2"):
            variants()
        if args.only in (None, "channelizer"):
            k3_variants(args.match)
            fma_peak()
            clocks_under_k5()
            channelizer_variants(args.match)
    return 0


if __name__ == "__main__":
    if "--child" in sys.argv:
        sys.path.insert(0, os.getcwd())
    sys.exit(main())
