"""K1 and K2 on the card: this tree's kernels against another checkout's,
and against compile-time variants of themselves.

    python3 -m ais_tpu_torch.probes.kernel_variants [--other DIR] [--no-variants]

Needs one CUDA device and nvcc.  Every time is the median, over 5 runs,
of one launch among many in a row between one CUDA event pair (no host
time in it), at the benchmark geometry (K1: n_in = 56 682 200, D = 50,
2891 taps, 2 channels; K2: 192 rows of 16384, L = 140), on seeded
inputs.  One JSON line a measurement; the first names the card.

  --other DIR   a second checkout of this repository (for example the
                parent commit, unpacked with `git archive` into a
                directory that .gitignore lists).  Its K1 and K2 run in a
                child process on the same inputs, in turns with this
                tree's (other, this, this, other); K2's corr and mag2 are
                compared bit for bit, K1's outputs by max |difference|.
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


def compare_with(other: Path) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        for label, cwd in (("other", other), ("this", REPO), ("this", REPO), ("other", other)):
            # This file, run as a script from the checkout's root: there
            # `ais_tpu_torch` is the checkout's own package.
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                                   f"{tmp}/{label}"], cwd=cwd, capture_output=True, text=True)
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
            if proc.returncode or not lines:
                raise RuntimeError(f"{label} ({cwd}) failed:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
            out(checkout=label, path=str(cwd), **json.loads(lines[0][7:]))
        same = {}
        for name in ("corr", "mag2"):
            a, b = (np.load(f"{tmp}/{w}_{name}.npy") for w in ("other", "this"))
            same[f"k2_{name}_bit_identical"] = bool(
                (a.view(np.uint32) == b.view(np.uint32)).all())
        a, b = (np.load(f"{tmp}/{w}_k1.npy") for w in ("other", "this"))
        out(compare="this against other", **same,
            k1_max_abs_difference=float(np.abs(a - b).max()), k1_max_abs=float(np.abs(a).max()))


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


def build_variant(source: Path, subs, name: str):
    """nvcc a copy of `source` with regex substitutions; (library, registers)."""
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
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed:\n{proc.stdout}{proc.stderr}")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", proc.stdout + proc.stderr)]
    return ctypes.CDLL(str(so)), regs


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
    parser.add_argument("--child", metavar="PREFIX", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        print("RESULT", json.dumps(run_wrappers(args.child)), flush=True)
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    out(card=card, torch=torch.__version__, cuda=torch.version.cuda)
    if args.other:
        compare_with(args.other.resolve())
    if not args.no_variants:
        variants()
    return 0


if __name__ == "__main__":
    if "--child" in sys.argv:
        sys.path.insert(0, os.getcwd())
    sys.exit(main())
