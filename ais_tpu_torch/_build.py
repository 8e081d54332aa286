"""Build, load and count the hand-written CUDA kernels (`csrc/*.cu`).

Route: `nvcc` straight to a shared library with a plain C interface,
loaded with `ctypes` (no PyTorch headers, so a build takes seconds).
The library is built at first use, keyed by a hash of the sources and
flags, into `build/ais_tpu_torch/` beside the package: one `nvcc -c`
per source, all started together, then one link.  Every C entry
point launches on the stream it is given and returns
`cudaGetLastError()`; `Kernel.__call__` raises when that is not 0.

Each kernel keeps a launch count (`Kernel.launches`), bumped only where
its wrapper launches it, so a run can show that its main path went
through the kernel.  `reset_launch_counts()` zeroes them all.

`require_card` is the one check that a module owning a kernel is on the
card it was asked for: the port defaults to `cuda` and never falls back
to the CPU unless the caller asks for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ais_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile_and_link(out: Path) -> str:
    """One `nvcc -c` a source, all at once, then `nvcc -shared`; returns
    the compilers' output (ptxas's register and shared-memory lines)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for src, proc in zip(_sources(), procs):
        text = proc.communicate()[0]
        logs.append(text)
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    return log


def require_card(device, owner: str) -> torch.device:
    """`device` as a torch.device; raises RuntimeError, naming
    device='cpu', when it is a CUDA device and there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{owner} on {str(dev)!r} needs a CUDA device; pass device='cpu' "
                           f"for the CPU")
    return dev


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = BUILD_DIR / f"libais_tpu_torch_{_source_hash()}.so"
        t0 = time.perf_counter()
        log = ""
        if not out.exists():
            log = _compile_and_link(out)
        _lib = ctypes.CDLL(str(out))
        _lib.ais_cuda_error_string.argtypes = [ctypes.c_int]
        _lib.ais_cuda_error_string.restype = ctypes.c_char_p
        build_info.update(
            path=str(out), seconds=time.perf_counter() - t0, log=log
        )
        return _lib


class Kernel:
    """One C entry point of the library, with its launch count."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = library().ais_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: launch failed: CUDA error {rc} ({msg})")
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int

WIRE_CHANNELIZER_CR1 = Kernel(
    "wire_channelizer_cr1",
    "ais_wire_channelizer_cr1",
    # raw, carrier, tap fragments, out, n_bytes, n_out, n_super, tile_words,
    # decim, q, n_chan, unscale, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
)
# K3 in its 1-bit tensor-core form (the same source as K1).
WIRE_CHANNELIZER_CI1_MMA = Kernel(
    "wire_channelizer_ci1_mma",
    "ais_wire_channelizer_ci1_mma",
    # raw, carrier, tap fragments, out, n_bytes, n_out, n_super, tile_words,
    # tile_outputs, decim, q, n_chan, unscale, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
)
MATCHED_FILTER = Kernel(
    "matched_filter",
    "ais_matched_filter",
    # x, conj taps, corr, mag2, batch, n, n_out, L, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _P],
)
_L = ctypes.c_longlong
# csrc/channelizer.cu: in, carrier, taps, out, n_in, n_out, ntaps, decim,
# q, n_chan, outputs a thread, outputs a tile, threads a block, stream.
_CHANNELIZER_ARGS = [_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _P]
CHANNELIZER = Kernel("channelizer", "ais_channelizer_f32", _CHANNELIZER_ARGS)
WIRE_CHANNELIZER_CI1 = Kernel("wire_channelizer_ci1", "ais_wire_channelizer_ci1",
                              _CHANNELIZER_ARGS)
WIRE_CHANNELIZER_CI2 = Kernel("wire_channelizer_ci2", "ais_wire_channelizer_ci2",
                              _CHANNELIZER_ARGS)
WIRE_CHANNELIZER_CI4 = Kernel("wire_channelizer_ci4", "ais_wire_channelizer_ci4",
                              _CHANNELIZER_ARGS)
# K5 decoding rtl_sdr's cu8 bytes in its prologue.
WIRE_CHANNELIZER_CU8 = Kernel("wire_channelizer_cu8", "ais_wire_channelizer_cu8",
                              _CHANNELIZER_ARGS)
PROBE = Kernel(
    "probe",
    "ais_probe",
    # x, y, out, n, stream
    [_P, _P, _P, _I, _P],
)
KERNELS = (WIRE_CHANNELIZER_CR1, WIRE_CHANNELIZER_CI1_MMA, MATCHED_FILTER, CHANNELIZER,
           WIRE_CHANNELIZER_CI1, WIRE_CHANNELIZER_CI2, WIRE_CHANNELIZER_CI4,
           WIRE_CHANNELIZER_CU8, PROBE)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}
