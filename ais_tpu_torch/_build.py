"""Build, load and count the hand-written CUDA kernels (`csrc/*.cu`).

Route: `nvcc` straight to a shared library with a plain C interface,
loaded with `ctypes` (no PyTorch headers, so a build takes seconds).
The library is built at first use, keyed by a hash of the sources and
flags, into `build/ais_tpu_torch/` beside the package.  Every C entry
point launches on the stream it is given and returns
`cudaGetLastError()`; `Kernel.__call__` raises when that is not 0.

Each kernel keeps a launch count (`Kernel.launches`), bumped only where
its wrapper launches it, so a run can show that its main path went
through the kernel.  `reset_launch_counts()` zeroes them all.
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

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ais_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
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
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
            os.replace(tmp, out)
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
    # raw, carrier, taps, out, n_bytes, n_out, ntaps, decim, q, n_chan, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
)
MATCHED_FILTER = Kernel(
    "matched_filter",
    "ais_matched_filter",
    # x, conj taps, corr, mag2, batch, n, n_out, L, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _P],
)
KERNELS = (WIRE_CHANNELIZER_CR1, MATCHED_FILTER)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}
