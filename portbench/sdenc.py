"""Build and call the benchmark's sigma-delta encoders (`native/sd.c`).

The library is compiled with the C compiler at first use into
`build/portbench/` of the checkout, named by a hash of the source, so
only the first run in a checkout builds it.  A missing compiler is an
error: the encoders are a sequential loop over every sample, and a
Python loop over 10^8 samples is no set-up.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SOURCE = Path(__file__).resolve().parent / "native" / "sd.c"
BUILD_DIR = ROOT / "build" / "portbench"
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    path = BUILD_DIR / f"libpb_sd_{digest}.so"
    if not path.exists():
        cc = shutil.which("cc") or shutil.which("gcc") or shutil.which("g++")
        if cc is None:
            raise RuntimeError("no C compiler: the wire encoders need one")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        lang = ["-x", "c"] if cc.endswith("g++") else []
        subprocess.run([cc, *lang, "-O2", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
        tmp.replace(path)
    lib = ctypes.CDLL(str(path))
    f32 = ctypes.POINTER(ctypes.c_float)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.pb_sigma_delta_cr1.argtypes = [f32, f32, ctypes.c_int64, ctypes.c_float,
                                       ctypes.c_float, u8]
    lib.pb_sigma_delta_ci1.argtypes = [f32, f32, ctypes.c_int64, ctypes.c_float, u8]
    lib.pb_sigma_delta_cr1.restype = None
    lib.pb_sigma_delta_ci1.restype = None
    _lib = lib
    return lib


def encode(fmt: str, re: np.ndarray, im: np.ndarray, scale: float, a2: float = 0.0) -> np.ndarray:
    """The wire bytes of I/Q planes (float32, one length) in `fmt`."""
    lib = _library()
    re = np.ascontiguousarray(re, np.float32)
    im = np.ascontiguousarray(im, np.float32)
    n = re.size
    f32 = ctypes.POINTER(ctypes.c_float)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    if fmt == "cr1":
        out = np.empty(-(-n // 8), np.uint8)
        lib.pb_sigma_delta_cr1(re.ctypes.data_as(f32), im.ctypes.data_as(f32), n,
                               float(scale), float(a2), out.ctypes.data_as(u8))
    elif fmt == "ci1":
        if n % 4:
            raise ValueError("ci1 packs 4 samples a byte")
        out = np.empty(n // 4, np.uint8)
        lib.pb_sigma_delta_ci1(re.ctypes.data_as(f32), im.ctypes.data_as(f32), n,
                               float(scale), out.ctypes.data_as(u8))
    else:
        raise ValueError(f"no encoder for {fmt!r}")
    return out

