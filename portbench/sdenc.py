"""The benchmark's wire encoders: the 1-bit sigma-delta wires (`native/sd.c`)
and the complex integer wires (NumPy).

The integer wires are the port's formats (`ais_tpu_torch/ops/convert.py`),
written anew here: interleaved I, Q, each component rounded to nearest
(ties to even) and saturated:

  ci16  int16 little-endian of x * scale * 32768, in [-32768, 32767]
  ci8   int8 of x * scale * 128, in [-128, 127]
  cu8   uint8 of 127.5 + 127.5 * x * scale, in [0, 255] (rtl_sdr's offset binary)

`scale` = 1 is the format's full scale.

The sigma-delta library is compiled with the C compiler at first use into
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

# (offset, full scale, stored type) of each complex integer wire.
INT_WIRES = {"ci16": (0.0, 32768.0, np.dtype("<i2")),
             "ci8": (0.0, 128.0, np.dtype(np.int8)),
             "cu8": (127.5, 127.5, np.dtype(np.uint8))}
_CHUNK = 1 << 20  # samples a piece of the integer encode


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


def _encode_int(fmt: str, re: np.ndarray, im: np.ndarray, scale: float) -> np.ndarray:
    """The wire bytes of I/Q planes in the complex integer wire `fmt`,
    in float32 pieces."""
    off, full, dtype = INT_WIRES[fmt]
    info = np.iinfo(dtype)
    gain = np.float32(full * scale)
    out = np.empty(2 * re.size, dtype)
    buf = np.empty(min(_CHUNK, re.size), np.float32)
    for lo in range(0, re.size, _CHUNK):
        hi = min(lo + _CHUNK, re.size)
        v = buf[: hi - lo]
        for comp, plane in ((0, re), (1, im)):
            np.multiply(plane[lo:hi], gain, out=v)
            v += np.float32(off)
            np.rint(v, out=v)
            np.clip(v, info.min, info.max, out=v)
            out[2 * lo + comp: 2 * hi: 2] = v
    return out.view(np.uint8)


def encode(fmt: str, re: np.ndarray, im: np.ndarray, scale: float, a2: float = 0.0) -> np.ndarray:
    """The wire bytes of I/Q planes (float32, one length) in `fmt`."""
    re = np.ascontiguousarray(re, np.float32)
    im = np.ascontiguousarray(im, np.float32)
    if fmt in INT_WIRES:
        return _encode_int(fmt, re, im, scale)
    lib = _library()
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

