"""The wire ingest on the card: the pinned chunk ring against the pageable copy.

    python3 -m ais_tpu_torch.probes.ingest [--nbytes N] [--reps R]

Needs one CUDA device.  On one random wire of N bytes (default the
benchmark's cu8 step, 452 052 400), each the median of R runs, one JSON
line a measurement, the first naming the card and its power limit:

  pageable    `host.to(device, non_blocking=True)` from pageable memory,
              then a synchronize (the receiver's copy before the ring);
  pinned_dma  one copy of the whole wire from a pinned buffer;
  fill        `native.copy_bytes` into a pinned buffer of the wire's size
              at 1, 2, 4 and 8 threads, and `np.copyto` (its twin);
  ring        `PinnedRing.stage` at the chunk size `chunk_bytes` picks and
              at 8, 16 and 64 MiB: the host's time in `stage` (what the
              benchmark's `stage_ms` times) and to the copies' end.

Rates are GB/s of the wire's bytes (1e9 bytes a second).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ais_tpu_torch import native
from ais_tpu_torch.pipeline import ingest


def _card() -> dict:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi failed: {e}"
    return {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "fill_threads": ingest.fill_threads(),
            "native": native.available()}


def _median_s(fn, reps: int) -> float:
    fn()  # warm: allocations, the first touch of pinned pages
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _emit(name: str, nbytes: int, seconds: float, **extra) -> None:
    print(json.dumps({"probe": name, "ms": round(seconds * 1e3, 4),
                      "gb_s": round(nbytes / seconds * 1e-9, 3), **extra}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nbytes", type=int, default=452_052_400)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ingest probe: needs a CUDA device")
    dev = torch.device("cuda")
    n = args.nbytes
    print(json.dumps(_card()), flush=True)
    src = np.random.default_rng(0).integers(0, 256, n, dtype=np.uint8)
    host = torch.from_numpy(src)

    def pageable():
        host.to(dev, non_blocking=True)
        torch.cuda.synchronize(dev)

    _emit("pageable", n, _median_s(pageable, args.reps))
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    pinned_np = pinned.numpy()
    np.copyto(pinned_np, src)
    dst = torch.empty(n, dtype=torch.uint8, device=dev)

    def pinned_dma():
        dst.copy_(pinned, non_blocking=True)
        torch.cuda.synchronize(dev)

    _emit("pinned_dma", n, _median_s(pinned_dma, args.reps))
    for threads in (1, 2, 4, 8):
        _emit("fill", n, _median_s(lambda t=threads: native.copy_bytes(pinned_np, src, t),
                                   args.reps), threads=threads)
    _emit("fill_numpy", n, _median_s(lambda: np.copyto(pinned_np, src), args.reps))
    del pinned, pinned_np, dst
    rows = np.zeros(2, np.float32)
    for chunk in (ingest.chunk_bytes(n), 8 << 20, 16 << 20, 64 << 20):
        ring = ingest.PinnedRing(dev, chunk, rows)
        host_s = []

        def staged():
            t0 = time.perf_counter()
            ring.stage(src, rows, 0)
            host_s.append(time.perf_counter() - t0)
            torch.cuda.synchronize(dev)

        total = _median_s(staged, args.reps)
        _emit("ring", n, statistics.median(host_s[1:]), chunk=chunk,
              chunks=len(ingest.chunk_plan(n, chunk)), to_copies_end_ms=round(total * 1e3, 4))
        del ring
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
