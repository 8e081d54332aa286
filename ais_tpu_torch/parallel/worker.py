"""One process of a multi-process distributed decode.

    python -m ais_tpu_torch.parallel.worker <coordinator> <n_procs> <rank> <out.json>
        [--device cuda|cpu]

Counterpart of the reference's `tools/multihost_worker.py`.  Each
process joins the `gloo` group at `<coordinator>` ("host:port", or
"none" for a single process), decodes a deterministic synthesized
capture of N_BLOCKS blocks through `DistributedBlockDecoder` over
LOCAL_SHARDS local shards (global shards = n_procs x LOCAL_SHARDS) and
writes its packets as JSON: every process of a group must write the
same list, equal to one process's.  With `--device cuda` (the default) rank r runs on card
`r % torch.cuda.device_count()`.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"
LOCAL_SHARDS = 4
N_BLOCKS = 8  # global overlap-save blocks of the capture


def synthesize(n: int) -> np.ndarray:
    """Deterministic capture of n samples at 48 ksps: 4 packets, one per
    quarter of the stream, the third straddling the half-way shard cut."""
    from ais_tpu_torch.tx import aivdm_payload_to_bytes, make_packet_iq

    pkt = make_packet_iq(aivdm_payload_to_bytes(PAYLOAD), samples_per_symbol=5)
    rng = np.random.default_rng(42)
    iq = ((rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.01).astype(np.complex64)
    for off in (5000, n // 4 + 2000, n // 2 - 600, 3 * n // 4 + 9000):
        iq[off: off + pkt.size] += pkt
    return iq


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("coordinator")
    ap.add_argument("n_procs", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("out")
    ap.add_argument("--device", default="cuda", help="cuda (a card a rank) or cpu")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ais_tpu_torch import _build
    from ais_tpu_torch.parallel.distributed import DistributedBlockDecoder, init_distributed

    device = args.device
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda needs a CUDA device")
        device = f"cuda:{args.rank % torch.cuda.device_count()}"
    t0 = time.perf_counter()
    init_distributed(None if args.coordinator == "none" else args.coordinator,
                     args.n_procs, args.rank)
    try:
        dec = DistributedBlockDecoder(n_devices=LOCAL_SHARDS, device=device)
        if dec.world_size != args.n_procs:
            raise RuntimeError(f"group of {dec.world_size}, expected {args.n_procs}")
        iq = synthesize(dec.core_len * N_BLOCKS)
        _build.reset_launch_counts()
        t1 = time.perf_counter()
        packets = dec.decode_stream(iq)
        t2 = time.perf_counter()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump({
            "process_id": args.rank, "n_processes": dec.world_size,
            "n_shards": dec.n_devices, "local_shards": dec.mesh.n_shards,
            "n_physical": dec.mesh.n_physical, "device": device,
            "packets": [{"nmea": p.nmea, "abs_sample": p.abs_sample} for p in packets],
            "launches": _build.launch_counts(), "init_s": t1 - t0, "decode_s": t2 - t1,
        }, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
