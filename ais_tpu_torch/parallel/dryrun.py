"""Multi-shard dry run: the sharded decode steps on tiny shapes.

Port of `__graft_entry__.py:dryrun_multichip`: the block demod over an
n-shard time mesh (sequence parallelism through overlap-save halos),
streams x time on a (2, n / 2) grid when n is even, and the sharded
cr1 wire program — wire decode -> channelizer -> demod -> compact pack —
at a reduced geometry (a wider transition band: fewer channelizer taps,
the same topology), one overlap-save wire step a shard, its output
consumed.
"""

from __future__ import annotations

import numpy as np

from ais_tpu_torch.core.params import DeframerConfig, DemodConfig
from ais_tpu_torch.ops.fir import mixer_phase
from ais_tpu_torch.parallel.mesh import make_stream_time_mesh, make_time_mesh
from ais_tpu_torch.parallel.pipeline import (
    make_sharded_demod,
    make_sharded_stream_demod,
    make_sharded_wire_pipeline,
)
from ais_tpu_torch.pipeline.wideband import WidebandConfig, aligned_n_in, num_taps


def _noise(rng, shape) -> np.ndarray:
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64)


def dryrun_multichip(n_devices: int, *, device="cuda") -> dict:
    """Run one step of each sharded program over `n_devices` shards;
    returns the shapes of what each produced."""
    cfg = DemodConfig(fftlen=256, agc_window=128, burst_len=512, max_bursts_per_block=4)
    block_len, core_len = 2048, 1024
    rng = np.random.default_rng(0)
    out = {}

    mesh = make_time_mesh(n_devices, device=device)
    fn = make_sharded_demod(cfg, block_len, core_len, mesh)
    rec = fn(_noise(rng, (n_devices, block_len)))
    out["time"] = list(rec.bits.cpu().shape)

    if n_devices >= 2 and n_devices % 2 == 0:
        mesh2 = make_stream_time_mesh(2, n_devices // 2, device=device)
        fn2 = make_sharded_stream_demod(cfg, block_len, core_len, mesh2)
        rec2 = fn2(_noise(rng, (2, n_devices // 2, block_len)))
        out["stream_time"] = list(rec2.bits.cpu().shape)

    # The run deframes nothing; the deframer's bound only has to fit the
    # tiny burst window.
    wcfg = WidebandConfig(block_len=4096, transition_hz=12e3, demod=cfg,
                          deframer=DeframerConfig(max_length_bytes=cfg.max_frame_bytes),
                          compact_lanes=32)
    n_in = aligned_n_in(wcfg, (wcfg.block_len - 1) * wcfg.decimation + num_taps(wcfg))
    step_raw = wcfg.core_len * wcfg.decimation  # one block a shard
    if step_raw % 8:
        raise ValueError("cr1 shard spans must be byte-aligned")
    fnw = make_sharded_wire_pipeline(wcfg, n_in, mesh, fmt="cr1")
    raws = rng.integers(0, 256, size=(n_devices, n_in // 8), dtype=np.uint8)
    ph = np.stack([np.stack([mixer_phase(off, wcfg.input_rate, d * step_raw)
                             for off in wcfg.offsets_hz]) for d in range(n_devices)])
    flat = fnw(raws, ph)
    out["wire"] = list(flat.cpu().shape)  # each output consumed: its copy waits for the work
    out["n_shards"], out["n_physical"] = mesh.n_shards, mesh.n_physical
    return out
