"""Sharded block demodulation over a shard mesh (`parallel/mesh.py`).

Port of `ais_tpu/parallel/pipeline.py`.  Sequence parallelism for a
streaming signal: the stream is framed into overlap-save blocks
`(n_blocks, block_len)` stepped by `core_len`, each block carrying its
own halo.  Sharding the block axis over the mesh's time shards makes
every shard decode its blocks alone — the halo duplicated at framing
replaces any exchange between shards, so the device work holds no
collective.  The ownership rule (a burst belongs to the block whose
*core* holds its preamble start) decodes each packet exactly once
across shards.

Each physical device holds one replica of the demodulator (or the
wideband receiver); shards on the same card share it.  Each shard's
work is enqueued on a `torch.cuda.Stream` of its own, one event a shard
lets the gather wait, and the results are concatenated on the first
shard's device.  On CPU shards the same work runs one shard after
another.
"""

from __future__ import annotations

import numpy as np
import torch

from ais_tpu_torch.core.params import DemodConfig
from ais_tpu_torch.parallel.mesh import Mesh
from ais_tpu_torch.pipeline.receiver import BurstRecords, make_burst_demod


class _Shards:
    """One replica a physical device, one CUDA stream a shard."""

    def __init__(self, mesh: Mesh, build):
        self.mesh = mesh
        self.replicas = {dev: build(dev) for dev in mesh.physical}
        self.streams = [torch.cuda.Stream(dev) if dev.type == "cuda" else None
                        for dev in mesh.devices]

    def map(self, work) -> list:
        """`work(replica, i)` for every shard i, on its device and stream;
        returns the results (tuples of tensors on the shards' devices),
        ready for the callers' current streams."""
        outs, events = [], []
        for i, (dev, stream) in enumerate(zip(self.mesh.devices, self.streams)):
            replica = self.replicas[dev]
            if stream is None:
                outs.append(work(replica, i))
                events.append(None)
                continue
            caller = torch.cuda.current_stream(dev)
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                # The shard's inputs were staged on the caller's stream.
                stream.wait_stream(caller)
                outs.append(work(replica, i))
                done = torch.cuda.Event()
                done.record(stream)
            events.append(done)
        for out, dev, done in zip(outs, self.mesh.devices, events):
            if done is not None:
                caller = torch.cuda.current_stream(dev)
                caller.wait_event(done)
                for t in out:
                    t.record_stream(caller)  # freed only after the caller's reads
        return outs

    def stage(self, x: torch.Tensor, sizes) -> list:
        """Shard i's slice of x's leading axis (`sizes[i]` entries) on its device."""
        parts = torch.split(x, list(sizes))
        return [p.to(dev, non_blocking=True) for p, dev in zip(parts, self.mesh.devices)]


def _blocks_tensor(x) -> torch.Tensor:
    if torch.is_tensor(x):
        if x.dtype != torch.complex64:
            raise ValueError(f"blocks must be complex64, got {x.dtype}")
        return x
    return torch.as_tensor(np.asarray(x, np.complex64))


def _cat_records(parts: list, device: torch.device, dim: int = 0) -> BurstRecords:
    return BurstRecords(*(torch.cat([p[f].to(device) for p in parts], dim=dim)
                          for f in range(len(BurstRecords._fields))))


def _demods(cfg: DemodConfig, block_len: int, core_len: int, mesh: Mesh) -> _Shards:
    return _Shards(mesh, lambda dev: make_burst_demod(cfg, block_len, core_len, device=dev))


def make_sharded_demod(cfg: DemodConfig, block_len: int, core_len: int, mesh: Mesh):
    """(n_blocks, block_len) complex64 -> BurstRecords with the whole
    block axis, the blocks sharded over the mesh in order; n_blocks must
    be a multiple of the shard count."""
    shards = _demods(cfg, block_len, core_len, mesh)
    n = mesh.n_shards

    def fn(blocks) -> BurstRecords:
        x = _blocks_tensor(blocks)
        if x.dim() != 2 or x.shape[0] % n:
            raise ValueError(f"blocks {tuple(x.shape)}: n_blocks not divisible by {n} shards")
        parts = shards.stage(x, [x.shape[0] // n] * n)
        return _cat_records(shards.map(lambda demod, i: demod(parts[i])), mesh.devices[0])

    return fn


def make_halo_exchange_demod(cfg: DemodConfig, block_len: int, core_len: int, mesh: Mesh,
                             n_blocks: int):
    """Sharded demod over HALO-FREE framing: `(n_blocks, core_len)`
    disjoint cores in, halos exchanged between neighbour shards.

    The duplication path (`make_sharded_demod`) ships `block_len /
    core_len` (~1.45x) the samples to the devices.  Here each shard gets
    only its own cores and builds its blocks from them plus the first
    `halo` samples of the next shard, which arrive by
    `tensor.to(device, non_blocking=True)` (a peer copy between two
    cards, none on one card): shard i receives from shard (i + 1) % n, so
    the last shard's last block wraps to shard 0's head.  Callers pad the
    stream tail, which the ownership rule ignores anyway.

    Returns a function of complex64 cores -> BurstRecords, bit-identical
    to the duplication path on the same samples."""
    halo = block_len - core_len
    if halo > core_len:
        raise ValueError("halo exceeds core_len: one-neighbor exchange breaks")
    n = mesh.n_shards
    if n_blocks % n:
        raise ValueError(f"n_blocks {n_blocks} not divisible by {n}")
    local = n_blocks // n
    shards = _demods(cfg, block_len, core_len, mesh)

    def fn(cores) -> BurstRecords:
        x = _blocks_tensor(cores)
        if tuple(x.shape) != (n_blocks, core_len):
            raise ValueError(f"cores {tuple(x.shape)} != {(n_blocks, core_len)}")
        flats = [p.reshape(-1) for p in shards.stage(x, [local] * n)]

        def work(demod, i):
            dev = mesh.devices[i]
            recv = flats[(i + 1) % n][:halo].to(dev, non_blocking=True)
            ext = torch.cat([flats[i], recv])
            return demod(ext.unfold(0, block_len, core_len))

        return _cat_records(shards.map(work), mesh.devices[0])

    return fn


def make_sharded_stream_demod(cfg: DemodConfig, block_len: int, core_len: int, mesh: Mesh):
    """(n_streams, n_blocks, block_len) -> BurstRecords with leading
    (n_streams, n_blocks): streams sharded over the grid's rows, blocks
    over its columns."""
    if len(mesh.shape) != 2:
        raise ValueError(f"a (stream, time) grid is 2-D, got shape {mesh.shape}")
    n_s, n_t = mesh.shape
    shards = _demods(cfg, block_len, core_len, mesh)

    def fn(blocks) -> BurstRecords:
        x = _blocks_tensor(blocks)
        if x.dim() != 3 or x.shape[0] % n_s or x.shape[1] % n_t:
            raise ValueError(f"blocks {tuple(x.shape)} do not divide over a "
                             f"{n_s} x {n_t} grid")
        ls, lt = x.shape[0] // n_s, x.shape[1] // n_t
        parts = [x[s * ls:(s + 1) * ls, t * lt:(t + 1) * lt].to(dev, non_blocking=True)
                 for (s, t), dev in zip(np.ndindex(n_s, n_t), mesh.devices)]

        def work(demod, i):
            rec = demod(parts[i].reshape(ls * lt, block_len))
            return BurstRecords(*(r.reshape(ls, lt, *r.shape[1:]) for r in rec))

        outs = shards.map(work)
        dev0 = mesh.devices[0]
        rows = [_cat_records(outs[s * n_t:(s + 1) * n_t], dev0, dim=1) for s in range(n_s)]
        return _cat_records(rows, dev0)

    return fn


def make_sharded_wire_pipeline(wcfg, n_in: int, mesh: Mesh, fmt: str = "cr1"):
    """Shard the benchmarked wire program — wire decode -> channelizer ->
    demod -> device-to-host record pack — over the mesh's time shards.

    Each shard owns one full overlap-save wire step, raw span
    [d*step_raw, d*step_raw + n_in), so no shard needs another's
    samples.  Per-shard mixer phases come in as an (n_shards, n_offsets)
    array (`ops/fir.py:mixer_phase` at each span's first sample).

    Built on one `WidebandReceiver(wcfg, n_in)` a physical device, whose
    `wire_records` and `pack_records` it runs: cr1 takes K1, or decode +
    K5 where K1 refuses the geometry; ci8 takes decode + K5.  The
    reference's `car, hf` arguments do not exist here: each channelizer
    owns its tables.  `wcfg.compact_lanes` picks the compact or the flat
    layout, as on one device.  Returns a function
      (raw (n_shards, wire_bytes) uint8, phase0s (n_shards, n_off))
        -> (n_shards, flat_len) uint8
    whose rows decode with `WidebandReceiver.decode_fetched((row,
    chan_start, span, fmt, at))`."""
    from ais_tpu_torch.pipeline.wideband import WidebandReceiver, wire_nbytes

    if fmt not in ("cr1", "ci8"):
        raise ValueError(f"sharded wire pipeline supports cr1/ci8, not {fmt}")

    def build(dev):
        rx = WidebandReceiver(wcfg, n_in, device=dev)
        rx.prepare(fmt)  # its tables, before any shard stream
        return rx

    shards = _Shards(mesh, build)
    n = mesh.n_shards
    row_bytes = wire_nbytes(fmt, shards.replicas[mesh.devices[0]].n_in)

    def fn(raw, phase0s) -> torch.Tensor:
        raw = torch.as_tensor(raw)
        phase0s = torch.as_tensor(phase0s)
        if raw.dtype != torch.uint8 or tuple(raw.shape) != (n, row_bytes) \
                or phase0s.shape[0] != n:
            raise ValueError(f"raw {tuple(raw.shape)} {raw.dtype} and phases "
                             f"{tuple(phase0s.shape)}: one uint8 row of {row_bytes} "
                             f"bytes a shard of {n}")
        raws, phs = shards.stage(raw, [1] * n), shards.stage(phase0s, [1] * n)

        def work(rx, i):
            return (rx.pack_records(rx.wire_records(raws[i][0], phs[i][0], fmt)),)

        dev0 = mesh.devices[0]
        return torch.stack([out[0].to(dev0) for out in shards.map(work)])

    return fn
