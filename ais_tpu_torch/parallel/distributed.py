"""Multi-process distributed decode.

Port of `ais_tpu/parallel/distributed.py`.  Several processes decode one
continuous stream together:

  - `torch.distributed` forms the process group (`init_distributed`);
  - the global block axis is divided over world_size x local shards;
    each process computes only its own blocks (`parallel/pipeline.py`);
  - because every block carries its own halo from framing, no sample
    crosses processes: the only traffic is one gather of per-block
    record rows a call, a few KB;
  - the ownership rule (a packet belongs to the block whose core holds
    its preamble start) holds globally, so each packet decodes once.

The group uses the `gloo` backend on CPU tensors: the rows are a few KB
a call and the reference also gathers them to the host
(`process_allgather`), and NCCL refuses two ranks on one card, the only
layout a single card allows.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ais_tpu_torch.core.params import DemodConfig
from ais_tpu_torch.parallel.mesh import make_time_mesh
from ais_tpu_torch.parallel.pipeline import make_sharded_demod
from ais_tpu_torch.pipeline.api import frame_stream
from ais_tpu_torch.pipeline.host import PacketDeduper, deframe_records
from ais_tpu_torch.pipeline.receiver import (
    BurstRecords,
    burst_table_geometry,
    required_halo,
)
from ais_tpu_torch.pipeline.wideband import le4_bytes, pack_wire_records


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join the process group at `coordinator_address` ("host:port"), or
    do nothing for a single process."""
    if coordinator_address is None:
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBlockDecoder:
    """Shard a stream's overlap-save blocks over every shard of every
    process: `n_devices` local shards (`make_time_mesh`) times the
    process group's world size."""

    def __init__(self, demod: DemodConfig = DemodConfig(), block_len: int = 16384,
                 n_devices: int | None = None, *, device="cuda"):
        self.cfg = demod
        self.block_len = block_len
        self.core_len = block_len - required_halo(demod)
        self.mesh = make_time_mesh(n_devices, device=device)
        self.world_size, self.rank = _world()
        # Global shard count: the block axis divides over all of them.
        self.n_devices = self.world_size * self.mesh.n_shards
        self._fn = make_sharded_demod(demod, block_len, self.core_len, self.mesh)
        _, self._n_sym = burst_table_geometry(demod)
        self._n_pack = -(-self._n_sym // 8)

    def _pack(self, rec: BurstRecords) -> torch.Tensor:
        """ONE gatherable tensor a call: (B, K*(24 + 12 + n_pack)) uint8
        rows, block by block: le4(meta_i), le4(f32 bits of meta_f), packed
        bits; bit_valid rides as its (first, count) run and the AFC chunk
        table as each burst's frequency."""
        w = pack_wire_records(rec, self.cfg.fftlen)
        B, K = w.meta_i.shape[:2]
        bi = le4_bytes(w.meta_i).reshape(B, K * 24)
        bf = le4_bytes(w.meta_f.contiguous().view(torch.int32)).reshape(B, K * 12)
        bp = w.packed.reshape(B, K * self._n_pack)
        return torch.cat([bi, bf, bp], dim=1)

    def _unpack(self, flat: np.ndarray) -> BurstRecords:
        """Host inverse of `_pack`: (B, K*(36+n_pack)) bytes -> BurstRecords
        (center and phase zeroed — nothing after the device demod reads
        them; the freq chunk table is rebuilt from the per-burst
        frequencies)."""
        flat = np.asarray(flat, np.uint8)
        B = flat.shape[0]
        K = flat.shape[1] // (36 + self._n_pack)
        bi, bf, bp = np.split(flat, [K * 24, K * 36], axis=1)
        meta_i = np.frombuffer(np.ascontiguousarray(bi).tobytes(), "<i4").reshape(B, K, 6)
        meta_f = np.frombuffer(np.ascontiguousarray(bf).tobytes(), "<f4").reshape(B, K, 3)
        bits = np.unpackbits(bp.reshape(B, K, self._n_pack), axis=-1)[..., : self._n_sym]
        first = meta_i[..., 4:5]
        count = meta_i[..., 5:6]
        idx = np.arange(self._n_sym, dtype=np.int32)
        bit_valid = (idx >= first) & (idx < first + count)
        # Bursts in one chunk share its estimate by construction, so
        # scattering the per-burst values back is exact.
        n_chunks = self.block_len // self.cfg.fftlen
        freq_est = np.zeros((B, n_chunks), np.float32)
        chunk = np.clip(meta_i[..., 0] // self.cfg.fftlen, 0, n_chunks - 1)
        b_idx = np.broadcast_to(np.arange(B)[:, None], chunk.shape)
        val = meta_i[..., 2].astype(bool)  # only real bursts scatter
        freq_est[b_idx[val], chunk[val]] = meta_f[..., 1][val]
        zeros = np.zeros((B, K), np.float32)
        return BurstRecords(
            position=meta_i[..., 0], center=zeros, phase=zeros, mag=meta_f[..., 0],
            valid=val, bits=bits, bit_valid=bit_valid, freq_est=freq_est,
            n_detected=meta_i[:, 0, 3], win_start=meta_i[..., 1], rssi=meta_f[..., 2])

    def decode_blocks(self, blocks):
        """(n_blocks, block_len) -> (BurstRecords, n): records of the
        blocks padded with zero blocks to a multiple of the global shard
        count; the caller reads the first n.

        In a process group every process passes the same global `blocks`;
        each materializes and decodes only its own slice, and the packed
        record rows are gathered to every process (`_pack`, `_unpack`):
        numpy records there, tensors on the first shard's device in a
        single process."""
        n = blocks.shape[0]
        total = n + (-n) % self.n_devices
        per = total // self.world_size
        lo, hi = self.rank * per, (self.rank + 1) * per
        local = np.zeros((per, self.block_len), np.complex64)
        if lo < n:
            local[: min(hi, n) - lo] = blocks[lo: min(hi, n)]
        rec = self._fn(local)
        if self.world_size == 1:
            return rec, n
        rows = self._pack(rec).cpu()
        gathered = torch.empty((self.world_size * per, rows.shape[1]), dtype=torch.uint8)
        dist.all_gather_into_tensor(gathered, rows)
        return self._unpack(gathered.numpy()), n

    def decode_stream(self, iq: np.ndarray, designator: str = "A") -> list:
        """Frame, decode and deframe one contiguous array."""
        blocks = frame_stream(iq, self.block_len, self.core_len)
        records, n = self.decode_blocks(blocks)
        return self.deframe(records, n, 0, designator, PacketDeduper())

    def deframe(self, records, n: int, start: int, designator: str,
                deduper: PacketDeduper) -> list:
        """Packets of the first n blocks of `decode_blocks`' records, the
        first block at stream sample `start`."""
        return deframe_records(records, start, self.core_len, designator, deduper, n,
                               fftlen=self.cfg.fftlen,
                               samples_per_symbol=self.cfg.samples_per_symbol)


class DistributedStreamDecoder:
    """Sustained streaming decode over the shards: rolling calls of
    `DistributedBlockDecoder` with state across calls — an input carry
    (the framing halo presented again to the next call), the absolute
    stream position and a persistent deduper — so a packet straddling a
    *call* boundary decodes exactly once, by the same ownership rule
    that governs block boundaries inside a call.  Every process of a
    group feeds the identical stream."""

    def __init__(self, demod: DemodConfig = DemodConfig(), block_len: int = 16384,
                 n_devices: int | None = None, blocks_per_call: int | None = None,
                 designator: str = "A", *, device="cuda"):
        self.block = DistributedBlockDecoder(demod, block_len, n_devices, device=device)
        self.block_len = block_len
        self.core_len = self.block.core_len
        self.blocks_per_call = blocks_per_call or 2 * self.block.n_devices
        if self.blocks_per_call % self.block.n_devices:
            raise ValueError(f"blocks_per_call {self.blocks_per_call} must divide over "
                             f"{self.block.n_devices} devices")
        self.designator = designator
        # Fresh samples a call; the other block_len - core_len are the carry.
        self.step = self.blocks_per_call * self.core_len
        self._need = self.step + (block_len - self.core_len)
        self._buf = np.zeros(0, np.complex64)
        self._pos = 0  # absolute sample index of _buf[0]
        self._deduper = PacketDeduper()

    def process(self, iq: np.ndarray) -> list:
        """Feed a chunk that continues the stream; returns the packets of
        every full call it completes."""
        self._buf = np.concatenate([self._buf, np.asarray(iq, np.complex64)])
        packets = []
        while self._buf.size >= self._need:
            span = self._buf[: self._need]
            stride = span.strides[0]
            blocks = np.lib.stride_tricks.as_strided(
                span, shape=(self.blocks_per_call, self.block_len),
                strides=(self.core_len * stride, stride))
            records, n = self.block.decode_blocks(blocks)
            packets.extend(self.block.deframe(records, n, self._pos, self.designator,
                                              self._deduper))
            self._buf = self._buf[self.step:]
            self._pos += self.step
        return packets

    def flush(self) -> list:
        """End of stream: zero-pad the residual to one full call."""
        if self._buf.size == 0:
            return []
        return self.process(np.zeros(max(self._need - self._buf.size, 0), np.complex64))
