"""Shard device lists for sharded AIS decoding.

Port of `ais_tpu/parallel/mesh.py`.  The reference builds a `jax` mesh
over its two data axes:

  - `time`: overlap-save time blocks of one continuous stream — each
    block carries its own halo, so blocks are embarrassingly parallel
    and no shard needs another's samples;
  - `stream`: independent IQ streams (channels, antennas, captures).

Here a mesh is a list of shard devices with the grid's shape.  Shard i
sits on `cuda:{i % torch.cuda.device_count()}` for `device="cuda"`, on
`cuda:k` for all of them for `device="cuda:k"`, and on the CPU for
`device="cpu"`.  More shards than cards is allowed: shards on one card
run on streams of their own (`parallel/pipeline.py`), as the
reference's tests run 8 virtual CPU devices.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Mesh(NamedTuple):
    """Shard devices in row-major order over `shape`: (n_time,) or
    (n_stream, n_time)."""

    devices: tuple   # torch.device a shard
    shape: tuple     # the grid's shape; its product is the shard count

    @property
    def n_shards(self) -> int:
        return len(self.devices)

    @property
    def physical(self) -> tuple:
        """The distinct devices, in order of their first shard."""
        return tuple(dict.fromkeys(self.devices))

    @property
    def n_physical(self) -> int:
        return len(self.physical)


def _shard_devices(n: int | None, device) -> tuple:
    dev = torch.device(device)
    if dev.type == "cpu":
        return (dev,) * (n or 1)
    if dev.type != "cuda":
        raise ValueError(f"no mesh on {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"a mesh on {device!r} needs a CUDA device; pass device='cpu' "
                           f"for CPU shards")
    if dev.index is not None:
        return (dev,) * (n or 1)
    count = torch.cuda.device_count()
    return tuple(torch.device("cuda", i % count) for i in range(n or count))


def make_time_mesh(n_devices: int | None = None, *, device="cuda") -> Mesh:
    """`n_devices` time shards (default: one a card, or one CPU shard)."""
    devices = _shard_devices(n_devices, device)
    return Mesh(devices, (len(devices),))


def make_stream_time_mesh(n_stream: int, n_time: int | None = None, *,
                          device="cuda") -> Mesh:
    """An (n_stream, n_time) grid of shards; `n_time` defaults to the
    cards (at least one) over `n_stream`."""
    if n_time is None:
        n_time = max(1, make_time_mesh(device=device).n_physical // n_stream)
    devices = _shard_devices(n_stream * n_time, device)
    return Mesh(devices, (n_stream, n_time))
