"""Wire ingest on a CUDA device: a step's bytes through a ring of pinned chunks.

A copy from pageable host memory keeps the host waiting for all of it,
at a fraction of the link's rate.  `PinnedRing.stage` instead cuts the
step's wire into chunks (`chunk_plan`), fills each into a pinned host
slot with several native threads (`fill`, the interpreter lock
released), and enqueues the slot's copy to the device on the ring's own
copy stream, so that chunk i crosses the link while chunk i+1 fills.  A
slot is filled again only once its event says its last copy is done.
The caller's current stream waits for the copies before any later work,
so every event recorded on it after `stage` returns covers them; the
caller's bytes have all been read when `stage` returns.

The device buffers are allocated on the copy stream and marked as used
by the current stream (`record_stream`): the caching allocator then
hands a freed buffer to a later copy only once the work queued on the
current stream before its release has run.

The chunk size follows the step's byte count (`chunk_bytes`): a quarter
of it, between 1 MiB and 32 MiB, so a 28 MB cr1 step is four chunks and
a 452 MB cu8 step fourteen of 32 MiB.  The fill takes one thread a core
the process may run on, at most eight (`fill_threads`).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ais_tpu_torch import native
from ais_tpu_torch.utils.profiling import SPANS

SLOTS = 4
CHUNK_MIN = 1 << 20
CHUNK_MAX = 32 << 20
_ALIGN = 1 << 12


def chunk_bytes(nbytes: int) -> int:
    """The chunk size for an `nbytes` wire: a quarter of it, rounded up to
    whole 4 KiB, between CHUNK_MIN and CHUNK_MAX."""
    quarter = -(-max(int(nbytes), 1) // SLOTS)
    return min(CHUNK_MAX, max(CHUNK_MIN, -(-quarter // _ALIGN) * _ALIGN))


def chunk_plan(nbytes: int, chunk: int) -> list[tuple[int, int]]:
    """(offset, size) of each chunk of an `nbytes` wire, in order: they
    cover [0, nbytes) once, each at most `chunk` bytes."""
    return [(off, min(chunk, nbytes - off)) for off in range(0, nbytes, chunk)]


def fill_threads() -> int:
    """Threads of one fill: the cores this process may run on, at most 8."""
    return min(8, len(os.sched_getaffinity(0)))


def fill(dst: np.ndarray, src: np.ndarray, threads: int) -> None:
    """dst[:] = src: the native threaded copy, or numpy without the
    native library."""
    if native.available():
        native.copy_bytes(dst, src, threads)
    else:
        np.copyto(dst, src)


class PinnedRing:
    """SLOTS pinned host chunks of `chunk` bytes with an event each, a
    pinned row shaped as `rows_like` (the step's mixer phases) beside
    each, and one copy stream, on a CUDA `device`.  Raises RuntimeError
    where pinned memory cannot be had."""

    def __init__(self, device, chunk: int, rows_like: np.ndarray):
        self.device = torch.device(device)
        self.chunk = int(chunk)
        self.slots = [torch.empty(self.chunk, dtype=torch.uint8, pin_memory=True)
                      for _ in range(SLOTS)]
        self.views = [s.numpy() for s in self.slots]
        proto = torch.from_numpy(np.asarray(rows_like))
        self.rows = torch.empty((SLOTS, *proto.shape), dtype=proto.dtype, pin_memory=True)
        self.events = [torch.cuda.Event() for _ in range(SLOTS)]
        self.stream = torch.cuda.Stream(self.device)
        self.threads = fill_threads()
        self._slot = 0  # the next chunk's slot

    def stage(self, src: np.ndarray, rows: np.ndarray, at: int) -> tuple:
        """(wire bytes on the device, `rows` on the device, fill ns) for
        one step's C-contiguous uint8 `src` (at least one byte); each
        chunk's fill and copy enqueue are the spans `rx.stage.fill` and
        `rx.stage.copy` of step `at`.  No stream is synchronized: the
        host waits only for a slot's last copies before filling it
        again.  The step's rows ride in the row of its first chunk's
        slot, copied just before that chunk, so the chunk's event covers
        them too."""
        cur = torch.cuda.current_stream(self.device)
        fill_ns = 0
        with torch.cuda.stream(self.stream):
            raw = torch.empty(src.size, dtype=torch.uint8, device=self.device)
            ph = torch.empty(self.rows.shape[1:], dtype=self.rows.dtype, device=self.device)
            for k, (off, size) in enumerate(chunk_plan(src.size, self.chunk)):
                i = self._slot
                self._slot = (i + 1) % SLOTS
                self.events[i].synchronize()
                if k == 0:
                    self.rows[i].numpy()[...] = rows
                    ph.copy_(self.rows[i], non_blocking=True)
                f0 = time.perf_counter_ns()
                fill(self.views[i][:size], src[off: off + size], self.threads)
                f1 = time.perf_counter_ns()
                raw[off: off + size].copy_(self.slots[i][:size], non_blocking=True)
                self.events[i].record(self.stream)
                c1 = time.perf_counter_ns()
                SPANS.add("rx.stage.fill", at, f0, f1)
                SPANS.add("rx.stage.copy", at, f1, c1)
                fill_ns += f1 - f0
            done = torch.cuda.Event()
            done.record(self.stream)
        raw.record_stream(cur)
        ph.record_stream(cur)
        cur.wait_event(done)
        return raw, ph, fill_ns
