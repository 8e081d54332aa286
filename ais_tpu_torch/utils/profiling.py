"""Profiling and observability helpers (port of `ais_tpu/utils/profiling.py`).

  - `trace(logdir)`: a `torch.profiler` capture around any pipeline
    section, written as a Chrome trace (Perfetto, chrome://tracing);
  - `StageTimer`: wall-clock per-stage accounting for host-side loops;
  - `SpanLog` and the process-wide `SPANS`: named host intervals of the
    receive path on the profiler's clock, off by default;
  - the debug tensors (correlator magnitude, timing error and mu) are
    fields of `BurstRecords` / `TimingResult` and the dict of
    `pipeline/receiver.py:make_debug_taps`.
"""

from __future__ import annotations

import contextlib
import gc as _gc
import os
import threading
import time
from collections import defaultdict

import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    """Profiler trace context: writes `trace_<pid>_<ns>.json` under
    `logdir`.  CPU activity always, CUDA activity when a card is present."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StageTimer:
    """Accumulating wall-clock timer for host pipeline stages."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name}: {t * 1e3:.1f} ms total / {n} calls "
                         f"({t / n * 1e3:.2f} ms avg)")
        return "\n".join(lines)


_NO_SPAN = contextlib.nullcontext()


class SpanLog:
    """Named host intervals.  Callers read `time.perf_counter_ns()` (a
    clock that is never stepped); the log stamps each reading on the wall
    clock that `torch.profiler`'s device events carry, `time.time_ns()`,
    by adding one offset taken at `enable` (`offset_ns`), so a span and
    the device work it enqueued or waited for can be laid side by side.

    A span is (name, start, end, at, parent, thread): `at` identifies the
    step it belongs to (every span of one receiver step shares its stream
    position; -1 for none), `parent` is the index of the span that was
    open on the same thread when it began (-1 for none).  Off by
    default: `begin` then returns -1, `add` and `end` do nothing and
    `span` returns one shared no-op context, so callers that time a part
    for their own counters pass the same two readings here.  With
    `enable(gc=True)` every garbage collection is a span `gc<generation>`
    with `at` -1.  Spans are kept in memory until `clear`; `arrays`
    reads them out."""

    def __init__(self):
        self.on = False
        self._names: dict[str, int] = {}
        self._rows: list = []   # [name, start, end, at, parent, thread]; end -1 while open
        self._gc_rows: list = []  # collections, apart: they may fire inside `begin`
        self._local = threading.local()
        self._lock = threading.RLock()  # a collection may fire while it is held
        self._gc_start: dict[int, int] = {}
        self.offset_ns = 0

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def enable(self, gc: bool = False) -> None:
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.on = True
        if gc and self._on_gc not in _gc.callbacks:
            _gc.callbacks.append(self._on_gc)

    def disable(self) -> None:
        self.on = False
        while self._on_gc in _gc.callbacks:
            _gc.callbacks.remove(self._on_gc)
        self._gc_start.clear()

    def clear(self) -> None:
        self._names, self._rows, self._gc_rows = {}, [], []
        self._local = threading.local()

    def begin(self, name: str, at: int, start_ns: int) -> int:
        """Open a span; returns its index for `end` (-1 while off)."""
        if not self.on:
            return -1
        stack = self._stack()
        row = [self._name(name), start_ns + self.offset_ns, -1, at, stack[-1] if stack else -1,
               threading.get_ident()]
        with self._lock:
            index = len(self._rows)
            self._rows.append(row)
        stack.append(index)
        return index

    def _name(self, name: str) -> int:
        with self._lock:
            return self._names.setdefault(name, len(self._names))

    def end(self, index: int, end_ns: int) -> None:
        if index < 0:
            return
        self._rows[index][2] = end_ns + self.offset_ns
        stack = self._stack()
        if index in stack:  # and any span left open inside it
            del stack[stack.index(index):]

    def add(self, name: str, at: int, start_ns: int, end_ns: int) -> None:
        """A closed span, under the span open on this thread."""
        if self.on:
            self.end(self.begin(name, at, start_ns), end_ns)

    def span(self, name: str, at: int):
        """A context that is the span `name` of step `at`, timed on entry
        and exit (the shared no-op while off)."""
        return self._timed(name, at) if self.on else _NO_SPAN

    @contextlib.contextmanager
    def _timed(self, name: str, at: int):
        index = self.begin(name, at, time.perf_counter_ns())
        try:
            yield
        finally:
            self.end(index, time.perf_counter_ns())

    def _on_gc(self, phase: str, info: dict) -> None:
        gen = int(info["generation"])
        if phase == "start":
            self._gc_start[gen] = time.perf_counter_ns() + self.offset_ns
        elif gen in self._gc_start and self.on:
            stack = self._stack()
            self._gc_rows.append([self._name(f"gc{gen}"), self._gc_start.pop(gen),
                                  time.perf_counter_ns() + self.offset_ns, -1, stack[-1] if stack else -1,
                                  threading.get_ident()])

    def arrays(self) -> dict:
        """The spans so far as numpy arrays: `names` (str), and per span
        `name` (index into `names`), `start_ns`, `end_ns`, `at`, `parent`,
        `thread`; the collections after the others."""
        rows = np.array(self._rows + self._gc_rows, np.int64).reshape(-1, 6)
        return {"names": np.array(list(self._names), dtype=str),
                "name": rows[:, 0].astype(np.int32), "start_ns": rows[:, 1],
                "end_ns": rows[:, 2], "at": rows[:, 3], "parent": rows[:, 4].astype(np.int32),
                "thread": rows[:, 5]}


# The process's span log: the receivers of `pipeline/wideband.py` report to it.
SPANS = SpanLog()
