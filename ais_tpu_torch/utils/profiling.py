"""Profiling and observability helpers (port of `ais_tpu/utils/profiling.py`).

  - `trace(logdir)`: a `torch.profiler` capture around any pipeline
    section, written as a Chrome trace (Perfetto, chrome://tracing);
  - `StageTimer`: wall-clock per-stage accounting for host-side loops;
  - the debug tensors (correlator magnitude, timing error and mu) are
    fields of `BurstRecords` / `TimingResult` and the dict of
    `pipeline/receiver.py:make_debug_taps`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


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
