"""What the benchmark records around the program's receiver calls.

The recorder wraps four methods of `WidebandReceiver`, its channelizer
call and the matched filter's forward, without changing what they
compute:

- on the step whose stream position is the spec's `check_pos`, it keeps
  the channelizer's outputs at the spec's sampled indices and, for the
  spec's sampled rows, K2's |corr|^2 (device copies of a few MB, taken
  once);
- with `trace` on, it records each call of `stage_wire`,
  `dispatch_wire`, `fetch_wire` and `decode_fetched` as a span on the
  wall clock, and runs `torch.profiler` over the process's card
  activity (kernels, copies, sets), whose timestamps are on the same
  clock.

A run calls `start()` before it builds the receiver and `recording()`
once the window has closed.
"""

from __future__ import annotations

import time

import numpy as np

SPANS = ("stage_wire", "dispatch_wire", "fetch_wire", "decode_fetched")
_active = None       # the recorder the wrapped methods report to
_wrapped = False


class Recorder:
    def __init__(self, spec: dict):
        self.spec = spec
        self.capture = False  # inside the checked step's dispatch
        self.spans: list = []
        self.kept: dict = {}
        self.prof = None
        if spec.get("trace") and str(spec.get("device", "cpu")).startswith("cuda"):
            import torch

            self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()

    def recording(self) -> dict:
        """The kept outputs, spans, device events and memory peak, as arrays."""
        import torch

        out = {}
        for key, val in self.kept.items():
            out[key] = val.cpu().numpy() if hasattr(val, "cpu") else np.array(val)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
            out["mem_reserved_peak"] = np.array(torch.cuda.max_memory_reserved())
        if self.prof is not None:
            self.prof.stop()
            names, idx, start, dur = {}, [], [], []
            for e in self.prof.profiler.kineto_results.events():
                if e.device_type() != torch.autograd.DeviceType.CUDA:
                    continue
                idx.append(names.setdefault(e.name(), len(names)))
                start.append(e.start_ns())
                dur.append(e.duration_ns())
            self.prof = None
            out["ev_names"] = np.array(list(names) or [""])
            out["ev_name"] = np.array(idx, np.int32)
            out["ev_start"] = np.array(start, np.int64)
            out["ev_dur"] = np.array(dur, np.int64)
        if self.spec.get("trace"):
            names = sorted({s[0] for s in self.spans} | set(SPANS))
            out["span_names"] = np.array(names)
            out["span_name"] = np.array([names.index(s[0]) for s in self.spans], np.int32)
            out["span_t"] = np.array([s[1:] for s in self.spans], np.int64).reshape(-1, 2)
        return out


def _span(name: str, fn):
    def wrapped(rx, *args, **kwargs):
        rec = _active
        if rec is None or not rec.spec.get("trace"):
            return fn(rx, *args, **kwargs)
        t0 = time.time_ns()
        try:
            return fn(rx, *args, **kwargs)
        finally:
            rec.spans.append((name, t0, time.time_ns()))
    return wrapped


def _dispatch(fn):
    def dispatch(rx, staged, *args, **kwargs):
        rec = _active
        if rec is not None:
            rec.capture = int(staged[2]) == int(rec.spec["check_pos"]) and not rec.kept
        try:
            return fn(rx, staged, *args, **kwargs)
        finally:
            if rec is not None:
                rec.capture = False
    return dispatch


def _channels(fn):
    import torch

    def wire_channels(rx, *args, **kwargs):
        out = fn(rx, *args, **kwargs)
        rec = _active
        if rec is not None and rec.capture:
            idx = torch.as_tensor(rec.spec["chan_idx"], device=out.device)
            rec.kept["chan"] = out.index_select(-1, idx).clone()
        return out
    return wire_channels


def _matched_filter(fn):
    import torch

    def forward(mf, x, *args, **kwargs):
        corr, mag2 = fn(mf, x, *args, **kwargs)
        rec = _active
        if rec is not None and rec.capture and "k2_mag2" not in rec.kept:
            rows = torch.as_tensor(rec.spec["k2_rows"], device=mag2.device)
            rec.kept["k2_mag2"] = mag2.index_select(0, rows).clone()
        return corr, mag2
    return forward


def _wrap() -> None:
    global _wrapped
    if _wrapped:
        return
    from ais_tpu_torch.ops.matched_filter import MatchedFilter
    from ais_tpu_torch.pipeline.wideband import WidebandReceiver as rx

    rx.stage_wire = _span("stage_wire", rx.stage_wire)
    rx.dispatch_wire = _span("dispatch_wire", _dispatch(rx.dispatch_wire))
    rx.fetch_wire = _span("fetch_wire", rx.fetch_wire)
    rx.decode_fetched = _span("decode_fetched", rx.decode_fetched)
    rx.wire_channels = _channels(rx.wire_channels)
    MatchedFilter.forward = _matched_filter(MatchedFilter.forward)
    _wrapped = True


def start(spec: dict) -> Recorder:
    """Record this process's receiver calls for one run."""
    global _active
    _wrap()
    _active = Recorder(spec)
    return _active


def stop() -> None:
    global _active
    _active = None
