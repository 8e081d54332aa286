"""One run of one cell: inputs, the engine, warm-up, the window, the check.

Everything that belongs to one configuration, traffic mix or metric is
a file found by its name in `BENCHMARK.json`:
`portbench/configs/<file>`, `portbench/traffic/<traffic>.json`,
`portbench/metrics/<metric>.py` (a `read(run)` that returns a number,
or None where it finds nothing to read).

One `WidebandReceiver` in this process runs a closed loop with
`outstanding` steps in flight: every collected step submits the next.
Every step is the seed's capture replayed at the next stream position
(step i at i x step_raw).
`warm_steps` steps run before the window; the window is `--seconds`
long, and a step counts in it when its packets were collected inside
it.  After the window the steps still in flight are collected, and
every collected step's packets are checked.
"""

from __future__ import annotations

import collections
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

import hook
import reference
import tracewin

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ais_tpu")


def process_start_time() -> float:
    """This process's start on the wall clock (Linux /proc)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not load,
    compared whole (`ais_tpu_torch` is not `ais_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_cell(root: Path, workload: str) -> SimpleNamespace:
    """The workload's manifest entries and its configuration and traffic files."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in manifest["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())

    def applies(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return SimpleNamespace(
        name=workload, cell=cell, cfg=cfg, traffic=traffic,
        end_to_end=[m for m in manifest["end_to_end"] if applies(m)],
        per_layer=[m for m in manifest["per_layer"] if applies(m)])


def reader(name: str):
    """`read` of `portbench/metrics/<name>.py`."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(name)}_{abs(hash(name))}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def geometry(cfg: dict, blocks: int) -> SimpleNamespace:
    """The call's sizes: n_in covers `blocks` demod blocks, rounded up to
    whole decimation rows and wire bytes."""
    D, ntaps, block, core = (int(cfg[k]) for k in ("decimation", "ntaps", "block_len",
                                                  "core_len"))
    n48 = block + core * (blocks - 1)
    align = math.lcm(D, 8)
    n_in = -(-((n48 - 1) * D + ntaps) // align) * align
    n_out = (n_in - ntaps) // D + 1
    return SimpleNamespace(n_in=n_in, n_out=n_out, n_chan=len(cfg["offsets_hz"]),
                           n_blocks=blocks, block_len=block, core_len=core, ntaps=ntaps,
                           decimation=D, step_raw=blocks * core * D, step_chan=blocks * core)


def program_config(cfg: dict, geo: SimpleNamespace):
    """The port's `WidebandConfig` for `cfg`; raises where the port's
    own sizes differ from the configuration's."""
    import dataclasses

    from ais_tpu_torch.core.params import DemodConfig
    from ais_tpu_torch.pipeline.wideband import WidebandConfig, num_taps, wideband_geometry

    wcfg = WidebandConfig(
        input_rate=float(cfg["input_rate"]), offsets_hz=tuple(cfg["offsets_hz"]),
        designators=tuple(cfg["designators"]), decimation=int(cfg["decimation"]),
        cutoff_hz=float(cfg["cutoff_hz"]), transition_hz=float(cfg["transition_hz"]),
        block_len=int(cfg["block_len"]),
        demod=dataclasses.replace(
            DemodConfig(), max_bursts_per_block=int(cfg["max_bursts_per_block"]),
            agc_window=int(cfg["demod"]["agc_window"]),
            agc_reference=float(cfg["demod"]["agc_reference"]),
            fftlen=int(cfg["demod"]["afc_fftlen"]),
            afc_gate_ratio=float(cfg["demod"]["afc_gate_ratio"])),
        overflow_recovery=bool(cfg["overflow_recovery"]),
        compact_lanes=int(cfg["compact_lanes_per_block_channel"]) * geo.n_chan * geo.n_blocks)
    got = (num_taps(wcfg), *wideband_geometry(wcfg, geo.n_in))
    want = (geo.ntaps, geo.n_chan, geo.n_blocks, geo.core_len)
    if got != want:
        raise RuntimeError(f"the port's geometry {got} is not the configuration's {want}")
    return wcfg


def check_spec(geo, traffic: dict, seed: int) -> dict:
    """Which step is checked layer by layer, and where: drawn from the
    seed.  The step is among the first `outstanding` submitted inside
    the window."""
    rng = np.random.default_rng([seed, 7])
    out = int(traffic["outstanding"])
    step = int(traffic["warm_steps"]) + out + int(rng.integers(0, out))
    n_idx = min(int(traffic["check_outputs"]), geo.n_out)
    idx = np.sort(rng.choice(geo.n_out, size=n_idx, replace=False))
    rows = np.sort(rng.choice(geo.n_chan * geo.n_blocks,
                              size=min(int(traffic["check_rows"]), geo.n_chan * geo.n_blocks),
                              replace=False))
    return {"check_step": step, "check_pos": step * geo.step_raw,
            "chan_idx": idx.tolist(), "k2_rows": rows.tolist()}


def note(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def _device_memory_used(torch, device) -> int:
    free, total = torch.cuda.mem_get_info(device)
    return int(total - free)


class Engine:
    """The traffic's steps through one `WidebandReceiver` in this
    process, `outstanding` of them staged and dispatched ahead
    (`stage_wire`, `dispatch_wire`), each then collected (`collect`:
    the wait for the device, the fetch, the host back half)."""

    def __init__(self, wcfg, geo, cfg, traffic, dev, spec):
        from ais_tpu_torch.pipeline.wideband import WidebandReceiver

        self.rec = hook.start(spec)
        self.rx = WidebandReceiver(wcfg, geo.n_in, device=dev)
        self.fmt = cfg["wire_format"]
        self.step_raw = geo.step_raw
        self.handles = collections.deque()
        self.mine = {"stage_s": 0.0, "dispatch_s": 0.0}
        self.collected = 0

    def start(self, wire):
        from ais_tpu_torch import _build

        self.rx.prepare(self.fmt)
        warm = np.random.default_rng(1).integers(0, 256, size=wire.size, dtype=np.uint8)
        self.rx.decode_wire(warm, self.fmt)
        self.rx.reset_dedup()
        _build.reset_launch_counts()
        self.reset_stats()

    def submit(self, idx, wire):
        t0 = time.perf_counter()
        staged = self.rx.stage_wire(wire, self.fmt, pos=idx * self.step_raw)
        t1 = time.perf_counter()
        self.handles.append((idx, self.rx.dispatch_wire(staged)))
        self.mine["stage_s"] += t1 - t0
        self.mine["dispatch_s"] += time.perf_counter() - t1

    def collect(self):
        """(step, packet) pairs of the oldest step in flight."""
        self.collected += 1
        idx, handle = self.handles.popleft()
        return [(idx, p) for p in self.rx.collect(handle)]

    def drain(self):
        out = []
        while self.handles:
            out.extend(self.collect())
        return out

    def stats(self) -> dict:
        st = self.rx.collect_stats
        return {"stage_s": self.mine["stage_s"], "exec_s": self.mine["dispatch_s"] + st["exec_s"],
                "fetch_s": st["fetch_s"], "host_s": st["host_s"], "steps": st["steps"]}

    def reset_stats(self):
        self.mine = dict.fromkeys(self.mine, 0.0)
        self.rx.reset_collect_stats()

    def totals(self) -> tuple[int, dict]:
        from ais_tpu_torch import _build

        return self.collected, _build.launch_counts()

    def close(self) -> dict:
        try:
            return self.rec.recording()
        finally:
            hook.stop()


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        root: Path = BENCH.parent, keep: dict | None = None) -> tuple[dict, list]:
    """One run; returns (the result line's object, the compared numbers
    as [name, value, limit, within]).  `keep`, where given, receives
    what `check` was given, as `check_args` (for `control.py`)."""
    t_proc = process_start_time()
    import torch

    import scene

    c = load_cell(root, workload)
    cfg, traffic = c.cfg, c.traffic
    geo = geometry(cfg, int(traffic["blocks"]))
    wcfg = program_config(cfg, geo)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    spec = check_spec(geo, traffic, seed)
    spec.update(trace=bool(trace), device=str(dev))
    mem_peak = 0
    found, next_idx = [], 0
    imports_s = time.time() - t_proc
    t_e0 = time.perf_counter()
    engine = Engine(wcfg, geo, cfg, traffic, dev, spec)
    t_in0 = time.perf_counter()
    engine_s = t_in0 - t_e0
    cap = scene.make_capture(cfg, traffic, geo.n_in, geo.step_raw, seed, dev)
    if on_card:  # the capture's scratch is the benchmark's, not the program's
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    inputs_s = time.perf_counter() - t_in0
    engine.start(cap.wire)
    start_s = time.perf_counter() - t_in0 - inputs_s

    def submit():
        nonlocal next_idx
        engine.submit(next_idx, cap.wire)
        next_idx += 1

    for _ in range(int(traffic["outstanding"])):
        submit()
    for _ in range(int(traffic["warm_steps"])):
        found.extend(engine.collect())
        submit()
    warm_s = time.perf_counter() - t_in0 - inputs_s - start_s
    engine.reset_stats()
    cpu0 = os.times()
    t0_ns = time.time_ns()
    t0 = time.perf_counter()
    setup_s = time.time() - t_proc
    counted, stamps = 0, []
    while True:
        found.extend(engine.collect())
        if on_card:
            mem_peak = max(mem_peak, _device_memory_used(torch, dev))
        stamps.append(time.perf_counter() - t0)
        if stamps[-1] > seconds:
            break  # collected after the window closed: not counted
        counted += 1
        submit()
    cpu1 = os.times()
    window = engine.stats()
    found.extend(engine.drain())
    steps_collected, launches = engine.totals()
    recording = engine.close()
    del engine

    t1_ns = t0_ns + int(seconds * 1e9)
    note(f"setup {setup_s:.3f} s: to the engine {imports_s:.3f} s, the engine built "
         f"{engine_s:.3f} s, inputs {inputs_s:.3f} s, receiver start {start_s:.3f} s, "
         f"warm steps {warm_s:.3f} s; {counted} steps in the window")
    note("steps collected a second of the window: "
         f"{np.bincount(np.asarray(stamps[:-1], int), minlength=int(seconds)).tolist()}")
    line = f"reserved peak {int(recording.get('mem_reserved_peak', 0))} B"
    if "ev_start" in recording and len(recording["ev_start"]):
        s, e = recording["ev_start"], recording["ev_start"] + recording["ev_dur"]
        line += (f", {len(s)} device events from {(s.min() - t0_ns) * 1e-9:.3f} s "
                 f"to {(e.max() - t0_ns) * 1e-9:.3f} s of the window")
    note(line)
    trace_win = tracewin.reduce(recording, t0_ns, t1_ns) if trace else None
    rec = SimpleNamespace(
        cell=c.cell, cfg=cfg, traffic=traffic, geo=geo, seed=seed, window_s=float(seconds),
        steps=counted, stats=window, setup_s=setup_s, inputs_s=inputs_s,
        cpu_s=(cpu1.user + cpu1.system) - (cpu0.user + cpu0.system),
        trace=trace_win, recording=recording)
    args = dict(cfg=cfg, geo=geo, cap=cap, found=found, n_submitted=next_idx,
                n_collected=steps_collected, kept=recording, spec=spec,
                launches=launches if on_card else None)
    if keep is not None:
        keep.update(check_args=args)
    checks, pk = check(**args)
    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return result_line(checks, pk, metrics, c.cell, dev, mem_peak, trace_win), checks


def result_line(checks, pk, metrics, cell, dev, mem_peak, trace_win) -> dict:
    """The contract's last line, the compared numbers last."""
    import torch

    on_card = dev.type == "cuda"
    result = {
        "correct": all(ok for *_, ok in checks),
        "attempted": int(pk["attempted"]),
        "failed": int(pk["missed"] + pk["wrong"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else dev.type,
            "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(mem_peak),
        },
    }
    if trace_win is not None:
        result["device"]["busy_s"] = trace_win.busy_s
        result["device"]["window_s"] = trace_win.window_s
        result["breakdown"] = {"device_ops": trace_win.device_ops,
                               "idle_gaps": trace_win.idle_gaps}
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit, _ in checks}
    return result


def check(cfg, geo, cap, found, n_submitted, n_collected, kept, spec, launches):
    """The compared numbers as [name, value, limit, within], and the
    packet comparison's counts.  `kept`: the checked step's channelizer
    outputs (`chan`) and K2's |corr|^2 rows (`k2_mag2`), as `hook.py`
    kept them; `launches`: the kernels' launches over every step (None
    off the card)."""
    import modem

    lim = cfg["check_limits"]
    pk = reference.compare_packets(found, cap.packets, range(n_submitted), geo.step_chan,
                                   geo.decimation, cfg["designators"],
                                   int(cfg["position_tolerance"]))
    out = [["missed_share", pk["missed"] / max(pk["attempted"], 1), lim["missed_share"]],
           ["wrong_packets", pk["wrong"], lim["wrong_packets"]]]
    if launches is not None:  # kernels run on the card only; the CPU takes plain versions
        out.append(["launch_gap", abs(n_collected - n_submitted) + sum(
            abs(int(launches.get(k, 0)) - n_submitted) for k in cfg["kernels"]), 0])
    if "chan" not in kept or "k2_mag2" not in kept:
        return [[n, v, l, v <= l] for n, v, l in out] + [["check_step_seen", 0, 1, False]], pk
    idx = np.asarray(spec["chan_idx"], np.int64)
    want = reference.channel_outputs(cfg, cap.wire, spec["check_pos"], idx)
    out.append(["chan_gap", reference.chan_gap(kept["chan"], want), lim["chan_gap"]])
    x, ambiguous = reference.k2_input(cfg, cap.wire, spec["check_pos"], spec["k2_rows"],
                                      geo.n_blocks)
    sps = int(round(cfg["input_rate"] / cfg["decimation"] / modem.BIT_RATE))
    pre = modem.preamble(sps)
    want2 = reference.corr_mag2(x, pre)
    mask = reference.compared(ambiguous, pre.size)
    out.append(["corr_gap", reference.corr_gap(kept["k2_mag2"], want2, mask), lim["corr_gap"]])
    note(f"corr_gap over {mask.mean():.4f} of the K2 rows' positions (the rest rest on an "
         "AFC tie)")
    return [[n, v, l, v <= l] for n, v, l in out], pk
