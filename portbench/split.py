"""One run of a cell with the receiver's own span log on: the host back
half split into its parts, and the idle gaps named by program spans.

    python3 portbench/split.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
                               [--spans 0|1] [--device cuda|cpu]

Runs the cell as `run.py` does (`harness.run`, the same window, checks
and result line) and prints, as the last line of standard output, one
JSON object: the result line's `correct`, the window's `msamples_per_s`
and the split below.  With `--spans 1` (the default) the program's span
log, `ais_tpu_torch.utils.profiling.SPANS`, is on for the whole run,
with a span for every garbage collection; `--spans 0` leaves it off, so
that a pair of runs on one seed gives what the log costs.

Per step of the window, from the receiver's `collect_stats` as it stood
when the window closed (the keys the engine's `stats()` passes on, and
the rest): `unpack_ms`, `deframe_ms`, `emit_ms`, `recover_ms`,
`dispatch_ms`; `burst_yield_pct` (frames the deframer returned over the
valid lanes shipped to the host); `gc_ms` (collections inside the
window, from the log); beside them the benchmark's own `stage_ms`,
`exec_ms`, `host_half_ms`, `host_cpu_pct` and, traced, `device_idle_pct`
(its readers).  Traced, `idle_gaps` are the breakdown's ten longest,
each label followed by the spans of the log live at the gap's middle,
outermost first (`decode_fetched/rx.host/rx.host.deframe/gc2`); besides
the program's, the log then holds the engine's `collect` and `submit`
and the harness's look at the card's memory as `bench.collect`,
`bench.submit` and `bench.memory`, so that a gap outside the receiver's
calls is named too.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
for _p in (str(_HERE.parent), str(_HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import harness  # noqa: E402
import tracewin  # noqa: E402

PARTS = {"unpack_ms": "unpack_s", "deframe_ms": "deframe_s", "emit_ms": "emit_s",
         "recover_ms": "recover_s", "dispatch_ms": "dispatch_s"}
READERS = ("msamples_per_s", "stage_ms", "exec_ms", "host_half_ms", "host_cpu_pct",
           "device_idle_pct")


def per_step_ms(stats: dict, key: str) -> float | None:
    """Milliseconds a step of `stats[key]`; None where the program has no such key."""
    if key not in stats or not stats.get("steps"):
        return None
    return 1e3 * stats[key] / stats["steps"]


def burst_yield_pct(stats: dict) -> float | None:
    """Frames the deframer returned, before dedup, over the valid lanes
    shipped to the host."""
    if not stats.get("lanes"):
        return None
    return 100.0 * stats["frames"] / stats["lanes"]


def gc_seconds(spans: dict, t0_ns: int, t1_ns: int) -> dict:
    """Seconds of each `gc<n>` span inside [t0_ns, t1_ns), and their count."""
    out = {}
    for i, name in enumerate(spans["names"]):
        if not str(name).startswith("gc"):
            continue
        sel = spans["name"] == i
        s = np.maximum(spans["start_ns"][sel], t0_ns)
        e = np.minimum(spans["end_ns"][sel], t1_ns)
        keep = e > s
        out[str(name)] = [int(keep.sum()), float((e[keep] - s[keep]).sum()) * 1e-9]
    return out


def nest(spans: dict, t: int) -> str:
    """The spans live at `t`, outermost first, joined by '/' ('' for none)."""
    live = np.nonzero((spans["start_ns"] <= t) & (spans["end_ns"] > t))[0]
    live = live[np.argsort(spans["start_ns"][live], kind="stable")]
    return "/".join(str(spans["names"][spans["name"][i]]) for i in live)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def split(args: argparse.Namespace) -> dict:
    from ais_tpu_torch.utils.profiling import SPANS

    seen: dict = {}
    engine, label, reader = harness.Engine, tracewin._label, harness.reader
    reset_stats, stats = engine.reset_stats, engine.stats

    def reset_and_mark(self):
        reset_stats(self)
        seen["t0_ns"] = time.time_ns()  # the last reset opens the window

    def stats_and_keep(self):
        seen["stats"] = dict(self.rx.collect_stats)
        return stats(self)

    def spans_now() -> dict:
        if "spans" not in seen:
            seen["spans"] = SPANS.arrays()
        return seen["spans"]

    def label_with_span(rec, t):
        inner = nest(spans_now(), t) if SPANS.on else ""
        return f"{label(rec, t)}/{inner}" if inner else label(rec, t)

    def bench_span(name, fn):
        def spanned(*args, **kwargs):
            with SPANS.span(name, -1):
                return fn(*args, **kwargs)
        return spanned

    def reader_keeping_run(name):
        read = reader(name)

        def keep(run):
            seen["run"] = run
            return read(run)
        return keep

    kept = {name: getattr(engine, name) for name in ("collect", "submit")}
    memory = harness._device_memory_used
    engine.reset_stats, engine.stats = reset_and_mark, stats_and_keep
    tracewin._label, harness.reader = label_with_span, reader_keeping_run
    for name, fn in kept.items():
        setattr(engine, name, bench_span(f"bench.{name}", fn))
    harness._device_memory_used = bench_span("bench.memory", memory)
    SPANS.clear()
    if args.spans:
        SPANS.enable(gc=True)
    try:
        result, _ = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                device=args.device)
        spans = spans_now()
    finally:
        SPANS.disable()
        engine.reset_stats, engine.stats = reset_stats, stats
        tracewin._label, harness.reader = label, reader
        for name, fn in kept.items():
            setattr(engine, name, fn)
        harness._device_memory_used = memory
    run, st = seen["run"], seen["stats"]
    t0_ns = seen["t0_ns"]
    t1_ns = t0_ns + int(args.seconds * 1e9)
    gcs = gc_seconds(spans, t0_ns, t1_ns) if args.spans else {}
    out = {"workload": args.workload, "seed": args.seed, "trace": args.trace,
           "spans": args.spans, "correct": result["correct"], "device": result["device"]["kind"]}
    for name in READERS:
        value = reader(name)(run)
        if value is not None:
            out[name] = value
    out.update({name: per_step_ms(st, key) for name, key in PARTS.items()})
    out["burst_yield_pct"] = burst_yield_pct(st)
    if args.spans:
        out["gc_ms"] = 1e3 * sum(s for _, s in gcs.values()) / st["steps"]
        out["gc_in_window"] = gcs
    host_parts = [out[k] for k in ("unpack_ms", "deframe_ms", "emit_ms", "recover_ms")]
    if None not in host_parts and out.get("host_half_ms"):
        out["parts_of_host_half_pct"] = 100.0 * sum(host_parts) / out["host_half_ms"]
    out["steps"] = st["steps"]
    out["lanes_a_step"] = st.get("lanes", 0) / max(st["steps"], 1)
    if "breakdown" in result:
        out["idle_gaps"] = result["breakdown"]["idle_gaps"]
        out["busy_s"] = result["device"]["busy_s"]
    return out


def main(argv=None) -> int:
    args = parse(argv)
    print(json.dumps(split(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
