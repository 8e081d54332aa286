"""Run one cell of BENCHMARK.json once on this machine's card.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the compared numbers, each beside its limit, as the last lines of
standard error, and one JSON object as the last line of standard output
(`--trace 0`: the cell's end-to-end metrics; `--trace 1`: its per-layer
metrics, the device's busy and window seconds and a breakdown).  Exits
non-zero, printing no result, without a card or with fewer cards than
the cell asks for, or when jax, jaxlib, flax or ais_tpu were loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

_HERE = Path(__file__).resolve().parent
for _p in (str(_HERE.parent), str(_HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import harness  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_and_print(args: argparse.Namespace, device: str) -> int:
    """The run after the card check: print the checks and the result."""
    result, checks = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                 device=device)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded {', '.join(bad)}; the port must not load them",
              file=sys.stderr)
        return 3
    for name, value, limit, ok in checks:
        print(f"check {name} {value!r} limit {limit!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    chips = int(harness.load_cell(harness.BENCH.parent, args.workload).cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return run_and_print(args, "cuda")


if __name__ == "__main__":
    sys.exit(main())
