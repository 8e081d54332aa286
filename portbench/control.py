"""The readings that the check's limits are set from (not run by run.py).

    python3 portbench/control.py --workload <name> --seeds <n> [<n> ...]

For each seed: one run of the cell with a short window (`--seconds`),
its compared numbers, and then the same check (`harness.check`) with the
control in the program's place: the reference one precision below the
float32 that the configuration states (bfloat16 operands, float32
sums) for the channelizer's outputs and K2's |corr|^2, on the run's own
checked step.  One JSON line a seed on standard
output: the program's numbers, `correct`, and the control's numbers
(`control_<name>`) and `control_correct`.
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


def control_checks(args: dict) -> list:
    """`harness.check` of a run (`args`, as the run gave it) with the
    control's outputs in the place of the program's."""
    import numpy as np

    import modem
    import reference

    cfg, wire, spec, geo = args["cfg"], args["cap"].wire, args["spec"], args["geo"]
    idx = np.asarray(spec["chan_idx"], np.int64)
    chan = reference.channel_outputs(cfg, wire, spec["check_pos"], idx, precision="bf16")
    x, _ = reference.k2_input(cfg, wire, spec["check_pos"], spec["k2_rows"], geo.n_blocks)
    sps = int(round(cfg["input_rate"] / cfg["decimation"] / modem.BIT_RATE))
    mag2 = reference.corr_mag2(x, modem.preamble(sps), precision="bf16")
    checks, _ = harness.check(**dict(args, kept={"chan": chan, "k2_mag2": mag2}))
    return checks


def main(argv=None, device: str = "cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        keep = {}
        result, checks = harness.run(args.workload, seed, args.seconds, False, device=device,
                                     keep=keep)
        ctrl = control_checks(keep["check_args"])
        line = {"workload": args.workload, "seed": seed, "correct": result["correct"],
                **{name: value for name, value, _, _ in checks},
                "control_correct": all(ok for *_, ok in ctrl),
                **{f"control_{name}": value for name, value, _, _ in ctrl
                   if name in ("chan_gap", "corr_gap")}}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
