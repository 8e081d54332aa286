"""Fixtures of the benchmark's CPU tests (`python -m pytest portbench -q`).

`tiny` is a throwaway checkout: a copy of `portbench/` and
`BENCHMARK.json`, the program beside them, and cells cut to 3 demod
blocks on the CPU (`tiny_<wire format>`; the ci1 configuration is the
tests' own), added as new files and new manifest entries only.
`run_cell` runs one of its cells in a child process the way `run.py`
does, past the look for a card, and returns the exit code, the result
line and standard error; `run_control` runs `control.py` the same way,
on the CPU or the card.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
TINY = dict(blocks=3, outstanding=2, warm_steps=2, check_outputs=64, check_rows=2)
CELLS = {"cr1": ("wb2m4_cr1", "archive_light"), "ci1": ("wb2m4_ci1", "archive_light")}


def ci1_config() -> dict:
    """The receiver of `wb2m4_cr1` on the 1-bit IQ wire (K3), as a later
    cell would add it: a configuration of the tests' own."""
    cfg = json.loads((BENCH / "configs" / "wb2m4_cr1.json").read_text())
    del cfg["cr1_a2"]
    cfg.update(name="wb2m4_ci1", wire_format="ci1", wire_headroom=0.7,
               kernels=["wire_channelizer_ci1_mma", "matched_filter"])
    return cfg

# Runs a cell on the CPU past run.py's look for a card.
DRIVER = """\
import sys
sys.path[:0] = [{bench!r}, {root!r}]
import run
sys.exit(run.run_and_print(run.parse(sys.argv[1:]), "cpu"))
"""


def make_checkout(dest: Path) -> Path:
    """A copy of the benchmark with the tiny cells added as new files."""
    shutil.copytree(BENCH, dest / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    (dest / "ais_tpu_torch").symlink_to(ROOT / "ais_tpu_torch")
    manifest = json.loads((dest / "BENCHMARK.json").read_text())
    (dest / "portbench" / "configs" / "wb2m4_ci1.json").write_text(json.dumps(ci1_config()))
    manifest["configs"].append({"name": "wb2m4_ci1", "source": "a CPU test",
                                "file": "portbench/configs/wb2m4_ci1.json", "reduced": [],
                                "why": "a CPU test"})
    for tag, (config, traffic) in CELLS.items():
        name = f"tiny_{tag}"
        t = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
        t.update(TINY)
        (dest / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(t))
        manifest["workloads"].append({"name": name, "config": config, "traffic": name,
                                      "chips": 1, "why": "a CPU test"})
        for metric in manifest["per_layer"]:
            metric["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    (dest / "drive.py").write_text(DRIVER.format(bench=str(dest / "portbench"), root=str(dest)))
    return dest


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> Path:
    return make_checkout(tmp_path_factory.mktemp("checkout"))


def run_cell(checkout: Path, name: str, seed: int = 2147483999, seconds: float = 2.0,
             trace: int = 0, pythonpath: str | None = None, timeout: float = 240):
    """(exit code, result line or None, standard error) of one run."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    if pythonpath:
        env["PYTHONPATH"] = pythonpath + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, str(checkout / "drive.py"), "--workload", name, "--seed", str(seed),
         "--seconds", str(seconds), "--trace", str(trace)],
        cwd=checkout, env=env, capture_output=True, text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
    return proc.returncode, result, proc.stderr


CONTROL = """\
import sys
sys.path[:0] = [{bench!r}, {root!r}]
import control
sys.exit(control.main(sys.argv[1:], device={device!r}))
"""


def run_control(checkout: Path, workload: str, seeds, device: str, seconds: float = 2.0,
                pythonpath: str | None = None) -> list:
    """`control.py`'s JSON lines for `seeds`, one process."""
    env = dict(os.environ)
    if pythonpath:
        env["PYTHONPATH"] = pythonpath + os.pathsep + env.get("PYTHONPATH", "")
    code = CONTROL.format(bench=str(checkout / "portbench"), root=str(checkout), device=device)
    proc = subprocess.run([sys.executable, "-c", code, "--workload", workload, "--seeds",
                           *map(str, seeds), "--seconds", str(seconds)],
                          cwd=checkout, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(line) for line in proc.stdout.strip().splitlines()]


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run the port's kernels")
    return torch.device("cuda")
