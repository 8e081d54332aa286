"""Fixtures of the benchmark's CPU tests (`python -m pytest portbench -q`).

`tiny` is a throwaway checkout: a copy of `portbench/` and
`BENCHMARK.json`, the program beside them, and cells cut to 3 demod
blocks on the CPU (`tiny_<wire format>`, all on `archive_light`; the
ci1, ci8 and ci16 configurations are the tests' own), added as new files
and new manifest entries only.
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
CELLS = {"cr1": "wb2m4_cr1", "ci1": "wb2m4_ci1", "ci8": "wb2m4_ci8", "ci16": "wb2m4_ci16"}


def _variant(name: str, **changes) -> dict:
    cfg = json.loads((BENCH / "configs" / "wb2m4_cr1.json").read_text())
    del cfg["cr1_a2"]
    cfg.update(name=name, **changes)
    return cfg


def ci1_config() -> dict:
    """The receiver of `wb2m4_cr1` on the 1-bit IQ wire (K3), as a later
    cell would add it: a configuration of the tests' own."""
    return _variant("wb2m4_ci1", wire_format="ci1", wire_headroom=0.7,
                    kernels=["wire_channelizer_ci1_mma", "matched_filter"])


def ci8_config() -> dict:
    """The receiver of `wb2m4_cr1` on the 8-bit IQ wire of an 8-bit SDR
    (the device's decode, then K5), the capture's peak at 0.9 of full
    scale: a configuration of the tests' own."""
    return _variant("wb2m4_ci8", wire_format="ci8", wire_headroom=0.9,
                    kernels=["channelizer", "matched_filter"])


def ci16_config() -> dict:
    """The same receiver on the 16-bit IQ wire: a configuration of the
    tests' own."""
    return _variant("wb2m4_ci16", wire_format="ci16", wire_headroom=0.9,
                    kernels=["channelizer", "matched_filter"])


TEST_CONFIGS = {"wb2m4_ci1": ci1_config, "wb2m4_ci8": ci8_config, "wb2m4_ci16": ci16_config}


def tiny_traffic() -> dict:
    """The traffic of every `tiny_<tag>`: archive_light cut to TINY."""
    t = json.loads((BENCH / "traffic" / "archive_light.json").read_text())
    t.update(TINY)
    return t


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
    for config, make in TEST_CONFIGS.items():
        (dest / "portbench" / "configs" / f"{config}.json").write_text(json.dumps(make()))
        manifest["configs"].append({"name": config, "source": "a CPU test",
                                    "file": f"portbench/configs/{config}.json", "reduced": [],
                                    "why": "a CPU test"})
    for tag, config in CELLS.items():
        name = f"tiny_{tag}"
        (dest / "portbench" / "traffic" / f"{name}.json").write_text(json.dumps(tiny_traffic()))
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
