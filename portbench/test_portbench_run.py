"""The harness end to end on the CPU at a cut size, through the
program's plain paths: the result line, the checks, a cell, a traffic
mix and a metric added as files only, and the guard against JAX."""

import json
import shutil

import pytest

import harness
from conftest import BENCH, make_checkout, run_cell

E2E = {"msamples_per_s": "Msamples/s", "setup_s": "s"}


def _check_lines(stderr: str) -> list:
    lines = stderr.strip().splitlines()
    tail = [ln for ln in lines if ln.startswith("check ")]
    assert tail and lines[-len(tail):] == tail  # the checks close standard error
    return tail


@pytest.mark.parametrize("name", ["tiny_cr1", "tiny_ci1", "tiny_ci8", "tiny_ci16"])
def test_a_run_prints_the_contract_line(tiny, name):
    rc, result, err = run_cell(tiny, name, seconds=3.0)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"
    assert {k: v["unit"] for k, v in result["metrics"].items()} == E2E
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu" and result["device"]["count"] == 1
    assert {ln.split()[1] for ln in _check_lines(err)} == set(result["checks"])


def test_a_traced_run_reads_the_per_layer_metrics(tiny):
    rc, result, err = run_cell(tiny, "tiny_cr1", seconds=2.0, trace=1)
    assert rc == 0, err[-3000:]
    # No card: no device trace, so the device readers find nothing and stay silent.
    assert set(result["metrics"]) == {"stage_ms", "exec_ms", "host_half_ms", "host_cpu_pct"}
    assert "busy_s" not in result["device"]


def test_a_cell_a_mix_and_a_metric_are_added_as_files(tmp_path):
    co = make_checkout(tmp_path)
    (co / "portbench" / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return run.steps\n")
    manifest = json.loads((co / "BENCHMARK.json").read_text())
    manifest["per_layer"].append({
        "name": "steps_in_window", "unit": "steps", "better": "higher", "source": "host_clock",
        "layer": "host process", "moves": "msamples_per_s", "workloads": ["tiny_ci1"]})
    (co / "BENCHMARK.json").write_text(json.dumps(manifest))
    rc, result, err = run_cell(co, "tiny_ci1", seconds=2.0, trace=1)
    assert rc == 0, err[-3000:]
    assert result["metrics"]["steps_in_window"]["value"] >= 1
    for path in BENCH.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            rel = path.relative_to(BENCH)
            assert (co / "portbench" / rel).read_bytes() == path.read_bytes(), rel


def _stubs(tmp_path, body: str, *, site: str = "") -> str:
    for name in harness.FORBIDDEN:
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(body)
    if site:
        (tmp_path / "sitecustomize.py").write_text(site)
    return str(tmp_path)


@pytest.mark.parametrize("name", ["tiny_cr1", "tiny_ci1"])
def test_runs_with_jax_and_the_jax_package_blocked(tiny, tmp_path, name):
    path = _stubs(tmp_path, "raise ImportError('blocked in this test')\n")
    rc, result, err = run_cell(tiny, name, seconds=2.0, pythonpath=path)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True


def test_a_loaded_jax_package_refuses_the_result(tiny, tmp_path):
    path = _stubs(tmp_path, "", site="import ais_tpu\n")
    rc, result, err = run_cell(tiny, "tiny_cr1", seconds=1.0, pythonpath=path)
    assert rc == 3 and result is None
    assert "ais_tpu" in err.splitlines()[-1]


def test_top_level_names_are_compared_whole(monkeypatch):
    import sys
    import types

    for name in ("ais_tpu_torch_extra", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax"]


def test_no_card_no_result(tmp_path):
    """run.py itself looks for a card first and prints no result without one."""
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    co = make_checkout(tmp_path)
    shutil.copy(BENCH / "run.py", co / "portbench" / "run.py")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "tiny_cr1",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=co, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
