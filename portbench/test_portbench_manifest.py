"""BENCHMARK.json against the benchmark's contract, and every name it
uses found as a file."""

import json
import re

import pytest

from conftest import BENCH, ROOT

M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")


def test_top_level_keys_and_limits():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert M["command"] == ["python3", "portbench/run.py"]
    assert M["paths"] == ["portbench"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024
    assert all(TEXT.match(w) for w in M["command"])


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves", "workloads"}),
])
def test_entries_have_just_the_contract_keys(section, keys):
    for entry in M[section]:
        assert set(entry) == keys, entry["name"]


def test_names_units_and_text():
    names = [e["name"] for s in ("configs", "workloads", "end_to_end", "per_layer") for e in M[s]]
    assert all(NAME.match(n) for n in names)
    assert len({e["name"] for e in M["end_to_end"] + M["per_layer"]}) == len(
        M["end_to_end"] + M["per_layer"])
    for section in ("configs", "workloads"):
        assert len({e["name"] for e in M[section]}) == len(M[section])
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in M["configs"] + M["workloads"]:
        assert TEXT.match(e["why"])
    for c in M["configs"]:
        assert TEXT.match(c["source"]) and c["reduced"] == [] and len(c["reduced"]) <= 16
    for m in M["per_layer"]:
        assert TEXT.match(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e


def test_every_name_is_a_file_and_every_cell_reports_enough():
    configs = {c["name"]: c for c in M["configs"]}
    cells = {w["name"]: w for w in M["workloads"]}
    used = {w["config"] for w in cells.values()}
    assert used == set(configs)
    assert len({c["file"] for c in configs.values()}) == len(configs)
    for c in configs.values():
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    for w in cells.values():
        assert w["chips"] in (1, 4)
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    for m in M["end_to_end"] + M["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= set(cells)
    for name in cells:
        per_layer = [m for m in M["per_layer"] if name in m.get("workloads", cells)]
        e2e = [m["name"] for m in M["end_to_end"] if name in m.get("workloads", cells)]
        assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
        assert all(m["moves"] in e2e for m in per_layer)


def test_check_limits_separate_program_and_control():
    """Every configuration states a limit for each compared number."""
    for c in M["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert set(cfg["check_limits"]) == {"missed_share", "wrong_packets", "chan_gap",
                                            "corr_gap"}
        assert cfg["check_limits"]["wrong_packets"] == 0
