"""The RTL-SDR deployment (`wb2m4_cu8`, cell `sdr8_archive`) at a size a
CPU test holds: its configuration on `archive_light` cut to `TINY`,
added to a throwaway checkout as a new traffic file and a new manifest
entry (`tiny_cu8`).  A sound run is correct; the stale, half and altered
faults and the control are not.  The `k5_roofline` reader, on no trace
and on a synthetic one.  The configuration against `wb2m4_cr1`'s."""

import json
from types import SimpleNamespace

import pytest

import harness
from conftest import BENCH, make_checkout, run_cell, run_control, tiny_traffic
from test_portbench_control import _assert_separated
from test_portbench_faults import FAULTS, _patch

CELL = "tiny_cu8"


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    co = make_checkout(tmp_path_factory.mktemp("cu8_checkout"))
    (co / "portbench" / "traffic" / f"{CELL}.json").write_text(json.dumps(tiny_traffic()))
    manifest = json.loads((co / "BENCHMARK.json").read_text())
    manifest["workloads"].append({"name": CELL, "config": "wb2m4_cu8", "traffic": CELL,
                                  "chips": 1, "why": "a CPU test"})
    for metric in manifest["per_layer"]:
        if "sdr8_archive" in metric["workloads"]:
            metric["workloads"].append(CELL)
    (co / "BENCHMARK.json").write_text(json.dumps(manifest))
    return co


# The checked step is the window's first or second submitted (harness.check_spec): a window of a
# few CPU steps reaches it even when other tests load the machine.
WINDOW_S = 6.0


def test_a_run_is_correct(checkout):
    rc, result, err = run_cell(checkout, CELL, seconds=WINDOW_S)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"msamples_per_s", "setup_s"}


def test_a_traced_run_on_the_cpu_leaves_the_device_readers_silent(checkout):
    rc, result, err = run_cell(checkout, CELL, seconds=2.0, trace=1)
    assert rc == 0, err[-3000:]
    assert set(result["metrics"]) == {"stage_ms", "exec_ms", "host_half_ms", "host_cpu_pct"}


@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_step_is_not_correct(checkout, tmp_path, fault):
    rc, result, err = run_cell(checkout, CELL, seconds=2.0,
                               pythonpath=_patch(tmp_path, checkout, fault))
    assert rc == 0, err[-3000:]
    assert result["correct"] is False and result["failed"] > 0


def test_control_fails_where_the_program_passes(checkout):
    _assert_separated(run_control(checkout, CELL, [2147483631, 2147483632], "cpu", WINDOW_S))


def _run(kernels: dict | None):
    cfg = json.loads((BENCH / "configs" / "wb2m4_cu8.json").read_text())
    trace = None if kernels is None else SimpleNamespace(kernels=kernels)
    return SimpleNamespace(trace=trace, geo=harness.geometry(cfg, 384), cfg=cfg)


def test_k5_roofline_reads_the_cu8_entry_alone():
    import roofline

    read = harness.reader("k5_roofline")
    assert read(_run(None)) is None
    assert read(_run({})) is None
    geo = _run({}).geo
    least = roofline.channelizer_work("cu8", geo.n_in, 2, geo.n_out, geo.ntaps).least_s()
    assert geo.n_in == 226_026_200
    ns = "(anonymous namespace)::"
    kernels = {
        # 10 launches in 8 times their least time: 12.5 %
        f"void {ns}channelizer_kernel<{ns}DecodeCu8, 2, 8, 50>(void const*, float2 const*, "
        "float const*, float2*, long long, int, int, int, int, int, int, int, int)":
            (10, 80 * least),
        f"void {ns}channelizer_kernel<{ns}DecodeF32, 2, 8, 50>(void const*, float2 const*, "
        "float const*, float2*, long long, int, int, int, int, int, int, int, int)": (10, 1.0),
        "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
        "at::detail::Array<char*, 3> >(int, at::native::CUDAFunctor_add<float>, "
        "at::detail::Array<char*, 3>)": (30, 2.0),
    }
    assert read(_run(kernels)) == pytest.approx(12.5)


def test_the_configuration_is_cr1s_on_the_cu8_wire():
    cr1 = json.loads((BENCH / "configs" / "wb2m4_cr1.json").read_text())
    cu8 = json.loads((BENCH / "configs" / "wb2m4_cu8.json").read_text())
    named = {"name", "about", "wire_format", "wire_headroom", "kernels", "assumed", "cr1_a2"}
    assert {k: v for k, v in cr1.items() if k not in named} == \
        {k: v for k, v in cu8.items() if k not in named}
    assert "cr1_a2" not in cu8 and cu8["reduced"] == []
    assert (cu8["name"], cu8["wire_format"], cu8["wire_headroom"]) == ("wb2m4_cu8", "cu8", 0.9)
    assert cu8["kernels"] == ["wire_channelizer_cu8", "matched_filter"]
    assert cu8["precision"] == "float32"
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cell = next(w for w in manifest["workloads"] if w["name"] == "sdr8_archive")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("wb2m4_cu8", "archive_light", 1)
    k1 = next(m for m in manifest["per_layer"] if m["name"] == "k1_roofline")
    assert "sdr8_archive" not in k1["workloads"]
