"""`split.py` on the CPU at a cut size: the receiver's parts against its
host half, the collections in the window, the gaps' program spans, and
the helpers on hand-made spans."""

import json
import subprocess
import sys

import numpy as np
import pytest

import split


def _split(checkout, *args):
    proc = subprocess.run(
        [sys.executable, "portbench/split.py", "--device", "cpu", "--workload", "tiny_cr1",
         "--seed", "2147483999", "--seconds", "2", *args],
        cwd=checkout, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("spans", ["1", "0"])
def test_the_parts_account_for_the_host_half(tiny, spans):
    out = _split(tiny, "--trace", "1", "--spans", spans)
    assert out["correct"] is True and out["steps"] >= 1 and out["msamples_per_s"] > 0
    parts = [out[k] for k in ("unpack_ms", "deframe_ms", "emit_ms", "recover_ms")]
    assert min(parts) >= 0 and sum(parts) <= out["host_half_ms"]
    assert out["parts_of_host_half_pct"] > 50
    assert 0 < out["dispatch_ms"] <= out["exec_ms"]
    assert out["burst_yield_pct"] > 0
    assert ("gc_ms" in out) == (spans == "1")
    assert "idle_gaps" not in out  # no card, no device trace


def test_the_helpers():
    spans = {"names": np.array(["rx.host", "rx.host.emit", "gc2"]),
             "name": np.array([0, 1, 2], np.int32),
             "start_ns": np.array([100, 110, 120]), "end_ns": np.array([200, 150, 130])}
    assert split.nest(spans, 125) == "rx.host/rx.host.emit/gc2"
    assert split.nest(spans, 140) == "rx.host/rx.host.emit"
    assert split.nest(spans, 170) == "rx.host" and split.nest(spans, 250) == ""
    assert split.gc_seconds(spans, 0, 125) == {"gc2": [1, 5e-9]}
    st = {"steps": 4, "unpack_s": 0.02, "lanes": 10, "frames": 4}
    assert split.per_step_ms(st, "unpack_s") == pytest.approx(5.0)
    assert split.per_step_ms(st, "deframe_s") is None  # a program without the key
    assert split.burst_yield_pct(st) == pytest.approx(40.0)
    assert split.burst_yield_pct({"steps": 4}) is None
