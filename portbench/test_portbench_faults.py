"""A run with the timed path broken underneath it (patched into the
program by a `sitecustomize` first on the path) comes out not correct:
a step that returns its state unchanged (the previous step's packets
again), half of the batch left out (the second half of every channel
zeroed), an answer altered where it is produced (one payload byte
flipped).  One card, so no exchange between chips to leave out.  On the
CPU at 3 blocks, and at the cell's own size on the card."""

import json

import pytest

from conftest import ROOT, run_cell, run_control

PATCH = """\
import sys
sys.path.insert(0, {root!r})
import dataclasses
from ais_tpu_torch.pipeline import wideband

FAULT = {fault!r}
rx = wideband.WidebandReceiver
decode, channels = rx.decode_fetched, rx.wire_channels

def stale(self, fetched):
    now = decode(self, fetched)
    before = getattr(self, "_fault_last", now)
    self._fault_last = now
    return before

def half(self, *args, **kwargs):
    out = channels(self, *args, **kwargs)
    out[:, out.shape[-1] // 2:] = 0
    return out

def altered(self, fetched):
    out = decode(self, fetched)
    if out:
        p = out[0]
        out[0] = dataclasses.replace(p, payload=bytes([p.payload[0] ^ 1]) + p.payload[1:])
    return out

if FAULT == "half":
    rx.wire_channels = half
else:
    rx.decode_fetched = {{"stale": stale, "altered": altered}}[FAULT]
"""
FAULTS = ["stale", "half", "altered"]


def _patch(tmp_path, root, fault) -> str:
    (tmp_path / "sitecustomize.py").write_text(PATCH.format(root=str(root), fault=fault))
    return str(tmp_path)


@pytest.mark.parametrize("tag", ["cr1", "ci1"])
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_step_is_not_correct(tiny, tmp_path, tag, fault):
    rc, result, err = run_cell(tiny, f"tiny_{tag}", seconds=2.0,
                               pythonpath=_patch(tmp_path, tiny, fault))
    assert rc == 0, err[-3000:]
    assert result["correct"] is False
    assert result["failed"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("fault", FAULTS)
def test_a_broken_step_is_not_correct_on_the_card(cuda, tmp_path, fault):
    lines = run_control(ROOT, "cr1_archive_1proc", [2147483621, 2147483622, 2147483623],
                        "cuda", 4.0, pythonpath=_patch(tmp_path, ROOT, fault))
    for ln in lines:
        print(json.dumps(dict(ln, fault=fault)))
        assert ln["correct"] is False
