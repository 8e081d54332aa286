"""The control: the reference put in the program's place one precision
below the configuration's float32 (bfloat16 operands, float32 sums),
judged by the run's own check, comes out not correct on the
channelizer's and K2's numbers, which the program passes; at a size a
test run holds (3 blocks, the CPU; both 1-bit wires), and at the cell's
own size on the card.  (The ci1 configuration's limits are cr1's.)"""

import json

import pytest

from conftest import BENCH, ROOT, run_control


def _assert_separated(lines):
    lim = json.loads((BENCH / "configs" / "wb2m4_cr1.json").read_text())["check_limits"]
    for ln in lines:
        print(json.dumps(ln))
        assert ln["correct"] is True and ln["control_correct"] is False
        assert ln["chan_gap"] < lim["chan_gap"] < ln["control_chan_gap"]
        assert ln["corr_gap"] < lim["corr_gap"] < ln["control_corr_gap"]
        assert ln["control_chan_gap"] >= 3 * lim["chan_gap"]


@pytest.mark.parametrize("tag", ["cr1", "ci1"])
def test_control_fails_where_the_program_passes(tiny, tag):
    _assert_separated(run_control(tiny, f"tiny_{tag}", [2147483601, 2147483602], "cpu"))


@pytest.mark.gpu
def test_control_at_the_cells_size_on_the_card(cuda):
    _assert_separated(run_control(ROOT, "cr1_archive_1proc", [2147483611, 2147483612,
                                                              2147483613], "cuda", 4.0))
