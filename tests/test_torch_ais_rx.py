"""The port's `ais_rx` CLI (`python -m ais_tpu_torch.cli.ais_rx`)
against the reference's (`ais_tpu/cli/ais_rx.py`): the same options
plus `--device`, and the golden sentence from a 250 ksps cf32 capture
file (the packet on channel A, `scene.golden_capture`).
"""

import pytest
import torch

from ais_tpu_torch.cli import ais_rx
from ais_tpu_torch.scene import GOLDEN_SENTENCE as SENTENCE
from ais_tpu_torch.scene import golden_capture

torch.set_num_threads(1)


def test_parser_has_the_reference_options():
    from ais_tpu.cli.ais_rx import build_parser as ref_parser

    def opts(p):
        return {(a.dest, tuple(a.option_strings), a.default, tuple(a.choices or ()))
                for a in p._actions if a.dest != "help"}

    got, want = opts(ais_rx.build_parser()), opts(ref_parser())
    assert want <= got
    assert got - want == {("device", ("--device",), "cuda", ())}


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    path = tmp_path_factory.mktemp("cap") / "golden.cf32"
    golden_capture(250e3).tofile(path)
    return str(path)


def test_golden_sentence_on_cpu(capture, capsys):
    assert ais_rx.main(["-s", capture, "-r", "250000", "--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert out.out.splitlines() == [SENTENCE]
    assert "Rate is 250000" in out.err


def test_meta_and_decode_lines(capture, capsys):
    ais_rx.main(["-s", capture, "-r", "250000", "--device", "cpu", "--meta", "--decode",
                 "--demod", "mlse"])
    (line,) = capsys.readouterr().out.splitlines()
    assert line.startswith("[A @") and "rssi=" in line and "dBfs] " + SENTENCE in line
    assert line.endswith("}") and "mmsi" in line.lower()
