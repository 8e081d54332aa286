"""The port's workbench CLIs on the CPU (`--device cpu`):
`ais_tpu_torch.cli.modem_bench` and `ais_tpu_torch.cli.ais_scope`, and the
debug taps the scope is built on (`pipeline/receiver.py:make_debug_taps`)
against the JAX package's on the same block.

Analogues of `tests/test_modem_bench.py`, `tests/test_scope.py` and the
scope case of `tests/test_streaming.py`.  The scope's panel data must
equal the reference's to 1e-4 (relative to each panel's scale).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_scope import BURST_AT, CFO_HZ, _baseband_capture  # noqa: E402

import ais_tpu.cli.ais_scope as ref_scope  # noqa: E402
from ais_tpu.core.params import DemodConfig  # noqa: E402
from ais_tpu_torch.cli import ais_scope, modem_bench  # noqa: E402
from ais_tpu_torch.pipeline.receiver import make_debug_taps  # noqa: E402

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


def test_clean_loopback_decodes(capsys):
    rc = modem_bench.main(["--demod", "feedforward", "--snr-db", "20", "--trials", "4",
                           "--json", "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    (point,) = out["points"]
    assert point["demod"] == "feedforward"
    assert point["success"] == 1.0


def test_impaired_loopback_mlse(capsys):
    rc = modem_bench.main(["--demod", "mlse", "--snr-db", "12", "--trials", "3", "--cfo-hz",
                           "250", "--ppm", "25", "--json", "--device", "cpu"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["points"][0]["success"] == 1.0


def test_all_chains_table_and_json_match_reference(capsys):
    """`--demod all` runs feedforward, pll and mlse; the JSON line has the
    reference's keys and, on these clean trials, its numbers."""
    import ais_tpu.cli.modem_bench as ref_bench

    argv = ["--demod", "all", "--snr-db", "20", "--trials", "2", "--cfo-hz", "100", "--json"]
    assert modem_bench.main([*argv, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert ref_bench.main(argv) == 0
    assert got == json.loads(capsys.readouterr().out)
    assert [p["demod"] for p in got["points"]] == ["feedforward", "pll", "mlse"]
    assert all(p["success"] == 1.0 for p in got["points"])
    assert modem_bench.main(["--demod", "pll", "--snr-db", "20", "--trials", "1",
                             "--device", "cpu"]) == 0
    assert "pll" in capsys.readouterr().out


def test_parser_has_the_reference_options():
    """Every option of the reference's parsers but `--platform`, which is
    `--device` here (default cuda)."""
    import ais_tpu.cli.modem_bench as ref_bench

    for mine, ref in ((modem_bench, ref_bench), (ais_scope, ref_scope)):
        got = {a.dest: a.default for a in mine.build_parser()._actions}
        want = {a.dest: a.default for a in ref.build_parser()._actions}
        want.pop("platform", None)
        assert got.pop("device") == "cuda"
        assert got == want


def test_debug_taps_match_reference():
    """The four taps of one 16384-sample block against the reference's
    (its FFT correlator gives the same valid span)."""
    from ais_tpu.pipeline.receiver import make_debug_taps as ref_taps

    cfg = DemodConfig()
    x = _baseband_capture()[BURST_AT - 3000: BURST_AT - 3000 + 16384]
    got = make_debug_taps(cfg, 16384, device="cpu")(x)
    want = ref_taps(cfg, 16384)(jnp.asarray(x))
    assert sorted(got) == sorted(want) == ["agc", "corr_mag2", "derotated", "freq_est_hz"]
    for key in ("agc", "derotated", "freq_est_hz"):
        w = np.asarray(want[key])
        assert got[key].shape == w.shape
        np.testing.assert_allclose(got[key].numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=0)
    w = np.asarray(want["corr_mag2"])
    n = min(w.size, got["corr_mag2"].numel())
    assert n >= 16384 - 140
    np.testing.assert_allclose(got["corr_mag2"].numpy()[:n], w[:n], atol=1e-4 * w.max(), rtol=0)
    assert abs(int(got["corr_mag2"].argmax()) - 3000) < 64
    # A batch of blocks keeps its leading axis.
    both = make_debug_taps(cfg, 16384, device="cpu")(np.stack([x, x]))
    assert both["corr_mag2"].shape == (2, got["corr_mag2"].numel())
    assert torch.equal(both["agc"][1], got["agc"])


def test_panel_data_correct():
    iq = _baseband_capture()
    cfg = DemodConfig()
    p = ais_scope.compute_panels(iq, iq, cfg, threshold=0.9, rate=48_000.0, device="cpu")
    # The correlator peak marks the burst; the PSD peak sits at its
    # carrier; the AFC chunk holding it estimates the injected offset.
    assert abs(p["peak"] - BURST_AT) < 64
    assert p["corr2"][p["peak"]] > p["thr"]
    peak_khz = p["psd_f_khz"][int(np.argmax(p["psd_db"]))]
    assert abs(peak_khz * 1e3 - CFO_HZ) < 1000.0
    assert abs(float(p["freq_est_hz"][BURST_AT // cfg.fftlen]) - CFO_HZ) < 25.0
    # And the data behind every panel equals the reference's.
    want = ref_scope.compute_panels(iq, iq, cfg, threshold=0.9, rate=48_000.0)
    assert sorted(p) == sorted(want)
    assert p["peak"] == want["peak"] and p["thr"] == want["thr"] and p["sps"] == want["sps"]
    for key in ("psd_f_khz", "psd_db", "freq_est_hz", "corr2", "agc", "der"):
        w = np.asarray(want[key])
        assert p[key].shape == w.shape, key
        np.testing.assert_allclose(p[key], w, atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=key)


def test_cli_renders_png(tmp_path):
    iq = _baseband_capture()
    cap = tmp_path / "cap.bin"
    iq.astype(np.complex64).tofile(cap)
    out = tmp_path / "scope.png"
    rc = ais_scope.main(["-s", str(cap), "-S", "-o", str(out), "--device", "cpu"])
    assert rc == 0
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert len(data) > 50_000  # six drawn panels, not an empty canvas


def test_wideband_capture_through_the_front_end(tmp_path):
    """Without -S the scope channelizes first: the golden 250 ksps capture's
    packet shows 24 000 channel samples in."""
    from ais_tpu_torch.scene import golden_capture

    iq = golden_capture(250e3)
    baseband, cfg = ais_scope.scoped_baseband(iq, 250e3, "A", "cpu")
    assert cfg.samples_per_symbol == 5.0 and abs(baseband.size - iq.size * 0.192) < 200
    p = ais_scope.compute_panels(iq, baseband, cfg, 0.9, 250e3, device="cpu")
    assert abs(p["peak"] - 24_000) < 256 and p["corr2"][p["peak"]] > p["thr"]
    other, _ = ais_scope.scoped_baseband(iq, 250e3, "B", "cpu")
    q = ais_scope.compute_panels(iq, other, cfg, 0.9, 250e3, device="cpu")
    assert q["corr2"].max() < q["thr"]


def test_render_says_when_matplotlib_is_absent(tmp_path, monkeypatch, capsys):
    """No matplotlib: the panels' data still computes, `render` raises a
    clear error and the CLI exits 1 with it, no ImportError."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    iq = _baseband_capture(40_000)
    p = ais_scope.compute_panels(iq, iq, DemodConfig(), 0.9, 48_000.0, device="cpu")
    assert p["corr2"].size == iq.size
    with pytest.raises(ais_scope.RenderUnavailable, match="matplotlib"):
        ais_scope.render(iq, iq, DemodConfig(), 0.9, str(tmp_path / "x.png"), 48_000.0,
                         device="cpu")
    cap = tmp_path / "cap.bin"
    iq.tofile(cap)
    assert ais_scope.main(["-s", str(cap), "-S", "-o", str(tmp_path / "y.png"),
                           "--device", "cpu"]) == 1
    assert "matplotlib" in capsys.readouterr().err and not (tmp_path / "y.png").exists()
    with pytest.raises(SystemExit, match="matplotlib"):
        modem_bench.main(["--demod", "feedforward", "--snr-db", "20", "--trials", "1",
                          "--device", "cpu", "--plot", str(tmp_path / "m.png")])


def test_scope_renders_png(tmp_path):
    """`python -m ais_tpu_torch.cli.ais_scope` in a child process renders
    the six panels from a capture with no GUI runtime present."""
    from ais_tpu_torch.tx import aivdm_payload_to_bytes, make_packet_iq

    rng = np.random.default_rng(0)
    iq = ((rng.normal(size=96_000) + 1j * rng.normal(size=96_000)) * 0.01).astype(np.complex64)
    packet = make_packet_iq(aivdm_payload_to_bytes("14eG;o@034o8sd<L9i:a;WF>062D"), 5)
    iq[30000: 30000 + packet.size] += packet
    path = tmp_path / "c.iq"
    iq.tofile(path)
    png = tmp_path / "scope.png"
    env = {**os.environ, "MPLBACKEND": "Agg"}
    out = subprocess.run(
        [sys.executable, "-m", "ais_tpu_torch.cli.ais_scope", "-s", str(path), "-S", "-o",
         str(png), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    data = png.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 20000


def test_modem_bench_plot(tmp_path):
    out = tmp_path / "modem.png"
    rc = modem_bench.main(["--demod", "pll", "--snr-db", "15", "--trials", "1", "--cfo-hz", "80",
                           "--device", "cpu", "--plot", str(out)])
    assert rc == 0 and out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
