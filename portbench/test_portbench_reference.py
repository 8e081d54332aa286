"""The plain reference against the program's plain versions at a small
size, and the comparison failing where it has to: one corrupted packet,
one perturbed channel sample, the bfloat16 control."""

import json

import numpy as np
import pytest
import torch

import modem
import reference
import scene
import sdenc
from conftest import BENCH, ci1_config

CFG = {"cr1": json.loads((BENCH / "configs" / "wb2m4_cr1.json").read_text()),
       "ci1": ci1_config()}


def _wire(tag: str, n: int, seed: int = 3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    re, im = (rng.normal(size=n).astype(np.float32) for _ in range(2))
    return sdenc.encode(tag, re, im, 0.3, CFG[tag].get("cr1_a2", 0.0))


def _program_channels(tag: str, wire: np.ndarray, n: int, pos: int) -> np.ndarray:
    from ais_tpu_torch.ops.fir import mixer_phase
    from ais_tpu_torch.ops.wire_channelizer import PackedWireChannelizer, WireChannelizer
    from ais_tpu_torch.pipeline.wideband import channel_taps

    from harness import program_config, geometry

    cfg = CFG[tag]
    wcfg = program_config(cfg, geometry(cfg, 1))
    args = (channel_taps(wcfg), cfg["decimation"], wcfg.offsets_hz, wcfg.input_rate, n)
    mod = (WireChannelizer(*args, device="cpu") if tag == "cr1"
           else PackedWireChannelizer("ci1", *args, device="cpu"))
    ph = torch.tensor(np.stack([mixer_phase(o, wcfg.input_rate, pos) for o in wcfg.offsets_hz]))
    return mod(torch.from_numpy(wire), ph).numpy()


@pytest.mark.parametrize("tag", ["cr1", "ci1"])
def test_channel_outputs_match_the_program_and_catch_one_sample(tag):
    from harness import geometry

    cfg = CFG[tag]
    n = geometry(cfg, 1).n_in
    pos = 3 * 588_000
    wire = _wire(tag, n)
    got = _program_channels(tag, wire, n, pos)
    idx = np.sort(np.random.default_rng(5).choice(got.shape[1], 256, replace=False))
    want = reference.channel_outputs(cfg, wire, pos, idx)
    limit = cfg["check_limits"]["chan_gap"]
    assert reference.chan_gap(got[:, idx], want) < limit / 20
    bad = got[:, idx].copy()
    bad[1, 17] += 0.01 * np.sqrt(np.mean(np.abs(want) ** 2))
    assert reference.chan_gap(bad, want) > limit
    control = reference.channel_outputs(cfg, wire, pos, idx, precision="bf16")
    assert reference.chan_gap(control, want) > 3 * limit


def test_corr_matches_the_program_and_the_control_fails():
    from ais_tpu_torch.ops.matched_filter import matched_filter_plain
    from ais_tpu_torch.pipeline.receiver import preamble_waveform
    from ais_tpu_torch.core.params import DemodConfig

    pre = modem.preamble(5)
    prog_pre = preamble_waveform(DemodConfig())
    assert np.max(np.abs(pre - prog_pre)) < 1e-6
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(3, 2048)) + 1j * rng.normal(size=(3, 2048))).astype(np.complex64)
    x[1, 500:640] += 4 * prog_pre
    _, mag2 = matched_filter_plain(torch.from_numpy(x),
                                   torch.from_numpy(np.conj(prog_pre).astype(np.complex64)))
    want = reference.corr_mag2(x, pre)
    limit = CFG["cr1"]["check_limits"]["corr_gap"]
    assert reference.corr_gap(mag2.numpy(), want) < limit / 20
    control = reference.corr_mag2(x, pre, precision="bf16")
    assert reference.corr_gap(control, want) > 3 * limit


@pytest.mark.parametrize("tag", ["cr1", "ci1"])
def test_k2_input_is_worked_out_again_and_matches_the_program(tag):
    """The reference's own channel outputs, AGC and AFC give K2 rows
    whose |corr|^2 matches the program's demod front on its own
    channel outputs; the bfloat16 control does not."""
    from ais_tpu_torch.pipeline.wideband import WidebandReceiver

    from harness import geometry, program_config

    cfg = CFG[tag]
    geo = geometry(cfg, 1)
    traffic = json.loads((BENCH / "traffic" / "archive_light.json").read_text())
    traffic.update(occupancy=1.0)
    cap = scene.make_capture(cfg, traffic, geo.n_in, geo.step_raw, 2147483731, "cpu")
    pos = 5 * geo.step_raw
    chans = _program_channels(tag, cap.wire, geo.n_in, pos)[:, : geo.block_len]
    rx = WidebandReceiver(program_config(cfg, geo), geo.n_in, device="cpu")
    got = rx.demod.debug_taps(torch.from_numpy(np.ascontiguousarray(chans)))["corr_mag2"].numpy()
    x, ambiguous = reference.k2_input(cfg, cap.wire, pos, [0, 1], 1)
    want = reference.corr_mag2(x, modem.preamble(5))
    mask = reference.compared(ambiguous, 140)
    assert mask.mean() > 0.5 and np.max(want) > 10 * np.median(want)  # preambles in the rows
    limit = cfg["check_limits"]["corr_gap"]
    gap = reference.corr_gap(got, want, mask)
    print(f"{tag} corr_gap {gap!r}")
    assert gap < limit / 5
    control = reference.corr_mag2(x, modem.preamble(5), precision="bf16")
    assert reference.corr_gap(control, want, mask) > 3 * limit


def test_afc_marks_a_near_tie_and_what_rests_on_it():
    fs, n = 48000.0, 4096
    bits = np.random.default_rng(4).integers(0, 2, -(-n // 5))
    burst = modem.gmsk(bits, 5)[:n] * np.exp(2j * np.pi * 200.0 / fs * np.arange(n))
    tone = np.exp(2j * np.pi * 3000.0 / fs * np.arange(n))
    x, amb = reference._afc(burst, fs, 9600.0, 1024, 6.0)
    assert x.shape == burst.shape and not amb.any()
    # One tone sits in the pairs on either side of it: a tie, in its chunk.
    mixed = np.concatenate([burst[:2048], tone[2048:3072], burst[3072:]])
    _, amb = reference._afc(mixed, fs, 9600.0, 1024, 6.0)
    assert np.array_equal(amb, np.arange(n) // 1024 == 2)
    ok = reference.compared(amb[None], 140)[0]
    assert ok.size == n - 139 and ok[: 2048 - 139].all() and not ok[2048 - 139: 3072].any()
    assert ok[3072:].all()


def test_taps_are_the_programs():
    from ais_tpu_torch.pipeline.wideband import WidebandConfig, channel_taps

    h = reference.taps(CFG["cr1"])
    assert h.size == CFG["cr1"]["ntaps"]
    assert np.array_equal(h.astype(np.float32), channel_taps(WidebandConfig()))


class P:
    def __init__(self, payload, abs_sample, designator):
        self.payload, self.abs_sample, self.designator = payload, abs_sample, designator


def test_packets_keyed_comparison_catches_one_corrupted_packet():
    pk = [scene.Packet(0, 3000, b"\x01" * 21), scene.Packet(1, 20000, b"\x02" * 21),
          scene.Packet(0, 67000, b"\x03" * 21)]
    step_chan = 100_000
    found = [(s, P(p.payload, s * step_chan + p.start // 50 + 40, "AB"[p.channel]))
             for s in range(3) for p in pk]
    ok = reference.compare_packets(found, pk, range(3), step_chan, 50, ["A", "B"])
    assert ok == {"attempted": 9, "matched": 9, "missed": 0, "wrong": 0, "spurious": 0}
    bad = list(found)
    bad[4] = (1, P(b"\x02" * 20 + b"\x00", found[4][1].abs_sample, "B"))
    got = reference.compare_packets(bad, pk, range(3), step_chan, 50, ["A", "B"])
    assert got["missed"] == 1 and got["wrong"] == 1
    twice = reference.compare_packets(found[:4] + found[3:4], pk, range(2), step_chan, 50,
                                      ["A", "B"])
    assert twice["wrong"] == 1 and twice["missed"] == 2
    # A step's call returning the previous step's packets matches nothing.
    stale = [(s + 1, p) for s, p in found[:6]]
    late = reference.compare_packets(stale, pk, range(3), step_chan, 50, ["A", "B"])
    assert late["matched"] == 0 and late["wrong"] == 6


def test_capture_is_the_same_work_for_every_seed():
    cfg, traffic = CFG["cr1"], json.loads((BENCH / "traffic" / "archive_light.json").read_text())
    n_core = 4 * 11760 * 50
    n_in = n_core + 600_000
    a = scene.make_capture(cfg, traffic, n_in, n_core, 2147483711, "cpu")
    b = scene.make_capture(cfg, traffic, n_in, n_core, 2147483712, "cpu")
    a2 = scene.make_capture(cfg, traffic, n_in, n_core, 2147483711, "cpu")
    assert len(a.packets) == len(b.packets) > 0
    assert len({p.payload for p in a.packets}) == len(a.packets)
    assert all(p.start + scene.BURST_SPAN < n_core for p in a.packets)
    assert np.array_equal(a.wire, a2.wire) and not np.array_equal(a.wire, b.wire)
    assert a.wire.size == -(-n_in // 8)
