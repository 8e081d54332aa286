"""The JAX reference's packets on `chip_smoke.py`'s scenes, kept in
`tests/test_torch_reference_packets.json`: the sets that script holds
the port to on the card where the reference itself does not decode a
scene's whole content (ROADMAP C).  Regenerate them on the CPU with

    JAX_PLATFORMS=cpu python tests/test_torch_reference_packets.py

(about 4 min and 3 GB; name entries as arguments to rewrite only those).
Scenes, each made exactly as `chip_smoke.py` makes it (seed 7):

  mlse_bench      the benchmark scene (96 blocks, 1762 packets), decoded
                  with `demod_mode="mlse"` (threshold 0.4).  The reference
                  runs it in 12-block steps, which frame the same blocks
                  as one 96-block step (block b starts at b * core_len
                  and is demodulated on its own);
  radio_channels  21 s of the 250 ksps full-load scene through
                  `AisRadio(sample_rate=250e3).run` in 1 << 20-sample
                  chunks;
  pll_bench       the benchmark scene as cr1 wire bytes, decoded with
                  `timing_mode="pll"` through `decode_wire` in 12-block
                  steps;
  pll_bench_3_blocks  the same at the scene and geometry of 3 blocks, one
                  step: small enough for the test below to run the port
                  on it on the CPU;
  wire_select_bench   not packets: [format, reason] of
                  `select_wire_format(iq, "cr1")` on the benchmark scene
                  and on it under `chip_smoke.with_interferer`'s carrier.

The reference runs its main-path formulations (the Pallas channelizer
and correlator, in interpret mode here, and the FIR symbol comb), the
ones the port implements; with its CPU defaults (FFT correlator, bank
timing) it decodes another set.  Each packet is [designator,
abs_sample, payload hex].  The tests check the file's form, and the
port's packets on the CPU against `pll_bench_3_blocks`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FIXTURE = Path(__file__).with_suffix(".json")


def mlse_bench() -> list:
    from ais_tpu.pipeline.wideband import WidebandConfig, WidebandReceiver
    from ais_tpu_torch.pipeline.wideband import aligned_n_in, num_taps

    import chip_smoke as cs

    cfg, n_in = cs.bench_geometry()
    iq, _ = cs.phase_scene(cfg, n_in)
    demod = dataclasses.replace(cfg.demod, demod_mode="mlse", corr_threshold=0.4,
                                corr_path="pallas", ff_path="fir")
    step_blocks = 12
    n48 = cfg.block_len + cfg.core_len * (step_blocks - 1)
    n_step = aligned_n_in(cfg, (n48 - 1) * cfg.decimation + num_taps(cfg))
    rcfg = WidebandConfig(*cfg._replace(demod=demod, compact_lanes=14 * 2 * step_blocks))
    rx = WidebandReceiver(rcfg, n_in=n_step)
    found = rx.decode(iq)
    if rx._pos != cs.N_BLOCKS * cfg.core_len * cfg.decimation:
        raise RuntimeError(f"the 12-block steps covered {rx._pos} raw samples, not 96 blocks")
    return cs.packet_keys(found)


def radio_channels() -> list:
    from ais_tpu.core.params import DemodConfig
    from ais_tpu.pipeline.radio import AisRadio
    from ais_tpu_torch.pipeline.wideband import WidebandConfig
    from ais_tpu_torch.scene import full_load_scene

    import chip_smoke as cs

    rate = cs.CHANNELS_RATE
    n = int(rate * cs.CHANNELS_SECONDS)
    iq, _ = full_load_scene(WidebandConfig(input_rate=rate), n, n - int(rate * 0.1),
                            seed=cs.SEED, lead=int(rate * 0.05))
    radio = AisRadio(sample_rate=rate, demod=DemodConfig(corr_path="pallas", ff_path="fir"))
    return cs.packet_keys(radio.run(cs.ArraySource(iq, rate), chunk_len=1 << 20))


def _pll_scene(blocks: int):
    """(config, n_in, cr1 wire bytes) of the benchmark scene at `blocks`
    blocks, encoded as `chip_smoke.py`'s main path encodes it."""
    import numpy as np

    from ais_tpu_torch.ops.convert import host_bytes

    import chip_smoke as cs

    cfg, n_in = cs.bench_geometry(blocks)
    iq, _ = cs.phase_scene(cfg, n_in)
    cfg = cfg._replace(demod=dataclasses.replace(cfg.demod, timing_mode="pll"))
    return cfg, n_in, host_bytes((iq * 0.7).astype(np.complex64), "cr1")


def pll_bench(blocks: int | None = None, step_blocks: int = 12) -> list:
    """The cr1 main path with `timing_mode="pll"`: the scene's cr1 wire
    bytes through the reference's `decode_wire` in 12-block steps (the
    same blocks as one 96-block step)."""
    from ais_tpu.pipeline.wideband import WidebandConfig, WidebandReceiver
    from ais_tpu_torch.pipeline.wideband import aligned_n_in, num_taps

    import chip_smoke as cs

    blocks = cs.N_BLOCKS if blocks is None else blocks
    cfg, n_in, wire = _pll_scene(blocks)
    demod = dataclasses.replace(cfg.demod, corr_path="pallas")
    n48 = cfg.block_len + cfg.core_len * (step_blocks - 1)
    n_step = aligned_n_in(cfg, (n48 - 1) * cfg.decimation + num_taps(cfg))
    rcfg = WidebandConfig(*cfg._replace(demod=demod, compact_lanes=14 * 2 * step_blocks))
    rx = WidebandReceiver(rcfg, n_in=n_step)
    found = []
    for step in range(blocks // step_blocks):
        at = step * rx.step_raw
        chunk = wire[at // 8: (at + n_step) // 8]
        if chunk.size != n_step // 8:
            raise RuntimeError(f"step {step} reads past the {blocks}-block wire")
        found += rx.decode_wire(chunk, "cr1")
    if rx._pos != blocks * cfg.core_len * cfg.decimation or rx._pos + n_step - rx.step_raw != n_in:
        raise RuntimeError(f"the steps covered {rx._pos} raw samples, not {blocks} blocks")
    return cs.packet_keys(found)


PLL_SMALL_BLOCKS = 3


def pll_bench_3_blocks() -> list:
    return pll_bench(PLL_SMALL_BLOCKS, PLL_SMALL_BLOCKS)


def wire_select_bench() -> dict:
    """`select_wire_format(iq, "cr1")` on the benchmark scene and on the
    same scene under `chip_smoke.with_interferer`'s carrier: [format,
    reason] of each."""
    from ais_tpu.ops.convert import select_wire_format

    import chip_smoke as cs

    cfg, n_in = cs.bench_geometry()
    iq, _ = cs.phase_scene(cfg, n_in)
    return {"scene": list(select_wire_format(iq, "cr1")),
            "interferer": list(select_wire_format(cs.with_interferer(iq), "cr1"))}


SCENES = {"mlse_bench": mlse_bench, "radio_channels": radio_channels, "pll_bench": pll_bench,
          "pll_bench_3_blocks": pll_bench_3_blocks}
SELECTIONS = {"wire_select_bench": wire_select_bench}


def test_reference_packets_are_scene_packets():
    """Each scene's entries are sorted, distinct, on channel A or B, and
    carry one of the scene's payloads (the base payload with bytes 1-3
    numbering the slot)."""
    from ais_tpu.tx import aivdm_payload_to_bytes
    from ais_tpu_torch.scene import BASE_PAYLOAD

    base = aivdm_payload_to_bytes(BASE_PAYLOAD)
    data = json.loads(FIXTURE.read_text())
    assert sorted(data) == sorted({**SCENES, **SELECTIONS})
    for scene in SCENES:
        packets = data[scene]
        assert packets == sorted(packets) and len({tuple(p) for p in packets}) == len(packets)
        for designator, abs_sample, payload in packets:
            raw = bytes.fromhex(payload)
            assert designator in ("A", "B") and abs_sample >= 0, (scene, abs_sample)
            assert len(raw) == len(base) and raw[0] == base[0] and raw[4:] == base[4:], scene


def test_wire_selections_name_a_format_and_a_reason():
    """The benchmark scene keeps cr1; under the out-of-band carrier the
    answer is ci8, for an interferer."""
    data = json.loads(FIXTURE.read_text())["wire_select_bench"]
    assert data["scene"] == ["cr1", "within envelope"]
    fmt, reason = data["interferer"]
    assert fmt == "ci8" and "interferer" in reason


def test_port_pll_packets_equal_reference_at_3_blocks():
    """The port's `timing_mode="pll"` packets on the CPU, at the benchmark
    scene cut to 3 blocks, are the reference's stored set: content,
    channel and position of every packet.  All 54 of the scene's packets
    are there; the full set's first entries are the same packets."""
    import torch

    from ais_tpu_torch.pipeline.wideband import WidebandReceiver

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    torch.set_num_threads(1)
    cfg, n_in, wire = _pll_scene(PLL_SMALL_BLOCKS)
    rx = WidebandReceiver(cfg, n_in=n_in, device="cpu")
    got = cs.packet_keys(rx.decode_wire(wire, "cr1"))
    data = json.loads(FIXTURE.read_text())
    assert got == data["pll_bench_3_blocks"] and len(got) == 54 and rx.overflow_blocks == 0
    full = {(d, h) for d, _, h in data["pll_bench"]}
    assert {(d, h) for d, _, h in got} <= full and len(full) == 1762


def main(names) -> None:
    os.environ.setdefault("AIS_TPU_CHAN", "pallas")
    sys.path.insert(0, str(REPO))
    data = json.loads(FIXTURE.read_text()) if FIXTURE.exists() else {}
    makers = {**SCENES, **SELECTIONS}
    for name in names or makers:
        t0 = time.perf_counter()
        data[name] = makers[name]()
        print(f"{name}: {len(data[name])} entries in {time.perf_counter() - t0:.1f} s",
              flush=True)
        FIXTURE.write_text(json.dumps(data, indent=0, sort_keys=True) + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
