"""The JAX reference's packets on `chip_smoke.py`'s scenes, kept in
`tests/test_torch_reference_packets.json`: the sets that script holds
the port to on the card where the reference itself does not decode a
scene's whole content (ROADMAP C).  Regenerate them on the CPU with

    JAX_PLATFORMS=cpu python tests/test_torch_reference_packets.py

(about 1.5 min and 3 GB).  Scenes, each made exactly as `chip_smoke.py`
makes it (seed 7):

  mlse_bench      the benchmark scene (96 blocks, 1762 packets), decoded
                  with `demod_mode="mlse"` (threshold 0.4).  The reference
                  runs it in 12-block steps, which frame the same blocks
                  as one 96-block step (block b starts at b * core_len
                  and is demodulated on its own);
  radio_channels  21 s of the 250 ksps full-load scene through
                  `AisRadio(sample_rate=250e3).run` in 1 << 20-sample
                  chunks.

The reference runs its main-path formulations (the Pallas channelizer
and correlator, in interpret mode here, and the FIR symbol comb), the
ones the port implements; with its CPU defaults (FFT correlator, bank
timing) it decodes another set.  Each packet is [designator,
abs_sample, payload hex].  The test checks the file's form.
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


SCENES = {"mlse_bench": mlse_bench, "radio_channels": radio_channels}


def test_reference_packets_are_scene_packets():
    """Each scene's entries are sorted, distinct, on channel A or B, and
    carry one of the scene's payloads (the base payload with bytes 1-3
    numbering the slot)."""
    from ais_tpu.tx import aivdm_payload_to_bytes
    from ais_tpu_torch.scene import BASE_PAYLOAD

    base = aivdm_payload_to_bytes(BASE_PAYLOAD)
    data = json.loads(FIXTURE.read_text())
    assert sorted(data) == sorted(SCENES)
    for scene, packets in data.items():
        assert packets == sorted(packets) and len({tuple(p) for p in packets}) == len(packets)
        for designator, abs_sample, payload in packets:
            raw = bytes.fromhex(payload)
            assert designator in ("A", "B") and abs_sample >= 0, (scene, abs_sample)
            assert len(raw) == len(base) and raw[0] == base[0] and raw[4:] == base[4:], scene


def main(names) -> None:
    os.environ.setdefault("AIS_TPU_CHAN", "pallas")
    sys.path.insert(0, str(REPO))
    data = json.loads(FIXTURE.read_text()) if FIXTURE.exists() else {}
    for name in names or SCENES:
        t0 = time.perf_counter()
        data[name] = SCENES[name]()
        print(f"{name}: {len(data[name])} packets in {time.perf_counter() - t0:.1f} s",
              flush=True)
        FIXTURE.write_text(json.dumps(data, indent=0, sort_keys=True) + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
