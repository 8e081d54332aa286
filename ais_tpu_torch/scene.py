"""The benchmark's full-load scene and its content-parity rule.

Port of `bench.py:_scene` and `bench.py:_content_parity`: a 2.4 Msps
capture with a distinct AIS payload in every 26.67 ms TDMA slot on both
channels, synthesized with the reference's modulator (`ais_tpu.tx`), and
the rule that scores decoded packets against the transmitted ones.
"""

from __future__ import annotations

import numpy as np

SLOT_SAMPLES_2P4M = 64000  # 26.67 ms AIS TDMA slot at 2.4 Msps
BASE_PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"


def full_load_scene(cfg, n_in: int, n_core: int, seed: int = 7):
    """(iq complex64 (n_in,), transmitted packets) for `cfg`'s channels.

    Packets are confined to the call's core span `n_core` (= step_raw):
    a packet starting in the trailing halo belongs to the next step."""
    from ais_tpu.tx import aivdm_payload_to_bytes
    from ais_tpu.tx.scenario import Scenario, ScenarioPacket

    base = bytearray(aivdm_payload_to_bytes(BASE_PAYLOAD))
    rng = np.random.default_rng(seed)
    packets = []
    burst_len = 62500 + 2000  # ~231 bits at 250 sps + ramp margin
    for ci, off in enumerate(cfg.offsets_hz):
        slot0 = 3000 + ci * 17000  # de-phase the two channels' slot grids
        k = 0
        while slot0 + k * SLOT_SAMPLES_2P4M + burst_len < n_core:
            p = bytearray(base)
            p[1] = (k * 7 + ci) % 256
            p[2] = (k * 131) % 256
            p[3] = (k >> 8) % 256
            packets.append(
                ScenarioPacket(
                    payload=bytes(p),
                    start_sample=slot0 + k * SLOT_SAMPLES_2P4M,
                    offset_hz=float(off),
                    phase=float(rng.uniform(0, 2 * np.pi)),
                    extra_freq_hz=float(rng.uniform(-200, 200)),
                )
            )
            k += 1
    iq = Scenario(
        sample_rate=cfg.input_rate, n_samples=n_in, packets=packets, noise=0.004
    ).build()
    return iq, packets


def content_parity(found, tx_packets, decim: int) -> float:
    """Fraction of transmitted packets decoded with exact payload bytes on
    the right channel within 300 channel samples of their start."""
    chan_of = {-25e3: "A", 25e3: "B"}
    remaining = list(found)
    matched = 0
    for tp in tx_packets:
        want_pos = tp.start_sample // decim
        want_chan = chan_of.get(tp.offset_hz, "A")
        for i, fp in enumerate(remaining):
            if (fp.payload == tp.payload and fp.designator == want_chan
                    and abs(fp.abs_sample - want_pos) < 300):
                matched += 1
                remaining.pop(i)
                break
    return matched / max(len(tx_packets), 1)
