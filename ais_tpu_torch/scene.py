"""The benchmark's full-load scene and its content-parity rule.

Port of `bench.py:_scene` and `bench.py:_content_parity`: a capture with
a distinct AIS payload in every 26.67 ms TDMA slot on both channels,
synthesized with the port's copy of the modulator (`ais_tpu_torch.tx`), and the rule
that scores decoded packets against the transmitted ones.  At 2.4 Msps
it is the benchmark's scene sample for sample; at any other rate its
slot grid scales with the rate, and `shift_hz` moves every channel as a
device with an LO error would record it (`pipeline/radio.py:
ppm_offset_hz`).
"""

from __future__ import annotations

import numpy as np

from ais_tpu_torch.core.params import AIS_BIT_RATE

SLOT_SAMPLES_2P4M = 64000  # 26.67 ms AIS TDMA slot at 2.4 Msps
CHANNEL_RATE = 48000.0
BASE_PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"


def _at_rate(samples_2p4m: int, rate: float) -> int:
    return int(round(samples_2p4m * rate / 2.4e6))


def full_load_scene(cfg, n_in: int, n_core: int, seed: int = 7, shift_hz: float = 0.0,
                    lead: int = 0):
    """(iq complex64 (n_in,), transmitted packets) for `cfg`'s channels
    (`cfg.input_rate`, `cfg.offsets_hz`), each channel moved by
    `shift_hz`, every packet `lead` samples later than the benchmark's.

    Packets are confined to the call's core span `n_core` (= step_raw):
    a packet starting in the trailing halo belongs to the next step."""
    from ais_tpu_torch.tx import aivdm_payload_to_bytes
    from ais_tpu_torch.tx.scenario import Scenario, ScenarioPacket

    base = bytearray(aivdm_payload_to_bytes(BASE_PAYLOAD))
    rng = np.random.default_rng(seed)
    packets = []
    rate = cfg.input_rate
    slot = _at_rate(SLOT_SAMPLES_2P4M, rate)
    burst_len = _at_rate(62500 + 2000, rate)  # ~231 bits + ramp margin
    for ci, off in enumerate(cfg.offsets_hz):
        slot0 = lead + _at_rate(3000 + ci * 17000, rate)  # de-phase the channels' slot grids
        k = 0
        while slot0 + k * slot + burst_len < n_core:
            p = bytearray(base)
            p[1] = (k * 7 + ci) % 256
            p[2] = (k * 131) % 256
            p[3] = (k >> 8) % 256
            packets.append(
                ScenarioPacket(
                    payload=bytes(p),
                    start_sample=slot0 + k * slot,
                    offset_hz=float(off) + shift_hz,
                    phase=float(rng.uniform(0, 2 * np.pi)),
                    extra_freq_hz=float(rng.uniform(-200, 200)),
                )
            )
            k += 1
    if abs(rate / AIS_BIT_RATE - round(rate / AIS_BIT_RATE)) < 1e-9:
        iq = Scenario(sample_rate=rate, n_samples=n_in, packets=packets, noise=0.004).build()
    else:
        iq = resampled_scene(rate, n_in, packets, noise=0.004)
    return iq, packets


def resampled_scene(rate: float, n_in: int, packets, noise: float) -> np.ndarray:
    """A capture at a rate that is no whole multiple of the bit rate (the
    250 ksps default): each channel's packets are modulated at 48 ksps
    (5 samples a symbol, `ais_tpu_torch.tx.scenario`), brought to `rate` by
    the streaming polyphase resampler, and mixed to their offset with a
    float64 phase; white noise of std `noise` a component is added once.
    Packet `start_sample`s are at `rate`."""
    from ais_tpu_torch.tx.scenario import Scenario, ScenarioPacket
    from ais_tpu_torch.ops.resample import PfbArbResampler

    up = rate / CHANNEL_RATE
    rng = np.random.default_rng(0)
    iq = ((rng.normal(size=n_in) + 1j * rng.normal(size=n_in)) * noise).astype(np.complex64)
    t = np.arange(n_in, dtype=np.float64)
    for off in sorted({p.offset_hz for p in packets}):
        chan = [ScenarioPacket(p.payload, int(round(p.start_sample / up)), 0.0, p.amplitude,
                               p.phase, p.extra_freq_hz)
                for p in packets if p.offset_hz == off]
        rs = PfbArbResampler(up)
        n48 = int(np.ceil(n_in / up)) + 2 * rs.taps_per_phase
        base = Scenario(sample_rate=CHANNEL_RATE, n_samples=n48, packets=chan, noise=0.0).build()
        step = 1 << 16
        sig = np.concatenate([rs.process(base[i: i + step]) for i in range(0, n48, step)])[:n_in]
        ph = np.remainder(2.0 * np.pi * (off / rate) * t[: sig.size], 2.0 * np.pi)
        iq[: sig.size] += (sig * np.exp(1j * ph)).astype(np.complex64)
    return iq


def content_parity(found, tx_packets, decim: float) -> float:
    """Fraction of transmitted packets decoded with exact payload bytes on
    the right channel within 300 channel samples of their start.

    `decim` is raw samples a channel sample (input rate / 48 ksps; not
    whole on the resampled per-channel path).  A packet belongs to
    channel A below the centre and B above it: the nominal -+25 kHz,
    shifted by any LO error under 25 kHz (154 ppm)."""
    remaining = list(found)
    matched = 0
    for tp in tx_packets:
        want_pos = tp.start_sample // decim
        want_chan = "B" if tp.offset_hz > 0 else "A"
        for i, fp in enumerate(remaining):
            if (fp.payload == tp.payload and fp.designator == want_chan
                    and abs(fp.abs_sample - want_pos) < 300):
                matched += 1
                remaining.pop(i)
                break
    return matched / max(len(tx_packets), 1)


GOLDEN_SENTENCE = "!AIVDM,1,1,,A,14eG;o@034o8sd<L9i:a;WF>062D,0*7D"


def golden_capture(rate: float) -> np.ndarray:
    """1.25 s at `rate` holding BASE_PAYLOAD once on channel A (-25 kHz),
    24 000 channel samples (0.5 s) in, modulated at 48 ksps and
    resampled: decoded, it gives GOLDEN_SENTENCE."""
    from ais_tpu_torch.tx import aivdm_payload_to_bytes, make_packet_iq
    from ais_tpu_torch.ops.resample import pfb_arb_resample

    burst = make_packet_iq(aivdm_payload_to_bytes(BASE_PAYLOAD), 5)
    sig48 = np.zeros(int(1.25 * CHANNEL_RATE), np.complex64)
    sig48[24_000: 24_000 + burst.size] = burst
    sig = pfb_arb_resample(sig48, rate / CHANNEL_RATE)
    rng = np.random.default_rng(7)
    iq = (rng.normal(size=sig.size) + 1j * rng.normal(size=sig.size)) * 0.02
    iq += sig * np.exp(-2j * np.pi * 25e3 * np.arange(sig.size) / rate)
    return iq.astype(np.complex64)
