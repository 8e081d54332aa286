"""Multi-packet capture synthesis for tests and benchmarks.

Builds wideband (or channel-rate) IQ scenes with AIS bursts on the A/B
channel offsets — the automated stand-in for the reference's recorded
development capture (`ais_chanA_wbx_250ksps.iq`, python/ais.grc:573).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ais_tpu_torch.core.params import AIS_BIT_RATE
from ais_tpu_torch.tx.frame import make_packet_iq


@dataclass(frozen=True)
class ScenarioPacket:
    payload: bytes
    start_sample: int           # at the scenario sample rate
    offset_hz: float = 0.0      # channel offset from capture center
    amplitude: float = 1.0
    phase: float = 0.0
    extra_freq_hz: float = 0.0  # residual carrier error within the channel


@dataclass
class Scenario:
    sample_rate: float
    n_samples: int
    packets: list[ScenarioPacket] = field(default_factory=list)
    noise: float = 0.01
    seed: int = 0

    def build(self) -> np.ndarray:
        sps = self.sample_rate / AIS_BIT_RATE
        sps_int = int(round(sps))
        if abs(sps - sps_int) > 1e-9:
            raise ValueError(
                f"scenario rate {self.sample_rate} is not an integer multiple "
                f"of the AIS bit rate"
            )
        rng = np.random.default_rng(self.seed)
        iq = (
            rng.normal(size=self.n_samples) + 1j * rng.normal(size=self.n_samples)
        ).astype(np.complex64) * self.noise
        for p in self.packets:
            burst = make_packet_iq(p.payload, samples_per_symbol=sps_int)
            n = np.arange(burst.size)
            carrier = np.exp(
                1j
                * (
                    2 * np.pi * (p.offset_hz + p.extra_freq_hz) / self.sample_rate * n
                    + p.phase
                )
            )
            end = min(self.n_samples, p.start_sample + burst.size)
            m = end - p.start_sample
            if m <= 0:
                continue
            iq[p.start_sample : end] += (p.amplitude * burst[:m] * carrier[:m]).astype(
                np.complex64
            )
        return iq


def spread_packets(
    payloads: list[bytes],
    n_samples: int,
    sample_rate: float,
    offsets_hz: tuple = (-25e3, +25e3),
    spacing: int | None = None,
    seed: int = 1,
) -> list[ScenarioPacket]:
    """Distribute payloads across channels/time like light AIS traffic."""
    rng = np.random.default_rng(seed)
    sps = int(round(sample_rate / AIS_BIT_RATE))
    burst_len = 2048 * sps  # generous packet footprint
    spacing = spacing or max(burst_len, n_samples // max(len(payloads), 1))
    out = []
    for i, payload in enumerate(payloads):
        start = i * spacing + int(rng.integers(0, max(spacing - burst_len, 1)))
        if start + burst_len > n_samples:
            break
        out.append(
            ScenarioPacket(
                payload=payload,
                start_sample=start,
                offset_hz=float(offsets_hz[i % len(offsets_hz)]),
                phase=float(rng.uniform(0, 2 * np.pi)),
                extra_freq_hz=float(rng.uniform(-200, 200)),
            )
        )
    return out
