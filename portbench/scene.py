"""One general traffic generator: a 2.4 Msps capture of AIS slots, as
wire bytes, from a traffic file's parameters and a seed.

Each channel's SOTDMA slot grid (one slot = 64 000 samples, 26.67 ms)
starts at the traffic's `slot0_samples[c]`; exactly round(occupancy x
slots) slots of each channel carry a burst, which slots drawn from the
seed, so every seed sends the same number of packets of the same
length.  Each burst is a distinct type-1 payload (the slot and channel
are written into it, and two bytes come from the seed), HDLC-framed and
NRZI-coded by `modem.py` and GMSK-modulated on the card, at a phase and
an extra frequency within +-`extra_freq_hz` drawn from the seed.  White
noise of `noise_std` a component, drawn on the card from the seed, is
added, and the capture is sigma-delta encoded into the configuration's
1-bit wire (`sdenc.py`).  Packets are kept inside the call's core span,
so each replayed step owns all of them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

import modem
import sdenc

SLOT = 64_000            # samples of one 26.67 ms slot at 2.4 Msps
BURST_SPAN = 64_500      # a burst's footprint, ramp margin included
BASE_PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"


class Packet(NamedTuple):
    channel: int       # index into the configuration's offsets
    start: int         # raw sample of the burst's first (ramp) bit in the step
    payload: bytes


class Capture(NamedTuple):
    wire: np.ndarray   # uint8 wire bytes of one step
    packets: list      # [Packet], sorted by (channel, start)


def _payloads(slots_by_channel, rng) -> list:
    base = bytearray(modem.sixbit_bytes(BASE_PAYLOAD))
    out = []
    for c, slots in enumerate(slots_by_channel):
        extra = rng.integers(0, 256, size=(len(slots), 2))
        for (k, (e0, e1)) in zip(slots.tolist(), extra.tolist()):
            p = bytearray(base)
            p[1] = (k * 7 + c) % 256
            p[2] = (k * 131) % 256
            p[3] = (k >> 8) % 256
            p[4], p[5] = e0, e1
            out.append(bytes(p))
    return out


def _modulate(levels: np.ndarray, sps: int, device) -> torch.Tensor:
    """GMSK phase (float64, device) of (n, L) line levels, the frequency
    pulse applied as a sum over the <= 5 symbols each sample sees."""
    pulse = np.zeros(5 * sps)
    p = modem.gmsk_pulse(sps)
    pulse[: p.size] = p
    sym = torch.tensor(2.0 * levels.astype(np.float64) - 1.0, device=device)
    n, L = sym.shape
    pul = torch.tensor(pulse, device=device).reshape(5, sps)
    freq = torch.zeros((n, L, sps), dtype=torch.float64, device=device)
    for d in range(5):
        shifted = torch.nn.functional.pad(sym, (d, 0))[:, :L]
        freq += shifted[:, :, None] * pul[d]
    phase = torch.cumsum(freq.reshape(n, L * sps), dim=1) * (math.pi / 2.0 / sps)
    return phase


def make_capture(cfg: dict, traffic: dict, n_in: int, n_core: int, seed: int,
                 device) -> Capture:
    """The step's capture for (`cfg`, `traffic`, `seed`) on `device`."""
    rate = float(cfg["input_rate"])
    sps = int(round(rate / modem.BIT_RATE))
    rng = np.random.default_rng(seed)
    slots_by_channel = []
    for c in range(len(cfg["offsets_hz"])):
        slot0 = int(traffic["slot0_samples"][c])
        n_slots = max(0, (n_core - BURST_SPAN - slot0 - 1) // SLOT + 1)
        take = int(round(float(traffic["occupancy"]) * n_slots))
        slots_by_channel.append(np.sort(rng.permutation(n_slots)[:take]))
    payloads = _payloads(slots_by_channel, rng)
    chans = np.concatenate([np.full(len(s), c) for c, s in enumerate(slots_by_channel)])
    starts = np.concatenate([int(traffic["slot0_samples"][c]) + s * SLOT
                             for c, s in enumerate(slots_by_channel)]).astype(np.int64)
    frames = [modem.nrzi(modem.frame_bits(p)) for p in payloads]
    lengths = np.array([f.size for f in frames])
    levels = np.ones((len(frames), int(lengths.max()) if frames else 1), np.uint8)
    for i, f in enumerate(frames):
        levels[i, : f.size] = f
        levels[i, f.size:] = f[-1]
    phases = rng.uniform(0, 2 * np.pi, size=len(frames))
    extra = rng.uniform(-1.0, 1.0, size=len(frames)) * float(traffic["extra_freq_hz"])
    offsets = np.asarray(cfg["offsets_hz"], np.float64)[chans] + extra

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    sigma = float(traffic["noise_std"])
    amp = float(traffic.get("amplitude", 1.0))
    re = torch.randn(n_in, generator=gen, device=device, dtype=torch.float32) * sigma
    im = torch.randn(n_in, generator=gen, device=device, dtype=torch.float32) * sigma
    chunk = 256
    for lo in range(0, len(frames), chunk):
        hi = min(lo + chunk, len(frames))
        theta = _modulate(levels[lo:hi], sps, device)
        n_s = theta.shape[1]
        t = torch.arange(n_s, dtype=torch.float64, device=device)
        w = torch.tensor(2 * np.pi * offsets[lo:hi] / rate, device=device)
        ph0 = torch.tensor(phases[lo:hi], device=device)
        theta = theta + w[:, None] * t + ph0[:, None]
        br = (amp * torch.cos(theta)).to(torch.float32)
        bi = (amp * torch.sin(theta)).to(torch.float32)
        for j in range(hi - lo):
            s, m = int(starts[lo + j]), int(lengths[lo + j]) * sps
            re[s: s + m] += br[j, :m]
            im[s: s + m] += bi[j, :m]
        del theta, br, bi
    headroom = float(cfg["wire_headroom"])
    sample = torch.randint(0, n_in, (1 << 22,), generator=gen, device=device)
    comps = torch.cat([re[sample].abs(), im[sample].abs()])
    peak = max(float(torch.quantile(comps, 0.999)),
               0.5 * max(float(re.abs().max()), float(im.abs().max())))
    scale = headroom / peak if peak > 0 else 1.0
    re_h, im_h = re.cpu().numpy(), im.cpu().numpy()
    del re, im, comps, sample
    wire = sdenc.encode(cfg["wire_format"], re_h, im_h, scale, float(cfg.get("cr1_a2", 0.0)))
    packets = sorted(Packet(int(c), int(s), p) for c, s, p in zip(chans, starts, payloads))
    return Capture(wire, packets)
