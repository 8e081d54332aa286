"""Dual-channel AIS radio: a 162.0 MHz-centred capture -> channel A + B
packets.  Port of `ais_tpu/pipeline/radio.py`.

Topology, chosen as the reference chooses it: when the input rate
decimates by a whole factor of at least 2 to the 48 ksps channel rate
(2.4 Msps, 240 ksps), both channels run in one `WidebandReceiver` (K5,
then one batched demod); otherwise (the reference's 250 ksps default)
and in single-channel mode, one `ChannelReceiver` a channel (K5 with
one channel, the host resampler, a `BasebandReceiver`).

Frequency correction (`ppm`): a device whose oscillator runs `ppm` high
records the spectrum shifted by +162.0e6 * ppm * 1e-6; the channel
offsets absorb the shift, which usually leaves carriers with no short
period (K5's full-length table).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator

import numpy as np

from ais_tpu_torch.core.params import AIS_CENTER_HZ, DemodConfig, ReceiverConfig, dual_channel_configs
from ais_tpu_torch.pipeline.api import ChannelReceiver
from ais_tpu_torch.pipeline.host import suppress_image_ghosts

# Channel rate the demodulator runs at (5 sps x 9600 bps).
CHANNEL_RATE = 48000.0


def ppm_offset_hz(ppm: float, center_hz: float = AIS_CENTER_HZ) -> float:
    """Channelizer-offset correction for a device with `ppm` LO error:
    a channel at true frequency f appears at f - center + center*ppm*1e-6."""
    return center_hz * ppm * 1e-6


class AisRadio:
    """Decode both AIS channels (or one 0-offset channel) from a
    162.0 MHz-centred stream, on `device`."""

    def __init__(self, sample_rate: float = 250e3, single_channel: bool = False,
                 block_len: int = 16384, demod: DemodConfig | None = None, ppm: float = 0.0,
                 fused_blocks: int = 8, *, device="cuda"):
        self.sample_rate = sample_rate
        self.ppm = float(ppm)
        self.device = device
        self._demod_override = demod
        self._block_len = block_len
        self._fused_blocks = fused_blocks
        shift = ppm_offset_hz(self.ppm)
        self.wideband = None
        self.rx_paths: list[ChannelReceiver] = []
        decim = sample_rate / CHANNEL_RATE
        if not single_channel and abs(decim - round(decim)) < 1e-9 and round(decim) >= 2:
            self.wideband = self._build_wideband(demod)
            return
        if single_channel:
            cfg = ReceiverConfig().with_offset(0.0 + shift, "A")
            configs = (dataclasses.replace(
                cfg, channelizer=dataclasses.replace(cfg.channelizer, input_rate=sample_rate)),)
        else:
            configs = tuple(c.with_offset(c.channelizer.offset_hz + shift, c.designator)
                            for c in dual_channel_configs(sample_rate))
        if demod is not None:
            configs = tuple(dataclasses.replace(c, demod=demod) for c in configs)
        self.rx_paths = [ChannelReceiver(c, block_len=block_len, device=device)
                         for c in configs]

    def _build_wideband(self, demod: DemodConfig | None):
        from ais_tpu_torch.pipeline.wideband import WidebandConfig, WidebandReceiver, num_taps

        shift = ppm_offset_hz(self.ppm)
        cfg = WidebandConfig(
            input_rate=self.sample_rate,
            offsets_hz=(-25e3 + shift, +25e3 + shift),
            decimation=int(round(self.sample_rate / CHANNEL_RATE)),
            block_len=self._block_len,
            demod=demod if demod is not None else DemodConfig(),
        )
        n48 = cfg.block_len + cfg.core_len * (self._fused_blocks - 1)
        n_in = (n48 - 1) * cfg.decimation + num_taps(cfg)
        return WidebandReceiver(cfg, n_in=n_in, device=self.device)

    @property
    def uses_fused_wideband(self) -> bool:
        return self.wideband is not None

    def process(self, iq: np.ndarray) -> list:
        if self.wideband is not None:
            return self.wideband.decode(iq)
        packets = []
        for rx in self.rx_paths:
            packets.extend(rx.process(iq))
        packets.sort(key=lambda p: p.abs_sample)
        if len(self.rx_paths) > 1:
            packets = suppress_image_ghosts(packets)
        return packets

    # -- runtime controls.  Gain and rate belong to a hardware source; for
    # file and UDP input they are bookkeeping, as in the reference.

    def set_threshold(self, threshold: float) -> None:
        """Change the correlator threshold; the stream carries on."""
        if self.wideband is not None:
            demod = dataclasses.replace(self.wideband.cfg.demod, corr_threshold=threshold)
            self._demod_override = demod
            old = self.wideband
            self.wideband = self._build_wideband(demod)
            self.wideband._buf = old._buf
            self.wideband._pos = old._pos
            self.wideband._dedupers = old._dedupers
            return
        for rx in self.rx_paths:
            rx.baseband.set_threshold(threshold)

    def get_threshold(self) -> float:
        if self.wideband is not None:
            return self.wideband.cfg.demod.resolved_corr_threshold
        return self.rx_paths[0].baseband.get_threshold()

    def set_gain(self, gain: float) -> float:
        """Forwarded to a live hardware source when one is attached."""
        self._gain = gain
        src = getattr(self, "_source", None)
        if src is not None and hasattr(src, "set_gain"):
            src.set_gain(gain)
        return self.get_gain()

    def get_gain(self) -> float:
        return getattr(self, "_gain", 0.0)

    def get_rate(self) -> float:
        return self.sample_rate

    def set_rate(self, rate: float) -> float:
        """Rebuild the topology for a new input rate.  The stream state
        does not carry across (the sample grid changed); decoding picks
        up again at the next preamble."""
        if rate == self.sample_rate:
            return self.sample_rate
        self.__init__(
            sample_rate=float(rate),
            single_channel=self.wideband is None and len(self.rx_paths) == 1,
            block_len=self._block_len, demod=self._demod_override, ppm=self.ppm,
            fused_blocks=self._fused_blocks, device=self.device)
        src = getattr(self, "_source", None)
        if src is not None and hasattr(src, "set_sample_rate"):
            src.set_sample_rate(rate)
        return self.sample_rate

    # -- checkpoint / resume: the active topology's receivers' state ------

    def get_state(self) -> dict:
        if self.wideband is not None:
            return {"topology": "wideband", "state": self.wideband.get_state()}
        return {"topology": "channels", "state": [rx.get_state() for rx in self.rx_paths]}

    def set_state(self, state: dict) -> None:
        if state["topology"] == "wideband":
            if self.wideband is None:
                raise ValueError("checkpoint is from a fused-wideband radio")
            self.wideband.set_state(state["state"])
            return
        if self.wideband is not None:
            raise ValueError("checkpoint is from a per-channel radio")
        if len(state["state"]) != len(self.rx_paths):
            raise ValueError("checkpoint channel count mismatch")
        for rx, s in zip(self.rx_paths, state["state"]):
            rx.set_state(s)

    def run(self, source, chunk_len: int = 1 << 20,
            on_packet: Callable | None = None) -> Iterator:
        """Stream from a `SampleSource` (`ais_tpu_torch.io.sources`), yielding
        packets as they decode, then the flushed tail's."""
        self._source = source
        for chunk in source.chunks(chunk_len):
            for p in self.process(chunk):
                if on_packet is not None:
                    on_packet(p)
                yield p
        for p in self.flush():
            if on_packet is not None:
                on_packet(p)
            yield p

    def flush(self) -> list:
        """Decode the buffered tail at the end of the stream (the fused
        path; the per-channel path decodes each chunk as it comes)."""
        if self.wideband is not None:
            return self.wideband.flush()
        return []
