"""Per-channel streaming receivers.

Port of `ais_tpu/pipeline/api.py`.  `BasebandReceiver` decodes one AIS
channel from channel-rate complex baseband; `ChannelReceiver` adds the
front end: wideband IQ -> one channel through K5 with one channel
(`ops/fir.py:freq_xlating_fir_decimate`), then, where the decimated
rate is not a whole number of samples a symbol (250 ksps / 5 = 50 ksps),
the host-side polyphase resampler to 5 samples a symbol.

Both are streaming-safe: consecutive `process()` calls are one stream.
Each carries the tail of a call into the next, so a packet straddling a
call boundary decodes exactly once (the deduper drops the second
sighting), and `get_state` / `set_state` take and give the reference's
dict.  `BasebandReceiver.process` demodulates all of a call's blocks in
one batched `BurstDemod` call on its device, then deframes block by
block.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ais_tpu_torch.core.params import DeframerConfig, DemodConfig, ReceiverConfig
from ais_tpu_torch.ops.firdes import low_pass
from ais_tpu_torch.ops.fir import freq_xlating_fir_decimate, mixer_phase
from ais_tpu_torch.ops.resample import PfbArbResampler
from ais_tpu_torch.pipeline.host import PacketDeduper, deframe_records
from ais_tpu_torch.pipeline.receiver import (
    BurstDemod,
    make_burst_demod,
    required_halo,
)


def frame_stream(iq: np.ndarray, block_len: int, core_len: int) -> np.ndarray:
    """Overlap-save framing: (n,) -> (n_blocks, block_len) stepped by
    core_len, zero-padded at the tail; block b starts at b * core_len."""
    iq = np.asarray(iq, dtype=np.complex64)
    n_blocks = max(1, -(-iq.size // core_len))
    padded = np.zeros(core_len * (n_blocks - 1) + block_len, dtype=np.complex64)
    padded[: iq.size] = iq
    stride = padded.strides[0]
    return np.lib.stride_tricks.as_strided(
        padded, shape=(n_blocks, block_len), strides=(core_len * stride, stride))


class BasebandReceiver:
    """Decode AIS packets from channel-rate complex baseband."""

    def __init__(self, demod: DemodConfig = DemodConfig(),
                 deframer: DeframerConfig = DeframerConfig(), designator: str = "A",
                 block_len: int = 16384, core_len: int | None = None, *, device="cuda"):
        if deframer.max_length_bytes > demod.max_frame_bytes:
            raise ValueError(
                f"DeframerConfig.max_length_bytes={deframer.max_length_bytes} exceeds the "
                f"demod window's frame capacity ({demod.max_frame_bytes} bytes at "
                f"burst_len={demod.burst_len}): the extraction window would truncate "
                f"long frames.  Scale the demod with "
                f"ais_tpu_torch.core.params.demod_for_max_frame({deframer.max_length_bytes}).")
        self.device = torch.device(device)
        self.demod_cfg = demod
        self.deframer_cfg = deframer
        self.designator = designator
        self.block_len = block_len
        self.core_len = core_len or (block_len - required_halo(demod))
        if self.core_len <= 0:
            raise ValueError(f"block_len {block_len} too small for halo")
        self._demod = self._build_demod()
        self._deduper = PacketDeduper()
        # Tail samples presented again to the next call.
        self._overlap = self.block_len - self.core_len
        self._tail = np.zeros(0, dtype=np.complex64)
        self._tail_start = 0  # absolute sample index of _tail[0]
        self._next_start = 0  # absolute index of the next fresh sample

    def process(self, iq: np.ndarray, start_sample: int | None = None) -> list:
        """Decode a chunk that continues the stream.  `start_sample`, when
        given, is the caller's absolute index of iq[0] (an upstream
        channelizer owns the counter); a jump resets the carry."""
        iq = np.asarray(iq, dtype=np.complex64)
        if start_sample is not None and start_sample != self._next_start:
            self._tail = np.zeros(0, dtype=np.complex64)
            self._next_start = start_sample
        self._tail_start = self._next_start - self._tail.size
        arr = np.concatenate([self._tail, iq]) if self._tail.size else iq
        base = self._tail_start
        self._next_start += iq.size

        packets: list = []
        if arr.size > 0:
            blocks = torch.from_numpy(frame_stream(arr, self.block_len, self.core_len).copy())
            cfg = self.demod_cfg
            packets = deframe_records(
                self._demod(blocks.to(self.device)), base, self.core_len, self.designator,
                self._deduper, deframer=self.deframer_cfg, fftlen=cfg.fftlen,
                samples_per_symbol=cfg.samples_per_symbol)
        keep = min(arr.size, self._overlap)
        self._tail = arr[arr.size - keep:]
        return packets

    def sentences(self, iq: np.ndarray) -> list[str]:
        return [p.nmea for p in self.process(iq)]

    def set_threshold(self, threshold: float) -> None:
        """Change the correlator threshold: rebuilds the demodulator."""
        self.demod_cfg = dataclasses.replace(self.demod_cfg, corr_threshold=threshold)
        self._demod = self._build_demod()

    def _build_demod(self) -> BurstDemod:
        return make_burst_demod(self.demod_cfg, self.block_len, self.core_len,
                                device=self.device)

    def get_threshold(self) -> float:
        return self.demod_cfg.resolved_corr_threshold

    def get_state(self) -> dict:
        return {"tail": self._tail.copy(), "next_start": self._next_start,
                "dedup_recent": list(self._deduper._recent)}

    def set_state(self, state: dict) -> None:
        self._tail = np.asarray(state["tail"], dtype=np.complex64).copy()
        self._next_start = int(state["next_start"])
        self._deduper._recent = list(state["dedup_recent"])


class ChannelReceiver:
    """Wideband IQ -> one AIS channel (K5) -> [resampler] -> decode.

    When the decimated rate is not a whole number of samples a symbol
    (the reference's default 250 ksps: 50 ksps, 5.208 sps), the streaming
    polyphase resampler brings it to `target_sps` first."""

    def __init__(self, config: ReceiverConfig = ReceiverConfig(), block_len: int = 16384,
                 target_sps: int = 5, *, device="cuda"):
        self.config = config
        self.device = torch.device(device)
        chan = config.channelizer
        self.decim = chan.resolved_decimation()
        self.taps = low_pass(1.0, chan.input_rate, chan.cutoff_hz, chan.transition_hz)
        out_rate = chan.input_rate / self.decim
        sps = out_rate / config.demod.bit_rate
        if abs(sps - round(sps)) > 1e-6:
            self.resample_rate = (target_sps * config.demod.bit_rate) / out_rate
            sps = float(target_sps)
        else:
            self.resample_rate = None
            sps = float(round(sps))
        demod = dataclasses.replace(config.demod, samples_per_symbol=sps)
        self.baseband = BasebandReceiver(demod=demod, deframer=config.deframer,
                                         designator=config.designator, block_len=block_len,
                                         device=self.device)
        # Raw-domain carry: the FIR history plus the decimation phase.
        self._ntaps = int(self.taps.size)
        self._tail = np.zeros(0, dtype=np.complex64)
        self._next_start = 0
        self._resampler = (PfbArbResampler(self.resample_rate)
                           if self.resample_rate is not None else None)

    def process(self, iq: np.ndarray) -> list:
        chan = self.config.channelizer
        iq = np.asarray(iq, dtype=np.complex64)
        arr = np.concatenate([self._tail, iq]) if self._tail.size else iq
        start = self._next_start - self._tail.size  # absolute index of arr[0]
        self._next_start += iq.size
        if arr.size < self._ntaps:
            self._tail = arr
            return []
        phase0 = mixer_phase(chan.offset_hz, chan.input_rate, start)
        baseband = freq_xlating_fir_decimate(
            torch.from_numpy(arr).to(self.device), self.taps, chan.offset_hz,
            chan.input_rate, self.decim, phase0=float(phase0)).cpu().numpy()
        # Baseband sample b sits at raw index start + b*decim; the raw
        # tail keeps the next call's first output on that grid.
        self._tail = arr[baseband.size * self.decim:]
        if self._resampler is not None:
            # The resampler's absolute output counter is the stream
            # position: any chunking gives the same samples.
            out_start = self._resampler.outputs_emitted
            return self.baseband.process(self._resampler.process(baseband),
                                         start_sample=out_start)
        return self.baseband.process(baseband, start_sample=start // self.decim)

    def sentences(self, iq: np.ndarray) -> list[str]:
        return [p.nmea for p in self.process(iq)]

    def get_state(self) -> dict:
        state = {"tail": self._tail.copy(), "next_start": self._next_start,
                 "baseband": self.baseband.get_state()}
        if self._resampler is not None:
            state["resampler"] = self._resampler.get_state()
        return state

    def set_state(self, state: dict) -> None:
        self._tail = np.asarray(state["tail"], dtype=np.complex64).copy()
        self._next_start = int(state["next_start"])
        self.baseband.set_state(state["baseband"])
        if self._resampler is not None:
            self._resampler.set_state(state["resampler"])
