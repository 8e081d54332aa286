"""Host-side burst-table overflow recovery.

Port of `ais_tpu/pipeline/recover.py`.  The demodulator's burst table
holds K bursts a block; when a block detects more (`n_detected > K`),
or its valid lanes do not fit the compact lane directory, the receiver
re-channelizes just that block's raw span on the host (float64 numpy)
and demodulates it again with a larger table: the smallest power of two
from 64 to 1024 that holds the detections.  Recovered packets go through
the receiver's per-channel dedupers, already primed by the first pass,
so only the packets the table dropped come out.

The re-demodulation runs `BurstDemod` on the receiver's own device (K2
on the card).  The reference pins the CPU and an FFT correlator there
because a Pallas kernel traced under `jax.default_device(cpu)` failed to
lower; that is a TPU workaround and is not carried over.
"""

from __future__ import annotations

import logging
from typing import Callable

import numpy as np
import torch

from ais_tpu_torch.pipeline.host import decode_block_records

log = logging.getLogger("ais_tpu_torch")

# Escalated burst-table sizes: powers of two, so each size builds once.
MIN_RECOVER_K = 64
MAX_RECOVER_K = 1024


def recover_table_size(n_detected: int) -> int:
    """The escalated table for a block with `n_detected` detections."""
    k = MIN_RECOVER_K
    while k < n_detected and k < MAX_RECOVER_K:
        k *= 2
    return k


def host_channelize_span(iq: np.ndarray, taps: np.ndarray, offset_hz: float, rate: float,
                         decim: int, abs_start: int) -> np.ndarray:
    """Mix `iq` down by `offset_hz` (carrier phased at absolute raw index
    `abs_start`), correlate with `taps`, decimate, in float64:
    out[j] = sum_k taps[k] * mixed[j*decim + k], the channelizers'
    geometry."""
    n = np.arange(abs_start, abs_start + iq.size, dtype=np.float64)
    mixed = (np.asarray(iq, np.complex64)
             * np.exp(-2j * np.pi * (offset_hz / rate) * n)).astype(np.complex64)
    L = taps.size
    nfft = 1 << int(iq.size + L - 1).bit_length()
    # Correlation as convolution with reversed taps: full[j + L - 1] =
    # sum_k taps[k] * mixed[j + k].
    full = np.fft.ifft(np.fft.fft(mixed, nfft) * np.fft.fft(taps[::-1].astype(np.float64), nfft))
    n_out = (iq.size - L) // decim + 1
    return full[L - 1: L - 1 + (n_out - 1) * decim + 1: decim].astype(np.complex64)


def recover_overflow_packets(iq_raw: np.ndarray, abs_raw_start: int, cfg, taps: np.ndarray,
                             overflowed, dedupers, demod_for: Callable[[int], object]) -> list:
    """Re-demodulate overflowed blocks with a larger burst table.

    iq_raw: the step's raw complex64 samples, iq_raw[0] at absolute raw
    index `abs_raw_start`; cfg: the WidebandConfig; taps: its channel
    low-pass; overflowed: (channel, block, n_detected) triples;
    dedupers: the receiver's per-channel dedupers; demod_for(K): a
    BurstDemod with a table of K, on the device it should run on.
    Returns the newly recovered packets."""
    block_len, core_len, decim = cfg.block_len, cfg.core_len, cfg.decimation
    packets = []
    for c, b, n_det in overflowed:
        i0 = b * core_len * decim
        span = iq_raw[i0: i0 + (block_len - 1) * decim + taps.size]
        chan = host_channelize_span(span, taps, cfg.offsets_hz[c], cfg.input_rate, decim,
                                    abs_raw_start + i0)
        k2 = recover_table_size(int(n_det))
        if n_det > k2:
            log.warning("overflow recovery: %d detections exceed even the escalated "
                        "table (%d); recovering the first %d", int(n_det), k2, k2)
        demod = demod_for(k2)
        x = torch.from_numpy(chan).to(demod.interp_bank.device)
        rec = demod(x[None])
        rec_np = type(rec)(*(t[0].cpu().numpy() for t in rec))
        recovered = decode_block_records(
            rec_np, abs_raw_start // decim + b * core_len, designator=cfg.designators[c],
            deframer=cfg.deframer, deduper=dedupers[c] if dedupers is not None else None,
            fftlen=cfg.demod.fftlen, samples_per_symbol=cfg.sps)
        log.info("overflow recovery: block (chan %d, block %d) re-demodulated with table "
                 "%d -> %d additional packets", c, b, k2, len(recovered))
        packets.extend(recovered)
    return packets
