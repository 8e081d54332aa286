"""Batched AIS burst demodulator: demod blocks -> per-burst bit records.

`BurstDemod` ports `ais_tpu/pipeline/receiver.py:make_burst_demod` for the main
path's modes (`demod_mode="discriminator"`, `timing_mode="feedforward"`,
the FIR symbol comb).  One call maps a (B, block_len) batch of halo'd
blocks to a fixed-size table of K burst records per block:

  AGC -> square-and-FFT AFC -> matched filter (K2) -> threshold/CFAR/NMS
  detection -> burst windows (a gather) -> RSSI, per-burst derotation ->
  feedforward timing + symbol FIR -> quadrature demod -> slice/diff/invert

Peaks are accepted only inside the block core, so blocks stepped by
core_len decode every packet exactly once (overlap-save framing).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ais_tpu.core.params import BURST_GRID, DemodConfig
from ais_tpu_torch.ops.agc import feedforward_agc
from ais_tpu_torch.ops.demod import quadrature_demod, slice_diff_invert
from ais_tpu_torch.ops.framing import frame_overlap_big
from ais_tpu_torch.ops.freq import square_and_fft_sync
from ais_tpu_torch.ops.interp import NSTEPS, NTAPS
from ais_tpu_torch.ops.matched_filter import MatchedFilter
from ais_tpu_torch.sync.corr import autocorr_threshold, detect_bursts
from ais_tpu_torch.sync.feedforward import feedforward_symbols_fir


class BurstRecords(NamedTuple):
    """Fixed-size per-block burst table; leading dims (B,) or (C, B)."""

    position: torch.Tensor    # (K,) int32, preamble start sample in the block
    center: torch.Tensor      # (K,) float32, fractional peak offset in (-1, 1)
    phase: torch.Tensor       # (K,) float32, correlator phase at the peak
    mag: torch.Tensor         # (K,) float32, |corr|^2 at the peak
    valid: torch.Tensor       # (K,) bool
    bits: torch.Tensor        # (K, n_symbols) uint8, NRZI-decoded bits
    bit_valid: torch.Tensor   # (K, n_symbols) bool
    freq_est: torch.Tensor    # (n_chunks,) float32, AFC estimates in Hz
    n_detected: torch.Tensor  # () int32, peaks before the cap (> K: overflow)
    win_start: torch.Tensor   # (K,) int32, block index of the burst window
    rssi: torch.Tensor        # (K,) float32, mean pre-AGC power over the window


def required_halo(cfg: DemodConfig) -> int:
    """Lookahead a block must carry past its core so any core-start burst
    is fully processable: burst window + correlator preamble + AGC window."""
    preamble_len = int(round(cfg.samples_per_symbol)) * 28
    return cfg.burst_len + max(cfg.agc_window, preamble_len) + 16


def burst_table_geometry(cfg: DemodConfig) -> tuple[int, int]:
    """(win_len, n_symbols) of the per-burst extraction table."""
    win_len = cfg.burst_len + BURST_GRID
    return win_len, int((win_len - 16) // cfg.samples_per_symbol)


def preamble_waveform(cfg: DemodConfig) -> np.ndarray:
    """The correlator's reference: GMSK of the NRZI'd training sequence."""
    from ais_tpu.tx.gmsk import preamble_waveform as gmsk_preamble

    return gmsk_preamble(int(round(cfg.samples_per_symbol)), cfg.gmsk_bt)


def _check_modes(cfg: DemodConfig) -> None:
    if cfg.demod_mode != "discriminator":
        raise NotImplementedError(
            f"demod_mode={cfg.demod_mode!r} is not ported yet (ROADMAP A.11)")
    if cfg.timing_mode != "feedforward":
        raise NotImplementedError(
            f"timing_mode={cfg.timing_mode!r} is not ported yet (ROADMAP A.11)")
    # "auto" resolves to the one formulation the port has; the reference's
    # CPU choice ("bank") is a different algorithm, not a device choice.
    if cfg.ff_path not in ("auto", "fir"):
        raise NotImplementedError(
            f"ff_path={cfg.ff_path!r} is not ported yet (ROADMAP A.11)")
    if cfg.corr_path not in ("auto", "pallas"):
        raise NotImplementedError(
            f"corr_path={cfg.corr_path!r}: the port's correlator is the matched "
            f"filter K2 (its plain version on the CPU)")


class BurstDemod(torch.nn.Module):
    """(B, block_len) complex64 blocks -> BurstRecords with leading (B,).

    Owns the matched filter (K2) and the interpolation bank; `preamble`,
    `interp_bank` and `ff_delta` are the constants the reference builds
    (see `pipeline/wideband.py:default_constants`)."""

    def __init__(self, cfg: DemodConfig, block_len: int, core_len: int, *,
                 preamble: np.ndarray, interp_bank: np.ndarray, ff_delta: float,
                 device=None):
        super().__init__()
        if block_len % cfg.fftlen != 0:
            raise ValueError(f"block_len {block_len} not a multiple of fftlen {cfg.fftlen}")
        if core_len > block_len - required_halo(cfg):
            raise ValueError(
                f"core_len {core_len} leaves less than required halo "
                f"{required_halo(cfg)} in block_len {block_len}")
        if block_len % BURST_GRID != 0:
            raise ValueError(f"block_len {block_len} not a multiple of {BURST_GRID}")
        _check_modes(cfg)
        bank = np.asarray(interp_bank, np.float32)
        if bank.shape != (NSTEPS + 1, NTAPS):
            raise ValueError(f"interpolation bank must be {(NSTEPS + 1, NTAPS)}, got {bank.shape}")
        self.cfg = cfg
        self.block_len = int(block_len)
        self.core_len = int(core_len)
        self.win_len, self.n_sym = burst_table_geometry(cfg)
        self.ff_delta = float(ff_delta)
        self.thresh = autocorr_threshold(preamble, cfg.resolved_corr_threshold)
        # The CFAR constant tracks the threshold knob upward but never
        # drops below its calibrated false-alarm base.
        self.cfar_k = (
            cfg.corr_cfar_k * max(1.0, cfg.resolved_corr_threshold / 0.9)
            if cfg.corr_cfar_k is not None else None
        )
        self.matched_filter = MatchedFilter(preamble, device=device)
        self.register_buffer("interp_bank", torch.tensor(bank, device=device))

    def forward(self, x: torch.Tensor) -> BurstRecords:
        cfg = self.cfg
        B = x.shape[0]
        K = cfg.max_bursts_per_block
        fs = cfg.sample_rate
        grid = BURST_GRID
        # AGC first (it commutes with the AFC's pure rotation); detection
        # runs on the per-chunk derotated stream, but each burst is then
        # decoded with ONE frequency correction, that of the chunk
        # holding its body.
        a = feedforward_agc(x, cfg.agc_window, cfg.agc_reference)
        y_det, est = square_and_fft_sync(a, fs, cfg.bit_rate, cfg.fftlen,
                                         gate_ratio=cfg.afc_gate_ratio)
        corr, mag2 = self.matched_filter(y_det)
        det = detect_bursts(corr, mag2, self.thresh, cfg.nms_radius, K,
                            self.core_len, cfar_k=self.cfar_k)
        pos = det.position.to(torch.int64)

        # Burst windows on a `grid`-sample lattice (the window carries
        # `grid` extra samples so the lattice never cuts the packet),
        # seeded at peak + mark_delay with one guard sample.
        starts = (pos + cfg.corr_mark_delay - 1).clamp(0, self.block_len - cfg.burst_len)
        win_idx = starts // grid                                    # (B, K)
        windows = frame_overlap_big(a, grid, self.win_len - grid)   # (B, n_win, win_len)
        rows = torch.arange(B, device=x.device)[:, None]
        bursts = windows[rows, win_idx].reshape(B * K, self.win_len)

        # Pre-AGC power per window (RSSI): mean |x|^2 over its grid cells.
        n_win = self.block_len // grid
        p_cell = (x.real ** 2 + x.imag ** 2).reshape(B, n_win, grid).mean(-1)
        cs = torch.cat([torch.zeros_like(p_cell[:, :1]), torch.cumsum(p_cell, -1)], -1)
        i0 = torch.arange(n_win, device=x.device)
        i1 = (i0 + self.win_len // grid).clamp(max=n_win)
        win_power = (cs[:, i1] - cs[:, i0]) / (i1 - i0).to(torch.float32).clamp(min=1.0)
        rssi = win_power.gather(-1, win_idx)

        # One AFC estimate per burst, from the chunk holding its body.
        chunk = ((pos + cfg.fftlen // 2) // cfg.fftlen).clamp(0, est.shape[-1] - 1)
        burst_freq = est.gather(-1, chunk).reshape(B * K)
        k = torch.arange(self.win_len, dtype=torch.float32, device=x.device)
        carrier_phase = ((-2.0 * math.pi / fs) * burst_freq)[:, None] * k[None, :]
        bursts = bursts * torch.polar(torch.ones_like(carrier_phase), carrier_phase)

        symbols, sym_valid = feedforward_symbols_fir(
            bursts, cfg.samples_per_symbol, self.n_sym, self.ff_delta,
            self.interp_bank, seg_len=cfg.ff_seg_len)
        bits = slice_diff_invert(quadrature_demod(symbols))
        return BurstRecords(
            det.position, det.center, det.phase, det.mag, det.valid,
            bits.reshape(B, K, self.n_sym), sym_valid.reshape(B, K, self.n_sym),
            est, det.n_detected, (win_idx * grid).to(torch.int32), rssi,
        )

