"""Coherent MLSE (Viterbi) GMSK demodulation, batched over bursts.

Port of `ais_tpu/sync/mlse.py`.  The trellis tables are built once in
numpy (`gmsk_trellis`, from `ais_tpu_torch.utils.cpm`); a batch
of N bursts then goes through:

  - `burst_frames`: interval-aligned (N, n_sym, sps) frames, each
    sample interpolated from the 8-tap bank at the burst's timing;
  - `mlse_levels`: branch metrics as fp32 products with the conjugate
    reference waveforms (TF32 is off package-wide: the reference pins
    Precision.HIGHEST here because a reduced-mantissa pass flips
    near-tie decisions), the carrier phase from the training sequence,
    then the add-compare-select recursion as a loop over symbols on an
    (N, n_states) tensor and a traceback.  Ties pick the first
    candidate, as `jnp.argmax` does.

The reference runs this with no Pallas kernel, so plain PyTorch is the
port; the recursion is one small launch chain per symbol.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ais_tpu_torch.ops.interp import DELAY, NSTEPS, NTAPS


class GmskTrellis(NamedTuple):
    n_states: int
    sps: int
    refs_r: np.ndarray       # (n_states*2, sps) Re of conj(reference waveforms)
    refs_i: np.ndarray       # (n_states*2, sps) Im of conj(reference waveforms)
    preds: np.ndarray        # (n_states, 2, 2): incoming (prev_state, symbol)
    train_paths: np.ndarray  # (4, n_train) flat (state*2+sym) paths of the
                             # NRZI training pattern at its 4 alignments
    frame_offset: int        # calibrated modulator-sample offset of interval 0


def _training_levels(n: int = 24) -> np.ndarray:
    from ais_tpu_torch.tx.frame import TRAINING_BITS, nrzi_encode

    return nrzi_encode(TRAINING_BITS[:n], initial_level=1)


@functools.lru_cache(maxsize=4)
def gmsk_trellis(sps: int, bt: float = 0.4) -> GmskTrellis:
    """The binary GMSK trellis (h = 1/2) at integer `sps`: reference
    waveforms, incoming transitions, the training sequence's paths and
    the interval grid's offset calibrated against the package's own
    modulator."""
    from ais_tpu_torch.tx.gmsk import modulate_bits
    from ais_tpu_torch.utils.cpm import gmsk_frequency_pulse, make_cpm_signals

    d = make_cpm_signals(M=2, h_num=1, h_den=2, sps=sps, pulse=gmsk_frequency_pulse(sps, bt))
    ns = d.n_states
    preds = np.zeros((ns, 2, 2), dtype=np.int32)
    counts = np.zeros(ns, dtype=np.int64)
    for ps in range(ns):
        for sym in range(2):
            nxt = d.next_state[ps, sym]
            preds[nxt, counts[nxt] % 2] = (ps, sym)
            counts[nxt] += 1
    if not (counts == 2).all():
        raise ValueError("irregular trellis")
    refs = np.conj(d.signals.reshape(ns * 2, sps))

    levels0 = _training_levels()
    paths = []
    for shift in range(4):
        state, path = 0, []
        for lv in np.roll(levels0, -shift):
            path.append(state * 2 + int(lv))
            state = int(d.next_state[state, int(lv)])
        paths.append(path)
    train_paths = np.asarray(paths, dtype=np.int32)

    # The sample offset q where the training path's reference waveforms
    # best match a modulated training burst.
    wf = modulate_bits(np.tile(levels0, 3), sps).astype(np.complex128)
    sigs = d.signals.reshape(ns * 2, sps)
    best_q, best_m = 0, -1.0
    for q in range(4 * sps):
        acc = 0.0 + 0.0j
        ok = True
        for k in range(8, 8 + 16):
            lo = q + k * sps
            if lo + sps > wf.size:
                ok = False
                break
            acc += np.vdot(sigs[train_paths[0, k % levels0.size]], wf[lo: lo + sps])
        if ok and abs(acc) > best_m:
            best_m, best_q = abs(acc), q
    return GmskTrellis(ns, sps, refs.real.astype(np.float32), refs.imag.astype(np.float32),
                       preds, train_paths, best_q)


def burst_frames(bursts: torch.Tensor, center0: torch.Tensor, sps: int, n_symbols: int,
                 delta: float, frame_offset: int, bank: torch.Tensor):
    """Interval-aligned frames of (N, L) bursts: (N, n_symbols, sps)
    complex64 and a (N, n_symbols) valid mask.

    `center0` (N,) is the feedforward first symbol centre (samples);
    interval k starts at center0 - delta + frame_offset + k*sps, with
    `delta` the calibrated tone-phase offset and `frame_offset` the
    trellis's.  Each sample is one 8-tap bank interpolation."""
    n, length = bursts.shape
    start0 = center0 - delta + frame_offset                               # (N,)
    k = torch.arange(n_symbols * sps, dtype=torch.float32, device=bursts.device)
    pos = start0[:, None] + k[None, :]
    i0 = torch.floor(pos).to(torch.int64)
    mu = pos - i0.to(torch.float32)
    in_range = (i0 - DELAY >= 0) & (i0 - DELAY + NTAPS <= length)
    lo = torch.clamp(i0 - DELAY, 0, length - NTAPS)
    rows = bank[torch.clamp(torch.round(mu * NSTEPS).to(torch.int64), 0, NSTEPS)]  # (N, S, 8)
    samples = torch.zeros(n, n_symbols * sps, dtype=bursts.dtype, device=bursts.device)
    for t in range(NTAPS):
        samples += rows[..., t] * bursts.gather(-1, lo + t)
    valid = in_range.reshape(n, n_symbols, sps).all(-1)
    return samples.reshape(n, n_symbols, sps), valid


class TrellisTensors(NamedTuple):
    """A trellis's tables on one device."""

    refs_r: torch.Tensor     # (2 ns, sps)
    refs_i: torch.Tensor
    ps_idx: torch.Tensor     # (ns, 2) predecessor state
    sym_idx: torch.Tensor    # (ns, 2) symbol on that transition
    branch: torch.Tensor     # (ns, 2) flat metric index ps*2 + sym
    train_paths: torch.Tensor


def trellis_tensors(tr: GmskTrellis, device) -> TrellisTensors:
    ps = torch.as_tensor(tr.preds[..., 0], dtype=torch.int64, device=device)
    sym = torch.as_tensor(tr.preds[..., 1], dtype=torch.int64, device=device)
    return TrellisTensors(
        torch.as_tensor(tr.refs_r, device=device), torch.as_tensor(tr.refs_i, device=device),
        ps, sym, ps * 2 + sym,
        torch.as_tensor(tr.train_paths, dtype=torch.int64, device=device))


def mlse_levels(frames: torch.Tensor, tt: TrellisTensors, n_train: int = 16,
                train_start: torch.Tensor | int = 4) -> torch.Tensor:
    """Viterbi NRZI levels (+-1 float32), (N, n_sym), from (N, n_sym, sps)
    interval-aligned frames.  The carrier phase comes from the training
    intervals [train_start, train_start + n_train) of each burst (N,)
    against the 4 alignments of the training path; the strongest wins."""
    n, n_sym, _ = frames.shape
    dev = frames.device
    fr, fi = frames.real, frames.imag
    cr = fr @ tt.refs_r.T - fi @ tt.refs_i.T                  # (N, n_sym, 2 ns)
    ci = fr @ tt.refs_i.T + fi @ tt.refs_r.T
    ts = torch.as_tensor(train_start, dtype=torch.int64, device=dev).expand(n)
    k = (ts[:, None] + torch.arange(n_train, device=dev)[None, :]).clamp(0, n_sym - 1)
    idx = tt.train_paths[:, :n_train]                           # (4, n_train)
    rows = torch.arange(n, device=dev)[:, None, None]
    tr_r = cr[rows, k[:, None, :], idx[None]].sum(-1)           # (N, 4)
    tr_i = ci[rows, k[:, None, :], idx[None]].sum(-1)
    mag = tr_r * tr_r + tr_i * tr_i
    best = torch.argmax(mag, dim=-1, keepdim=True)
    norm = torch.sqrt(mag.gather(-1, best)) + 1e-12
    cphi = (tr_r.gather(-1, best) / norm)[:, :, None]
    sphi = (tr_i.gather(-1, best) / norm)[:, :, None]
    metrics = cr * cphi + ci * sphi                             # Re(corr e^{-j phi})
    del cr, ci
    # Branch metrics of every state's two incoming transitions, symbol-major.
    m = metrics[:, :, tt.branch].permute(1, 0, 2, 3).contiguous()  # (n_sym, N, ns, 2)
    del metrics

    ns = tt.ps_idx.shape[0]
    pm = torch.zeros(n, ns, dtype=torch.float32, device=dev)
    choices = torch.empty(n_sym, n, ns, dtype=torch.bool, device=dev)
    flat_ps = tt.ps_idx.reshape(-1)
    for s in range(n_sym):
        cand = pm[:, flat_ps].reshape(n, ns, 2) + m[s]
        c0, c1 = cand[..., 0], cand[..., 1]
        pick = c1 > c0                      # first of equal candidates, as argmax
        choices[s] = pick
        pm = torch.where(pick, c1, c0)

    state = torch.argmax(pm, dim=-1)                            # (N,)
    syms = torch.empty(n_sym, n, dtype=torch.int64, device=dev)
    for s in range(n_sym - 1, -1, -1):
        j = choices[s].gather(-1, state[:, None])[:, 0].to(torch.int64)
        syms[s] = tt.sym_idx[state, j]
        state = tt.ps_idx[state, j]
    return 2.0 * syms.T.to(torch.float32) - 1.0
