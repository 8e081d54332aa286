"""`ais_scope` — offline signal scopes for captures (GRC GUI equivalent).

The reference's development flowgraphs attach QT GUI sinks to the
receive chain — a frequency/waterfall scope on the wideband input and
time scopes on the correlator and demod signals
(reference: python/ais.grc:573 file source feeding scope sinks;
python/ais_demod_grc.grc exposes the demod chain the same way).  This
build has no interactive GUI runtime, so the same diagnostic surface is
a command: render the taps `make_debug_taps` exposes
(ais_tpu_torch/pipeline/receiver.py) plus input-domain views into one PNG.

Port of `ais_tpu/cli/ais_scope.py`: the same panels and options, plus
`--device` (the chain's taps are computed on the card unless `--device
cpu` is given).  `compute_panels` needs no matplotlib; `render` does and
says so when it is absent.

Panels:
  1. input power spectral density (Welch, dB)
  2. input spectrogram (time x frequency, perceptual colormap)
  3. AFC frequency estimate per chunk (ops/freq.py square_and_fft_sync)
  4. correlator |y|^2 with the detection threshold
     (sync/corr.py autocorr_threshold) and the strongest burst marked
  5. eye diagram of the FM discriminator output over the strongest burst
  6. constellation of the AGC'd, AFC-derotated burst samples

Usage:
  python -m ais_tpu_torch.cli.ais_scope -s capture.bin -r 250e3 [--channel A|B] [-o scope.png]
  python -m ais_tpu_torch.cli.ais_scope -s baseband.bin -S      # channel-rate input
"""

from __future__ import annotations

import argparse
import sys

# Single fixed hue for series marks; neutral ink for text/grid; the
# spectrogram uses a perceptually-uniform sequential colormap (never a
# rainbow).  Single-series panels carry their name in the title, not a
# legend.
SERIES = "#2a6fbb"
ACCENT = "#c4541d"
INK = "#3a3a3a"
GRID = "#d9d9d9"


class RenderUnavailable(RuntimeError):
    """`render` cannot draw: matplotlib is not installed."""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ais_scope_torch", description="render receive-chain scopes to a PNG"
    )
    p.add_argument("-s", "--source", required=True, help="IQ capture file")
    p.add_argument(
        "-r", "--rate", type=float, default=250e3, help="sample rate [default=%(default)s]"
    )
    p.add_argument(
        "-F",
        "--format",
        default="complex64",
        choices=["complex64", "cf32", "ci16", "cs16", "ci8", "cs8", "cu8"],
    )
    p.add_argument(
        "-S",
        "--singlechannel",
        action="store_true",
        help="input is already channel-rate baseband (no channelizer)",
    )
    p.add_argument(
        "--channel", default="A", choices=["A", "B"], help="channel to scope"
    )
    p.add_argument("-o", "--output", default="ais_scope.png")
    p.add_argument(
        "--max-samples",
        type=int,
        default=2_000_000,
        help="cap on input samples read [default=%(default)s]",
    )
    p.add_argument(
        "--threshold",
        type=float,
        default=0.9,
        help="correlator threshold fraction to draw [default=%(default)s]",
    )
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device the receive chain runs on [default=%(default)s]",
    )
    return p


def _style(ax, title):
    ax.set_title(title, color=INK, fontsize=9)
    ax.tick_params(colors=INK, labelsize=7)
    ax.grid(True, color=GRID, linewidth=0.6, alpha=0.8)
    for s in ax.spines.values():
        s.set_color(GRID)


def compute_panels(iq, baseband, cfg, threshold: float, rate: float, *,
                   device="cuda") -> dict:
    """Compute the data behind every panel (separated from drawing so
    tests can assert the diagnostics are CORRECT, not just rendered):
    psd_f_khz/psd_db, freq_est_hz (per AFC chunk), corr2 (correlator
    power aligned to the baseband stream), thr, peak (strongest burst
    index), agc/der (stitched chain taps).  The chain runs on `device`."""
    import numpy as np

    from ais_tpu_torch.pipeline.receiver import make_debug_taps, required_halo
    from ais_tpu_torch.sync.corr import autocorr_threshold
    from ais_tpu_torch.tx.gmsk import preamble_waveform

    block_len = 16384
    # Stitch step: the largest fftlen multiple that still leaves the
    # demod halo — keeps the AFC chunk lattice (one estimate per fftlen
    # samples) aligned with absolute sample indices across blocks.
    core_len = ((block_len - required_halo(cfg)) // cfg.fftlen) * cfg.fftlen
    core_chunks = core_len // cfg.fftlen
    taps_fn = make_debug_taps(cfg, block_len, device=device)

    # Run the taps block-wise over the capture; stitch the core spans so
    # indices line up with the baseband stream.
    n_blocks = max(1, min(64, (baseband.size - 1) // core_len + 1))
    agc = np.zeros(n_blocks * core_len, np.complex64)
    der = np.zeros(n_blocks * core_len, np.complex64)
    corr2 = np.zeros(n_blocks * core_len, np.float32)
    freqs = []
    for b in range(n_blocks):
        x = np.zeros(block_len, np.complex64)
        seg = baseband[b * core_len : b * core_len + block_len]
        x[: seg.size] = seg
        t = {k: v.cpu().numpy() for k, v in taps_fn(x).items()}
        agc[b * core_len : (b + 1) * core_len] = t["agc"][:core_len]
        der[b * core_len : (b + 1) * core_len] = t["derotated"][:core_len]
        c = t["corr_mag2"]
        corr2[b * core_len : b * core_len + min(core_len, c.size)] = c[:core_len]
        freqs.append(t["freq_est_hz"][:core_chunks])
    # Trim the zero-padded tail block span back to the real capture.
    n_bb = min(baseband.size, agc.size)
    agc, der, corr2 = agc[:n_bb], der[:n_bb], corr2[:n_bb]
    freqs = np.concatenate(freqs)[: max(1, -(-n_bb // cfg.fftlen))]

    sps = int(round(cfg.samples_per_symbol))
    pre = preamble_waveform(sps, cfg.gmsk_bt)
    thr = autocorr_threshold(pre, threshold)
    peak = int(np.argmax(corr2))

    nfft = 4096
    nseg = max(1, iq.size // nfft)
    segs = iq[: nseg * nfft].reshape(nseg, nfft) * np.hanning(nfft)
    psd = (np.abs(np.fft.fftshift(np.fft.fft(segs, axis=-1), axes=-1)) ** 2).mean(0)
    f = np.fft.fftshift(np.fft.fftfreq(nfft, 1 / rate)) / 1e3

    return {
        "psd_f_khz": f,
        "psd_db": 10 * np.log10(psd + 1e-12),
        "freq_est_hz": freqs,
        "corr2": corr2,
        "thr": thr,
        "peak": peak,
        "agc": agc,
        "der": der,
        "sps": sps,
    }


def render(iq, baseband, cfg, threshold: float, out_path: str, rate: float, *,
           device="cuda"):
    """Draw the six panels; `iq` is the raw input, `baseband` the
    channel-rate signal the demod sees (equal when -S)."""
    try:
        import matplotlib
    except ImportError as exc:
        raise RenderUnavailable(
            f"rendering the scope PNG needs matplotlib, which is not installed ({exc}); "
            f"`compute_panels` gives the panels' data without it") from exc

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np
    import torch

    from ais_tpu_torch.ops.demod import quadrature_demod

    p = compute_panels(iq, baseband, cfg, threshold, rate, device=device)
    der, corr2 = p["der"], p["corr2"]
    freqs, thr, peak, sps = p["freq_est_hz"], p["thr"], p["peak"], p["sps"]

    fig, axes = plt.subplots(2, 3, figsize=(15, 8), dpi=110)
    fig.patch.set_facecolor("white")

    # 1 — PSD of the raw input.
    ax = axes[0, 0]
    ax.plot(p["psd_f_khz"], p["psd_db"], color=SERIES, linewidth=1.2)
    _style(ax, f"input PSD ({rate/1e3:.0f} ksps)")
    ax.set_xlabel("frequency (kHz)", color=INK, fontsize=8)
    ax.set_ylabel("dB", color=INK, fontsize=8)

    # 2 — spectrogram of the raw input.
    ax = axes[0, 1]
    nfft_s = 512
    nseg = max(1, iq.size // nfft_s)
    segs = iq[: nseg * nfft_s].reshape(nseg, nfft_s) * np.hanning(nfft_s)
    sg = np.abs(np.fft.fftshift(np.fft.fft(segs, axis=-1), axes=-1)) ** 2
    ax.imshow(
        10 * np.log10(sg.T + 1e-12),
        aspect="auto",
        origin="lower",
        cmap="magma",
        extent=[0, nseg * nfft_s / rate, -rate / 2e3, rate / 2e3],
    )
    _style(ax, "spectrogram")
    ax.grid(False)
    ax.set_xlabel("time (s)", color=INK, fontsize=8)
    ax.set_ylabel("kHz", color=INK, fontsize=8)

    # 3 — AFC estimate per chunk.
    ax = axes[0, 2]
    t_chunk = np.arange(freqs.size) * cfg.fftlen / cfg.sample_rate
    ax.step(t_chunk, freqs, where="post", color=SERIES, linewidth=1.2)
    _style(ax, "AFC frequency estimate per chunk")
    ax.set_xlabel("time (s)", color=INK, fontsize=8)
    ax.set_ylabel("Hz", color=INK, fontsize=8)

    # 4 — correlator power + threshold.
    ax = axes[1, 0]
    t_bb = np.arange(corr2.size) / cfg.sample_rate
    ax.plot(t_bb, corr2, color=SERIES, linewidth=0.7)
    ax.axhline(thr, color=ACCENT, linewidth=1.0, linestyle="--")
    ax.annotate(
        f"threshold ({threshold:g})",
        xy=(0, thr),
        xytext=(4, 4),
        textcoords="offset points",
        color=ACCENT,
        fontsize=7,
    )
    ax.plot([peak / cfg.sample_rate], [corr2[peak]], "o", color=ACCENT, ms=5)
    _style(ax, "correlator |y|² (strongest burst marked)")
    ax.set_xlabel("time (s)", color=INK, fontsize=8)

    # 5 — eye diagram of the discriminator output over the burst.
    ax = axes[1, 1]
    span = min(256 * sps, der.size - peak)
    if span > 4 * sps:
        fm = quadrature_demod(torch.from_numpy(der[peak : peak + span])).numpy()
        n_tr = (fm.size - 1) // (2 * sps)
        tr = fm[: n_tr * 2 * sps].reshape(n_tr, 2 * sps)
        xs = np.arange(2 * sps) / sps
        for row in tr:
            ax.plot(xs, row, color=SERIES, alpha=0.12, linewidth=0.8)
    _style(ax, "eye diagram — FM discriminator (2 symbols)")
    ax.set_xlabel("symbols", color=INK, fontsize=8)

    # 6 — constellation of the derotated burst.
    ax = axes[1, 2]
    if span > 4 * sps:
        z = der[peak : peak + span]
        ax.plot(z.real, z.imag, ".", color=SERIES, ms=2, alpha=0.4)
    ax.set_aspect("equal")
    _style(ax, "constellation — AGC + AFC derotated burst")

    fig.suptitle(
        "ais_scope — receive-chain diagnostics", color=INK, fontsize=11
    )
    fig.tight_layout(rect=[0, 0, 1, 0.97])
    fig.savefig(out_path, facecolor="white")
    plt.close(fig)


def scoped_baseband(iq, rate: float, channel: str, device):
    """(baseband, DemodConfig) of one AIS channel of a wideband capture:
    the `ChannelReceiver` front end alone (mix, filter and decimate on
    K5, then the fractional resampler where the rate asks for one)."""
    import dataclasses

    import numpy as np
    import torch

    from ais_tpu_torch.core.params import ReceiverConfig
    from ais_tpu_torch.ops.fir import freq_xlating_fir_decimate
    from ais_tpu_torch.pipeline.api import ChannelReceiver

    rc = ReceiverConfig()
    offset = -25e3 if channel == "A" else 25e3
    rc = dataclasses.replace(
        rc,
        channelizer=dataclasses.replace(rc.channelizer, input_rate=rate, offset_hz=offset),
        designator=channel,
    )
    chan = ChannelReceiver(rc, device=device)
    baseband = freq_xlating_fir_decimate(
        torch.from_numpy(np.asarray(iq, np.complex64)).to(chan.device), chan.taps, offset,
        rate, chan.decim).cpu().numpy()
    if chan._resampler is not None:
        baseband = chan._resampler.process(baseband)
    return baseband, chan.baseband.demod_cfg


def main(argv: list[str] | None = None) -> int:
    options = build_parser().parse_args(argv)
    import numpy as np

    from ais_tpu_torch.core.params import DemodConfig
    from ais_tpu_torch.io.sources import read_iq_file

    iq = read_iq_file(options.source, options.format)[: options.max_samples]
    if iq.size == 0:
        print("empty capture", file=sys.stderr)
        return 1

    if options.singlechannel:
        baseband = np.asarray(iq, np.complex64)
        cfg = DemodConfig()
    else:
        baseband, cfg = scoped_baseband(iq, options.rate, options.channel, options.device)

    try:
        render(
            np.asarray(iq, np.complex64),
            np.asarray(baseband, np.complex64),
            cfg,
            options.threshold,
            options.output,
            options.rate,
            device=options.device,
        )
    except RenderUnavailable as exc:
        print(exc, file=sys.stderr)
        return 1
    print(f"wrote {options.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
