"""Standalone loopback-modem workbench.

Equivalent of the reference's modem experimentation flowgraphs
(reference: python/ais_demod_grc.py:20-70 — random bits -> gmskmod ->
pfb clock sync -> quadrature demod -> scope; python/ais_demod2.grc —
the same bench with channel impairments), rebuilt as a CLI: it
modulates randomized AIS packets through `ais_tpu_torch.tx`, pushes them
through a selectable demod chain under selectable impairments (AWGN
SNR, carrier offset, symbol-clock ppm), and reports packet success per
operating point — with an optional scope-style PNG (discriminator
output, eye diagram, recovered constellation) standing in for the GRC
scope sinks.

Port of `ais_tpu/cli/modem_bench.py`: the same options, JSON line and
exit code; `--platform` became `--device` (the demodulators run on the
card unless `--device cpu` is given).

Usage:
    python -m ais_tpu_torch.cli.modem_bench --snr-db 20 10 8 6 --demod all
    python -m ais_tpu_torch.cli.modem_bench --snr-db 8 --cfo-hz 300 --ppm 30 --plot modem.png
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

SAMPLE_RATE = 48_000.0
SPS = 5


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="ais_modem_bench_torch",
        description="Loopback GMSK modem bench (tx -> impairments -> demod)",
    )
    ap.add_argument(
        "--demod",
        default="all",
        choices=["feedforward", "pll", "mlse", "all"],
        help="demod chain(s) to exercise [default: all]",
    )
    ap.add_argument(
        "--snr-db",
        type=float,
        nargs="+",
        default=[20.0, 12.0, 9.0, 6.0],
        help="per-sample SNR operating points [default: 20 12 9 6]",
    )
    ap.add_argument("--cfo-hz", type=float, default=0.0, help="carrier offset")
    ap.add_argument(
        "--ppm", type=float, default=0.0, help="symbol-clock offset (ppm)"
    )
    ap.add_argument("--trials", type=int, default=20, help="packets per point")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--plot",
        metavar="OUT.png",
        help="render scope panels (GRC scope-sink equivalent) for the "
        "first operating point",
    )
    ap.add_argument(
        "--json", action="store_true", help="print one JSON line instead of a table"
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device the demodulators run on [default: cuda]; "
        "'cpu' runs the kernels' plain versions",
    )
    return ap


def _random_payload(rng: np.random.Generator) -> bytes:
    """A random (valid-length) AIS position-report-sized payload."""
    return bytes(rng.integers(0, 256, size=21, dtype=np.uint8))


def _impair(
    iq: np.ndarray,
    snr_db: float,
    cfo_hz: float,
    ppm: float,
    rng: np.random.Generator,
    guard: int = 2048,
) -> np.ndarray:
    """AWGN + carrier offset + clock skew around a guard-padded burst."""
    if ppm:
        # Symbol-clock offset: resample the waveform by (1 + ppm*1e-6)
        # on the host grid (the receiver's clock is the reference).
        n = iq.size
        t = np.arange(n) * (1.0 + ppm * 1e-6)
        m = int(np.floor(t[-1])) + 1
        iq = np.interp(np.arange(m), t, iq.real) + 1j * np.interp(
            np.arange(m), t, iq.imag
        )
    if cfo_hz:
        iq = iq * np.exp(2j * np.pi * cfo_hz * np.arange(iq.size) / SAMPLE_RATE)
    sigma = 10.0 ** (-snr_db / 20.0) / np.sqrt(2.0)
    out = (
        rng.normal(size=iq.size + 2 * guard) * sigma
        + 1j * rng.normal(size=iq.size + 2 * guard) * sigma
    )
    out[guard : guard + iq.size] += iq * np.exp(1j * rng.uniform(0, 2 * np.pi))
    return out.astype(np.complex64)


def _make_receiver(chain: str, device: str):
    from ais_tpu_torch.core.params import DemodConfig
    from ais_tpu_torch.pipeline.api import BasebandReceiver

    cfg = {
        "feedforward": DemodConfig(timing_mode="feedforward"),
        "pll": DemodConfig(timing_mode="pll"),
        "mlse": DemodConfig(demod_mode="mlse", corr_threshold=0.4),
    }[chain]
    return BasebandReceiver(demod=cfg, device=device)


def run_point(
    chain: str, snr_db: float, args, rxs: dict
) -> tuple[int, int]:
    """One (chain, SNR) operating point -> (decoded, trials)."""
    from ais_tpu_torch.decode.nmea import frame_to_nmea
    from ais_tpu_torch.tx import make_packet_iq

    rng = np.random.default_rng(args.seed)
    rx = rxs[chain]
    ok = 0
    for _ in range(args.trials):
        raw = _random_payload(rng)
        iq = make_packet_iq(raw, samples_per_symbol=SPS)
        burst = _impair(iq, snr_db, args.cfo_hz, args.ppm, rng)
        want = frame_to_nmea(raw).splitlines()
        got = rx.sentences(burst)
        ok += all(w in got for w in want)
    return ok, args.trials


def _scope_png(args, out_path: str) -> None:
    """Scope panels for one clean-ish burst: the reference bench's
    wxgui scope sinks (python/ais_demod_grc.py:38-51), offline."""
    try:
        import matplotlib
    except ImportError as exc:
        raise SystemExit(f"--plot needs matplotlib, which is not installed: {exc}")

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import torch

    from ais_tpu_torch.ops.agc import feedforward_agc
    from ais_tpu_torch.ops.demod import quadrature_demod
    from ais_tpu_torch.ops.interp import interp_taps
    from ais_tpu_torch.sync.feedforward import feedforward_symbols, ff_delta
    from ais_tpu_torch.tx import make_packet_iq

    rng = np.random.default_rng(args.seed + 1)
    raw = _random_payload(rng)
    iq = make_packet_iq(raw, samples_per_symbol=SPS)
    burst = _impair(iq, args.snr_db[0], args.cfo_hz, args.ppm, rng)
    dev = torch.device(args.device)
    b = feedforward_agc(torch.from_numpy(burst).to(dev)[None], 512, 2.0)
    soft = quadrature_demod(b)[0].cpu().numpy()
    sym, valid = feedforward_symbols(b, float(SPS), 300, ff_delta(float(SPS), 0.4),
                                     torch.from_numpy(interp_taps()).to(dev))
    sym = sym[0].cpu().numpy()[valid[0].cpu().numpy()]

    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    axes[0].plot(soft[1500:3500], lw=0.6)
    axes[0].set_title("discriminator output (scope)")
    n_eye = (soft.size - 2000) // (2 * SPS)
    eye = soft[2000 : 2000 + n_eye * 2 * SPS].reshape(n_eye, 2 * SPS)
    axes[1].plot(eye[: min(n_eye, 120)].T, color="tab:blue", alpha=0.15, lw=0.8)
    axes[1].set_title("eye diagram (2 symbols)")
    axes[2].plot(sym.real, sym.imag, ".", ms=2)
    axes[2].set_title("recovered symbols")
    axes[2].set_aspect("equal")
    for ax in axes:
        ax.grid(alpha=0.3)
    fig.suptitle(
        f"loopback modem: SNR {args.snr_db[0]:g} dB, "
        f"CFO {args.cfo_hz:g} Hz, clock {args.ppm:g} ppm"
    )
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    chains = (
        ["feedforward", "pll", "mlse"] if args.demod == "all" else [args.demod]
    )
    rxs = {c: _make_receiver(c, args.device) for c in chains}
    rows = []
    for snr in args.snr_db:
        for chain in chains:
            ok, n = run_point(chain, snr, args, rxs)
            rows.append(
                {
                    "demod": chain,
                    "snr_db": snr,
                    "decoded": ok,
                    "trials": n,
                    "success": round(ok / n, 3),
                }
            )
    if args.json:
        print(
            json.dumps(
                {
                    "bench": "loopback_modem",
                    "cfo_hz": args.cfo_hz,
                    "ppm": args.ppm,
                    "points": rows,
                }
            )
        )
    else:
        print(f"# loopback modem bench  (CFO {args.cfo_hz:g} Hz, {args.ppm:g} ppm)")
        print(f"{'demod':<12} {'SNR dB':>7} {'decoded':>9} {'success':>8}")
        for r in rows:
            print(
                f"{r['demod']:<12} {r['snr_db']:>7g} "
                f"{r['decoded']:>5d}/{r['trials']:<3d} {r['success']:>8.2f}"
            )
    if args.plot:
        _scope_png(args, args.plot)
        print(f"scope panels -> {args.plot}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
