"""`ais_rx` on the PyTorch/CUDA port: decode AIS from a source.

    python -m ais_tpu_torch.cli.ais_rx -s capture.cf32 -r 250000
    python -m ais_tpu_torch.cli.ais_rx -s capture.cf32 -r 250000 --device cpu

Port of `ais_tpu/cli/ais_rx.py` with the same options and output lines
(one !AIVDM sentence a packet on stdout; `--meta` prefixes position,
channel, correlation, carrier and power; `--decode` appends the parsed
fields), plus `--device` (default cuda; `cpu` runs every kernel's plain
version).  Sources and the rtl_tcp client are the port's own copies of the
reference's (`ais_tpu_torch.io`).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ais_rx", description="AIS receiver on PyTorch/CUDA")
    p.add_argument("-s", "--source", default="uhd",
                   help="source: uhd, osmocom, rtl_tcp[:host:port], <filename>, or "
                   "<ip:port> [default=%(default)s]")
    p.add_argument("-r", "--rate", type=float, default=250e3,
                   help="sample rate [default=%(default)s]")
    p.add_argument("-S", "--singlechannel", action="store_true",
                   help="decode a single 0-offset channel instead of A & B")
    p.add_argument("-e", "--error", type=float, default=0.0,
                   help="device ppm error (hardware sources)")
    p.add_argument("-g", "--gain", type=float, default=None,
                   help="RF gain in dB (hardware sources; default: hardware AGC)")
    p.add_argument("-R", "--subdev", default=None, help="USRP subdevice (hardware sources)")
    p.add_argument("-A", "--antenna", default=None, help="antenna (hardware sources)")
    p.add_argument("-D", "--args", default="", help="device args (hardware sources)")
    p.add_argument("-F", "--format", default="complex64",
                   choices=["complex64", "cf32", "ci16", "cs16", "ci8", "cs8", "cu8", "ci4",
                            "ci2", "ci1", "cr1"],
                   help="IQ sample format of the source [default=%(default)s]")
    p.add_argument("--repeat", action="store_true", help="loop a file source")
    p.add_argument("--demod", default="discriminator", choices=["discriminator", "mlse"],
                   help="bit decision: the discriminator chain, or the coherent "
                   "Viterbi decoder [default=%(default)s]")
    p.add_argument("--threshold", type=float, default=None,
                   help="correlator threshold as a fraction of the autocorrelation "
                   "peak [default: 0.9, or 0.4 with --demod mlse]")
    p.add_argument("--meta", action="store_true",
                   help="prefix each sentence with sample position, channel, corr power")
    p.add_argument("--decode", action="store_true",
                   help="append parsed message fields (type, MMSI, position, ...) "
                   "after each sentence")
    p.add_argument("--device", default="cuda",
                   help="torch device the receiver runs on [default=%(default)s]")
    return p


def main(argv: list[str] | None = None) -> int:
    options = build_parser().parse_args(argv)
    from ais_tpu_torch.core.params import DemodConfig
    from ais_tpu_torch.io.rtl_tcp import RtlTcpSource
    from ais_tpu_torch.io.sources import FileSource, open_source
    from ais_tpu_torch.pipeline.radio import AisRadio

    src = open_source(options.source, options.rate, options.format,
                      device_args=options.args, gain_db=options.gain, ppm=int(options.error))
    if isinstance(src, FileSource):
        src.repeat = options.repeat
    if options.format in ("ci2", "ci1", "cr1") and options.rate < 100e3:
        print(f"warning: {options.format} needs the channelizer's processing gain; at "
              "channel-rate input the quantization noise lands in-band and decode will "
              "likely fail — use ci4/ci8 below 100 ksps", file=sys.stderr)
    print(f"Rate is {int(options.rate)}", file=sys.stderr)
    threshold = options.threshold
    if threshold is None:
        threshold = 0.4 if options.demod == "mlse" else 0.9
    demod = DemodConfig(demod_mode=options.demod, corr_threshold=threshold)
    # A hardware source corrects the ppm error on the device; a soft
    # source's correction goes into the channel offsets.  Never both.
    soft_ppm = 0.0 if isinstance(src, RtlTcpSource) else options.error
    radio = AisRadio(sample_rate=options.rate, single_channel=options.singlechannel,
                     demod=demod, ppm=soft_ppm, device=options.device)
    try:
        for packet in radio.run(src):
            line = packet.nmea
            if options.meta:
                rssi_db = 10.0 * np.log10(packet.rssi) if packet.rssi > 0 else float("-inf")
                line = (f"[{packet.designator} @{packet.abs_sample} "
                        f"corr={packet.corr_mag:.0f} f={packet.freq_est_hz:+.0f}Hz "
                        f"rssi={rssi_db:.1f}dBfs] {line}")
            if options.decode:
                from ais_tpu_torch.decode.fields import format_fields

                line = f"{line}  {{{format_fields(packet.fields)}}}"
            print(line, flush=True)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
