"""The card's peaks and each kernel's least work, from the shapes alone.

A kernel's share of its roofline is its least possible time over its
measured time: the larger of its operations over the dense fp16
tensor-core peak and its bytes (each input read once, each output
written once) over the memory bandwidth.  The operations are the
algorithm's, counted from the shapes, not what a kernel happens to do:

- channelizer, the wire -> channels stage (K1 on cr1, K3 on ci1; on
  ci16, ci8 and cu8 the decode to complex samples and K5), per channel:
  the mix, one complex carrier product an input sample (2 real
  operations on cr1's real stream, 6 on every complex one), and the
  decimated FIR, a complex sample times a real tap (2 multiply-adds, 4
  operations) per tap and output; in: the wire bytes (1/8, 1/4, 4, 2
  and 2 a sample on cr1, ci1, ci16, ci8, cu8) and the taps; out:
  complex64 outputs.  The least work is read from the wire, never from
  a complex64 intermediate, so a channelizer that decodes inside its
  kernel and one that decodes first are judged on the same work: a
  reader sums the time of every kernel of the stage (for ci16, ci8 and
  cu8, the decode's and K5's);
- K2, per row: the correlation, a complex multiply-add (8 operations)
  per preamble sample and output, and |corr|^2 (3 operations) per
  output; in: complex64 rows and the preamble; out: corr (complex64)
  and |corr|^2 (float32).
"""

from __future__ import annotations

from typing import NamedTuple

# NVIDIA H100 SXM5 80GB data sheet: dense fp16/bf16 tensor-core rate,
# HBM3 bandwidth; both at the card's full 700 W power limit.
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


class Work(NamedTuple):
    flops: float
    bytes: float

    def least_s(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES_PER_S)

    def bound(self) -> str:
        return "operations" if self.flops / PEAK_FLOPS >= self.bytes / PEAK_BYTES_PER_S else "bytes"


def channelizer_work(fmt: str, n_in: int, n_chan: int, n_out: int, ntaps: int) -> Work:
    """One wire -> channels stage over an n_in-sample wire in `fmt`."""
    mix = 2 if fmt == "cr1" else 6
    wire_bytes = {"cr1": -(-n_in // 8), "ci1": n_in // 4, "ci16": 4 * n_in, "ci8": 2 * n_in,
                  "cu8": 2 * n_in}[fmt]
    flops = n_chan * (mix * n_in + 4 * ntaps * n_out)
    return Work(float(flops), float(wire_bytes + 4 * ntaps + 8 * n_chan * n_out))


def matched_filter_work(rows: int, n: int, length: int) -> Work:
    """One K2 call over (rows, n) complex64 with a `length`-sample preamble."""
    n_out = n - length + 1
    flops = rows * n_out * (8 * length + 3)
    return Work(float(flops), float(8 * rows * n + 8 * length + 12 * rows * n_out))


def share_pct(work: Work, launches: int, seconds: float) -> float | None:
    """The kernel's share of its roofline over `launches` launches that
    took `seconds` on the card in all; None when it never ran."""
    if launches <= 0 or seconds <= 0:
        return None
    return 100.0 * work.least_s() * launches / seconds
