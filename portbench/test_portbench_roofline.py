"""The kernels' least work, against values worked by hand at the
cells' shapes (384 blocks: n_in 226 026 200, 4 520 464 outputs a
channel, 2891 taps, 2 channels; K2 on 768 rows of 16 384 samples, a
140-sample preamble; the integer wires' stage at the same shapes)."""

import pytest

import roofline

N_IN, N_OUT, NTAPS = 226_026_200, 4_520_464, 2891


def test_k1_counts_at_the_cell_shape():
    w = roofline.channelizer_work("cr1", N_IN, 2, N_OUT, NTAPS)
    # mix: 2 ops a sample a channel; FIR: 4 ops a tap an output a channel
    assert w.flops == 2 * (2 * 226_026_200 + 4 * 2891 * 4_520_464) == 105_453_396_192
    # wire 28 253 275 B + taps 11 564 B + 2 x 4 520 464 complex64 outputs
    assert w.bytes == 28_253_275 + 11_564 + 72_327_424
    assert w.bound() == "operations"
    assert w.least_s() == pytest.approx(105_453_396_192 / 989e12)


def test_k3_counts_at_the_cell_shape():
    w = roofline.channelizer_work("ci1", N_IN, 2, N_OUT, NTAPS)
    assert w.flops == 2 * (6 * 226_026_200 + 4 * 2891 * 4_520_464)
    assert w.bytes == 56_506_550 + 11_564 + 72_327_424
    assert w.bound() == "operations"


@pytest.mark.parametrize("fmt,per_sample", [("ci16", 4), ("ci8", 2), ("cu8", 2)])
def test_integer_wire_counts_at_the_cell_shape(fmt, per_sample):
    """The decode and K5 together: a complex mix, read from the wire bytes."""
    w = roofline.channelizer_work(fmt, N_IN, 2, N_OUT, NTAPS)
    assert w.flops == 2 * (6 * 226_026_200 + 4 * 2891 * 4_520_464)
    assert w.bytes == per_sample * 226_026_200 + 11_564 + 72_327_424
    # 2 or 4 wire bytes a sample outweigh the operations at 3.35 TB/s
    assert w.bound() == "bytes"
    assert w.least_s() == pytest.approx(w.bytes / 3.35e12)


def test_k2_counts_at_the_cell_shape():
    w = roofline.matched_filter_work(768, 16384, 140)
    n_out = 16384 - 140 + 1
    assert w.flops == 768 * n_out * (8 * 140 + 3) == 14_010_727_680
    assert w.bytes == 8 * 768 * 16384 + 8 * 140 + 12 * 768 * n_out == 250_378_336
    assert w.bound() == "bytes"
    assert w.least_s() == pytest.approx(250_378_336 / 3.35e12)


def test_share_is_silent_without_launches():
    w = roofline.matched_filter_work(768, 16384, 140)
    assert roofline.share_pct(w, 0, 0.0) is None
    assert roofline.share_pct(w, 10, 10 * w.least_s() * 4) == pytest.approx(25.0)
