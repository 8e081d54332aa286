"""The complex integer wires (ci16, ci8, cu8): the encoders and the
reference's decoder on chosen values, the decoder against the port's on
random bytes, and the 1-bit wires' captures held byte for byte.  The
tests' own ci8 and ci16 cells run in `test_portbench_run.py` (ci8 also in
`_faults.py` and `_control.py`)."""

import hashlib
import json

import numpy as np
import pytest
import torch

import reference
import scene
import sdenc
from conftest import BENCH, ci1_config, tiny_traffic
from harness import geometry

# Values in units of one step of the format (x * full scale): ties,
# roundings either way, saturation at both ends.
STEPS = np.array([0.0, 0.5, 1.5, -1.5, -0.5, 2.4, -2.6, 3.5])
CODES = np.array([0, 0, 2, -2, 0, 2, -3, 4])


@pytest.mark.parametrize("fmt,full", [("ci8", 128.0), ("ci16", 32768.0)])
def test_signed_wires_round_to_nearest_and_saturate(fmt, full):
    top = full - 1
    steps = np.concatenate([STEPS, [top + 0.4, top + 0.6, 2 * full, -full - 0.4, -full - 1,
                                    -3 * full]])
    codes = np.concatenate([CODES, [top, top, top, -full, -full, -full]])
    re = (steps / full).astype(np.float32)
    im = re[::-1].copy()
    wire = sdenc.encode(fmt, re, im, 1.0)
    stored = wire.view("<i2" if fmt == "ci16" else np.int8)
    assert np.array_equal(stored[0::2], codes) and np.array_equal(stored[1::2], codes[::-1])
    got = reference.wire_samples(fmt, wire, np.arange(re.size))
    assert np.array_equal(got, (codes + 1j * codes[::-1]) / full)


def test_ci16_is_little_endian():
    wire = sdenc.encode("ci16", np.float32([258 / 32768]), np.float32([-2 / 32768]), 1.0)
    assert wire.tolist() == [2, 1, 0xFE, 0xFF]


def test_cu8_is_offset_binary():
    # 127.5 + t, away from ties except at t = 0 (127.5 -> 128, ties to even)
    t = np.array([0.0, 0.3, -0.3, 1.2, -1.2, 126.9, 127.9, 130.0, -127.3, -127.8, -300.0])
    codes = np.array([128, 128, 127, 129, 126, 254, 255, 255, 0, 0, 0])
    x = (t / 127.5).astype(np.float32)
    wire = sdenc.encode("cu8", x, -x, 1.0)
    assert np.array_equal(wire[0::2], codes)
    assert np.array_equal(wire[1::2], [128, 127, 128, 126, 129, 1, 0, 0, 255, 255, 255])
    got = reference.wire_samples("cu8", wire, np.arange(t.size))
    assert np.array_equal(got.real, (codes - 127.5) / 127.5)


def test_scale_is_a_share_of_full_scale():
    x = np.float32([0.25, -0.5])
    assert sdenc.encode("ci8", x, x, 0.5).view(np.int8).tolist() == [16, 16, -32, -32]


PORT = {"ci16": "iq_from_bytes_ci16", "ci8": "iq_from_bytes_ci8", "cu8": "iq_from_bytes_cu8"}


@pytest.mark.parametrize("fmt", sorted(PORT))
def test_reference_decode_is_the_ports(fmt):
    """Two readings of one format, written apart: the reference's (NumPy,
    float64, at any indices) and the port's (`ops/convert.py`)."""
    from ais_tpu_torch.ops import convert

    n = 5000
    per = 4 if fmt == "ci16" else 2
    wire = np.random.default_rng(11).integers(0, 256, per * n, dtype=np.uint8)
    port = getattr(convert, PORT[fmt])(torch.from_numpy(wire)).numpy().astype(np.complex128)
    pos = np.random.default_rng(12).permutation(n)
    got = reference.wire_samples(fmt, wire, pos)
    # cu8's 1/127.5 is rounded to float32 in the port; the others are exact
    tol = 0 if fmt != "cu8" else 2.0 ** -23
    assert np.max(np.abs(got - port[pos])) <= tol


# sha256 of the wire bytes and the packets (channel, start, payload) of
# the tiny cells' captures, computed on the tree before the integer
# wires were added.
DIGESTS = {
    ("cr1", 2147483701): "8fa8b077e080c2cb544b6e739d03b7dda615751e266de9aa515ba323dcad651f",
    ("cr1", 2147495993): "cb39b53e74c8f526415af2aeddcc25a5e5cecbcf866593d93d7623817d30009a",
    ("ci1", 2147483701): "57e208abd324c64a28015d370deb0a9d3b36ef29f261a04ca19f6133bda5b307",
    ("ci1", 2147495993): "87345ac97fd8b55e81342e7f772bae9f3bcbf0e7b1060160f03c0a72cae936bc",
}


def _capture(cfg, traffic, seed):
    """The capture on the CPU in one thread: with the thread pool, the
    CPU's float64 cos of a burst's phase can differ in its last bit on a
    process's first capture, which flips float32 samples and wire bits
    (the benchmark's runs make their captures on the card)."""
    geo = geometry(cfg, int(traffic["blocks"]))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return scene.make_capture(cfg, traffic, geo.n_in, geo.step_raw, seed, "cpu"), geo
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("tag,seed", sorted(DIGESTS))
def test_one_bit_captures_are_unchanged(tag, seed):
    cfg = (json.loads((BENCH / "configs" / "wb2m4_cr1.json").read_text()) if tag == "cr1"
           else ci1_config())
    cap, _ = _capture(cfg, tiny_traffic(), seed)
    h = hashlib.sha256(cap.wire.tobytes())
    for p in cap.packets:
        h.update(f"{p.channel},{p.start},".encode() + p.payload)
    assert h.hexdigest() == DIGESTS[(tag, seed)]

