"""The port's wire formats (`ais_tpu_torch/ops/convert.py`) against the
JAX reference (`ais_tpu/ops/convert.py`).

Every decoder must give exactly the reference's complex64 samples on
seeded random bytes (both are integer arithmetic and float32 scaling by
powers of two or the same float32 constants); `ci1_from_bytes_cd1` and
every encoder in `host_bytes` must give identical bytes.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ais_tpu.ops import convert as rconvert
from ais_tpu_torch.ops import convert as tconvert
from ais_tpu_torch.pipeline import wideband as tw

torch.set_num_threads(1)


def _bytes(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _iq(n: int, seed: int, amp: float = 0.3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=n) + 1j * rng.normal(size=n)) * amp).astype(np.complex64)


@pytest.mark.parametrize("fmt,n_bytes", [
    ("ci16", 4000), ("ci8", 2000), ("cu8", 2000), ("ci4", 1000), ("ci2", 500), ("ci1", 250),
])
def test_decoder_exact(fmt, n_bytes):
    raw = _bytes(n_bytes, len(fmt) + n_bytes)
    want = np.asarray(getattr(rconvert, f"iq_from_bytes_{fmt}")(jnp.asarray(raw)))
    got = getattr(tconvert, f"iq_from_bytes_{fmt}")(torch.from_numpy(raw)).numpy()
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_ci2_levels_are_the_lloyd_max_levels():
    raw = np.array([0b00011011, 0b11100100], np.uint8)  # codes 0,1,2,3 then 3,2,1,0
    got = tconvert.iq_from_bytes_ci2(torch.from_numpy(raw)).numpy()
    a, b = np.float32(tconvert.CI2_INNER), np.float32(tconvert.CI2_OUTER)
    np.testing.assert_array_equal(got, np.array([-b - 1j * a, a + 1j * b, b + 1j * a, -a - 1j * b],
                                                np.complex64))
    assert (tconvert.CI2_THRESH, tconvert.CI2_INNER, tconvert.CI2_OUTER) == (
        rconvert.CI2_THRESH, rconvert.CI2_INNER, rconvert.CI2_OUTER)


@pytest.mark.parametrize("n", [4000, 4004, 804])
def test_cd1_pre_decode_byte_exact(n):
    """cd1 -> ci1 bytes equal the reference's, including the pad byte of
    n % 8 == 4, and undo the host-side ci1 -> cd1 transform."""
    ci1 = _bytes(n // 4, n)
    cd1 = tconvert.cd1_bytes_from_ci1(ci1, n)
    np.testing.assert_array_equal(cd1, rconvert.cd1_bytes_from_ci1(ci1, n))
    assert cd1.size == tconvert.cd1_wire_nbytes(n) == rconvert.cd1_wire_nbytes(n)
    got = tconvert.ci1_from_bytes_cd1(torch.from_numpy(cd1), n).numpy()
    np.testing.assert_array_equal(got, np.asarray(rconvert.ci1_from_bytes_cd1(jnp.asarray(cd1), n)))
    np.testing.assert_array_equal(got, ci1)
    # Random cd1 bytes too (every byte pattern, not only encoder output).
    rand = _bytes(cd1.size, n + 1)
    np.testing.assert_array_equal(
        tconvert.ci1_from_bytes_cd1(torch.from_numpy(rand), n).numpy(),
        np.asarray(rconvert.ci1_from_bytes_cd1(jnp.asarray(rand), n)))
    np.testing.assert_array_equal(
        tconvert.iq_from_bytes_cd1(torch.from_numpy(rand), n).numpy(),
        np.asarray(rconvert.iq_from_bytes_cd1(jnp.asarray(rand), n)))


@pytest.mark.parametrize("fmt", ["ci16", "cs16", "ci8", "cs8", "ci4", "ci2", "ci1", "cd1",
                                 "cr1", "cu8"])
def test_host_bytes_identical(fmt):
    """Byte-identical encodes, on a Gaussian buffer with clipped peaks
    and on a sparse burst (the peak-referenced sigma-delta scale)."""
    iq = _iq(4000, 3, amp=0.45)
    sparse = np.zeros(4000, np.complex64)
    sparse[1000:1400] = _iq(400, 4, amp=0.2)
    for x in (iq, sparse):
        np.testing.assert_array_equal(tconvert.host_bytes(x, fmt), rconvert.host_bytes(x, fmt))


def test_host_bytes_options_identical():
    iq = _iq(4000, 5)
    for kw in ({"ci2_dither": 0.0}, {"ci2_dither": 0.3}):
        np.testing.assert_array_equal(tconvert.host_bytes(iq, "ci2", **kw),
                                      rconvert.host_bytes(iq, "ci2", **kw))
    for fmt in ("ci1", "cd1", "cr1"):
        np.testing.assert_array_equal(tconvert.host_bytes(iq, fmt, headroom=0.5),
                                      rconvert.host_bytes(iq, fmt, headroom=0.5))
    with pytest.raises(ValueError, match="even"):
        tconvert.host_bytes(iq[:3], "ci2")
    with pytest.raises(ValueError, match="size % 4"):
        tconvert.host_bytes(iq[:6], "ci1")


def test_ci1_numpy_twin_matches_native():
    from ais_tpu import native

    if not native.available():
        pytest.skip("the native host library did not build")
    iq = _iq(2000, 6)
    np.testing.assert_array_equal(tconvert._sigma_delta_ci1_numpy(iq, 1.7),
                                  native.sigma_delta_ci1(iq, 1.7))


def test_wire_byte_counts_match_reference_table():
    """The receiver's byte count per format is the reference stage_wire's."""
    for n in (1_000_000, 1_000_004, 822_200):
        assert tw.wire_nbytes("ci16", n) == 4 * n
        assert tw.wire_nbytes("ci8", n) == 2 * n
        assert tw.wire_nbytes("cu8", n) == 2 * n
        assert tw.wire_nbytes("ci4", n) == n
        assert tw.wire_nbytes("ci2", n) == n // 2
        assert tw.wire_nbytes("ci1", n) == n // 4
        assert tw.wire_nbytes("cd1", n) == rconvert.cd1_wire_nbytes(n)
        assert tw.wire_nbytes("cr1", n) == rconvert.cr1_wire_nbytes(n)
    with pytest.raises(ValueError, match="unsupported wire format"):
        tw.wire_nbytes("cx3", 1000)


def test_wire_api_default_format_matches_reference():
    """`rx.decode_wire(buf)` means the same format in both packages."""
    from ais_tpu.pipeline.wideband import WidebandReceiver as RefReceiver

    for name in ("stage_wire", "submit_wire", "decode_wire", "wire_records", "wire_channels"):
        got = inspect.signature(getattr(tw.WidebandReceiver, name)).parameters["fmt"].default
        assert got == "ci8", name
    for name in ("stage_wire", "submit_wire", "decode_wire"):
        want = inspect.signature(getattr(RefReceiver, name)).parameters["fmt"].default
        got = inspect.signature(getattr(tw.WidebandReceiver, name)).parameters["fmt"].default
        assert got == want, name
