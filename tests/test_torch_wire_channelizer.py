"""Port K1 (cr1 wire channelizer) and the cr1 wire format against the
JAX reference (`ais_tpu/ops/pallas_fir.py`, `ais_tpu/ops/convert.py`).

The reference's fused Pallas kernel runs in interpret mode on the CPU,
as its own tests run it; the port's wrapper takes its plain version
for a CPU tensor.  Tolerance for the channelizer: atol 2e-5 of the
output's full scale and rtol 2e-4 (`tests/test_pallas_fir.py`), since
the two sum 2891 fp32 products in different orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ais_tpu.ops.firdes import low_pass
from ais_tpu_torch.ops import convert as tconvert
from ais_tpu_torch.ops.fir import fir_polyphase, mixer_phase
from ais_tpu_torch.ops.wire_channelizer import (
    WireChannelizer,
    carrier_table_period,
    rotate_carrier,
    wire_channelizer_cr1,
    wire_channelizer_cr1_plain,
    wire_channelizer_supported,
)

torch.set_num_threads(1)

RATE, DECIM, OFFSETS = 2.4e6, 50, (-25e3, 25e3)
TAPS = low_pass(1.0, RATE, 11e3, 2e3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _wire(n_in: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    iq = ((rng.normal(size=n_in) + 1j * rng.normal(size=n_in)) * 0.3).astype(np.complex64)
    return tconvert.host_bytes(iq, "cr1")


def test_cr1_decode_matches_reference():
    from ais_tpu.ops.convert import iq_from_bytes_cr1

    raw = np.random.default_rng(1).integers(0, 256, 125, dtype=np.uint8)
    for n in (1000, 997):
        want = np.asarray(iq_from_bytes_cr1(jnp.asarray(raw), n))
        got = tconvert.iq_from_bytes_cr1(torch.from_numpy(raw), n).numpy()
        np.testing.assert_array_equal(got, want)


def test_cr1_encoder_matches_reference():
    """The host encoder is bit-identical to the reference's, and its
    numpy twin to the native loop."""
    from ais_tpu import native
    from ais_tpu.ops.convert import host_bytes

    rng = np.random.default_rng(2)
    iq = ((rng.normal(size=4000) + 1j * rng.normal(size=4000)) * 0.2).astype(np.complex64)
    np.testing.assert_array_equal(tconvert.host_bytes(iq, "cr1"), host_bytes(iq, "cr1"))
    assert tconvert.CR1_A2 == pytest.approx(2.0 - 4.0 * np.cos(2 * np.pi * (0.25 - 25e3 / 2.4e6)) ** 2)
    assert tconvert.cr1_wire_nbytes(4001) == 501
    if native.available():
        np.testing.assert_array_equal(
            tconvert._sigma_delta_cr1_numpy(iq[:2000], 1.5, tconvert.CR1_A2),
            native.sigma_delta_cr1(iq[:2000], 1.5, tconvert.CR1_A2),
        )
    with pytest.raises(ValueError, match="unsupported format"):
        tconvert.host_bytes(iq, "cx3")


def test_mixer_phase_matches_reference():
    from ais_tpu.ops.fir import mixer_phase as ref_phase

    for off in OFFSETS:
        for at in (0, 777, 1_764_000, 123_456_789):
            assert mixer_phase(off, RATE, at) == ref_phase(off, RATE, at)


def test_fir_polyphase_matches_direct_convolution():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 1003)).astype(np.float32)
    taps = rng.normal(size=97).astype(np.float32)
    got = fir_polyphase(torch.from_numpy(x), torch.from_numpy(taps), 7).numpy()
    n_out = (1003 - 97) // 7 + 1
    want = np.array([[np.dot(taps, row[m * 7: m * 7 + 97]) for m in range(n_out)] for row in x])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_in", [80_000, 400_000])
def test_plain_matches_pallas_kernel(n_in):
    """K1's plain version against the reference kernel (interpret mode);
    400 000 samples spans more than one of the reference's tiles."""
    from ais_tpu.ops.pallas_fir import pallas_wire_channelizer, wire_channelizer_buffers

    raw = _wire(n_in, 17)
    phase0s = np.stack([mixer_phase(o, RATE, 777) for o in OFFSETS])
    car, h = wire_channelizer_buffers("cr1", TAPS, DECIM, OFFSETS, RATE)
    want = np.asarray(pallas_wire_channelizer(
        jnp.asarray(raw), jnp.asarray(phase0s), jnp.asarray(car), jnp.asarray(h),
        fmt="cr1", ntaps=TAPS.size, decim=DECIM, offsets=OFFSETS, rate=RATE,
        n_in=n_in, interpret=True,
    ))
    chan = WireChannelizer(TAPS, DECIM, OFFSETS, RATE, n_in)
    got = chan(torch.from_numpy(raw), torch.from_numpy(phase0s)).numpy()
    assert got.shape == want.shape == (2, chan.n_out)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=2e-4)


def test_supported_geometry():
    assert carrier_table_period(OFFSETS, RATE) == 96
    assert wire_channelizer_supported("cr1", TAPS.size, DECIM, OFFSETS, RATE, 1_998_200)
    assert wire_channelizer_supported("ci1", TAPS.size, DECIM, OFFSETS, RATE)
    assert not wire_channelizer_supported("cx3", TAPS.size, DECIM, OFFSETS, RATE)
    assert not wire_channelizer_supported("cr1", TAPS.size, DECIM, OFFSETS, RATE, 80_004)
    assert not wire_channelizer_supported("cr1", TAPS.size, DECIM, (np.pi * 1e4,), RATE)
    with pytest.raises(ValueError, match="unsupported"):
        WireChannelizer(TAPS, DECIM, OFFSETS, RATE, 80_004)


def test_dispatch_takes_plain_version_only_on_cpu():
    raw = torch.zeros(10_000, dtype=torch.uint8, device="meta")
    car = torch.zeros(2, 96, 2, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        wire_channelizer_cr1(raw, car, torch.zeros(TAPS.size, device="meta"),
                             decim=DECIM, n_in=80_000)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda):
    n_in = 400_000
    raw = torch.from_numpy(_wire(n_in, 5)).to(cuda)
    chan = WireChannelizer(TAPS, DECIM, OFFSETS, RATE, n_in, device=cuda)
    ph = torch.from_numpy(np.stack([mixer_phase(o, RATE, 999) for o in OFFSETS])).to(cuda)
    car = rotate_carrier(chan.carrier, ph)
    got = wire_channelizer_cr1(raw, car, chan.taps, decim=DECIM, n_in=n_in)
    want = wire_channelizer_cr1_plain(raw, car, chan.taps, DECIM, n_in)
    err = (got - want).abs()
    assert bool((err <= 2e-5 * want.abs().max() + 2e-4 * want.abs()).all())


# -- K1's tensor-core form: the host side of the kernel ----------------------

SMALL_TAPS = low_pass(1.0, RATE, 11e3, 9e3)     # a few hundred taps


def _offsets(n_chan: int) -> tuple:
    return (-25e3, 25e3, 0.0, 50e3)[:n_chan]


@pytest.mark.parametrize("n_chan", [1, 2, 3, 4])
def test_folded_form_matches_plain(n_chan):
    """Folded taps g_c = h e^{-jwk} (split, packed, unpacked again) and one
    rotation an output reproduce the plain version, at the file's
    tolerance, for random start phases."""
    from ais_tpu_torch.ops.wire_channelizer import wire_channelizer_cr1_folded

    n_in, offsets = 40_000, _offsets(n_chan)
    chan = WireChannelizer(SMALL_TAPS, DECIM, offsets, RATE, n_in)
    assert chan.frags.dtype == torch.int32
    assert tuple(chan.frags.shape) == (-(-SMALL_TAPS.size // 128), 8, -(-n_chan // 2), 32, 2)
    rng = np.random.default_rng(40 + n_chan)
    raw = torch.from_numpy(rng.integers(0, 256, n_in // 8, dtype=np.uint8))
    ph = torch.from_numpy(rng.uniform(0, 2 * np.pi, n_chan).astype(np.float32))
    car = rotate_carrier(chan.carrier, ph)
    want = wire_channelizer_cr1_plain(raw, car, chan.taps, DECIM, n_in).numpy()
    got = wire_channelizer_cr1_folded(raw, car, chan.folded, DECIM, n_in).numpy()
    assert got.shape == want.shape == (n_chan, chan.n_out)
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=2e-4)


def test_folded_taps_from_table_match_offsets():
    """Without a module the wrapper folds from the rotated table: the same
    taps, to the table's float32 rounding."""
    from ais_tpu_torch.ops.wire_channelizer import carrier_table, fold_taps, fold_taps_from_table

    want = fold_taps(TAPS, OFFSETS, RATE)
    car = rotate_carrier(torch.from_numpy(carrier_table(OFFSETS, RATE)),
                         torch.tensor([0.7, 4.1])).numpy()
    got = fold_taps_from_table(TAPS, car)
    assert got.shape == want.shape == (2, TAPS.size)
    assert np.abs(got - want).max() <= 4e-7 * np.abs(TAPS).max()


@pytest.mark.parametrize("taps", [TAPS, SMALL_TAPS * 1e-3, SMALL_TAPS * 77.0],
                         ids=["bench", "small", "large"])
def test_split_taps_reconstruct_to_stated_bound(taps):
    from ais_tpu_torch.ops.wire_channelizer import (
        SPLIT_ABS_ERR, SPLIT_REL_ERR, fold_taps, pack_fragments, split_taps, unpack_fragments,
    )

    g = fold_taps(taps, OFFSETS, RATE)
    planes = np.stack([g.real, g.imag])
    hi, lo, e = split_taps(planes)
    assert hi.dtype == lo.dtype == np.float16
    v = np.ldexp(planes, e)
    assert 2.0 ** 14 <= np.abs(v).max() < 2.0 ** 15
    err = np.abs(v - (hi.astype(np.float64) + lo.astype(np.float64)))
    assert bool((err <= SPLIT_REL_ERR * np.abs(v) + SPLIT_ABS_ERR).all())
    # ... and through the packed buffer, in the taps' own scale.
    frags, unscale = pack_fragments(g)
    assert unscale == 2.0 ** -e
    back = unpack_fragments(frags, unscale, taps.size, 2)
    bound = (SPLIT_REL_ERR * np.abs(planes) + SPLIT_ABS_ERR * unscale).max(axis=0)
    assert bool((np.abs(back.real - g.real) <= bound).all())
    assert bool((np.abs(back.imag - g.imag) <= bound).all())


def _fp16_pair(reg: int) -> tuple:
    """(half 0, half 1) of a 32-bit register holding two fp16."""
    return tuple(np.array([reg & 0xFFFF, reg >> 16], np.uint16).view(np.float16).astype(float))


@pytest.mark.parametrize("decim", [50, 37])
def test_fragment_bit_indexing_equals_unpack(decim):
    """The Python twin of the kernel's A operand: staged words, funnel-
    shift windows and the shift-and-mask registers give, in every k-slot,
    the +-1 sample `unpack_bits_pm1` puts at m*D + tap."""
    from ais_tpu_torch.ops.wire_channelizer import (
        SUPER_TAPS, TILE_OUTPUTS, a_registers, fragment_tap, n_super_steps, tile_wire_words, window,
    )

    ntaps = 300
    n_tiles = 3
    n_in = 8 * (-(-((n_tiles * TILE_OUTPUTS - 1) * decim + ntaps) // 8))
    rng = np.random.default_rng(decim)
    raw = rng.integers(0, 256, n_in // 8, dtype=np.uint8)
    s = np.concatenate([tconvert.unpack_bits_pm1(torch.from_numpy(raw), n_in).numpy(),
                        -np.ones(4096, np.float32)])      # past the end: zero bits
    for tile in range(n_tiles):
        words = tile_wire_words(raw, tile, ntaps, decim)
        for row in rng.integers(0, TILE_OUTPUTS, 6):
            m = tile * TILE_OUTPUTS + int(row)
            for S in range(n_super_steps(ntaps)):
                for t in range(4):
                    win = window(words, int(row) * decim + S * SUPER_TAPS + 32 * t)
                    for j in range(8):
                        for kg, reg in enumerate(a_registers(win, j)):
                            for half, val in enumerate(_fp16_pair(reg)):
                                tap = S * SUPER_TAPS + fragment_tap(j, t, kg, half)
                                assert val == s[m * decim + tap], (tile, row, S, t, j, kg, half)


def test_fragment_layout_through_an_emulated_mma():
    """One warp's m16n8k16 chain in numpy, with the fragment layouts of the
    PTX ISA (A: row g / g+8, k-slots 2t + 8kg + half; B: k-slot rows,
    column g; C: rows g / g+8, columns 2t, 2t+1): A registers from the
    twin, B registers from the packed buffer; hi + lo columns, unscaled,
    equal the direct sum over the folded taps."""
    from ais_tpu_torch.ops.wire_channelizer import (
        SUPER_TAPS, a_registers, fold_taps, n_super_steps, pack_fragments, tile_wire_words, window,
    )

    decim, n_chan = 50, 3
    g = fold_taps(SMALL_TAPS, _offsets(n_chan), RATE)
    ntaps = SMALL_TAPS.size
    frags, unscale = pack_fragments(g)
    frags = frags.view(np.uint32)
    rng = np.random.default_rng(9)
    n_in = 16 * decim + ntaps + 200
    raw = rng.integers(0, 256, -(-n_in // 8), dtype=np.uint8)
    s = tconvert.unpack_bits_pm1(torch.from_numpy(raw), 8 * raw.size).numpy().astype(np.float64)
    words = tile_wire_words(raw, 0, ntaps, decim)
    n_nt = frags.shape[2]
    c = np.zeros((n_nt, 16, 8))
    for S in range(n_super_steps(ntaps)):
        for j in range(8):
            a = np.zeros((16, 16))
            b = np.zeros((n_nt, 16, 8))
            for lane in range(32):
                gq, t = lane >> 2, lane & 3
                for h in range(2):
                    win = window(words, (gq + 8 * h) * decim + S * SUPER_TAPS + 32 * t)
                    for kg, reg in enumerate(a_registers(win, j)):
                        for half, val in enumerate(_fp16_pair(reg)):
                            a[gq + 8 * h, 2 * t + 8 * kg + half] = val
                for nt in range(n_nt):
                    for kg in range(2):
                        for half, val in enumerate(_fp16_pair(int(frags[S, j, nt, lane, kg]))):
                            b[nt, 2 * t + 8 * kg + half, gq] = val
            c += a @ b
    cols = c.transpose(1, 0, 2).reshape(16, 8 * n_nt)[:, : 4 * n_chan].reshape(16, n_chan, 2, 2)
    got = cols.sum(axis=-1) * unscale                       # (row, chan, re/im)
    for m in range(16):
        want = (g * s[m * decim: m * decim + ntaps]).sum(axis=1)
        np.testing.assert_allclose(got[m, :, 0] + 1j * got[m, :, 1], want,
                                   atol=1e-6 * np.abs(g).sum(axis=1).max())


def test_cr1_supported_needs_shared_memory():
    from ais_tpu_torch.ops.wire_channelizer import MAX_SMEM_BYTES, kernel_smem_bytes

    assert kernel_smem_bytes(TAPS.size, DECIM, 2) == 23 * 8 * 32 * 8 + 4 * 491
    assert kernel_smem_bytes(TAPS.size, DECIM, 4) <= MAX_SMEM_BYTES
    long_taps = 8 * 1024
    assert not wire_channelizer_supported("cr1", long_taps, DECIM, (0.0, 25e3, 50e3), RATE)
    assert wire_channelizer_supported("cr1", long_taps, DECIM, OFFSETS, RATE)


@pytest.mark.gpu
@pytest.mark.parametrize("n_chan", [1, 3, 4])
def test_kernel_matches_plain_on_card_other_channel_counts(cuda, n_chan):
    n_in = 400_000
    raw = torch.from_numpy(_wire(n_in, 6)).to(cuda)
    chan = WireChannelizer(TAPS, DECIM, _offsets(n_chan), RATE, n_in, device=cuda)
    ph = torch.rand(n_chan, device=cuda) * 6.28
    got = chan(raw, ph)
    want = wire_channelizer_cr1_plain(raw, rotate_carrier(chan.carrier, ph), chan.taps, DECIM, n_in)
    err = (got - want).abs()
    assert bool((err <= 2e-5 * want.abs().max() + 2e-4 * want.abs()).all())
