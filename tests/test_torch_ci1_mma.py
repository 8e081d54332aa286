"""K3's 1-bit tensor-core form (ci1 as K1's product on the wire's bit
sequence) against its plain version and the JAX reference, on the CPU.

The kernel itself runs only on a card; what is checked here is all it
rests on: the folded bit-stream taps, the fragment buffer, the staged
words, windows and A registers at a bit decimation of 2D, one tile
through an emulated mma, the predicate that routes a geometry to it, and
the form as a whole in plain PyTorch (`wire_channelizer_ci1_folded`).
The reference's ci1 Pallas kernel runs in interpret mode, as its own
tests run it.  Tolerance: atol 2e-5 of the output's full scale and rtol
2e-4 (`tests/test_pallas_fir.py`): the forms sum 2891 x 2 products in
different orders, and the folded taps carry 22 bits (hi + lo).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ais_tpu.ops.firdes import low_pass
from ais_tpu_torch.ops import convert as tconvert
from ais_tpu_torch.ops import wire_channelizer as twc
from ais_tpu_torch.ops.fir import mixer_phase

torch.set_num_threads(1)

RATE, DECIM = 2.4e6, 50
TAPS = low_pass(1.0, RATE, 11e3, 2e3)           # the bench's 2891 taps
SMALL_TAPS = low_pass(1.0, RATE, 11e3, 9e3)     # a few hundred taps
TILE = twc.CI1_TILE_OUTPUTS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _offsets(n_chan: int) -> tuple:
    return (-25e3, 25e3, 0.0, 50e3)[:n_chan]


def _ci1_wire(n_in: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    iq = ((rng.normal(size=n_in) + 1j * rng.normal(size=n_in)) * 0.3).astype(np.complex64)
    return tconvert.host_bytes(iq, "ci1")


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max(), rtol=2e-4)


def _fp16_pair(reg: int) -> tuple:
    """(half 0, half 1) of a 32-bit register holding two fp16."""
    return tuple(np.array([reg & 0xFFFF, reg >> 16], np.uint16).view(np.float16).astype(float))


# -- (a) the form as a whole ---------------------------------------------------

@pytest.mark.parametrize("n_chan", [1, 2, 3, 4])
def test_folded_form_matches_plain_and_reference_kernel(n_chan):
    """`wire_channelizer_ci1_folded` from the module's fragments against
    the plain version and the reference's ci1 kernel (interpret mode) on
    the same wire bytes and start phases."""
    from ais_tpu.ops.pallas_fir import pallas_wire_channelizer, wire_channelizer_buffers

    n_in, offsets = 80_000, _offsets(n_chan)
    raw = _ci1_wire(n_in, 17 + n_chan)
    ph = np.stack([mixer_phase(o, RATE, 777) for o in offsets])
    chan = twc.PackedWireChannelizer("ci1", TAPS, DECIM, offsets, RATE, n_in, device="cpu")
    assert chan.folded is not None and chan.folded.ntaps == 2 * TAPS.size
    assert chan.frags.dtype == torch.int32
    assert tuple(chan.frags.shape) == (-(-2 * TAPS.size // 128), 8, -(-n_chan // 2), 32, 2)
    car = twc.rotate_carrier(chan.carrier, torch.from_numpy(ph))
    got = twc.wire_channelizer_ci1_folded(torch.from_numpy(raw), car, chan.folded, DECIM,
                                          n_in).numpy()
    plain = twc.wire_channelizer_packed_plain("ci1", torch.from_numpy(raw), car, chan.taps,
                                              DECIM).numpy()
    assert got.shape == (n_chan, chan.n_out)
    _close(got, plain)
    rcar, h = wire_channelizer_buffers("ci1", TAPS, DECIM, offsets, RATE)
    want = np.asarray(pallas_wire_channelizer(
        jnp.asarray(raw), jnp.asarray(ph), jnp.asarray(rcar), jnp.asarray(h), fmt="ci1",
        ntaps=TAPS.size, decim=DECIM, offsets=offsets, rate=RATE, n_in=n_in, interpret=True))
    _close(got, want)


@pytest.mark.parametrize("decim,n_in", [(51, 40_188), (37, 39_960), (1, 4_000)])
def test_folded_form_other_decimations(decim, n_in):
    """Odd decimations (bit decimation 2D is then not a multiple of 4) and
    a wire that ends inside a 32-bit word."""
    offsets = _offsets(2)
    assert n_in % decim == 0 and n_in % 4 == 0 and (decim != 51 or (n_in // 4) % 4)
    chan = twc.PackedWireChannelizer("ci1", SMALL_TAPS, decim, offsets, RATE, n_in,
                                    device="cpu")
    rng = np.random.default_rng(decim)
    raw = torch.from_numpy(rng.integers(0, 256, n_in // 4, dtype=np.uint8))
    car = twc.rotate_carrier(chan.carrier,
                             torch.from_numpy(rng.uniform(0, 6.28, 2).astype(np.float32)))
    got = twc.wire_channelizer_ci1_folded(raw, car, chan.folded, decim, n_in).numpy()
    _close(got, twc.wire_channelizer_packed_plain("ci1", raw, car, chan.taps, decim).numpy())


def test_folded_taps_from_table_match_offsets():
    """Without a module the wrapper folds from the rotated baseband table:
    the same bit-stream taps, to the table's float32 rounding."""
    offsets = _offsets(3)
    want = twc.bit_stream_taps(twc.fold_taps(TAPS, offsets, RATE, baseband=True))
    car = twc.rotate_carrier(
        torch.from_numpy(twc._k5.carrier_table(offsets, RATE)), torch.tensor([0.7, 4.1, 2.2]))
    got = twc.bit_stream_taps(twc.fold_taps_from_table(TAPS, car.numpy()))
    assert got.shape == want.shape == (3, 2 * TAPS.size)
    assert np.abs(got - want).max() <= 4e-7 * np.abs(TAPS).max()


# -- (b) the bit-stream taps and their buffer ----------------------------------

@pytest.mark.parametrize("n_chan", [1, 2, 3, 4])
def test_bit_stream_taps_and_fragments(n_chan):
    offsets = _offsets(n_chan)
    g = twc.fold_taps(TAPS, offsets, RATE, baseband=True)
    k = np.arange(TAPS.size)
    for c, off in enumerate(offsets):       # the baseband fold: no fs/4
        np.testing.assert_allclose(g[c], TAPS * np.exp(-2j * np.pi * off * k / RATE),
                                   atol=1e-12 * np.abs(TAPS).max())
    G = twc.bit_stream_taps(g)
    assert G.shape == (n_chan, 2 * TAPS.size)
    np.testing.assert_array_equal(G[:, 0::2], g)
    np.testing.assert_array_equal(G[:, 1::2], 1j * g)
    # sum_i G[i] b[i] = sum_k g[k] (I[k] + jQ[k]) on random +-1 bits.
    b = np.random.default_rng(n_chan).integers(0, 2, 2 * TAPS.size) * 2.0 - 1.0
    np.testing.assert_allclose(G @ b, g @ (b[0::2] + 1j * b[1::2]), atol=1e-12)
    # ... and through the packed buffer, to the split's stated bound.
    frags, unscale = twc.pack_fragments(G)
    assert frags.shape == (46, 8, -(-n_chan // 2), 32, 2)
    back = twc.unpack_fragments(frags, unscale, 2 * TAPS.size, n_chan)
    for part_back, part in ((back.real, G.real), (back.imag, G.imag)):
        bound = twc.SPLIT_REL_ERR * np.abs(part) + twc.SPLIT_ABS_ERR * unscale
        assert bool((np.abs(part_back - part) <= bound).all())


# -- (c) the staged words, windows and A registers -----------------------------

@pytest.mark.parametrize("decim", [50, 51, 37])
def test_windows_and_a_registers_equal_the_decoder(decim):
    """A tile's staged words, funnel-shift windows and shift-and-mask A
    registers at the bit decimation 2D give, in every k-slot, the I or Q
    value `iq_from_bytes_ci1` puts at sample m*D + tap // 2."""
    ntaps = 150                                   # complex taps: 300 bit taps
    n_tiles = 2
    n_in = 4 * (-(-((n_tiles * TILE - 1) * decim + ntaps) // 4))
    rng = np.random.default_rng(decim)
    raw = rng.integers(0, 256, n_in // 4, dtype=np.uint8)
    x = tconvert.iq_from_bytes_ci1(torch.from_numpy(raw)).numpy()
    b = np.stack([x.real, x.imag], axis=-1).reshape(-1)       # I0 Q0 I1 Q1 ..
    b = np.concatenate([b, -np.ones(8192, np.float32)])       # past the end: zero bits
    assert twc.tile_words(2 * ntaps, 2 * decim, TILE) == (
        ((TILE - 1) * 2 * decim + 96 + 2 * 128) >> 5) + 2
    for tile in range(n_tiles):
        words = twc.tile_wire_words(raw, tile, 2 * ntaps, 2 * decim, TILE)
        assert words.size == twc.tile_words(2 * ntaps, 2 * decim, TILE)
        for row in rng.integers(0, TILE, 5):
            m = tile * TILE + int(row)
            for S in range(twc.n_super_steps(2 * ntaps)):
                for t in range(4):
                    win = twc.window(words, int(row) * 2 * decim + S * twc.SUPER_TAPS + 32 * t)
                    for j in range(8):
                        for kg, reg in enumerate(twc.a_registers(win, j)):
                            for half, val in enumerate(_fp16_pair(reg)):
                                i = S * twc.SUPER_TAPS + twc.fragment_tap(j, t, kg, half)
                                assert val == b[2 * m * decim + i], (tile, row, S, t, j, kg, half)


# -- (d) one tile through an emulated mma --------------------------------------

def test_one_tile_through_an_emulated_mma():
    """One warp's m16n8k16 chain in numpy with the PTX fragment layouts: A
    registers from the twin at decimation 2D, B registers from the packed
    bit-stream taps; hi + lo columns, unscaled, equal the direct sum of
    the folded taps over the decoded complex samples."""
    decim, n_chan = 50, 3
    offsets = _offsets(n_chan)
    g = twc.fold_taps(SMALL_TAPS, offsets, RATE, baseband=True)
    ntaps = SMALL_TAPS.size
    frags, unscale = twc.pack_fragments(twc.bit_stream_taps(g))
    frags = frags.view(np.uint32)
    rng = np.random.default_rng(9)
    n_in = 4 * (-(-(16 * decim + ntaps + 100) // 4))
    raw = rng.integers(0, 256, n_in // 4, dtype=np.uint8)
    x = tconvert.iq_from_bytes_ci1(torch.from_numpy(raw)).numpy().astype(np.complex128)
    words = twc.tile_wire_words(raw, 0, 2 * ntaps, 2 * decim, TILE)
    n_nt = frags.shape[2]
    c = np.zeros((n_nt, 16, 8))
    for S in range(twc.n_super_steps(2 * ntaps)):
        for j in range(8):
            a = np.zeros((16, 16))
            bm = np.zeros((n_nt, 16, 8))
            for lane in range(32):
                gq, t = lane >> 2, lane & 3
                for h in range(2):
                    win = twc.window(words, (gq + 8 * h) * 2 * decim + S * twc.SUPER_TAPS + 32 * t)
                    for kg, reg in enumerate(twc.a_registers(win, j)):
                        for half, val in enumerate(_fp16_pair(reg)):
                            a[gq + 8 * h, 2 * t + 8 * kg + half] = val
                for nt in range(n_nt):
                    for kg in range(2):
                        for half, val in enumerate(_fp16_pair(int(frags[S, j, nt, lane, kg]))):
                            bm[nt, 2 * t + 8 * kg + half, gq] = val
            c += a @ bm
    cols = c.transpose(1, 0, 2).reshape(16, 8 * n_nt)[:, : 4 * n_chan].reshape(16, n_chan, 2, 2)
    got = cols.sum(axis=-1) * unscale                       # (row, chan, re/im)
    for m in range(16):
        want = (g * x[m * decim: m * decim + ntaps]).sum(axis=1)
        np.testing.assert_allclose(got[m, :, 0] + 1j * got[m, :, 1], want,
                                   atol=2e-6 * np.abs(g).sum(axis=1).max())


# -- (e) the predicate ---------------------------------------------------------

ACCEPTED = [
    (TAPS.size, 50, (-25e3, 25e3), RATE, 80_000),
    (TAPS.size, 50, (-25e3,), RATE, None),
    (TAPS.size, 50, (-25e3, 25e3, 0.0, 50e3), RATE, 400_000),   # 4 channels: one block
    (TAPS.size, 51, (-25e3, 25e3), RATE, 400_044),              # odd D, ends inside a word
    (TAPS.size, 48, (-25e3, 25e3), RATE, None),                 # refused by the TPU kernel
    (300, 5, (0.0, 60e3), 240e3, 20_000),
    (2891, 50, (-1.25e3, 1.25e3), RATE, None),                  # period 1920
]
REFUSED = [
    (TAPS.size, 50, (25e3 * np.sqrt(2),), RATE, None, "no periodic carrier"),
    (TAPS.size, 50, (-1e3, 1e3), RATE, None, "period 2400 > 2048"),
    (TAPS.size, 50, (0.0,) * 5, RATE, None, "5 channels"),
    (TAPS.size, 50, (), RATE, None, "no channel"),
    (TAPS.size, 50, (-25e3, 25e3), RATE, 80_002, "not whole bytes"),
    (TAPS.size, 50, (-25e3, 25e3), RATE, 80_020, "not whole decimation rows"),
    (TAPS.size, 50, (-25e3, 25e3), RATE, 2_800, "shorter than the filter"),
    (7000, 50, (-25e3, 25e3, 0.0), RATE, None, "B of 3 channels beyond shared memory"),
    (2891, 1800, (-25e3, 25e3, 0.0), RATE, None, "a tile's words beyond shared memory"),
]


@pytest.mark.parametrize("geometry", ACCEPTED, ids=lambda g: f"{g[0]}taps_d{g[1]}_{len(g[2])}ch")
def test_predicate_accepts(geometry):
    ntaps, decim, offsets, rate, n_in = geometry
    assert twc.ci1_mma_supported(ntaps, decim, offsets, rate, n_in)
    # ... and the template takes every one of them too: the route is a
    # choice between two kernels, never between a kernel and none.
    assert twc.wire_channelizer_supported("ci1", ntaps, decim, offsets, rate, n_in)


@pytest.mark.parametrize("geometry", REFUSED, ids=lambda g: g[5].replace(" ", "_"))
def test_predicate_refuses(geometry):
    ntaps, decim, offsets, rate, n_in, _ = geometry
    assert not twc.ci1_mma_supported(ntaps, decim, offsets, rate, n_in)


def test_shared_memory_edge():
    """B is 46 super-steps x 8 k-steps x NT x 32 lanes x 8 bytes; with a
    tile's words it fits a block at 4 channels and 2891 taps, and stops
    fitting where the taps grow."""
    words = twc.tile_words(2 * 2891, 100, TILE)
    assert words == (((TILE - 1) * 100 + 96 + 45 * 128) >> 5) + 2
    assert twc.kernel_smem_bytes(2 * 2891, 100, 2, TILE) == 94_208 + 4 * words
    assert twc.kernel_smem_bytes(2 * 2891, 100, 4, TILE) == 188_416 + 4 * words
    assert twc.kernel_smem_bytes(2 * 2891, 100, 4, TILE) <= twc.MAX_SMEM_BYTES
    # Two blocks of 2 channels share a multiprocessor (1 KB reserved each).
    assert 2 * (twc.kernel_smem_bytes(2 * 2891, 100, 2, TILE) + 1024) <= 233_472
    edge = max(n for n in range(2891, 4000)
               if twc.ci1_mma_takes(n, 50, 4, 96))
    assert twc.ci1_mma_takes(edge, 50, 4, 96) and not twc.ci1_mma_takes(edge + 1, 50, 4, 96)
    assert twc.kernel_smem_bytes(2 * (edge + 1), 100, 4, TILE) > twc.MAX_SMEM_BYTES
    assert twc.ci1_mma_takes(edge + 1, 50, 2, 96)            # half the columns: it fits


# -- (f) the module and the routes ----------------------------------------------

def test_module_on_the_cpu_returns_the_plain_version():
    n_in, offsets = 40_000, _offsets(2)
    raw = torch.from_numpy(_ci1_wire(n_in, 3))
    ph = torch.tensor([0.3, 5.1])
    chan = twc.PackedWireChannelizer("ci1", SMALL_TAPS, DECIM, offsets, RATE, n_in,
                                    device="cpu")
    want = twc.wire_channelizer_packed_plain(
        "ci1", raw, twc.rotate_carrier(chan.carrier, ph), chan.taps, DECIM)
    assert torch.equal(chan(raw, ph), want)
    # A geometry the 1-bit form refuses has no fragments, and K4's modules none.
    other = twc.PackedWireChannelizer("ci1", SMALL_TAPS, DECIM, (25e3 * np.sqrt(2),), RATE,
                                      n_in, device="cpu")
    assert other.folded is None and other.full_table
    assert twc.PackedWireChannelizer("ci2", SMALL_TAPS, DECIM, offsets, RATE, n_in,
                                     device="cpu").folded is None


def test_cd1_through_ci1_equals_ci1():
    """cd1 reaches K3 as ci1 bytes (`ci1_from_bytes_cd1`): the folded form
    on them equals the folded form on the ci1 encoding of the same bits."""
    n_in, offsets = 40_000, _offsets(2)
    rng = np.random.default_rng(12)
    iq = ((rng.normal(size=n_in) + 1j * rng.normal(size=n_in)) * 0.3).astype(np.complex64)
    ci1 = torch.from_numpy(tconvert.host_bytes(iq, "ci1"))
    cd1 = torch.from_numpy(tconvert.host_bytes(iq, "cd1"))
    via = tconvert.ci1_from_bytes_cd1(cd1, n_in)
    assert torch.equal(via, ci1) and via.data_ptr() % 4 == 0
    chan = twc.PackedWireChannelizer("ci1", SMALL_TAPS, DECIM, offsets, RATE, n_in,
                                    device="cpu")
    car = twc.rotate_carrier(chan.carrier, torch.tensor([1.0, 2.0]))
    a = twc.wire_channelizer_ci1_folded(via, car, chan.folded, DECIM, n_in)
    b = twc.wire_channelizer_ci1_folded(ci1, car, chan.folded, DECIM, n_in)
    assert torch.equal(a, b)


def test_dispatch_takes_plain_version_only_on_cpu():
    raw = torch.zeros(20_000, dtype=torch.uint8, device="meta")
    car = torch.zeros(2, 96, 2, device="meta")
    with pytest.raises(NotImplementedError, match="meta"):
        twc.wire_channelizer_packed("ci1", raw, car, torch.zeros(TAPS.size, device="meta"),
                                    decim=DECIM, n_in=80_000)


def test_new_kernel_has_its_own_launch_count():
    from ais_tpu_torch import _build

    names = [k.name for k in _build.KERNELS]
    assert len(set(names)) == len(names)
    assert {"wire_channelizer_cr1", "wire_channelizer_ci1",
            "wire_channelizer_ci1_mma"} <= set(names)
    assert _build.WIRE_CHANNELIZER_CI1_MMA.symbol != _build.WIRE_CHANNELIZER_CR1.symbol
    # K1's arguments and the tile's outputs.
    assert len(_build.WIRE_CHANNELIZER_CI1_MMA.argtypes) \
        == len(_build.WIRE_CHANNELIZER_CR1.argtypes) + 1


@pytest.mark.gpu
@pytest.mark.parametrize("n_chan", [1, 2, 3, 4])
def test_kernel_matches_plain_on_card(cuda, n_chan):
    from ais_tpu_torch import _build

    n_in, offsets = 400_000, _offsets(n_chan)
    raw = torch.from_numpy(_ci1_wire(n_in, 5)).to(cuda)
    chan = twc.PackedWireChannelizer("ci1", TAPS, DECIM, offsets, RATE, n_in, device=cuda)
    ph = torch.rand(n_chan, device=cuda) * 6.28
    before = (_build.WIRE_CHANNELIZER_CI1_MMA.launches, _build.WIRE_CHANNELIZER_CI1.launches)
    got = chan(raw, ph)
    assert _build.WIRE_CHANNELIZER_CI1_MMA.launches == before[0] + 1
    assert _build.WIRE_CHANNELIZER_CI1.launches == before[1]
    want = twc.wire_channelizer_packed_plain("ci1", raw, twc.rotate_carrier(chan.carrier, ph),
                                             chan.taps, DECIM)
    err = (got - want).abs()
    assert bool((err <= 2e-5 * want.abs().max() + 2e-4 * want.abs()).all())
