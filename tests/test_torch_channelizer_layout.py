"""The layout of the K3/K4/K5 kernel (`csrc/channelizer.cu`), checked
without a compiler.

The kernel's index arithmetic lives in `ops/channelizer.py` (the plan,
thread -> (phase, output group), the staged span, the padded tap rows,
the chunked walk's tap index, the partial sums' places) and in
`ops/wire_channelizer.py:word_sample` (the word-a-thread decoders).
`emulate` walks a whole launch with them in numpy float32, block by
block, and is held to the plain versions at the kernel's own tolerance
on the card, |err| <= 2e-5*max|y| + 2e-4*|y| (the two sum the products
in different orders).
"""

import numpy as np
import pytest
import torch

from ais_tpu_torch.ops import channelizer as tch
from ais_tpu_torch.ops import convert as tconvert
from ais_tpu_torch.ops import wire_channelizer as twc
from ais_tpu_torch.ops.firdes import low_pass

torch.set_num_threads(1)

RATE = 2.4e6
TAPS = low_pass(1.0, RATE, 11e3, 2e3)                 # 2891 taps
TAPS_250K = low_pass(1.0, 250e3, 11e3, 4e3)
SHORT = low_pass(1.0, 48e3, 11e3, 4e3)


def _iq(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=n) + 1j * rng.normal(size=n)) * 0.3).astype(np.complex64)


def _rotated(offsets, rate, n_in, seed):
    car = torch.from_numpy(tch.carrier_table(offsets, rate, n_in))
    ph = torch.from_numpy(np.random.default_rng(seed).uniform(0, 6.28, len(offsets))
                          .astype(np.float32))
    return tch.rotate_carrier(car, ph)


def emulate(x: np.ndarray, car: np.ndarray, taps: np.ndarray, decim: int,
            plan: tch.Plan) -> np.ndarray:
    """One launch, as the kernel walks it: x (n_in,) complex64 decoded
    samples, car the rotated (n_chan, q, 2) table."""
    n_chan, q = car.shape[0], car.shape[1]
    n_in, r, tile = x.size, plan.outputs, plan.tile
    m_total = tch.n_out(n_in, taps.size, decim)
    jc = tch.tap_chunks(taps.size, decim, r)
    h = tch.padded_taps(taps, decim, r)
    slen = tch.stage_len(tile, taps.size, decim, r)
    items = np.arange(tch.n_items(tile, decim, r))
    p, g = tch.item_phase_group(items, decim)
    assert tch.smem_bytes(r, tile, plan.threads, taps.size, decim, n_chan) == plan.smem
    cr, ci = car[..., 0], car[..., 1]
    out = np.zeros((n_chan, m_total), np.complex64)
    for m0 in range(0, m_total, tile):
        first, off = tch.stage_origin(m0, decim)
        assert first % tch.ALIGN == 0 and first + off == m0 * decim
        n = first + np.arange(slen)
        xs = np.where(n < n_in, x[np.minimum(n, n_in - 1)], 0).astype(np.complex64)
        k = n % q
        z_re = xs.real * cr[:, k] - xs.imag * ci[:, k]            # (n_chan, slen) float32
        z_im = xs.real * ci[:, k] + xs.imag * cr[:, k]
        acc_re = np.zeros((n_chan, r, items.size), np.float32)
        acc_im = np.zeros_like(acc_re)
        for chunk in range(jc + 1):
            for u in range(r):
                js = [tch.chunk_tap(chunk, u, i, r) for i in range(r)]
                live = [i for i in range(r) if 0 <= js[i] < jc * r]
                if not live:
                    continue
                at = off + (g * r + chunk * r + u) * decim + p
                assert at.max() < slen
                for i in live:
                    acc_re[:, i] += h[js[i], p] * z_re[:, at]
                    acc_im[:, i] += h[js[i], p] * z_im[:, at]
        part = np.full(decim * (n_chan * tile + 1), np.nan + 0j, np.complex64)
        for c in range(n_chan):
            for i in range(r):
                part[tch.partial_index(p, c, g * r + i, tile, n_chan)] = (
                    acc_re[c, i] + 1j * acc_im[c, i])
        for c in range(n_chan):
            for ml in range(min(tile, m_total - m0)):
                total = np.complex64(0)
                for ph in range(decim):
                    total = np.complex64(total + part[tch.partial_index(ph, c, ml, tile, n_chan)])
                out[c, m0 + ml] = total
    return out


def _hold(got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape and np.isfinite(got).all()
    limit = 2e-5 * np.abs(want).max() + 2e-4 * np.abs(want)
    assert (np.abs(got - want) <= limit).all(), float(np.abs(got - want).max())


# name: (taps, rate, decim, offsets, n_out wanted)
GEOMETRIES = {
    "bench_d50_2ch_ends_inside_a_tile": (TAPS, RATE, 50, (-25e3, 25e3), 300),
    "d50_1ch": (TAPS, RATE, 50, (25e3,), 130),
    "d50_3ch": (TAPS, RATE, 50, (-25e3, 25e3, 0.0), 100),
    "d50_4ch": (TAPS, RATE, 50, (-25e3, 25e3, 0.0, 50e3), 70),
    "d5_1ch": (TAPS_250K, 250e3, 5, (25e3,), 1500),
    "d1_1ch": (SHORT, 48e3, 1, (6e3,), 7000),
    "non_periodic_offset": (TAPS, RATE, 50, (25e3 * np.sqrt(2), -25e3), 140),
    "zero_offset_period_1": (TAPS_250K, 250e3, 5, (0.0,), 300),
}


def _case(name):
    taps, rate, decim, offsets, m = GEOMETRIES[name]
    n_in = (m - 1) * decim + taps.size
    n_in += -n_in % decim
    return taps, rate, decim, offsets, n_in


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_emulated_walk_matches_plain_k5(name):
    taps, rate, decim, offsets, n_in = _case(name)
    car = _rotated(offsets, rate, n_in, 3)
    x = _iq(n_in, 11)
    plan = tch.kernel_plan(taps.size, decim, len(offsets))
    want = tch.freq_xlating_polyphase_plain(torch.from_numpy(x), car, torch.from_numpy(taps),
                                            decim).numpy()
    got = emulate(x, tch.at_least_min_period(car).numpy(), taps, decim, plan)
    _hold(got, want)


@pytest.mark.parametrize("fmt", ["ci1", "ci2", "ci4", "cu8"])
def test_emulated_walk_matches_plain_wire(fmt):
    taps, rate, decim, offsets, n_in = _case("bench_d50_2ch_ends_inside_a_tile")
    n_in = 17_600                                       # whole ci1 words, D rows
    raw = tconvert.host_bytes(_iq(n_in, 13), fmt)
    car = _rotated(offsets, rate, n_in, 4)
    want = twc.wire_channelizer_packed_plain(fmt, torch.from_numpy(raw), car,
                                             torch.from_numpy(taps), decim).numpy()
    # The kernel's decoder, a word a thread.
    per = twc.PACKED[fmt].samples_per_word
    words = np.frombuffer(raw.tobytes(), "<u4")
    x = np.array([twc.word_sample(fmt, int(w), k) for w in words for k in range(per)],
                 np.complex64)
    got = emulate(x, car.numpy(), taps, decim, tch.kernel_plan(taps.size, decim, 2))
    _hold(got, want)


@pytest.mark.parametrize("fmt", ["ci1", "ci2", "ci4", "cu8"])
def test_word_decoder_equals_plain_decoder_bit_for_bit(fmt):
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, 64, dtype=np.uint8)
    raw[:8] = (0x00, 0xFF, 0x80, 0x7F, 0x08, 0xF7, 0x1B, 0xE4)
    want = twc.PACKED[fmt].decode(torch.from_numpy(raw)).numpy()
    per = twc.PACKED[fmt].samples_per_word
    got = np.array([twc.word_sample(fmt, int(w), k)
                    for w in np.frombuffer(raw.tobytes(), "<u4") for k in range(per)], np.complex64)
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()


@pytest.mark.parametrize("plan", [
    tch.Plan(1, 3, 64, 0), tch.Plan(1, 15, 768, 0), tch.Plan(4, 8, 64, 0), tch.Plan(8, 16, 32, 0),
    tch.Plan(4, 60, 768, 0), tch.Plan(8, 48, 320, 0), tch.Plan(8, 128, 768, 0),
], ids=lambda p: f"r{p.outputs}_t{p.tile}_threads{p.threads}")
def test_every_outputs_a_thread_and_several_passes(plan):
    """R = 1, 4, 8, tiles that one pass of the threads does not cover
    (the partial sums then have their own room), and the variants the
    probe times."""
    taps, decim, offsets = TAPS, 50, (-25e3, 25e3)
    n_in = 99 * decim + taps.size + 9
    plan = plan._replace(smem=tch.smem_bytes(plan.outputs, plan.tile, plan.threads, taps.size,
                                             decim, 2))
    car = _rotated(offsets, RATE, n_in, 6)
    x = _iq(n_in, 12)
    want = tch.freq_xlating_polyphase_plain(torch.from_numpy(x), car, torch.from_numpy(taps),
                                            decim).numpy()
    _hold(emulate(x, car.numpy(), taps, decim, plan), want)


def test_plan_at_the_bench_geometry():
    plan = tch.kernel_plan(2891, 50, 2)
    assert plan == tch.Plan(8, 120, 768, 160_256)
    # 58 tap rows in 8 chunks of 8; 184 rows of 50 and the alignment slack.
    assert tch.tap_chunks(2891, 50, 8) == 8
    assert tch.stage_len(120, 2891, 50, 8) == 16 + 184 * 50
    # 15 output groups of 50 phases on 24 warps, 6 a scheduler.
    assert tch.n_items(120, 50, 8) == 750 <= plan.threads
    assert tch.kernel_plan(2891, 50, 4) == tch.Plan(4, 60, 768, 204_512)
    assert tch.kernel_plan(2891, 50, 3).outputs == 4


GRID = [(ntaps, decim, n_chan)
        for ntaps in (7, 361, 2891, 6001)
        for decim in (1, 2, 5, 48, 50, 51, 96, 160, 400, 1000, 1800, 3000)
        for n_chan in (1, 2, 3, 4)]


@pytest.mark.parametrize("n_chan", [1, 2, 3, 4])
def test_plans_are_launchable(n_chan):
    for ntaps, decim, nc in GRID:
        plan = tch.kernel_plan(ntaps, decim, nc)
        if nc != n_chan or plan is None:
            continue
        r, tile, threads, smem = plan
        assert r in (1, 4, 8) and (r < 8 or nc <= 2)
        assert tile % r == 0 and tile >= r
        assert threads % 32 == 0 and 32 <= threads <= tch.MAX_THREADS
        assert smem == tch.smem_bytes(r, tile, threads, ntaps, decim, nc) <= tch.MAX_SMEM_BYTES
        z_entries = nc * tch.stage_len(tile, ntaps, decim, r)
        if tch.n_items(tile, decim, r) <= threads:
            # The partial sums take the samples' place: they must fit it.
            assert decim * (nc * tile + 1) <= z_entries
        # The last row any thread reads lies in the staged span.
        last = (tch.ALIGN - 1) + (tile - r + tch.tap_chunks(ntaps, decim, r) * r + r - 1) * decim
        assert last <= tch.stage_len(tile, ntaps, decim, r)


def _parent_accepts(ntaps, decim, n_chan):
    """The support rule of the kernel this one replaced: 256 threads, 4,
    8, 16 or 32 of them an output, the tile's span and the taps in
    232 448 bytes."""
    return any(n_chan * ((256 // g - 1) * decim + ntaps) * 8 + ntaps * 4 <= 232_448
               for g in (4, 8, 16, 32))


def test_supports_every_geometry_the_previous_kernel_did():
    offsets = (-25e3, 25e3, 0.0, 50e3)
    taken = 0
    for ntaps in (1, 7, 140, 361, 2891, 6001, 20_011, 28_000):
        for n_chan in (1, 2, 3, 4):
            # The largest decimation the previous kernel took, and around it.
            edge = max(1, ((232_448 - 4 * ntaps) // (8 * n_chan) - ntaps) // 7)
            for decim in list(range(1, 70)) + [96, 128, 160, 200, 400, 640, 1000, 1800, 2500,
                                               3600, edge - 1, edge, edge + 1]:
                if decim < 1 or not _parent_accepts(ntaps, decim, n_chan):
                    continue
                taken += 1
                assert tch.kernel_plan(ntaps, decim, n_chan) is not None, (ntaps, decim, n_chan)
                assert tch.channelizer_supported(ntaps, decim, offsets[:n_chan], RATE)
                for fmt in ("ci1", "ci2", "ci4"):
                    assert twc.wire_channelizer_supported(fmt, ntaps, decim, offsets[:n_chan], RATE)
    assert taken > 1500
    assert tch.kernel_plan(2891, 4000, 4) is None
    assert not tch.channelizer_supported(2891, 50, offsets + (75e3,), RATE)


def test_adjacent_lanes_read_adjacent_samples():
    """Within an output group the lanes of a warp take consecutive
    phases: consecutive interleaved samples, consecutive taps."""
    decim, r = 50, 8
    items = np.arange(tch.n_items(128, decim, r))
    p, g = tch.item_phase_group(items, decim)
    at = (g * r) * decim + p
    same_group = g[1:] == g[:-1]
    assert (np.diff(at)[same_group] == 1).all() and (np.diff(p)[same_group] == 1).all()
    assert set(zip(p.tolist(), g.tolist())) == {(a, b) for a in range(decim) for b in range(16)}


@pytest.mark.parametrize("n_chan,tile", [(1, 128), (2, 128), (3, 64), (4, 64)])
def test_partial_sums_have_their_own_places_and_banks(n_chan, tile):
    decim = 50
    seen = {tch.partial_index(p, c, m, tile, n_chan)
            for p in range(decim) for c in range(n_chan) for m in range(tile)}
    assert len(seen) == decim * n_chan * tile and max(seen) < decim * (n_chan * tile + 1)
    # 16 lanes of one 8-byte store (adjacent phases, one output): 16 banks pairs.
    for p0 in (0, 16, 34):
        slots = {tch.partial_index(p0 + lane, 0, 5, tile, n_chan) % 16 for lane in range(16)}
        assert len(slots) == 16


def test_padded_taps_and_chunk_taps():
    taps = np.arange(1, 12, dtype=np.float32)          # 11 taps, D = 3: J = 4
    rows = tch.padded_taps(taps, 3, 2)
    assert rows.shape == (4, 3) and rows[3].tolist() == [10.0, 11.0, 0.0]
    assert tch.padded_taps(taps, 3, 8).shape == (8, 3)
    assert (tch.padded_taps(taps, 3, 8)[4:] == 0).all()
    # Every (output, tap row) pair is met exactly once over the walk.
    for r, jc in ((1, 5), (2, 3), (4, 2), (8, 8)):
        met = [(i, tch.chunk_tap(chunk, u, i, r)) for chunk in range(jc + 1) for u in range(r)
               for i in range(r)]
        live = [(i, j) for i, j in met if 0 <= j < jc * r]
        assert sorted(live) == [(i, j) for i in range(r) for j in range(jc * r)]
        # The first chunk meets no tap of a chunk before it, the last none of its own.
        assert all(j >= 0 or i > u for chunk, u, i, j in
                   [(0, u, i, tch.chunk_tap(0, u, i, r)) for u in range(r) for i in range(r)])
        assert all(tch.chunk_tap(jc, u, i, r) >= jc * r for u in range(r) for i in range(u + 1))


def test_short_period_table_is_tiled_to_the_kernels_minimum():
    car = _rotated((0.0, 60e3), 240e3, 1000, 8)         # period 4
    wide = tch.at_least_min_period(car)
    assert car.shape[1] == 4 and wide.shape[1] == 16
    x = torch.from_numpy(_iq(1000, 9))
    assert torch.equal(tch.mix_plain(x, car), tch.mix_plain(x, wide))
    long = _rotated((-25e3, 25e3), RATE, 1000, 8)
    assert tch.at_least_min_period(long) is long


def test_stage_origin_is_aligned_for_every_word_decoder():
    for m0, decim in ((0, 50), (128, 50), (1328, 5), (7, 51), (3, 1)):
        first, off = tch.stage_origin(m0, decim)
        assert first % 16 == 0 and 0 <= off < 16 and first + off == m0 * decim
