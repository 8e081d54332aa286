"""rtl_sdr's cu8 wire (offset-binary uint8 I, Q; (v - 127.5) / 127.5) on
the port's wire path: `stage_wire` / `dispatch_wire` / `wire_channels`
into K5's cu8 entry (`ops/wire_channelizer.py:PACKED["cu8"]`,
`csrc/channelizer.cu:DecodeCu8`).

On the CPU: the kernel's word decoder against `iq_from_bytes_cu8`; the
channels against a float64 reference written here in plain PyTorch; the
packets against the complex path on the same bytes and against the JAX
reference's decode of its own `iq_from_bytes_cu8`; overflow recovery;
the byte count and the fan's constructor.  On the card (`gpu`, skipped
here): the entry against the plain version, and one launch a step.
The JAX package is imported inside the one test that compares with it,
so that the card's tests run where there is no JAX
(`python -m pytest --noconftest -m gpu tests/test_torch_cu8.py`).
"""

import dataclasses

import numpy as np
import pytest
import torch

from ais_tpu_torch import _build
from ais_tpu_torch.core.params import DemodConfig
from ais_tpu_torch.ops import channelizer as tch
from ais_tpu_torch.ops import wire_channelizer as twc
from ais_tpu_torch.ops.convert import host_bytes, iq_from_bytes_cu8
from ais_tpu_torch.pipeline import wideband as tw
from ais_tpu_torch.tx import aivdm_payload_to_bytes
from ais_tpu_torch.tx.scenario import Scenario, ScenarioPacket

torch.set_num_threads(1)

PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"
DEMOD = DemodConfig(max_bursts_per_block=24, ff_path="fir")


def _key(packets):
    return [(p.nmea, p.designator, p.abs_sample) for p in packets]


def _receiver(blocks: int, demod: DemodConfig = DEMOD, device="cpu", **changes):
    cfg = tw.WidebandConfig(demod=demod, compact_lanes=14 * 2 * blocks, **changes)
    n48 = cfg.block_len + cfg.core_len * (blocks - 1)
    n_in = tw.aligned_n_in(cfg, (n48 - 1) * cfg.decimation + tw.num_taps(cfg))
    return tw.WidebandReceiver(cfg, n_in=n_in, device=device)


def _random_wire(n_in: int, seed: int) -> np.ndarray:
    wire = np.random.default_rng(seed).integers(0, 256, 2 * n_in, dtype=np.uint8)
    wire[:8] = (0, 255, 127, 128, 255, 0, 128, 127)
    return wire


def plain_channels_f64(wire: np.ndarray, taps: np.ndarray, offsets_hz, rate: int, decim: int,
                       at: int) -> torch.Tensor:
    """The receiver's channels from the definition, float64 throughout:
    x[n] = ((I - 127.5) + j(Q - 127.5)) / 127.5, mixed by
    e^{-j2pi off (at + n) / fs}, then y[m] = sum_k h[k] z[mD + k].
    The phase comes from integers (off and fs are whole hertz), so it
    is exact for any stream position `at`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    v = torch.from_numpy(wire.astype(np.float64)).reshape(-1, 2)
    x = torch.complex(v[:, 0] - 127.5, v[:, 1] - 127.5) / 127.5
    n = torch.arange(x.numel(), dtype=torch.int64) + at
    h = torch.from_numpy(np.asarray(taps, np.float64))
    ntaps = h.numel()
    n_out = (x.numel() - ntaps) // decim + 1
    j_rows = -(-ntaps // decim)
    h_rows = torch.nn.functional.pad(h, (0, j_rows * decim - ntaps)).reshape(j_rows, decim)
    out = []
    for off in offsets_hz:
        turns = torch.remainder(-int(off) * n, rate).to(torch.float64) / rate
        z = x * torch.polar(torch.ones_like(turns), 2 * np.pi * turns)
        z = torch.nn.functional.pad(z, (0, (n_out + j_rows) * decim - z.numel()))
        rows = z.reshape(-1, decim)
        y = torch.zeros(n_out, dtype=torch.complex128)
        for j in range(j_rows):
            y += rows[j: j + n_out] @ h_rows[j].to(torch.complex128)
        out.append(y)
    return torch.stack(out)


def test_packed_entry_and_word_decoder():
    """cu8's entry: two samples a 32-bit word, 2 bytes a sample, its own
    kernel; the kernel's decoder (`word_sample`, its shifts and float32
    arithmetic) gives `iq_from_bytes_cu8` bit for bit on every byte value
    (random words: `test_torch_channelizer_layout.py`)."""
    spec = twc.PACKED["cu8"]
    assert spec.samples_per_word == 2 and spec.kernel is _build.WIRE_CHANNELIZER_CU8
    assert spec.nbytes(1001) == 2002 and spec.whole(1001)
    raw = np.arange(256, dtype=np.uint8)
    raw = np.stack([raw, raw[::-1]], axis=-1).reshape(-1)
    want = iq_from_bytes_cu8(torch.from_numpy(raw)).numpy()
    got = np.array([twc.word_sample("cu8", int(w), k)
                    for w in raw.view("<u4") for k in range(2)], np.complex64)
    assert got.view(np.uint32).tolist() == want.view(np.uint32).tolist()


def test_wire_channels_match_a_float64_reference():
    """`wire_channels(..., "cu8")` (K5's cu8 entry's plain version here) at
    one block, 2 channels, a stream position past 2**31 samples, against
    `plain_channels_f64`.  Tolerance 2e-6 of the outputs' largest
    magnitude: the port works in float32 (the decode rounds once, the
    carrier table is float32, 2891 products summed in float32), which
    puts its error near 4e-7 of that scale; the benchmark's bfloat16
    control reads ~1.4e-3 on such a gap."""
    rx = _receiver(1)
    cfg = rx.cfg
    at = 2**31 + 12_345 * cfg.decimation
    wire = _random_wire(rx.n_in, 5)
    got = rx.wire_channels(torch.from_numpy(wire), torch.from_numpy(rx._phase0s(at)), "cu8")
    want = plain_channels_f64(wire, rx.constants.taps, cfg.offsets_hz, int(cfg.input_rate),
                              cfg.decimation, at)
    assert set(rx._channelizers) == {"cu8"}
    assert got.dtype == torch.complex64 and got.shape == want.shape
    err = (got.to(torch.complex128) - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= 2e-6 * scale, (err, scale)


@pytest.fixture(scope="module")
def scene():
    """One block, a packet on each channel, as cu8 bytes."""
    rx = _receiver(1)
    raw = aivdm_payload_to_bytes(PAYLOAD)
    iq = Scenario(sample_rate=2.4e6, n_samples=rx.n_in, noise=0.004, packets=[
        ScenarioPacket(raw, 200_000, -25e3, phase=0.7),
        ScenarioPacket(raw, 420_000, +25e3, amplitude=0.6, extra_freq_hz=140.0),
    ]).build()
    return dict(n_in=rx.n_in, wire=host_bytes((iq * 0.7).astype(np.complex64), "cu8"))


def test_decode_wire_equals_the_complex_path_and_the_reference(scene):
    """The wire path on cu8 bytes, the complex path on the same bytes
    decoded by `iq_from_bytes_cu8`, and the JAX reference's complex path
    on its own `iq_from_bytes_cu8` (its main-path choices forced, as the
    other parity tests force them) give the same packets."""
    import jax.numpy as jnp

    from ais_tpu.core.params import DemodConfig as RefDemodConfig
    from ais_tpu.ops.convert import iq_from_bytes_cu8 as ref_cu8
    from ais_tpu.pipeline.wideband import WidebandConfig, WidebandReceiver

    wire = scene["wire"]
    rx = _receiver(1)
    got = rx.decode_wire(wire, "cu8")
    assert set(rx._channelizers) == {"cu8"} and rx.overflow_blocks == 0
    assert len(got) == 2 and {p.designator for p in got} == {"A", "B"}
    iq = iq_from_bytes_cu8(torch.from_numpy(wire)).numpy()
    cplx = _receiver(1).decode(iq)
    assert _key(got) == _key(cplx)
    demod = RefDemodConfig(max_bursts_per_block=24, ff_path="fir", corr_path="pallas")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AIS_TPU_CHAN", "pallas")
        ref = WidebandReceiver(WidebandConfig(demod=demod, compact_lanes=28), n_in=scene["n_in"])
        want = ref.decode(np.asarray(ref_cu8(jnp.asarray(wire))))
    assert _key(got) == _key(want)


def test_a_forced_overflow_recovers_the_same_packets():
    """Six packets in one block on channel A: a burst table of 2 overflows
    and the step's cu8 bytes are decoded again on the host
    (`iq_from_bytes(host, "cu8", n_in)`) and re-demodulated; the packets
    are those of a table that holds them all."""
    rx = _receiver(2)
    cfg = rx.cfg
    raw = aivdm_payload_to_bytes(PAYLOAD)
    rng = np.random.default_rng(3)
    packets = []
    for k in range(6):
        p = bytearray(raw)
        p[1] = 10 + k
        packets.append(ScenarioPacket(
            payload=bytes(p), start_sample=(400 + k * 1800) * cfg.decimation,
            offset_hz=float(cfg.offsets_hz[0]), phase=float(rng.uniform(0, 2 * np.pi)),
            extra_freq_hz=float(rng.uniform(-100, 100))))
    iq = Scenario(sample_rate=cfg.input_rate, n_samples=rx.n_in, packets=packets,
                  noise=0.004).build()
    wire = host_bytes((iq * 0.7).astype(np.complex64), "cu8")
    want = rx.decode_wire(wire, "cu8")
    assert rx.overflow_blocks == 0
    assert sorted(p.payload for p in want) == sorted(p.payload for p in packets)
    small = _receiver(2, dataclasses.replace(DEMOD, max_bursts_per_block=2))
    got = small.decode_wire(wire, "cu8")
    assert small.overflow_blocks >= 1 and small.recover_s > 0
    assert _key(got) == _key(want)


def test_byte_count_and_the_fan_take_cu8():
    from ais_tpu_torch.pipeline.multiproc import MultiProcessWideband

    for n in (1_000_000, 1_000_001, 822_200):
        assert tw.wire_nbytes("cu8", n) == 2 * n
    assert "cu8" in tw.WIRE_FORMATS
    rx = _receiver(1)
    with pytest.raises(ValueError, match="bytes"):
        rx.stage_wire(np.zeros(2 * rx.n_in - 2, np.uint8), "cu8")
    fan = MultiProcessWideband(rx.cfg, rx.n_in, n_workers=1, fmt="cu8", device="cpu")
    assert fan.fmt == "cu8" and not fan._launched
    with pytest.raises(ValueError, match="unsupported wire format"):
        MultiProcessWideband(rx.cfg, rx.n_in, n_workers=1, fmt="cu16", device="cpu")


def test_cu8_takes_every_geometry_k5_takes():
    """cu8 always fills whole bytes, so its entry takes exactly K5's
    geometries: the receiver never needs to decode it first."""
    offsets = (-25e3, 25e3, 0.0, 50e3, 75e3)
    for ntaps, decim, n_chan, n_in in [(2891, 50, 2, 822_050), (2891, 51, 2, 400_095),
                                       (151, 5, 1, 1_048_575), (2891, 4000, 4, None),
                                       (2891, 50, 5, None), (2891, 50, 2, 80_010)]:
        args = (ntaps, decim, offsets[:n_chan], 2.4e6, n_in)
        assert twc.wire_channelizer_supported("cu8", *args) == tch.channelizer_supported(*args)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K5's cu8 entry runs on the card only")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("n_chan,decim,n_in", [(2, 50, 56_682_200), (2, 51, 400_095),
                                                (3, 50, 400_000), (1, 5, 1_048_575)])
def test_entry_matches_plain_on_card(cuda, n_chan, decim, n_in):
    """The entry against its plain version (`iq_from_bytes_cu8`, then K5's
    plain version) on the same random bytes, within the kernel's own
    tolerance |err| <= 2e-5*max|y| + 2e-4*|y| (the two sum in different
    orders); max |err| printed."""
    offsets = (-25e3, 25e3, 0.0)[:n_chan]
    taps = tw.channel_taps(tw.WidebandConfig())
    chan = twc.PackedWireChannelizer("cu8", taps, decim, offsets, 2.4e6, n_in, device=cuda)
    raw = torch.from_numpy(_random_wire(n_in, 9)).to(cuda)
    ph = torch.tensor(np.random.default_rng(4).uniform(0, 2 * np.pi, n_chan), dtype=torch.float32,
                      device=cuda)
    _build.reset_launch_counts()
    got = chan(raw, ph)
    car = tch.rotate_carrier(chan.carrier, ph)
    want = twc.wire_channelizer_packed_plain("cu8", raw, car, chan.taps, decim)
    torch.cuda.synchronize()
    assert _build.launch_counts()["wire_channelizer_cu8"] == 1
    err = (got - want).abs()
    print(f"cu8 n_chan={n_chan} D={decim} n_in={n_in}: max|err| {err.max().item():.3e} "
          f"of max|y| {want.abs().max().item():.3e}")
    assert bool((err <= 2e-5 * want.abs().max() + 2e-4 * want.abs()).all())


@pytest.mark.gpu
def test_one_launch_a_step_on_card(cuda):
    """Three cu8 steps through `decode_wire`: the entry and K2 once a
    step, and no other kernel."""
    rx = _receiver(4, device=cuda)
    wire = _random_wire(rx.n_in, 11)
    _build.reset_launch_counts()
    for _ in range(3):
        rx.decode_wire(wire, "cu8")
    counts = {k: n for k, n in _build.launch_counts().items() if n}
    assert counts == {"wire_channelizer_cu8": 3, "matched_filter": 3}
    assert rx.collect_stats["wire_bytes"] == 3 * 2 * rx.n_in
