"""The port's own copies of the reference's numpy-only leaf modules
(`core/params.py`, `ops/firdes.py`, `utils/`, `tx/`, `decode/`, `io/`,
`native/`), each held against the reference on seeded numpy inputs.

The copies are field for field and bit for bit the reference's, so every
comparison here is exact (`assert_array_equal`, `==`), never a tolerance.
"""

import dataclasses
import inspect
import shutil

import numpy as np
import pytest

import ais_tpu.core.params as ref_params
import ais_tpu.decode as ref_decode
import ais_tpu.decode.fields as ref_fields
import ais_tpu.io.sources as ref_sources
import ais_tpu.ops.firdes as ref_firdes
import ais_tpu.tx as ref_tx
import ais_tpu.tx.scenario as ref_scenario
import ais_tpu.utils.bits as ref_bits
import ais_tpu.utils.cpm as ref_cpm
import ais_tpu_torch.core.params as params
import ais_tpu_torch.decode as decode
import ais_tpu_torch.decode.fields as fields
import ais_tpu_torch.io.sources as sources
import ais_tpu_torch.ops.firdes as firdes
import ais_tpu_torch.tx as tx
import ais_tpu_torch.tx.scenario as scenario
import ais_tpu_torch.utils.bits as bits
import ais_tpu_torch.utils.cpm as cpm

PAYLOADS = ("14eG;o@034o8sd<L9i:a;WF>062D", "15M67FC000G?ufbE`FepT@3n00Sa",
            "B52K>;h00Fc>jpUlNV@ikwpUoP06", "H52KMe4<51DhU@F0l5T000000000")


def _payload_bytes(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(11, 64)), dtype=np.uint8).tobytes()
            for _ in range(n)]


@pytest.mark.parametrize("call", [
    ("low_pass", (1.0, 2.4e6, 11e3, 2e3)),
    ("low_pass", (0.7, 250e3, 9e3, 4e3)),
    ("low_pass", (1.0, 48e3, 7e3, 3e3, 33)),
    ("low_pass_2", (32.0, 32 * 48e3, 20e3, 8e3, 60.0)),
    ("low_pass_2", (1.0, 250e3, 10e3, 5e3)),
    ("gaussian", (1.0, 5, 0.4, 20)),
    ("gaussian", (2.0, 8.5, 0.3, 33)),
    ("gmsk_phase_taps", (5, 0.4)),
    ("gmsk_phase_taps", (8, 0.5, 3)),
    ("num_taps_low_pass", (2.4e6, 2e3)),
], ids=lambda c: f"{c[0]}{len(c[1])}")
def test_firdes_bit_identical(call):
    name, args = call
    want, got = getattr(ref_firdes, name)(*args), getattr(firdes, name)(*args)
    assert np.asarray(got).dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got, want)


def test_params_constants_and_dataclasses_equal():
    """Every public name of `core.params`: constants equal; dataclasses
    with the same fields, types and defaults; functions with the same
    signature and results."""
    public = [n for n in dir(ref_params) if not n.startswith("_")]
    assert sorted(public) == sorted(n for n in dir(params) if not n.startswith("_"))
    checked = 0
    for name in public:
        want, got = getattr(ref_params, name), getattr(params, name)
        if dataclasses.is_dataclass(want):
            wf, gf = dataclasses.fields(want), dataclasses.fields(got)
            assert [(f.name, f.type) for f in wf] == [(f.name, f.type) for f in gf], name
            try:
                w0, g0 = want(), got()
            except TypeError:
                continue
            assert dataclasses.asdict(w0) == dataclasses.asdict(g0), name
            checked += 1
        elif inspect.isfunction(want):
            assert str(inspect.signature(want)) == str(inspect.signature(got)), name
        elif not inspect.ismodule(want):
            assert np.array_equal(np.asarray(want), np.asarray(got)), name
            checked += 1
    assert checked >= 8
    for rate in (250e3, 2.4e6):
        for w, g in zip(ref_params.dual_channel_configs(rate), params.dual_channel_configs(rate)):
            assert ref_params.config_to_dict(w) == params.config_to_dict(g)
            assert dataclasses.asdict(params.config_from_dict(params.config_to_dict(g))) \
                == dataclasses.asdict(g)
    for n in (64, 120, 200):
        assert dataclasses.asdict(ref_params.demod_for_max_frame(n)) \
            == dataclasses.asdict(params.demod_for_max_frame(n))


@pytest.mark.parametrize("sps", [5, 8])
def test_tx_bit_identical(sps):
    rng = np.random.default_rng(sps)
    levels = rng.integers(0, 2, 300).astype(np.uint8)
    np.testing.assert_array_equal(tx.modulate_bits(levels, sps, 0.4, 0.3),
                                  ref_tx.modulate_bits(levels, sps, 0.4, 0.3))
    np.testing.assert_array_equal(tx.preamble_waveform(sps), ref_tx.preamble_waveform(sps))
    for ascii_payload, raw in zip(PAYLOADS, _payload_bytes(1, len(PAYLOADS))):
        assert tx.aivdm_payload_to_bytes(ascii_payload) == ref_tx.aivdm_payload_to_bytes(ascii_payload)
        np.testing.assert_array_equal(tx.frame_bits(raw, 4), ref_tx.frame_bits(raw, 4))
        np.testing.assert_array_equal(tx.nrzi_encode(tx.frame_bits(raw)),
                                      ref_tx.nrzi_encode(ref_tx.frame_bits(raw)))
        got = tx.make_packet_iq(raw, sps, phase0=1.1)
        want = ref_tx.make_packet_iq(raw, sps, phase0=1.1)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_scenario_bit_identical():
    payloads = _payload_bytes(2, 5)
    kw = dict(n_samples=400_000, sample_rate=2.4e6, seed=3)
    want_p = ref_scenario.spread_packets(payloads, **kw)
    got_p = scenario.spread_packets(payloads, **kw)
    assert [dataclasses.asdict(p) for p in got_p] == [dataclasses.asdict(p) for p in want_p]
    want = ref_scenario.Scenario(2.4e6, 400_000, want_p, noise=0.02, seed=5).build()
    got = scenario.Scenario(2.4e6, 400_000, got_p, noise=0.02, seed=5).build()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        scenario.Scenario(250e3, 1000, got_p[:1]).build()


def test_bits_and_cpm_equal():
    data = np.random.default_rng(4).integers(0, 256, 40, dtype=np.uint8).tobytes()
    for name in ("bytes_to_bits_lsb_first", "bytes_to_bits_msb_first"):
        want, got = getattr(ref_bits, name)(data), getattr(bits, name)(data)
        np.testing.assert_array_equal(got, want)
        back = name.replace("bytes_to_bits", "bits_to_bytes")
        assert getattr(bits, back)(got) == getattr(ref_bits, back)(want) == data
    for sps in (4, 5):
        np.testing.assert_array_equal(cpm.gmsk_frequency_pulse(sps), ref_cpm.gmsk_frequency_pulse(sps))
        pulse = cpm.gmsk_frequency_pulse(sps, 0.4, 3)
        want = ref_cpm.make_cpm_signals(sps=sps, pulse=pulse)
        got = cpm.make_cpm_signals(sps=sps, pulse=pulse)
        assert type(got)._fields == type(want)._fields
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert cpm.dec2base(37, 4, 5) == ref_cpm.dec2base(37, 4, 5)
    assert cpm.base2dec([1, 0, 3], 4) == ref_cpm.base2dec([1, 0, 3], 4)


def _bit_stream(seed: int):
    rng = np.random.default_rng(seed)
    payloads = _payload_bytes(seed, 3) + [tx.aivdm_payload_to_bytes(PAYLOADS[seed % 4])]
    parts = [rng.integers(0, 2, 50).astype(np.uint8)]
    for p in payloads:
        parts += [tx.frame_bits(p, ramp_bits=4), rng.integers(0, 2, 17).astype(np.uint8)]
    return np.concatenate(parts), payloads


@pytest.mark.parametrize("seed", range(4))
def test_decode_equal_on_frames_made_by_tx(seed):
    stream, payloads = _bit_stream(seed)
    want, got = ref_decode.deframe(stream), decode.deframe(stream)
    assert [dataclasses.asdict(f) for f in got] == [dataclasses.asdict(f) for f in want]
    assert [f.payload for f in got] == payloads
    np.testing.assert_array_equal(decode.find_flags(stream), ref_decode.find_flags(stream))
    broken = stream.copy()
    broken[70] ^= 1
    assert [f.payload for f in decode.deframe(broken)] \
        == [f.payload for f in ref_decode.deframe(broken)]
    for f in got:
        for des in ("A", "B"):
            assert decode.frame_to_nmea(f.payload, des) == ref_decode.frame_to_nmea(f.payload, des)
        assert decode.crc16_x25(f.payload) == ref_decode.crc16_x25(f.payload)
        assert decode.fcs_bytes(f.payload) == ref_decode.fcs_bytes(f.payload)
        assert decode.check_frame(f.payload + decode.fcs_bytes(f.payload))


@pytest.mark.parametrize("ascii_payload", PAYLOADS)
def test_fields_equal(ascii_payload):
    raw = tx.aivdm_payload_to_bytes(ascii_payload)
    want, got = ref_fields.parse_fields(raw), fields.parse_fields(raw)
    assert got == want and got
    assert fields.format_fields(got) == ref_fields.format_fields(want)
    assert decode.frame_to_nmea(raw) == ref_decode.frame_to_nmea(raw)


@pytest.mark.parametrize("fmt", ["cf32", "ci16", "ci8", "cu8", "ci4", "ci2", "ci1", "cr1"])
def test_source_conversion_equal(fmt, tmp_path):
    """`io.sources` converts every file format as the reference does (the
    ci2 levels come from the port's own `ops/convert.py`)."""
    rng = np.random.default_rng(7)
    dtype = {"cf32": np.complex64, "ci16": np.int16, "ci8": np.int8}.get(fmt, np.uint8)
    if fmt == "cf32":
        raw = (rng.normal(size=64) + 1j * rng.normal(size=64)).astype(np.complex64)
    else:
        info = np.iinfo(dtype)
        raw = rng.integers(info.min, info.max + 1, 256).astype(dtype)
    np.testing.assert_array_equal(sources._convert(raw, fmt), ref_sources._convert(raw, fmt))
    path = tmp_path / f"x.{fmt}"
    raw.tofile(path)
    np.testing.assert_array_equal(sources.read_iq_file(path, fmt),
                                  ref_sources.read_iq_file(path, fmt))
    got = np.concatenate(list(sources.FileSource(str(path), 250e3, fmt).chunks(50)))
    want = np.concatenate(list(ref_sources.FileSource(str(path), 250e3, fmt).chunks(50)))
    np.testing.assert_array_equal(got, want)


def test_rtl_tcp_and_grc_copies_equal():
    import ais_tpu.io.grc as ref_grc
    import ais_tpu.io.rtl_tcp as ref_rtl
    import ais_tpu_torch.io.grc as grc
    import ais_tpu_torch.io.rtl_tcp as rtl

    for spec in ("rtl_tcp", "rtl_tcp:10.0.0.2:4321", "rtl_tcp=host"):
        assert rtl.parse_rtl_tcp_addr(spec) == ref_rtl.parse_rtl_tcp_addr(spec)
    assert rtl._pack_cmd(0x02, 2_400_000) == ref_rtl._pack_cmd(0x02, 2_400_000)
    assert issubclass(rtl.RtlTcpSource, sources.SampleSource)
    variables = {"samp_rate": 250000, "decim": 5}
    for text in ("samp_rate/decim", "2*samp_rate + 1", "-decim"):
        assert grc._eval_expr(text, variables) == ref_grc._eval_expr(text, variables)


# -- native: the port's library against its numpy twins and the reference's --

@pytest.fixture(scope="module")
def natives():
    """(port's native module, reference's), both loaded."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built here")
    from ais_tpu import native as ref_native
    from ais_tpu_torch import native

    if not (native.available() and ref_native.available()):
        pytest.skip("the native library did not build")
    return native, ref_native


def test_native_builds_outside_the_package(natives):
    from ais_tpu_torch import _build

    native, _ = natives
    path = native._lib_path()
    assert path.parent == _build.BUILD_DIR and path.exists()
    pkg = (_build.CSRC.parent / "native")
    assert not list(pkg.glob("*.so"))


@pytest.mark.parametrize("fmt,dtype", [("ci16", np.int16), ("ci8", np.int8), ("cu8", np.uint8)])
def test_native_iq_convert(natives, fmt, dtype):
    native, ref_native = natives
    info = np.iinfo(dtype)
    raw = np.random.default_rng(8).integers(info.min, info.max + 1, 2000).astype(dtype)
    got = native.iq_convert(raw, fmt)
    np.testing.assert_array_equal(got, ref_native.iq_convert(raw, fmt))
    scale = {"ci16": 32768.0, "ci8": 128.0}.get(fmt)
    f = raw.astype(np.float32) / scale if scale else (raw.astype(np.float32) - 127.5) / 127.5
    np.testing.assert_allclose(got, (f[0::2] + 1j * f[1::2]).astype(np.complex64), atol=1e-6)


def test_native_crc_and_deframe(natives):
    native, ref_native = natives
    assert native.crc16_x25(b"123456789") == 0x906E
    for seed in range(6):
        stream, payloads = _bit_stream(seed)
        got = native.hdlc_deframe(stream)
        assert got == ref_native.hdlc_deframe(stream)
        assert [(p, s) for p, s in got] == [(f.payload, f.start_bit) for f in decode.deframe(stream)]
        assert [p for p, _ in got] == payloads
        for p in payloads:
            assert native.crc16_x25(p) == decode.crc16_x25(p) == ref_native.crc16_x25(p)


def test_native_packed_batch_deframe(natives):
    """One batched call over packed (bits, valid) planes: the reference's
    library and the per-burst numpy deframer give the same frames."""
    native, ref_native = natives
    n_lanes, n_sym = 9, 1536
    packed = np.zeros((n_lanes, 2, n_sym // 8), np.uint8)
    lanes, want = [], []
    for lane in range(n_lanes):
        if lane % 3 == 0:
            continue
        stream, _ = _bit_stream(20 + lane)
        stream = stream[:n_sym]
        planes = np.zeros((2, n_sym), np.uint8)
        planes[0, : stream.size] = stream
        planes[1, : stream.size] = 1
        packed[lane] = np.packbits(planes, axis=-1)
        for f in decode.deframe(stream):
            want.append((f.payload, f.start_bit, len(lanes)))
        lanes.append(lane)
    lanes = np.asarray(lanes, np.int32)
    got = native.hdlc_deframe_packed_batch(packed, lanes, n_sym)
    assert got == ref_native.hdlc_deframe_packed_batch(packed, lanes, n_sym)
    assert got == want and len(got) >= 12


def test_native_sigma_delta_encoders(natives):
    from ais_tpu_torch.ops import convert

    native, ref_native = natives
    rng = np.random.default_rng(9)
    iq = ((rng.normal(size=4000) + 1j * rng.normal(size=4000)) * 0.2).astype(np.complex64)
    got = native.sigma_delta_cr1(iq, 1.5, convert.CR1_A2)
    np.testing.assert_array_equal(got, ref_native.sigma_delta_cr1(iq, 1.5, convert.CR1_A2))
    np.testing.assert_array_equal(got, convert._sigma_delta_cr1_numpy(iq, 1.5, convert.CR1_A2))
    got = native.sigma_delta_ci1(iq, 1.5)
    np.testing.assert_array_equal(got, ref_native.sigma_delta_ci1(iq, 1.5))
    np.testing.assert_array_equal(got, convert._sigma_delta_ci1_numpy(iq, 1.5))
