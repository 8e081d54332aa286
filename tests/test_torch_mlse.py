"""Coherent MLSE (`ais_tpu_torch/sync/mlse.py`, `refine_freq`, the mlse
branch of `BurstDemod`) against `ais_tpu.sync.mlse` and
`ais_tpu.sync.feedforward`.

Tolerances: the trellis tables are equal exactly (the same numpy);
`refine_freq` to 1e-6 rad/sample (0.008 Hz at 48 ksps); interpolated
frames to 1e-5 absolute on unit-scale bursts; the Viterbi levels
exactly on bursts clear of near-ties (the metrics are fp32 products
summed in another order than XLA's, so a near-tie may flip, which is why
the receivers are compared at packet level).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ais_tpu.core.params import DemodConfig
from ais_tpu.sync import feedforward as rff
from ais_tpu.sync import mlse as rm
from ais_tpu.tx import aivdm_payload_to_bytes, make_packet_iq
from ais_tpu_torch.ops.interp import interp_taps
from ais_tpu_torch.pipeline.api import BasebandReceiver
from ais_tpu_torch.sync import feedforward as tff
from ais_tpu_torch.sync import mlse as tm

torch.set_num_threads(1)

SENTENCE = "!AIVDM,1,1,,A,14eG;o@034o8sd<L9i:a;WF>062D,0*7D"
RAW = aivdm_payload_to_bytes("14eG;o@034o8sd<L9i:a;WF>062D")
IQ = make_packet_iq(RAW, 5)


def _bursts(sigmas, freqs, seed=0):
    """Unit-scale bursts, each the packet at 5 sps plus noise and a
    residual carrier, one per (sigma, freq)."""
    rng = np.random.default_rng(seed)
    out = []
    for sigma, f in zip(sigmas, freqs):
        b = (rng.normal(size=4096) + 1j * rng.normal(size=4096)) * sigma
        rot = np.exp(2j * np.pi * f * np.arange(IQ.size) / 48000.0 + 1j * rng.uniform(0, 6))
        b[1: 1 + IQ.size] += IQ * rot
        out.append(b)
    return np.asarray(out, np.complex64)


def test_trellis_tables_equal():
    want, got = rm.gmsk_trellis(5), tm.gmsk_trellis(5)
    assert got.n_states == want.n_states == 64 and got.frame_offset == want.frame_offset
    for name in ("refs_r", "refs_i", "preds", "train_paths"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_refine_freq_matches_reference():
    b = _bursts([0.03, 0.1, 0.2], [0.0, -17.0, 23.0])
    got = tff.refine_freq(torch.from_numpy(b), 5.0).numpy()
    want = np.asarray([float(rff.refine_freq(jnp.asarray(x), 5.0)) for x in b])
    np.testing.assert_allclose(got, want, atol=1e-6)
    hz = got * 48000.0 / (2 * np.pi)
    np.testing.assert_allclose(hz, [0.0, -17.0, 23.0], atol=2.0)


def _reference_frames(b):
    """The reference's per-burst chain up to the frames, and its levels."""
    w0 = rff.refine_freq(b, 5.0)
    ph = -w0 * jnp.arange(b.size, dtype=jnp.float32)
    b2 = b * jax.lax.complex(jnp.cos(ph), jnp.sin(ph))
    base, intercept, _ = rff.estimate_timing(b2, 5.0)
    fr, v = rm.burst_frames(b2, base + intercept, 5, 300)
    return np.asarray(b2), float(base + intercept), np.asarray(fr), np.asarray(v)


def test_frames_and_levels_match_reference():
    bursts = _bursts([0.02, 0.05, 0.1, 0.15], [0.0, 12.0, -20.0, 5.0], seed=4)
    tt = tm.trellis_tensors(tm.gmsk_trellis(5), "cpu")
    delta = tff.ff_delta(5.0, 0.4)
    bank = torch.from_numpy(interp_taps())
    b2s, centers, frames, valids = zip(*(_reference_frames(jnp.asarray(b)) for b in bursts))
    got_fr, got_v = tm.burst_frames(torch.from_numpy(np.stack(b2s)),
                                    torch.tensor(centers, dtype=torch.float32), 5, 300,
                                    delta, tm.gmsk_trellis(5).frame_offset, bank)
    np.testing.assert_allclose(got_fr.numpy(), np.stack(frames), atol=1e-5)
    np.testing.assert_array_equal(got_v.numpy(), np.stack(valids))
    ts = torch.tensor([4, 5, 6, 7])
    levels = tm.mlse_levels(torch.from_numpy(np.stack(frames)), tt, train_start=ts).numpy()
    want = np.stack([np.asarray(rm.mlse_levels(jnp.asarray(f), rm.gmsk_trellis(5),
                                               train_start=int(t)))
                     for f, t in zip(frames, ts)])
    np.testing.assert_array_equal(levels, want)


def _weak_capture():
    rng = np.random.default_rng(3)
    iq = (rng.normal(size=48000) + 1j * rng.normal(size=48000)).astype(np.complex64) * 0.35
    iq[9000: 9000 + IQ.size] += IQ.astype(np.complex64)
    return iq


def test_mlse_decodes_weak_packet_the_discriminator_misses():
    """tests/test_mlse.py's pipeline case: the port's BasebandReceiver
    with MLSE finds the reference's packet at ~6 dB SNR, the
    discriminator finds nothing, as in the reference."""
    from ais_tpu.pipeline import BasebandReceiver as RefBaseband

    iq = _weak_capture()
    mlse = DemodConfig(demod_mode="mlse", corr_threshold=0.4, corr_path="pallas",
                       ff_path="fir")
    got = BasebandReceiver(demod=mlse, device="cpu").process(iq.copy())
    want = RefBaseband(demod=mlse).process(iq.copy())
    assert [(p.nmea, p.abs_sample) for p in got] == [(p.nmea, p.abs_sample) for p in want]
    assert [p.nmea for p in got] == [SENTENCE]
    disc = dataclasses.replace(mlse, demod_mode="discriminator")
    assert BasebandReceiver(demod=disc, device="cpu").sentences(iq.copy()) == []


def test_mlse_records_match_reference():
    """The mlse BurstDemod's records on blocks of a normal-SNR capture:
    valid lanes, positions and bits from index 2 equal."""
    from ais_tpu.pipeline.receiver import make_burst_demod
    from ais_tpu_torch.pipeline.receiver import BurstDemod, demod_constants

    rng = np.random.default_rng(4)
    iq = (rng.normal(size=2 * 16384) + 1j * rng.normal(size=2 * 16384)).astype(np.complex64)
    iq *= 0.05
    iq[3000: 3000 + IQ.size] += IQ
    iq[16384 + 5000: 16384 + 5000 + IQ.size] += IQ * np.exp(0.7j)
    blocks = iq.reshape(2, 16384)
    cfg = DemodConfig(demod_mode="mlse", corr_path="pallas", max_bursts_per_block=4)
    core = 16384 - 4096 - 512 - 16
    want = jax.tree.map(np.asarray, jax.jit(make_burst_demod(cfg, 16384, core))(
        jnp.asarray(blocks)))
    pre, bank, delta = demod_constants(cfg)
    got = BurstDemod(cfg, 16384, core, preamble=pre, interp_bank=bank, ff_delta=delta,
                     device="cpu")(torch.from_numpy(blocks))
    v = got.valid.numpy()
    np.testing.assert_array_equal(v, want.valid)
    assert v.sum() >= 2  # the two packets, and sidelobes at the 0.4 threshold
    np.testing.assert_array_equal(got.position.numpy()[v], want.position[v])
    np.testing.assert_array_equal(got.bit_valid.numpy()[v], want.bit_valid[v])
    np.testing.assert_array_equal(got.bits.numpy()[v][:, 2:], want.bits[v][:, 2:])


def test_full_load_packets_match_reference():
    """The whole slice in MLSE mode on a 2-block full-load scene (a packet
    in every slot of both channels): the port's packets are the
    reference's.  At full load MLSE decodes fewer than the discriminator
    in both packages (its per-burst estimators span a window that holds
    the neighbouring packets too)."""
    from ais_tpu.pipeline.wideband import WidebandConfig, WidebandReceiver
    from ais_tpu_torch.pipeline import wideband as tw
    from ais_tpu_torch.scene import content_parity, full_load_scene

    demod = DemodConfig(demod_mode="mlse", corr_path="pallas", ff_path="fir")
    cfg = tw.WidebandConfig(demod=demod)
    n48 = cfg.block_len + cfg.core_len
    n_in = tw.aligned_n_in(cfg, (n48 - 1) * cfg.decimation + tw.num_taps(cfg))
    port = tw.WidebandReceiver(cfg, n_in=n_in, device="cpu")
    iq, tx = full_load_scene(cfg, n_in, port.step_raw)
    iq = iq.astype(np.complex64)
    got = port.decode(iq)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AIS_TPU_CHAN", "pallas")
        want = WidebandReceiver(WidebandConfig(demod=demod), n_in=n_in).decode(iq)
    assert [(p.nmea, p.designator, p.abs_sample) for p in got] == \
        [(p.nmea, p.designator, p.abs_sample) for p in want]
    assert 0.5 < content_parity(got, tx, 50) <= 1.0
