"""The port's multi-process decoders (`ais_tpu_torch/parallel/distributed.py`)
against the JAX package's (`ais_tpu/parallel/distributed.py`).

The per-block record rows that cross processes: `_pack`'s bytes equal
the reference's on the same records (the JAX demod's, as numpy, fed to
both), and `_unpack` inverts them.  `decode_stream` on 8 CPU shards
decodes the reference's packets on its 8 virtual devices; uneven block
counts are padded; the rolling `DistributedStreamDecoder`, fed unaligned
chunks with packets straddling both call boundaries, decodes the
one-shot decode's packets and the reference's.  Two
`python -m ais_tpu_torch.parallel.worker` children on `gloo` (CPU, one
thread each, in an environment where `ais_tpu` and `jax` cannot be
imported) decode the same packets as one process.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ais_tpu_torch.core.params import DemodConfig
from ais_tpu_torch.parallel.distributed import (
    DistributedBlockDecoder,
    DistributedStreamDecoder,
    init_distributed,
)
from ais_tpu_torch.parallel.worker import synthesize
from ais_tpu_torch.pipeline.api import frame_stream
from ais_tpu_torch.pipeline.host import deframe_records
from ais_tpu_torch.pipeline.receiver import BurstRecords
from ais_tpu_torch.tx import aivdm_payload_to_bytes, make_packet_iq

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
PAYLOAD = "14eG;o@034o8sd<L9i:a;WF>062D"
SENTENCE = "!AIVDM,1,1,,A,14eG;o@034o8sd<L9i:a;WF>062D,0*7D"
CFG = DemodConfig(corr_path="pallas", ff_path="fir")
BLOCK, CORE = 16384, 11264


def _ref_cfg():
    from ais_tpu.core.params import DemodConfig as RefDemodConfig

    return RefDemodConfig(corr_path="pallas", ff_path="fir")


def _stream_with_packets(offsets, n, seed=0):
    rng = np.random.default_rng(seed)
    iq = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64) * 0.01
    pkt = make_packet_iq(aivdm_payload_to_bytes(PAYLOAD), samples_per_symbol=5)
    for off in offsets:
        iq[off: off + pkt.size] += pkt
    return iq


def _key(packets):
    return sorted((p.payload, p.abs_sample) for p in packets)


@pytest.fixture(scope="module")
def eight():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual JAX devices")


@pytest.fixture(scope="module")
def ref_records(eight):
    """The JAX demod's records of 3 blocks with 4 packets, as numpy."""
    from ais_tpu.pipeline.receiver import make_burst_demod

    iq = _stream_with_packets([3000, 9000, 20000, 30000], CORE * 3, seed=8)
    blocks = frame_stream(iq, BLOCK, CORE)
    rec = jax.jit(make_burst_demod(_ref_cfg(), BLOCK, CORE))(jnp.asarray(blocks))
    return jax.tree.map(np.asarray, rec)


def test_pack_bytes_equal_reference(ref_records):
    from ais_tpu.parallel.distributed import DistributedBlockDecoder as RefDecoder

    want = np.asarray(RefDecoder(_ref_cfg())._pack(ref_records))
    dec = DistributedBlockDecoder(CFG, device="cpu")
    got = dec._pack(BurstRecords(*(torch.from_numpy(np.array(a)) for a in ref_records)))
    assert got.dtype == torch.uint8
    assert int(ref_records.valid.sum()) >= 4
    np.testing.assert_array_equal(got.numpy(), want)


def test_unpack_inverts_pack(ref_records):
    from ais_tpu.parallel.distributed import DistributedBlockDecoder as RefDecoder

    dec = DistributedBlockDecoder(CFG, device="cpu")
    rec = BurstRecords(*(torch.from_numpy(np.array(a)) for a in ref_records))
    flat = dec._pack(rec).numpy()
    back = dec._unpack(flat)
    ref_back = RefDecoder(_ref_cfg())._unpack(flat)
    for name in BurstRecords._fields:
        np.testing.assert_array_equal(getattr(back, name), getattr(ref_back, name), name)
    for name in ("position", "mag", "valid", "n_detected", "win_start", "rssi"):
        np.testing.assert_array_equal(getattr(back, name), getattr(ref_records, name), name)
    v = ref_records.valid
    np.testing.assert_array_equal(back.bits[v], ref_records.bits[v])
    np.testing.assert_array_equal(back.bit_valid[v], ref_records.bit_valid[v])

    def packets(r):
        return deframe_records(BurstRecords(*r), 0, CORE, n_blocks=3)

    assert len(packets(back)) == 4
    assert _key(packets(back)) == _key(packets(ref_records))


def test_decode_stream_matches_reference(eight):
    from ais_tpu.parallel.distributed import DistributedBlockDecoder as RefDecoder

    offsets = [5000, 40000, 77000]
    iq = _stream_with_packets(offsets, CORE * 8, seed=4)
    dec = DistributedBlockDecoder(CFG, n_devices=8, device="cpu")
    assert (dec.n_devices, dec.world_size, dec.rank) == (8, 1, 0)
    packets = dec.decode_stream(iq)
    found = sorted(p.abs_sample for p in packets)
    assert len(found) == len(offsets)
    for off, got in zip(offsets, found):
        assert abs(got - (off + 50)) < 120  # peak lands on a training lobe
    assert all(p.nmea == SENTENCE for p in packets)
    assert _key(packets) == _key(RefDecoder(_ref_cfg()).decode_stream(iq))


def test_uneven_blocks_padded():
    iq = _stream_with_packets([9000], CORE * 3, seed=5)  # 3 blocks, 8 shards
    dec = DistributedBlockDecoder(CFG, n_devices=8, device="cpu")
    records, n = dec.decode_blocks(frame_stream(iq, BLOCK, CORE))
    assert n == 3 and records.valid.shape[0] == 8
    assert [p.nmea for p in dec.decode_stream(iq)] == [SENTENCE]


def test_rolling_calls_match_one_shot_and_reference(eight):
    from ais_tpu.parallel.distributed import DistributedStreamDecoder as RefStream

    sd = DistributedStreamDecoder(CFG, BLOCK, n_devices=8, blocks_per_call=8, device="cpu")
    step = sd.step
    n = 3 * step
    # Packets straddling both call boundaries (preamble just before the
    # cut, body in the next call's span) and mid-call ones.
    offsets = [5000, step - 700, step + 40_000, 2 * step - 650, 2 * step + 90_000]
    iq = _stream_with_packets(offsets, n, seed=4)
    want = _key(DistributedBlockDecoder(CFG, BLOCK, n_devices=8, device="cpu").decode_stream(iq))
    assert len(want) == len(offsets)

    def rolling(decoder):
        got = []
        for lo in range(0, n, 70_001):  # unaligned chunks: the carry
            got.extend(decoder.process(iq[lo: lo + 70_001]))
        return _key(got + decoder.flush())

    assert rolling(sd) == want
    assert rolling(RefStream(_ref_cfg(), BLOCK, blocks_per_call=8)) == want


def test_state_carries_across_calls():
    sd = DistributedStreamDecoder(CFG, BLOCK, n_devices=8, blocks_per_call=8, device="cpu")
    iq = _stream_with_packets([2000], sd.step // 2, seed=6)
    assert sd.process(iq) == []
    assert sd._buf.size == sd.step // 2 and sd._pos == 0
    got = sd.process(_stream_with_packets([], sd.step, seed=7))
    assert len(got) == 1 and abs(got[0].abs_sample - 2000) < 64
    assert sd._pos == sd.step and sd._buf.size == sd.step // 2


def test_blocks_per_call_must_divide_and_single_process_is_no_group():
    init_distributed()  # no address: nothing to join
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError):
        DistributedStreamDecoder(CFG, BLOCK, n_devices=8, blocks_per_call=12, device="cpu")
    assert DistributedStreamDecoder(CFG, BLOCK, n_devices=4, device="cpu").blocks_per_call == 8


def test_worker_capture_is_the_reference_workers():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        from multihost_worker import synthesize as ref_synthesize
    finally:
        sys.path.remove(str(REPO / "tools"))
    want, _ = ref_synthesize(CORE * 8)
    np.testing.assert_array_equal(synthesize(CORE * 8), want)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_match_one(tmp_path):
    """Two worker children form a gloo group over TCP, each decodes its
    half of the 8 global blocks on 4 CPU shards, and both must write the
    packets one process decodes — the 4 packets, one straddling the
    cut between the two processes' halves."""
    blocked = tmp_path / "blocked"
    for name in ("ais_tpu", "jax", "jaxlib"):
        (blocked / name).mkdir(parents=True)
        (blocked / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked: the port stands alone')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=f"{blocked}{os.pathsep}{REPO}", OMP_NUM_THREADS="1")
    coordinator = f"127.0.0.1:{_free_port()}"
    outs = [tmp_path / f"p{rank}.json" for rank in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ais_tpu_torch.parallel.worker", coordinator, "2", str(rank),
         str(outs[rank]), "--device", "cpu"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        for p in procs:
            _, stderr = p.communicate(timeout=300)
            assert p.returncode == 0, stderr[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = [json.loads(path.read_text()) for path in outs]
    for r in results:
        assert (r["n_processes"], r["n_shards"], r["local_shards"]) == (2, 8, 4)
    assert results[0]["packets"] == results[1]["packets"]

    dec = DistributedBlockDecoder(n_devices=8, device="cpu")
    want = [{"nmea": p.nmea, "abs_sample": p.abs_sample}
            for p in dec.decode_stream(synthesize(dec.core_len * 8))]
    assert len(want) == 4
    assert results[0]["packets"] == want
