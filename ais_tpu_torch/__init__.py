"""ais_tpu_torch — the AIS receiver on PyTorch and CUDA (NVIDIA Hopper).

A port of `ais_tpu` (the JAX package, which stays the reference).  Plain
tensor code is PyTorch; every Pallas kernel of the reference becomes a
hand-written CUDA kernel for `sm_90a` (sources in `csrc/`, built with
`nvcc` at first use by `_build.py`).  Each kernel keeps a plain PyTorch
version beside it in the same module: a wrapper runs that plain version
only for a tensor on the CPU, and for a CUDA tensor launches the kernel
or raises.

What runs today: complex IQ or wire bytes of every format -> packets
through `pipeline.wideband.WidebandReceiver` (`decode`, `flush`,
`decode_wire(raw, fmt)`), with overflow recovery, either bit decision
(discriminator or coherent MLSE) and either timing recovery
(feedforward, with its FIR, FFT and bank extractions, or the PLL loop);
the `ais_rx` receive path: `pipeline.radio.AisRadio` (fused wideband at
whole decimations, ppm-shifted carriers included; per-channel
`pipeline.api` receivers with the host resampler otherwise); the CLIs
`ais_rx`, `ais_scope` and `modem_bench` (`python -m
ais_tpu_torch.cli.<name>`); wire-format selection; and multi-device
decode (`parallel`: sharded demod, halo exchange, stream x time, the
sharded wire program, and the block and stream decoders over the
processes of a `torch.distributed` group); and the multi-process wire
fan (`pipeline.multiproc.MultiProcessWideband`: wire steps over N worker
processes on one card, each with its own receiver, so the host back
half of several steps runs at once).

Module map (port <- reference):

====================================  ====================================
ais_tpu_torch                         ais_tpu
====================================  ====================================
ops/convert.py                        ops/convert.py (decoders, host_bytes)
ops/fir.py                            ops/fir.py (mixer, polyphase, xlating)
ops/resample.py                       ops/resample.py
ops/channelizer.py (K5)               ops/pallas_fir.py (float kernel)
ops/wire_channelizer.py (K1, K3, K4)  ops/pallas_fir.py (wire kernels)
ops/probe.py (K6)                     tools/tpu_pallas_probe.py
ops/framing.py, window.py, agc.py     the same names
ops/freq.py, demod.py, interp.py      the same names
ops/matched_filter.py (K2)            ops/pallas_corr.py
sync/corr.py, feedforward.py, mlse.py the same names
sync/timing.py, utils/profiling.py    the same names
pipeline/receiver.py, host.py         the same names
pipeline/wideband.py, recover.py      the same names
pipeline/api.py, radio.py             the same names
pipeline/multiproc.py                 the same name
cli/ais_rx.py, ais_scope.py,          the same names
modem_bench.py
parallel/mesh.py, pipeline.py,        parallel/mesh.py, pipeline.py,
distributed.py                        distributed.py
parallel/dryrun.py                    __graft_entry__.py:dryrun_multichip
parallel/worker.py                    tools/multihost_worker.py
====================================  ====================================

The port imports nothing of `ais_tpu`, not even its numpy-only leaf
modules: it keeps its own copies under the same sub-package names
(`core/params.py`, `ops/firdes.py`, `utils/bits.py`, `utils/cpm.py`,
`decode/`, `tx/`, `io/`, `native/`), held field for field and bit for
bit against the reference by the tests.
"""

import torch

# The reference pins Precision.HIGHEST on every dot (pallas_fir.py,
# pallas_corr.py): a reduced-mantissa pass raises the correlation noise
# floor.  TF32 keeps ~3 decimal digits, so the port turns it off for
# both matmuls and cuDNN convolutions (the latter defaults to TF32).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
