"""ais_tpu_torch — the AIS receiver on PyTorch and CUDA (NVIDIA Hopper).

A port of `ais_tpu` (the JAX package, which stays the reference).  Plain
tensor code is PyTorch; every Pallas kernel of the reference becomes a
hand-written CUDA kernel for `sm_90a` (sources in `csrc/`, built with
`nvcc` at first use by `_build.py`).  Each kernel keeps a plain PyTorch
version beside it in the same module: a wrapper runs that plain version
only for a tensor on the CPU, and for a CUDA tensor launches the kernel
or raises.

What runs today (slices 1 and 2): complex IQ or wire bytes of every
format -> packets through `pipeline.wideband.WidebandReceiver`
(`decode`, `flush`, `decode_wire(raw, fmt)`).

Module map (port <- reference):

====================================  ====================================
ais_tpu_torch                         ais_tpu
====================================  ====================================
ops/convert.py                        ops/convert.py (decoders, host_bytes)
ops/fir.py                            ops/fir.py (mixer_phase, polyphase)
ops/channelizer.py (K5)               ops/pallas_fir.py (float kernel)
ops/wire_channelizer.py (K1, K3, K4)  ops/pallas_fir.py (wire kernels)
ops/probe.py (K6)                     tools/tpu_pallas_probe.py
ops/framing.py, window.py, agc.py     the same names
ops/freq.py, demod.py, interp.py      the same names
ops/matched_filter.py (K2)            ops/pallas_corr.py
sync/corr.py, sync/feedforward.py     the same names
pipeline/receiver.py, host.py         the same names
pipeline/wideband.py                  pipeline/wideband.py
====================================  ====================================

The jax-free leaf modules of the reference (`ais_tpu.core.params`,
`ais_tpu.ops.firdes`, `ais_tpu.decode`, `ais_tpu.native`, `ais_tpu.tx`)
are reused as they are.
"""

import torch

# The reference pins Precision.HIGHEST on every dot (pallas_fir.py,
# pallas_corr.py): a reduced-mantissa pass raises the correlation noise
# floor.  TF32 keeps ~3 decimal digits, so the port turns it off for
# both matmuls and cuDNN convolutions (the latter defaults to TF32).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
