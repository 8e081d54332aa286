"""Multi-device decode: shard meshes, sharded demod and wire programs,
the multi-process decoders (port of `ais_tpu/parallel/`)."""

from ais_tpu_torch.parallel.mesh import make_stream_time_mesh, make_time_mesh  # noqa: F401
from ais_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_halo_exchange_demod,
    make_sharded_demod,
    make_sharded_stream_demod,
    make_sharded_wire_pipeline,
)
