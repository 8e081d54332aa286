from ais_tpu_torch.io.sources import (  # noqa: F401
    FileSource,
    SampleSource,
    UdpSource,
    open_source,
    read_iq_file,
)
