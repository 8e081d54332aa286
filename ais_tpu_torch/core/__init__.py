from ais_tpu_torch.core.params import (  # noqa: F401
    AIS_BIT_RATE,
    AIS_CHANNEL_A_HZ,
    AIS_CHANNEL_B_HZ,
    AIS_CENTER_HZ,
    GMSK_BT,
    PREAMBLE_NRZI,
    ChannelizerConfig,
    DeframerConfig,
    DemodConfig,
    ReceiverConfig,
    dual_channel_configs,
)
