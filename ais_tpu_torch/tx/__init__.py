from ais_tpu_torch.tx.frame import (  # noqa: F401
    aivdm_payload_to_bytes,
    frame_bits,
    make_packet_iq,
    nrzi_encode,
    stuff,
)
from ais_tpu_torch.tx.gmsk import (  # noqa: F401
    modulate_bits,
    modulate_symbols,
    preamble_waveform,
)
