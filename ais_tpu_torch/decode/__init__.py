from ais_tpu_torch.decode.crc import check_frame, crc16_x25, fcs_bytes  # noqa: F401
from ais_tpu_torch.decode.hdlc import Frame, deframe, find_flags, unstuff  # noqa: F401
from ais_tpu_torch.decode.nmea import (  # noqa: F401
    ascii_to_sixbit,
    frame_to_nmea,
    nmea_checksum,
    payload_to_sixbit,
    sixbit_to_ascii,
    to_sentences,
)
