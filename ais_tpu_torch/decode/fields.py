"""AIS message field parser: payload bytes -> typed Python fields.

The reference stops at the NMEA armoring boundary (its pdu_to_nmea emits
`!AIVDM` sentences, lib/pdu_to_nmea_impl.cc:99-125, and users bolt on an
external decoder); this module closes that gap so the framework is
usable end-to-end.  Field layouts per ITU-R M.1371-5 / the public AIVDM
catalogue:

  - types 1/2/3: Class A position report (nav status, ROT, SOG,
    position, COG, heading, UTC second)
  - type 4 (and 11): base-station report (UTC date/time, position)
  - type 5: static & voyage data (IMO, callsign, name, ship type,
    dimensions, draught, destination)
  - type 18: Class B position report
  - type 24: Class B static data, parts A and B

Anything else parses the common header (type / repeat / MMSI) and
reports the raw bit count.  All parsing is plain host-side integer work
on decoded payloads (a few hundred packets/s at full channel load —
nowhere near the tensor path).

Bit conventions: the payload byte stream is read MSB-first (the same
order `decode.nmea` armors it); signed fields are two's complement;
text fields use the 6-bit ASCII table (0..31 -> '@'..'_', 32..63 ->
' '..'?') with '@' meaning "unused" and trailing whitespace stripped.
"""

from __future__ import annotations

import numpy as np

# Scaling sentinels per ITU-R M.1371: "not available" markers.
LON_NA = 0x6791AC0   # 181 degrees
LAT_NA = 0x3412140   # 91 degrees
SOG_NA = 1023
COG_NA = 3600
HDG_NA = 511


def payload_bits(payload: bytes) -> np.ndarray:
    """Payload bytes -> MSB-first bit vector (uint8)."""
    return np.unpackbits(np.frombuffer(payload, dtype=np.uint8))


def _u(bits: np.ndarray, start: int, n: int) -> int:
    """Unsigned integer from bits[start : start+n] (0 if out of range)."""
    if start + n > bits.size:
        return 0
    out = 0
    for b in bits[start : start + n]:
        out = (out << 1) | int(b)
    return out


def _s(bits: np.ndarray, start: int, n: int) -> int:
    """Two's-complement signed integer."""
    x = _u(bits, start, n)
    return x - (1 << n) if x & (1 << (n - 1)) else x


def _text(bits: np.ndarray, start: int, n_chars: int) -> str:
    """6-bit ASCII string; '@' (0) terminates, trailing spaces stripped."""
    chars = []
    for i in range(n_chars):
        v = _u(bits, start + 6 * i, 6)
        if v == 0:  # '@' = end of string
            break
        chars.append(chr(v + 64) if v < 32 else chr(v))
    return "".join(chars).rstrip()


def _position(bits: np.ndarray, lon_at: int, lat_at: int) -> dict:
    lon_raw = _s(bits, lon_at, 28)
    lat_raw = _s(bits, lat_at, 27)
    return {
        "lon_deg": None if lon_raw == LON_NA else lon_raw / 600000.0,
        "lat_deg": None if lat_raw == LAT_NA else lat_raw / 600000.0,
    }


def _sog(raw: int) -> float | None:
    return None if raw == SOG_NA else raw / 10.0


def _cog(raw: int) -> float | None:
    return None if raw == COG_NA else raw / 10.0


def _hdg(raw: int) -> int | None:
    return None if raw == HDG_NA else raw


def parse_fields(payload: bytes) -> dict:
    """Decode an AIS payload's fields into a flat dict.

    Always contains `msg_type`, `repeat`, `mmsi`, and `n_bits`; the
    per-type fields documented in the module docstring are added when
    the type is known.  Unknown/truncated messages degrade to the
    header, never raise.
    """
    bits = payload_bits(payload)
    msg_type = _u(bits, 0, 6)
    out = {
        "msg_type": msg_type,
        "repeat": _u(bits, 6, 2),
        "mmsi": _u(bits, 8, 30),
        "n_bits": int(bits.size),
    }
    if msg_type in (1, 2, 3) and bits.size >= 144:
        rot_raw = _s(bits, 42, 8)
        out.update(
            nav_status=_u(bits, 38, 4),
            # ROT sensor value: +-(val/4.733)^2 deg/min, -128 = n/a.
            rot_deg_min=(
                None
                if rot_raw == -128
                else round(
                    (1 if rot_raw >= 0 else -1) * (abs(rot_raw) / 4.733) ** 2, 1
                )
            ),
            sog_kn=_sog(_u(bits, 50, 10)),
            position_accuracy=_u(bits, 60, 1),
            **_position(bits, 61, 89),
            cog_deg=_cog(_u(bits, 116, 12)),
            heading_deg=_hdg(_u(bits, 128, 9)),
            utc_second=_u(bits, 137, 6),
        )
    elif msg_type in (4, 11) and bits.size >= 144:
        out.update(
            year=_u(bits, 38, 14) or None,
            month=_u(bits, 52, 4) or None,
            day=_u(bits, 56, 5) or None,
            hour=_u(bits, 61, 5),
            minute=_u(bits, 66, 6),
            second=_u(bits, 72, 6),
            position_accuracy=_u(bits, 78, 1),
            **_position(bits, 79, 107),
            epfd=_u(bits, 134, 4),
        )
    elif msg_type == 5 and bits.size >= 420:
        out.update(
            ais_version=_u(bits, 38, 2),
            imo=_u(bits, 40, 30),
            callsign=_text(bits, 70, 7),
            shipname=_text(bits, 112, 20),
            ship_type=_u(bits, 232, 8),
            to_bow_m=_u(bits, 240, 9),
            to_stern_m=_u(bits, 249, 9),
            to_port_m=_u(bits, 258, 6),
            to_starboard_m=_u(bits, 264, 6),
            epfd=_u(bits, 270, 4),
            eta_month=_u(bits, 274, 4) or None,
            eta_day=_u(bits, 278, 5) or None,
            eta_hour=_u(bits, 283, 5),
            eta_minute=_u(bits, 288, 6),
            draught_m=_u(bits, 294, 8) / 10.0,
            destination=_text(bits, 302, 20),
        )
    elif msg_type == 18 and bits.size >= 168:
        out.update(
            sog_kn=_sog(_u(bits, 46, 10)),
            position_accuracy=_u(bits, 56, 1),
            **_position(bits, 57, 85),
            cog_deg=_cog(_u(bits, 112, 12)),
            heading_deg=_hdg(_u(bits, 124, 9)),
            utc_second=_u(bits, 133, 6),
        )
    elif msg_type == 24 and bits.size >= 160:
        part = _u(bits, 38, 2)
        out["part"] = part
        if part == 0:
            out["shipname"] = _text(bits, 40, 20)
        elif part == 1:
            out.update(
                ship_type=_u(bits, 40, 8),
                vendor_id=_text(bits, 48, 3),
                callsign=_text(bits, 90, 7),
                to_bow_m=_u(bits, 132, 9),
                to_stern_m=_u(bits, 141, 9),
                to_port_m=_u(bits, 150, 6),
                to_starboard_m=_u(bits, 156, 6),
            )
    return out


def format_fields(fields: dict) -> str:
    """One-line human-readable rendering for the CLI's --decode flag."""
    parts = [f"type={fields['msg_type']}", f"mmsi={fields['mmsi']}"]
    if fields.get("lat_deg") is not None:
        parts.append(f"pos={fields['lat_deg']:.5f},{fields['lon_deg']:.5f}")
    for key, fmt in (
        ("sog_kn", "sog={:.1f}kn"),
        ("cog_deg", "cog={:.1f}"),
        ("heading_deg", "hdg={}"),
        ("shipname", "name={!r}"),
        ("callsign", "callsign={!r}"),
        ("destination", "dest={!r}"),
        ("draught_m", "draught={}m"),
    ):
        v = fields.get(key)
        if v not in (None, ""):
            parts.append(fmt.format(v))
    return " ".join(parts)
