// ais_native — native runtime kernels for the host half of the receiver.
//
// The reference implements its byte-rate path in C++ GNU Radio blocks
// (hdlc_deframer_bp upstream; pdu_to_nmea in lib/pdu_to_nmea_impl.cc).
// This library provides the same capabilities as a plain C ABI consumed
// via ctypes (no pybind11 in this environment):
//
//   - iq_convert_*: interleaved integer IQ -> complex64 (SDR ingest,
//     reference python/radio.py:151-215 source formats)
//   - crc16_x25: HDLC frame check sequence
//   - hdlc_deframe: flag search + unstuff + CRC over an unpacked bit
//     buffer, emitting payload spans (the hot part of the host back half
//     when burst counts are large)
//
// Build: cc -O3 -shared -fPIC ais_native.cpp -o libais_native.so

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------- IQ ----

void iq_convert_i16(const int16_t* in, float* out, int64_t n_complex,
                    float scale) {
  for (int64_t i = 0; i < 2 * n_complex; ++i) out[i] = in[i] * scale;
}

void iq_convert_i8(const int8_t* in, float* out, int64_t n_complex,
                   float scale) {
  for (int64_t i = 0; i < 2 * n_complex; ++i) out[i] = in[i] * scale;
}

void iq_convert_u8(const uint8_t* in, float* out, int64_t n_complex,
                   float offset, float scale) {
  for (int64_t i = 0; i < 2 * n_complex; ++i)
    out[i] = (in[i] - offset) * scale;
}

// First-order sigma-delta 1-bit encode of interleaved float IQ into the
// ci1 wire format: 4 complex samples per byte, bit layout MSB-first
// I0 Q0 I1 Q1 I2 Q2 I3 Q3.  Two independent noise-shaping loops (I, Q);
// the quantizer level is 1.0 in the scaled domain (caller pre-scales by
// gain/rms).  The AIS channels occupy < +/-36 kHz of a 2.4 Msps capture
// (OSR ~ 33), so first-order shaping moves the 1-bit quantization noise
// above the channelizer's 11 kHz low-pass: full-load content parity
// stays 1.0 where plain 1-bit hard limiting loses >3% of packets.
// Integrator clipped to +/-4 for overload stability.  n_complex % 4 == 0.
void sigma_delta_ci1(const float* iq, int64_t n_complex, float scale,
                     uint8_t* out) {
  float ei = 0.0f, eq = 0.0f;
  for (int64_t b = 0; b < n_complex / 4; ++b) {
    uint8_t byte = 0;
    for (int k = 0; k < 4; ++k) {
      int64_t s = 4 * b + k;
      float si = iq[2 * s] * scale + ei;
      float sq = iq[2 * s + 1] * scale + eq;
      int bi = si >= 0.0f;
      int bq = sq >= 0.0f;
      ei = si - (bi ? 1.0f : -1.0f);
      eq = sq - (bq ? 1.0f : -1.0f);
      if (ei > 4.0f) ei = 4.0f; else if (ei < -4.0f) ei = -4.0f;
      if (eq > 4.0f) eq = 4.0f; else if (eq < -4.0f) eq = -4.0f;
      byte = (uint8_t)((byte << 2) | (bi << 1) | bq);
    }
    out[b] = byte;
  }
}

// Second-order BANDPASS sigma-delta 1-bit encode of complex IQ into the
// cr1 wire format: 8 REAL samples per byte (1 bit per complex input
// sample), MSB-first in time.  The encoder shifts the complex baseband
// to an fs/4 IF (multiply by j^n: Re(iq*j^n) cycles re, -im, -re, im)
// and noise-shapes the 1-bit quantization error with NTF = (1+z^-2)^2 —
// zeros at +/-fs/4, so the error feedback uses the 2- and 4-delayed
// terms: si = x[n] - 2 e[n-2] - e[n-4].  The decoder downconverts by
// (-j)^n back to baseband; the mirror sideband lands at fs/2 where the
// channelizer low-pass removes it (ops/convert.py:iq_from_bytes_cr1).
// Error terms clipped to +/-4 for 1-bit overload stability (same
// discipline as sigma_delta_ci1).  Trailing bits of the last byte (when
// n_complex % 8 != 0) are zero-padded.
void sigma_delta_cr1(const float* iq, int64_t n_complex, float scale,
                     float a2, uint8_t* out) {
  float e1 = 0.0f, e2 = 0.0f, e3 = 0.0f, e4 = 0.0f;
  int64_t n_bytes = (n_complex + 7) / 8;
  for (int64_t b = 0; b < n_bytes; ++b) {
    uint8_t byte = 0;
    for (int k = 0; k < 8; ++k) {
      int64_t s = 8 * b + k;
      int bit = 0;
      if (s < n_complex) {
        float x;
        switch (s & 3) {  // Re(iq[s] * j^s)
          case 0: x = iq[2 * s]; break;
          case 1: x = -iq[2 * s + 1]; break;
          case 2: x = -iq[2 * s]; break;
          default: x = iq[2 * s + 1]; break;
        }
        float si = x * scale - a2 * e2 - e4;
        bit = si >= 0.0f;
        float e0 = si - (bit ? 1.0f : -1.0f);
        if (e0 > 4.0f) e0 = 4.0f; else if (e0 < -4.0f) e0 = -4.0f;
        e4 = e3; e3 = e2; e2 = e1; e1 = e0;
      }
      byte = (uint8_t)((byte << 1) | bit);
    }
    out[b] = byte;
  }
}

// --------------------------------------------------------------- CRC ----

static uint16_t crc_table[256];
static bool crc_ready = false;

static void crc_init() {
  for (int b = 0; b < 256; ++b) {
    uint16_t crc = (uint16_t)b;
    for (int k = 0; k < 8; ++k)
      crc = (crc & 1) ? (uint16_t)((crc >> 1) ^ 0x8408) : (uint16_t)(crc >> 1);
    crc_table[b] = crc;
  }
  crc_ready = true;
}

uint16_t crc16_x25(const uint8_t* data, int64_t len) {
  if (!crc_ready) crc_init();
  uint16_t crc = 0xFFFF;
  for (int64_t i = 0; i < len; ++i)
    crc = (uint16_t)((crc >> 8) ^ crc_table[(crc ^ data[i]) & 0xFF]);
  return (uint16_t)(crc ^ 0xFFFF);
}

// -------------------------------------------------------------- HDLC ----

// Core deframe over unpacked bits (values 0/1); shared by the
// single-burst and batched entry points below.  Frames whose unstuffed
// content is octet-aligned, within [min_len, max_len] payload octets
// (FCS excluded) and CRC-valid are written into `payload_out` starting
// at *payload_used; `frame_lens[i]` and `frame_starts[i]` (bit index of
// the opening flag) describe frame i from slot *n_frames_io onward.
// Mirrors ais_tpu_torch.decode.hdlc.deframe.
static void deframe_core(const uint8_t* bits, int64_t n_bits,
                         int32_t min_len, int32_t max_len,
                         uint8_t* payload_out, int64_t payload_capacity,
                         int32_t* frame_lens, int64_t* frame_starts,
                         int32_t max_frames, int32_t* n_frames_io,
                         int64_t* payload_used_io) {
  if (!crc_ready) crc_init();
  int32_t n_frames = *n_frames_io;
  int64_t payload_used = *payload_used_io;
  // State machine: hunt for flag, then collect bits with unstuffing until
  // the closing flag; every flag both closes one frame and opens the next.
  uint8_t shift = 0;         // last 8 bits, newest in LSB? keep MSB-first
  int64_t last_flag = -1;
  // candidate buffer: max stuffed span we care about
  const int64_t kMaxSpan = 8LL * (max_len + 2) * 2 + 64;
  uint8_t frame_bytes[8192];
  for (int64_t i = 0; i + 8 <= n_bits; ++i) {
    // flag = 0 1 1 1 1 1 1 0 in transmission order
    if (!(bits[i] == 0 && bits[i + 1] == 1 && bits[i + 2] == 1 &&
          bits[i + 3] == 1 && bits[i + 4] == 1 && bits[i + 5] == 1 &&
          bits[i + 6] == 1 && bits[i + 7] == 0))
      continue;
    if (last_flag >= 0 && i - last_flag > 16 && i - last_flag < kMaxSpan) {
      // candidate body: bits (last_flag+8 .. i)
      int64_t start = last_flag + 8, end = i;
      int ones = 0;
      int64_t nb = 0;
      bool bad = false;
      std::memset(frame_bytes, 0, sizeof(frame_bytes));
      for (int64_t j = start; j < end && !bad; ++j) {
        if (bits[j]) {
          ++ones;
          if (ones > 5) { bad = true; break; }
          frame_bytes[nb >> 3] |= (uint8_t)(1u << (nb & 7));  // LSB-first
          ++nb;
        } else {
          if (ones == 5) { ones = 0; continue; }  // stuffed zero
          ones = 0;
          ++nb;
        }
        if ((nb >> 3) >= (int64_t)sizeof(frame_bytes)) bad = true;
      }
      if (!bad && nb % 8 == 0) {
        int64_t nbytes = nb / 8;
        int64_t payload_len = nbytes - 2;
        if (payload_len >= min_len && payload_len <= max_len) {
          uint16_t crc = crc16_x25(frame_bytes, payload_len);
          uint16_t fcs = (uint16_t)(frame_bytes[payload_len] |
                                    (frame_bytes[payload_len + 1] << 8));
          if (crc == fcs && n_frames < max_frames &&
              payload_used + payload_len <= payload_capacity) {
            std::memcpy(payload_out + payload_used, frame_bytes,
                        (size_t)payload_len);
            frame_lens[n_frames] = (int32_t)payload_len;
            frame_starts[n_frames] = last_flag;
            payload_used += payload_len;
            ++n_frames;
          }
        }
      }
    }
    last_flag = i;
  }
  (void)shift;
  *n_frames_io = n_frames;
  *payload_used_io = payload_used;
}

int32_t hdlc_deframe(const uint8_t* bits, int64_t n_bits, int32_t min_len,
                     int32_t max_len, uint8_t* payload_out,
                     int64_t payload_capacity, int32_t* frame_lens,
                     int64_t* frame_starts, int32_t max_frames) {
  int32_t n_frames = 0;
  int64_t payload_used = 0;
  deframe_core(bits, n_bits, min_len, max_len, payload_out,
               payload_capacity, frame_lens, frame_starts, max_frames,
               &n_frames, &payload_used);
  return n_frames;
}

// Batched deframe straight from the wire-record PACKED bit planes
// (pipeline/wideband.py:pack_wire_flat layout): `packed` is
// (n_lanes, 2, n_pack) uint8 with plane 0 = bits, plane 1 = bit-valid,
// MSB-first within each byte; `lanes` lists the flat lane indices whose
// valid flag was set.  For each listed lane the valid bits are
// compressed and deframed; `frame_lane[i]` records which entry of
// `lanes` produced frame i (frame_starts stay in compressed-bit
// coordinates, identical to the per-burst path).  ONE ctypes call per
// collect() replaces ~400 per-burst calls whose marshalling dominated
// the host back half at full channel load.
int32_t hdlc_deframe_packed_batch(
    const uint8_t* packed, const int32_t* lanes, int32_t n_lanes,
    int32_t n_pack, int32_t n_sym, int32_t min_len, int32_t max_len,
    uint8_t* payload_out, int64_t payload_capacity, int32_t* frame_lens,
    int64_t* frame_starts, int32_t* frame_lane, int32_t max_frames) {
  int32_t n_frames = 0;
  int64_t payload_used = 0;
  uint8_t bits[65536];
  if (n_sym > (int32_t)sizeof(bits)) return -1;
  for (int32_t li = 0; li < n_lanes; ++li) {
    const uint8_t* bp = packed + (int64_t)lanes[li] * 2 * n_pack;
    const uint8_t* vp = bp + n_pack;
    int64_t nb = 0;
    for (int32_t j = 0; j < n_sym; ++j) {
      uint8_t mask = (uint8_t)(0x80u >> (j & 7));
      if (vp[j >> 3] & mask) bits[nb++] = (bp[j >> 3] & mask) ? 1 : 0;
    }
    int32_t before = n_frames;
    deframe_core(bits, nb, min_len, max_len, payload_out,
                 payload_capacity, frame_lens, frame_starts, max_frames,
                 &n_frames, &payload_used);
    for (int32_t f = before; f < n_frames; ++f) frame_lane[f] = li;
  }
  return n_frames;
}

}  // extern "C"
