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
//     buffer, emitting payload spans; hdlc_deframe_packed_batch and
//     hdlc_deframe_rows, the same over every burst of a record fetch in
//     one call (the hot part of the host back half when burst counts are
//     large)
//
// Build: cc -O3 -shared -fPIC ais_native.cpp -o libais_native.so

#include <cstdint>
#include <cstring>
#include <vector>

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

// Every deframe entry point turns its input into a packed bit stream and
// deframes it with `deframe_words`.  A stream is held in 64-bit words,
// most significant bit first (stream bit q is bit 63 - (q & 63) of word
// q >> 6, the order of the device's packed planes), and every bit past
// the stream's end is zero, with two zero words after the last one.
// Flags, six-one aborts and stuffed zeros are found 64 positions at a
// time with shifts and masks, so no loop branches on the value of a bit.

// Bits a stream entry may hold (the batched entries' limit).
static const int32_t kMaxStreamBits = 65536;

namespace {

struct ReverseTable {
  uint8_t t[256];
  constexpr ReverseTable() : t() {
    for (int b = 0; b < 256; ++b) {
      int r = 0;
      for (int k = 0; k < 8; ++k) r |= ((b >> k) & 1) << (7 - k);
      t[b] = (uint8_t)r;
    }
  }
};
constexpr ReverseTable kReverse;  // MSB-first byte -> LSB-first (HDLC order)

inline int clz64(uint64_t x) { return __builtin_clzll(x); }

// The top n bits set (0 <= n <= 64).
inline uint64_t top_bits(int64_t n) {
  return n <= 0 ? 0 : n >= 64 ? ~0ULL : ~(~0ULL >> n);
}

// The 64 stream bits from bit q on, bit q in the MSB.
inline uint64_t bits_at(const uint64_t* w, int64_t q) {
  const int64_t i = q >> 6;
  const int s = (int)(q & 63);
  return (w[i] << s) | ((w[i + 1] >> 1) >> (63 - s));
}

inline uint64_t load_be64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
#if __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  v = __builtin_bswap64(v);
#endif
  return v;
}

// Windows of six bits starting at p0 .. p0 + 63: `six` where all six are
// ones, `stuffed` where five ones are followed by a zero (MSB = p0).
inline void run_masks(const uint64_t* w, int64_t p0, uint64_t* six,
                      uint64_t* stuffed) {
  const uint64_t five = bits_at(w, p0) & bits_at(w, p0 + 1) &
                        bits_at(w, p0 + 2) & bits_at(w, p0 + 3) &
                        bits_at(w, p0 + 4);
  const uint64_t last = bits_at(w, p0 + 5);
  *six = five & last;
  *stuffed = five & ~last;
}

struct FrameSink {
  int32_t min_len, max_len;
  uint8_t* payload_out;
  int64_t payload_capacity;
  int64_t* frame_offsets;  // may be null
  int32_t* frame_lens;
  int64_t* frame_starts;
  int32_t max_frames;
  int32_t n_frames;
  int64_t payload_used;
};

// The candidate between the flag at `flag` and the next one at `end`:
// body bits [flag + 8, end).  Accepted when it holds no six ones in a
// row, unstuffs to whole octets, carries [min_len, max_len] payload
// octets and its CRC-16/X.25 matches the FCS.
void candidate(const uint64_t* w, int64_t flag, int64_t end, FrameSink* out) {
  const int64_t s = flag + 8;
  // A stuffed zero at q is the last bit of a window 11111 0 at q - 5;
  // windows that start before s hold the flag's closing zero.
  int64_t n_stuffed = 0;
  for (int64_t p0 = s; p0 <= end - 6; p0 += 64) {
    uint64_t six, stuffed;
    run_masks(w, p0, &six, &stuffed);
    const uint64_t inside = top_bits(end - 5 - p0);
    if (six & inside) return;
    n_stuffed += __builtin_popcountll(stuffed & inside);
  }
  const int64_t nb = end - s - n_stuffed;
  // The frame buffer's limit: 8192 octets.
  if ((nb & 7) || nb >= 8 * 8192) return;
  const int64_t payload_len = nb / 8 - 2;
  if (payload_len < out->min_len || payload_len > out->max_len) return;

  uint8_t frame[8192];
  int64_t nbytes = 0;
  uint64_t acc = 0;  // pending bits, MSB-aligned
  int nacc = 0;
  auto put = [&](int64_t a, int64_t b) {  // append stream bits [a, b)
    while (a < b) {
      const int n = (int)((b - a) < 56 ? (b - a) : 56);
      acc |= (bits_at(w, a) & top_bits(n)) >> nacc;
      nacc += n;
      a += n;
      while (nacc >= 8) {
        frame[nbytes++] = kReverse.t[acc >> 56];
        acc <<= 8;
        nacc -= 8;
      }
    }
  };
  int64_t cur = s;
  for (int64_t p0 = s; p0 <= end - 6; p0 += 64) {
    uint64_t six, stuffed;
    run_masks(w, p0, &six, &stuffed);
    stuffed &= top_bits(end - 5 - p0);
    while (stuffed) {
      const int j = clz64(stuffed);
      const int64_t q = p0 + j + 5;
      put(cur, q);
      cur = q + 1;
      stuffed &= ~(0x8000000000000000ULL >> j);
    }
  }
  put(cur, end);

  const uint16_t crc = crc16_x25(frame, payload_len);
  const uint16_t fcs =
      (uint16_t)(frame[payload_len] | (frame[payload_len + 1] << 8));
  if (crc != fcs || out->n_frames >= out->max_frames ||
      out->payload_used + payload_len > out->payload_capacity)
    return;
  std::memcpy(out->payload_out + out->payload_used, frame, (size_t)payload_len);
  if (out->frame_offsets) out->frame_offsets[out->n_frames] = out->payload_used;
  out->frame_lens[out->n_frames] = (int32_t)payload_len;
  out->frame_starts[out->n_frames] = flag;
  out->payload_used += payload_len;
  ++out->n_frames;
}

// Deframe one stream of n_bits bits.  Every flag (0 1 1 1 1 1 1 0 in
// transmission order) closes the candidate the previous flag opened and
// opens the next; a candidate is tried when the flags lie more than 16
// and fewer than kMaxSpan bits apart.  Frames go to `out` with the bit
// index of their opening flag.  Mirrors ais_tpu_torch.decode.hdlc.deframe.
void deframe_words(const uint64_t* w, int64_t n_bits, FrameSink* out) {
  if (!crc_ready) crc_init();
  const int64_t kMaxSpan = 8LL * (out->max_len + 2) * 2 + 64;
  int64_t last_flag = -1;
  for (int64_t p0 = 0; p0 + 8 <= n_bits; p0 += 64) {
    const uint64_t x = w[p0 >> 6], nx = w[(p0 >> 6) + 1];
    uint64_t m = ~x & ~((x << 7) | (nx >> 57));
    for (int k = 1; k < 7; ++k) m &= (x << k) | (nx >> (64 - k));
    m &= top_bits(n_bits - 7 - p0);  // the whole flag inside the stream
    while (m) {
      const int j = clz64(m);
      const int64_t p = p0 + j;
      if (last_flag >= 0 && p - last_flag > 16 && p - last_flag < kMaxSpan)
        candidate(w, last_flag, p, out);
      last_flag = p;
      m &= ~(0x8000000000000000ULL >> j);
    }
  }
}

inline int64_t stream_words(int64_t n_bits) { return ((n_bits + 63) >> 6) + 2; }

// One byte a bit (nonzero = 1) into the stream words `w`, which hold
// stream_words(n_bits) zeros.  Eight bytes a step: each byte's nonzero
// test lands in its top bit, and one multiply gathers the eight top
// bits into a byte, the first bit in its MSB.
void pack_byte_bits(const uint8_t* bits, int64_t n_bits, uint64_t* w) {
  const uint64_t kLow7 = 0x7F7F7F7F7F7F7F7FULL;
  const int64_t n8 = n_bits >> 3;
  for (int64_t i = 0; i < n8; ++i) {
    uint64_t v;
    std::memcpy(&v, bits + 8 * i, 8);
#if __BYTE_ORDER__ != __ORDER_LITTLE_ENDIAN__
    v = __builtin_bswap64(v);
#endif
    const uint64_t nz = ((((v & kLow7) + kLow7) | v) >> 7) & 0x0101010101010101ULL;
    w[i >> 3] |= ((nz * 0x8040201008040201ULL) >> 56) << (56 - 8 * (i & 7));
  }
  for (int64_t i = 8 * n8; i < n_bits; ++i)
    w[i >> 6] |= (uint64_t)(bits[i] != 0) << (63 - (i & 63));
}

}  // namespace

int32_t hdlc_deframe(const uint8_t* bits, int64_t n_bits, int32_t min_len,
                     int32_t max_len, uint8_t* payload_out,
                     int64_t payload_capacity, int32_t* frame_lens,
                     int64_t* frame_starts, int32_t max_frames) {
  // A burst's stream fits the stack buffer; a longer one takes the heap.
  uint64_t stack_w[kMaxStreamBits / 64 + 2];
  std::vector<uint64_t> heap_w;
  uint64_t* w = stack_w;
  if (n_bits > kMaxStreamBits) {
    heap_w.resize((size_t)stream_words(n_bits));
    w = heap_w.data();
  }
  std::memset(w, 0, sizeof(uint64_t) * (size_t)stream_words(n_bits));
  pack_byte_bits(bits, n_bits, w);
  FrameSink out{min_len, max_len, payload_out, payload_capacity, nullptr,
                frame_lens, frame_starts, max_frames, 0, 0};
  deframe_words(w, n_bits, &out);
  return out.n_frames;
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
  if (n_sym > kMaxStreamBits) return -1;
  uint64_t w[kMaxStreamBits / 64 + 2];
  FrameSink out{min_len, max_len, payload_out, payload_capacity, nullptr,
                frame_lens, frame_starts, max_frames, 0, 0};
  for (int32_t li = 0; li < n_lanes; ++li) {
    const uint8_t* bp = packed + (int64_t)lanes[li] * 2 * n_pack;
    const uint8_t* vp = bp + n_pack;
    int64_t nb = 0;
    std::memset(w, 0, sizeof(uint64_t) * (size_t)stream_words(n_sym));
    for (int32_t j = 0; j < n_sym; ++j) {
      const uint8_t mask = (uint8_t)(0x80u >> (j & 7));
      if (vp[j >> 3] & mask) {
        w[nb >> 6] |= (uint64_t)((bp[j >> 3] & mask) != 0) << (63 - (nb & 63));
        ++nb;
      }
    }
    const int32_t before = out.n_frames;
    deframe_words(w, nb, &out);
    for (int32_t f = before; f < out.n_frames; ++f) frame_lane[f] = li;
  }
  return out.n_frames;
}

// Batched deframe straight from a wire fetch's rows
// (pipeline/wideband.py:WireRows; byte 24 of a pack_wire_compact row,
// byte 0 of pack_wire_flat's bit plane): `rows` is (n_rows, row_bytes)
// uint8, each row's packed bit plane (n_sym bits, MSB-first) starting
// at byte `plane_offset`, and the row's valid bits
// the run [first[r], first[r] + count[r]) clipped to [0, n_sym).  The
// run is realigned into a stream a word at a time and deframed; frame i
// is row `frame_row[i]`'s, its payload at `frame_offsets[i]` in
// `payload_out`, its start bit counted from the run's first bit (the
// compressed-bit coordinates of `hdlc_deframe_packed_batch`).  Returns
// the frame count, or -1 where a row cannot hold n_sym bits or n_sym
// exceeds kMaxStreamBits.
int32_t hdlc_deframe_rows(
    const uint8_t* rows, int32_t n_rows, int32_t row_bytes,
    int32_t plane_offset, int32_t n_sym, const int32_t* first,
    const int32_t* count, int32_t min_len, int32_t max_len,
    uint8_t* payload_out, int64_t payload_capacity, int64_t* frame_offsets,
    int32_t* frame_lens, int64_t* frame_starts, int32_t* frame_row,
    int32_t max_frames) {
  const int32_t n_pack = (n_sym + 7) / 8;
  if (n_sym < 0 || n_sym > kMaxStreamBits || plane_offset < 0 ||
      plane_offset + n_pack > row_bytes)
    return -1;
  // Each row: its plane as words, then the run realigned to bit 0.
  uint8_t plane[kMaxStreamBits / 8 + 24];
  uint64_t pw[kMaxStreamBits / 64 + 3];
  uint64_t w[kMaxStreamBits / 64 + 2];
  const int32_t n_pw = (n_pack + 7) / 8 + 2;
  std::memset(plane + n_pack, 0, 24);
  FrameSink out{min_len, max_len, payload_out, payload_capacity, frame_offsets,
                frame_lens, frame_starts, max_frames, 0, 0};
  for (int32_t r = 0; r < n_rows; ++r) {
    const int64_t a = first[r] > 0 ? first[r] : 0;
    const int64_t b_raw = (int64_t)first[r] + count[r];
    const int64_t b = b_raw < n_sym ? b_raw : n_sym;
    const int64_t n = b > a ? b - a : 0;
    if (n < 8) continue;  // no room for a flag
    std::memcpy(plane, rows + (int64_t)r * row_bytes + plane_offset, (size_t)n_pack);
    for (int32_t i = 0; i < n_pw; ++i) pw[i] = load_be64(plane + 8 * i);
    const int64_t last = (n - 1) >> 6;
    for (int64_t i = 0; i <= last; ++i) w[i] = bits_at(pw, a + 64 * i);
    w[last] &= top_bits(n - 64 * last);
    w[last + 1] = w[last + 2] = 0;
    const int32_t before = out.n_frames;
    deframe_words(w, n, &out);
    for (int32_t f = before; f < out.n_frames; ++f) frame_row[f] = r;
  }
  return out.n_frames;
}

}  // extern "C"
