/* The benchmark's wire encoders: 1-bit sigma-delta of a capture.

   cr1: real fs/4-IF stream, one bit a complex sample, 8 a byte, MSB
   first.  x[n] = Re(iq[n] j^n) (re, -im, -re, im), noise-shaped by
   NTF = 1 + a2 z^-2 + z^-4, whose zeros sit on the two AIS channels.
   ci1: first-order sigma-delta of I and Q, bytes I0 Q0 .. I3 Q3, MSB
   first.  Both clip the error to +-4 (1-bit overload stability).

   Build: cc -O2 -shared -fPIC (portbench/sdenc.py does it at first use). */
#include <stdint.h>

void pb_sigma_delta_cr1(const float* re, const float* im, int64_t n, float scale,
                        float a2, uint8_t* out) {
  float e1 = 0.0f, e2 = 0.0f, e3 = 0.0f, e4 = 0.0f;
  int64_t n_bytes = (n + 7) / 8;
  for (int64_t b = 0; b < n_bytes; ++b) {
    uint8_t byte = 0;
    for (int k = 0; k < 8; ++k) {
      int64_t s = 8 * b + k;
      int bit = 0;
      if (s < n) {
        float x;
        switch (s & 3) {
          case 0: x = re[s]; break;
          case 1: x = -im[s]; break;
          case 2: x = -re[s]; break;
          default: x = im[s]; break;
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

void pb_sigma_delta_ci1(const float* re, const float* im, int64_t n, float scale,
                        uint8_t* out) {
  float ei = 0.0f, eq = 0.0f;
  for (int64_t b = 0; b < n / 4; ++b) {
    uint8_t byte = 0;
    for (int k = 0; k < 4; ++k) {
      int64_t s = 4 * b + k;
      float si = re[s] * scale + ei;
      float sq = im[s] * scale + eq;
      int bi = si >= 0.0f, bq = sq >= 0.0f;
      ei = si - (bi ? 1.0f : -1.0f);
      eq = sq - (bq ? 1.0f : -1.0f);
      if (ei > 4.0f) ei = 4.0f; else if (ei < -4.0f) ei = -4.0f;
      if (eq > 4.0f) eq = 4.0f; else if (eq < -4.0f) eq = -4.0f;
      byte = (uint8_t)((byte << 2) | (bi << 1) | bq);
    }
    out[b] = byte;
  }
}
