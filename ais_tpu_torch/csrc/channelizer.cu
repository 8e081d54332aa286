// K5, K3, K4: decode -> periodic-carrier mix -> polyphase decimating FIR,
// one template whose decode prologue is its only difference.
//
// Replaces, in ais_tpu/ops/pallas_fir.py:
//   K5  pallas_freq_xlating_polyphase (body _chan_kernel): complex64 IQ;
//   K3  _pallas_wire_channelizer_ci1 (body _wire_kernel_ci1): ci1 bit
//       pairs, MSB-first I0 Q0 I1 Q1 I2 Q2 I3 Q3, levels +-1 (cd1 arrives
//       here after ci1_from_bytes_cd1);
//   K4  pallas_wire_channelizer, fmt ci2 / ci4 (body _wire_kernel):
//       ci2 bytes I0 Q0 I1 Q1 as 2-bit Lloyd-Max codes, MSB first; ci4
//       bytes (I << 4) | Q as 4-bit two's complement times 1/8.
//
// Computes, from the definition, for every channel c and output m:
//
//   y[c, m] = sum_{k < ntaps} h[k] * x[m*D + k] * car_c[(m*D + k) mod q]
//
// with x the decoded complex sample and car_c the baseband mixer rotated
// by the runtime start phase: a periodic table of q entries (q = 96 at
// +-25 kHz / 2.4 Msps) that the wrapper rotates once per call.  The TPU
// kernels' phase-major transposes, lane permutations (_WIRE_PERMS,
// _ci1_unit_perm), parity folds and anti-diagonal collapse exist for the
// MXU and are not carried over: samples are decoded in natural order.
//
// What bounds it on an H100: fp32 FMAs.  At the bench geometry (n_in ~
// 56.7 M samples, D = 50, 2891 taps, 2 channels) a call is ~2.6e10 flop;
// the float input is 453.5 MB, read about 1.9 times (tile halos), so
// the FMAs and not the bytes set the time.  Design: the mixed sample
// z_c[n] = x[n] * car_c[n] does not depend on m, so a block decodes and
// mixes its tile's span of (T - 1) * D + ntaps samples into shared
// memory once (every channel, float2) beside all the taps; then G
// threads share each of the T outputs, each summing every G-th tap
// (2 FMAs a channel a tap, fp32 IEEE throughout: the reference pins
// Precision.HIGHEST), and a warp shuffle adds the G partial sums.  With
// 256 threads a block, G = 4 and T = 64 at the bench geometry, a block
// takes ~108 KB, so two blocks share an SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct DecodeF32 {  // K5: complex64 samples
  static __device__ __forceinline__ float2 load(const void* src, long long n) {
    return static_cast<const float2*>(src)[n];
  }
};

struct DecodeCi1 {  // K3: 4 samples a byte, sample s at bits 7-2s (I), 6-2s (Q)
  static __device__ __forceinline__ float2 load(const void* src, long long n) {
    const unsigned b = static_cast<const uint8_t*>(src)[n >> 2];
    const int s = static_cast<int>(n & 3);
    const unsigned i = (b >> (7 - 2 * s)) & 1u;
    const unsigned q = (b >> (6 - 2 * s)) & 1u;
    return make_float2(i ? 1.0f : -1.0f, q ? 1.0f : -1.0f);
  }
};

// Lloyd-Max levels, as ais_tpu/ops/convert.py:CI2_INNER / CI2_OUTER.
__device__ __forceinline__ float ci2_level(unsigned c) {
  const float mag = (c == 0u || c == 3u) ? 1.5104f : 0.4528f;
  return c >= 2u ? mag : -mag;
}

struct DecodeCi2 {  // K4: 2 samples a byte, I0 Q0 I1 Q1 codes from the MSB
  static __device__ __forceinline__ float2 load(const void* src, long long n) {
    const unsigned b = static_cast<const uint8_t*>(src)[n >> 1];
    const int sh = (n & 1) ? 2 : 6;
    return make_float2(ci2_level((b >> sh) & 3u), ci2_level((b >> (sh - 2)) & 3u));
  }
};

struct DecodeCi4 {  // K4: one sample a byte, signed nibbles / 8
  static __device__ __forceinline__ float2 load(const void* src, long long n) {
    const int b = static_cast<const uint8_t*>(src)[n];
    int i = b >> 4, q = b & 15;
    i -= (i >= 8) ? 16 : 0;
    q -= (q >= 8) ? 16 : 0;
    return make_float2(static_cast<float>(i) * 0.125f, static_cast<float>(q) * 0.125f);
  }
};

template <class Decode, int NCH>
__global__ void __launch_bounds__(kThreads)
channelizer_kernel(const void* __restrict__ src,
                   const float2* __restrict__ car,    // (NCH, q), rotated
                   const float* __restrict__ taps,    // (ntaps,)
                   float2* __restrict__ out,          // (NCH, n_out)
                   long long n_in, int n_out, int ntaps, int decim, int q,
                   int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = kThreads / group;
  const int span = (tile - 1) * decim + ntaps;
  float2* s_z = reinterpret_cast<float2*>(smem);             // (NCH, span)
  float* s_taps = reinterpret_cast<float*>(s_z + NCH * span);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * tile;
  const long long n0 = static_cast<long long>(m0) * decim;
  const int ph0 = static_cast<int>(n0 % q);

  for (int i = tid; i < ntaps; i += kThreads) s_taps[i] = taps[i];
  // Decode and mix the tile's span once, for every channel.
  for (int i = tid; i < span; i += kThreads) {
    const long long n = n0 + i;
    const float2 x = n < n_in ? Decode::load(src, n) : make_float2(0.0f, 0.0f);
    const int ci = (ph0 + i) % q;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const float2 cv = car[c * q + ci];
      s_z[c * span + i] = make_float2(x.x * cv.x - x.y * cv.y, x.x * cv.y + x.y * cv.x);
    }
  }
  __syncthreads();

  const int o = tid / group;  // output of this thread within the tile
  const int g = tid % group;  // which of the output's G tap subsets
  const int m = m0 + o;

  float acc_re[NCH], acc_im[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc_re[c] = acc_im[c] = 0.0f;
  const int base = o * decim;
#pragma unroll 4
  for (int k = g; k < ntaps; k += group) {
    const float h = s_taps[k];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const float2 z = s_z[c * span + base + k];
      acc_re[c] = fmaf(h, z.x, acc_re[c]);
      acc_im[c] = fmaf(h, z.y, acc_im[c]);
    }
  }
  // The G threads of an output are adjacent lanes of one warp.
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    for (int off = group >> 1; off > 0; off >>= 1) {
      acc_re[c] += __shfl_xor_sync(0xffffffffu, acc_re[c], off);
      acc_im[c] += __shfl_xor_sync(0xffffffffu, acc_im[c], off);
    }
  }
  if (g != 0 || m >= n_out) return;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
    out[static_cast<long long>(c) * n_out + m] = make_float2(acc_re[c], acc_im[c]);
}

template <class Decode, int NCH>
int launch(const void* src, const float2* car, const float* taps, float2* out,
           long long n_in, int n_out, int ntaps, int decim, int q, int group,
           cudaStream_t stream) {
  const int tile = kThreads / group;
  const size_t smem = sizeof(float2) * NCH * ((tile - 1) * decim + ntaps) +
                      sizeof(float) * ntaps;
  auto kernel = channelizer_kernel<Decode, NCH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_out + tile - 1) / tile;
  kernel<<<blocks, kThreads, smem, stream>>>(src, car, taps, out, n_in, n_out,
                                             ntaps, decim, q, group);
  return static_cast<int>(cudaGetLastError());
}

template <class Decode>
int dispatch(const void* src, const void* car, const void* taps, void* out,
             long long n_in, int n_out, int ntaps, int decim, int q, int n_chan,
             int group, void* stream) {
  // G must divide a warp, so an output's partial sums meet by shuffles.
  if (group < 1 || group > 32 || (group & (group - 1)) || n_out <= 0 || q <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto c = static_cast<const float2*>(car);
  auto t = static_cast<const float*>(taps);
  auto o = static_cast<float2*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_chan) {
    case 1: return launch<Decode, 1>(src, c, t, o, n_in, n_out, ntaps, decim, q, group, s);
    case 2: return launch<Decode, 2>(src, c, t, o, n_in, n_out, ntaps, decim, q, group, s);
    case 3: return launch<Decode, 3>(src, c, t, o, n_in, n_out, ntaps, decim, q, group, s);
    case 4: return launch<Decode, 4>(src, c, t, o, n_in, n_out, ntaps, decim, q, group, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Every entry point: (input, rotated carrier (n_chan, q) float2, taps,
// out (n_chan, n_out) float2, n_in samples, n_out, ntaps, decim, q,
// n_chan, G threads an output, stream) -> cudaGetLastError().

extern "C" int ais_channelizer_f32(const void* x, const void* car, const void* taps,
                                   void* out, long long n_in, int n_out, int ntaps,
                                   int decim, int q, int n_chan, int group,
                                   void* stream) {
  return dispatch<DecodeF32>(x, car, taps, out, n_in, n_out, ntaps, decim, q, n_chan,
                             group, stream);
}

extern "C" int ais_wire_channelizer_ci1(const void* raw, const void* car,
                                        const void* taps, void* out, long long n_in,
                                        int n_out, int ntaps, int decim, int q,
                                        int n_chan, int group, void* stream) {
  return dispatch<DecodeCi1>(raw, car, taps, out, n_in, n_out, ntaps, decim, q, n_chan,
                             group, stream);
}

extern "C" int ais_wire_channelizer_ci2(const void* raw, const void* car,
                                        const void* taps, void* out, long long n_in,
                                        int n_out, int ntaps, int decim, int q,
                                        int n_chan, int group, void* stream) {
  return dispatch<DecodeCi2>(raw, car, taps, out, n_in, n_out, ntaps, decim, q, n_chan,
                             group, stream);
}

extern "C" int ais_wire_channelizer_ci4(const void* raw, const void* car,
                                        const void* taps, void* out, long long n_in,
                                        int n_out, int ntaps, int decim, int q,
                                        int n_chan, int group, void* stream) {
  return dispatch<DecodeCi4>(raw, car, taps, out, n_in, n_out, ntaps, decim, q, n_chan,
                             group, stream);
}
