// K1: cr1 wire channelizer — packed 1-bit real samples -> per-channel
// decimated complex baseband, in one pass.
//
// Replaces ais_tpu/ops/pallas_fir.py:_pallas_wire_channelizer_cr1 (body
// _wire_kernel_cr1), the TPU kernel on the reference's main path.
//
// Computes, from the definition, for every channel c and output m:
//
//   y[c, m] = sum_{k < ntaps} h[k] * s[m*D + k] * car_c[(m*D + k) mod q]
//
// with s[n] = +1/-1 from bit n of the wire (8 samples a byte, MSB first)
// and car_c the IF-folded mixer e^{-j2pi(off_c + fs/4) n / fs} rotated by
// the runtime start phase — a periodic table of q entries (q = 96 at the
// standard +-25 kHz / 2.4 Msps geometry) that the wrapper rotates once
// per call.  The TPU kernel's R=4 parity folds, lane permutation and
// anti-diagonal collapse exist for the MXU and are not carried over.
//
// What bounds it on an H100: fp32 FMAs.  At the bench geometry (n_in ~
// 56.7 M samples, D = 50, 2891 taps, 2 channels) one call is ~2.6e10
// flop for 7 MB of wire bytes, so it is compute-bound on the CUDA cores.
// Design: one thread block per tile of T = 128 outputs; the tile's wire
// bytes (~1.2 KB), all taps (11.6 KB) and the carrier table (1.5 KB)
// are staged in shared memory, and each thread accumulates one output
// for every channel in registers.  s = +-1 becomes a sign flip of the
// tap, so a tap costs one select and 2 FMAs per channel.  Precision is
// fp32 IEEE throughout (the reference pins Precision.HIGHEST).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;  // outputs (= threads) per block

template <int NCH>
__global__ void __launch_bounds__(kTile)
wire_channelizer_cr1_kernel(const uint8_t* __restrict__ raw,
                            const float2* __restrict__ car,   // (NCH, q)
                            const float* __restrict__ taps,   // (ntaps,)
                            float2* __restrict__ out,         // (NCH, n_out)
                            int n_bytes, int n_out, int ntaps, int decim,
                            int q) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* s_car = reinterpret_cast<float2*>(smem);
  float* s_taps = reinterpret_cast<float*>(s_car + NCH * q);
  uint8_t* s_bytes = reinterpret_cast<uint8_t*>(s_taps + ntaps);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kTile;
  // kTile * decim is a multiple of 8, so every tile starts on a byte.
  const long long byte0 = (static_cast<long long>(m0) * decim) >> 3;
  const int tile_bytes = ((kTile - 1) * decim + ntaps + 7) >> 3;

  for (int i = tid; i < NCH * q; i += kTile) s_car[i] = car[i];
  for (int i = tid; i < ntaps; i += kTile) s_taps[i] = taps[i];
  for (int i = tid; i < tile_bytes; i += kTile) {
    const long long b = byte0 + i;
    s_bytes[i] = b < n_bytes ? raw[b] : 0;
  }
  __syncthreads();

  const int m = m0 + tid;
  if (m >= n_out) return;

  float acc_re[NCH], acc_im[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) acc_re[c] = acc_im[c] = 0.0f;

  int bit = tid * decim;  // sample index within the tile
  int ci = static_cast<int>((static_cast<long long>(m) * decim) % q);
#pragma unroll 4
  for (int k = 0; k < ntaps; ++k, ++bit) {
    const int b = (s_bytes[bit >> 3] >> (7 - (bit & 7))) & 1;
    const float h = b ? s_taps[k] : -s_taps[k];
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const float2 cv = s_car[c * q + ci];
      acc_re[c] = fmaf(h, cv.x, acc_re[c]);
      acc_im[c] = fmaf(h, cv.y, acc_im[c]);
    }
    if (++ci == q) ci = 0;
  }
#pragma unroll
  for (int c = 0; c < NCH; ++c)
    out[static_cast<long long>(c) * n_out + m] = make_float2(acc_re[c], acc_im[c]);
}

template <int NCH>
int launch(const uint8_t* raw, const float2* car, const float* taps, float2* out,
           int n_bytes, int n_out, int ntaps, int decim, int q,
           cudaStream_t stream) {
  const size_t smem = sizeof(float2) * NCH * q + sizeof(float) * ntaps +
                      (((kTile - 1) * decim + ntaps + 7) >> 3);
  auto kernel = wire_channelizer_cr1_kernel<NCH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_out + kTile - 1) / kTile;
  kernel<<<blocks, kTile, smem, stream>>>(raw, car, taps, out, n_bytes, n_out,
                                          ntaps, decim, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ais_wire_channelizer_cr1(const void* raw, const void* car,
                                        const void* taps, void* out,
                                        int n_bytes, int n_out, int ntaps,
                                        int decim, int q, int n_chan,
                                        void* stream) {
  if ((kTile * decim) % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto r = static_cast<const uint8_t*>(raw);
  auto c = static_cast<const float2*>(car);
  auto t = static_cast<const float*>(taps);
  auto o = static_cast<float2*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_chan) {
    case 1: return launch<1>(r, c, t, o, n_bytes, n_out, ntaps, decim, q, s);
    case 2: return launch<2>(r, c, t, o, n_bytes, n_out, ntaps, decim, q, s);
    case 3: return launch<3>(r, c, t, o, n_bytes, n_out, ntaps, decim, q, s);
    case 4: return launch<4>(r, c, t, o, n_bytes, n_out, ntaps, decim, q, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ais_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
