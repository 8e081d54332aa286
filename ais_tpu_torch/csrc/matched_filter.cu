// K2: preamble matched filter with fused |corr|^2.
//
// Replaces ais_tpu/ops/pallas_corr.py:pallas_matched_filter (body
// _corr_kernel), the burst detector's correlator on the reference's
// main path.  Computes, for every row b of AFC-derotated demod blocks:
//
//   corr[b, i] = sum_{k < L} conj(p[k]) * x[b, i + k]
//   mag2[b, i] = |corr[b, i]|^2
//
// for i < n - L + 1 (L = 140, the GMSK preamble at 5 samples/symbol).
//
// What bounds it on an H100: operations.  At the bench geometry (192
// rows of 16384 samples) one call is 3.5e9 fp32 flop and 63 MB of
// traffic (25 MB of x read, 25 MB of corr and 12.5 MB of mag2 written):
// 0.052 ms of FMAs at the fp32 rate against 0.019 ms of memory.  Both
// operands are full fp32, so a tensor-core form would need three-way
// splits of both; the sum stays on the CUDA cores.  The first kernel
// (one thread an output) paid two 8-byte shared-memory loads, a tap and
// a sample, for every 4 FMAs: the loads set its pace, 27 % of the rate.
//
// What this design does about it: a thread computes kR = 8 consecutive
// outputs from registers.  The outputs i..i+7 and the taps k..k+7 touch
// the samples i+k..i+k+14: two 8-sample halves held in registers, of
// which one is reloaded a block of 8 taps (the halves swap roles, so
// nothing moves).  A block of 8 taps is 8 tap loads (broadcasts) and 8
// sample loads for 256 FMAs: one load for 16 FMAs, not for 2.  A thread's
// samples lie 8 apart from its neighbour's, so the tile is stored with
// one pad every 8 samples (stride 9: conflict-free 8-byte loads).  The
// outputs go back through the same shared memory, so that corr and mag2
// are written with neighbouring threads on neighbouring addresses.
//
// Every output keeps the first kernel's own chain of fmaf's (k
// ascending; re: p.x*v.x then -p.y*v.y; im: p.x*v.y then p.y*v.x) and
// the rounded, uncontracted mag2, so each value is bit for bit what the
// first kernel wrote: no near-tie of the burst detector can flip.  No
// tap is padded with zeros (a sample outside an output's window never
// enters its sum).  fp32 IEEE throughout (the reference pins HIGHEST).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kR = 8;                    // outputs a thread
constexpr int kTile = kThreads * kR;     // outputs a block (1024)

// Index of sample j of the tile in the padded shared-memory layout:
// one pad after every kR samples.
constexpr int kStride = kR + 1;
__device__ __forceinline__ int padded(int j) { return j + j / kR; }

// Eight samples that start on a multiple of kR: contiguous at `src`.
__device__ __forceinline__ void load_half(float2 (&dst)[kR], const float2* src) {
#pragma unroll
  for (int j = 0; j < kR; ++j) dst[j] = src[j];
}

// Taps k0..k0+7 (those below L) into the 8 outputs: output r and tap
// k0 + kk read window sample r + kk, in `lo` (0..7) or `hi` (8..14).
template <bool kFull>
__device__ __forceinline__ void mac_block(float (&re)[kR], float (&im)[kR],
                                          const float2 (&lo)[kR], const float2 (&hi)[kR],
                                          const float2* s_p, int k0, int L) {
#pragma unroll
  for (int kk = 0; kk < kR; ++kk) {
    if (kFull || k0 + kk < L) {
      const float2 p = s_p[k0 + kk];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float2 v = (r + kk < kR) ? lo[(r + kk) % kR] : hi[(r + kk) % kR];
        re[r] = fmaf(p.x, v.x, re[r]);
        re[r] = fmaf(-p.y, v.y, re[r]);
        im[r] = fmaf(p.x, v.y, im[r]);
        im[r] = fmaf(p.y, v.x, im[r]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 8)
matched_filter_kernel(const float2* __restrict__ x,      // (B, n)
                      const float2* __restrict__ pc,     // (L,) conj taps
                      float2* __restrict__ corr,         // (B, n_out)
                      float* __restrict__ mag2,          // (B, n_out)
                      int n, int n_out, int L, int span) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* s_p = reinterpret_cast<float2*>(smem);
  float2* s_x = s_p + L;

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kTile;
  const long long row = blockIdx.y;
  const float2* xb = x + row * n;

  for (int k = tid; k < L; k += kThreads) s_p[k] = pc[k];
  for (int j = tid; j < span; j += kThreads) {
    const int idx = i0 + j;
    s_x[padded(j)] = idx < n ? xb[idx] : make_float2(0.0f, 0.0f);
  }
  __syncthreads();

  float re[kR], im[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) re[r] = im[r] = 0.0f;

  // Half h of this thread's samples: tile samples 8(tid + h) .. 8(tid + h) + 7,
  // at half0 + h * kStride in the padded layout; the block of taps
  // 8b..8b+7 reads halves b and b + 1.
  const float2* half0 = s_x + tid * kStride;
  const int n_full = L / kR;
  const bool rest = (L % kR) != 0;
  float2 ha[kR], hb[kR];
  load_half(ha, half0);
  load_half(hb, half0 + kStride);
  int b = 0;
  for (; b + 2 <= n_full; b += 2) {
    const float2* next = half0 + (b + 2) * kStride;
    mac_block<true>(re, im, ha, hb, s_p, b * kR, L);
    load_half(ha, next);
    mac_block<true>(re, im, hb, ha, s_p, (b + 1) * kR, L);
    load_half(hb, next + kStride);
  }
  if (b < n_full) {
    mac_block<true>(re, im, ha, hb, s_p, b * kR, L);
    load_half(ha, half0 + (b + 2) * kStride);
    if (rest) mac_block<false>(re, im, hb, ha, s_p, (b + 1) * kR, L);
  } else if (rest) {
    mac_block<false>(re, im, ha, hb, s_p, b * kR, L);
  }

  // Back through shared memory, so the stores are coalesced.
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kR; ++r) s_x[tid * kStride + r] = make_float2(re[r], im[r]);
  __syncthreads();
  for (int j = tid; j < kTile; j += kThreads) {
    const int i = i0 + j;
    if (i < n_out) {
      const float2 v = s_x[padded(j)];
      corr[row * n_out + i] = v;
      // Rounded products (no FMA contraction): mag2 is exactly |corr|^2 of
      // the stored corr, as the plain version computes it.
      mag2[row * n_out + i] = __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
    }
  }
}

}  // namespace

extern "C" int ais_matched_filter(const void* x, const void* pc, void* corr,
                                  void* mag2, int batch, int n, int n_out,
                                  int L, void* stream) {
  if (batch <= 0 || batch > 65535 || n_out <= 0 || L <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // Samples a block stages: its 1024 outputs' windows, in whole halves
  // (the last reload reads up to half L/8 + 2 of the last thread).
  const int span = kTile + (L / kR + 3) * kR;
  const size_t smem = sizeof(float2) * (L + span + span / kR + 1);
  cudaError_t err = cudaFuncSetAttribute(
      matched_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_out + kTile - 1) / kTile, batch);
  matched_filter_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(pc),
      static_cast<float2*>(corr), static_cast<float*>(mag2), n, n_out, L, span);
  return static_cast<int>(cudaGetLastError());
}
