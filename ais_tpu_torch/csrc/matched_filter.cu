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
// What bounds it on an H100: at the bench geometry (192 rows of 16384
// samples) one call is ~3.5e9 flop and ~63 MB of traffic (25 MB of x
// read, 25 MB of corr and 12.5 MB of mag2 written).  Against the card's
// ~67 TFLOP/s fp32 and 3.35 TB/s that is ~52 us of FMAs against ~19 us
// of memory, so the direct form leans compute-bound; fusing mag2 saves
// the separate 25 MB read + 12.5 MB write a later squaring pass costs.
// Design: one thread block per (row, tile of T = 256 outputs); the
// tile's T + L - 1 input samples and the L conjugated taps are staged in
// shared memory, and each thread computes one output with 4 fp32 FMAs a
// tap and writes corr and mag2.  Neighbouring threads read neighbouring
// samples, so the shared-memory reads are conflict-free; the tap read is
// a broadcast.  fp32 IEEE throughout (the reference pins HIGHEST).

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;  // outputs (= threads) per block

__global__ void __launch_bounds__(kTile)
matched_filter_kernel(const float2* __restrict__ x,      // (B, n)
                      const float2* __restrict__ pc,     // (L,) conj taps
                      float2* __restrict__ corr,         // (B, n_out)
                      float* __restrict__ mag2,          // (B, n_out)
                      int n, int n_out, int L) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* s_p = reinterpret_cast<float2*>(smem);
  float2* s_x = s_p + L;

  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * kTile;
  const long long row = blockIdx.y;
  const float2* xb = x + row * n;

  for (int k = tid; k < L; k += kTile) s_p[k] = pc[k];
  for (int j = tid; j < kTile + L - 1; j += kTile) {
    const int idx = i0 + j;
    s_x[j] = idx < n ? xb[idx] : make_float2(0.0f, 0.0f);
  }
  __syncthreads();

  const int i = i0 + tid;
  if (i >= n_out) return;
  float re = 0.0f, im = 0.0f;
#pragma unroll 4
  for (int k = 0; k < L; ++k) {
    const float2 p = s_p[k];
    const float2 v = s_x[tid + k];
    re = fmaf(p.x, v.x, re);
    re = fmaf(-p.y, v.y, re);
    im = fmaf(p.x, v.y, im);
    im = fmaf(p.y, v.x, im);
  }
  corr[row * n_out + i] = make_float2(re, im);
  // Rounded products (no FMA contraction): mag2 is exactly |corr|^2 of
  // the stored corr, as the plain version computes it.
  mag2[row * n_out + i] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

}  // namespace

extern "C" int ais_matched_filter(const void* x, const void* pc, void* corr,
                                  void* mag2, int batch, int n, int n_out,
                                  int L, void* stream) {
  if (batch <= 0 || batch > 65535 || n_out <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float2) * (L + kTile + L - 1);
  cudaError_t err = cudaFuncSetAttribute(
      matched_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_out + kTile - 1) / kTile, batch);
  matched_filter_kernel<<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(pc),
      static_cast<float2*>(corr), static_cast<float*>(mag2), n, n_out, L);
  return static_cast<int>(cudaGetLastError());
}
