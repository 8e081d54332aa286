// K1: cr1 wire channelizer — packed 1-bit real samples -> per-channel
// decimated complex baseband, in one pass, on the tensor cores.
//
// Replaces ais_tpu/ops/pallas_fir.py:_pallas_wire_channelizer_cr1 (body
// _wire_kernel_cr1), the TPU kernel on the reference's main path.
//
// Computes, for every channel c and output m:
//
//   y[c, m] = sum_{k < ntaps} h[k] * s[m*D + k] * car_c[(m*D + k) mod q]
//
// with s[n] = +1/-1 from bit n of the wire (8 samples a byte, MSB first)
// and car_c the IF-folded mixer e^{-j2pi(off_c + fs/4) n / fs} rotated by
// the runtime start phase: a periodic table of q entries that the
// wrapper rotates once a call.
//
// What bounds it on an H100: operations.  At the bench geometry (n_in ~
// 56.7 M samples, D = 50, 2891 taps, 2 channels) one call is 2.6e10 fp32
// flop for 7 MB of wire bytes in and 18 MB out: 0.39 ms at the fp32 rate
// outside the tensor cores, 0.008 ms of memory traffic.  The first kernel
// (one thread an output; a byte load, a shift, a select, a tap load and
// two carrier loads to feed four FMAs a tap) ran at 9 % of that rate: the
// FMA pipe waited on everything around it.
//
// What this design does about it:
//
//  1. The carrier leaves the inner loop.  car_c[n] = e^{j phi_c} e^{-j w_c n},
//     so y[c, m] = car_c[m*D mod q] * sum_k g_c[k] * s[m*D + k] with
//     constant complex taps g_c[k] = h[k] e^{-j w_c k}, folded on the host
//     in float64.  The rotation is one complex multiply an output, in the
//     epilogue, from the rotated table.
//  2. The sum runs on the tensor cores: Y = A * B with A[m, k] = s[m*D + k],
//     +-1 and so exact in fp16, and B's columns the taps.  Only B needs
//     more than fp16's 11 bits: each tap, scaled by a power of two 2^e
//     that brings the largest to [2^14, 2^15), is split into hi + lo, both
//     fp16, and the parts are separate columns (channel, re/im, hi/lo):
//     8 columns for 2 channels, one mma.sync.m16n8k16 tile, 16 for 3-4.
//     The accumulators are fp32; hi + lo and 2^-e come in the epilogue.
//  3. A never exists in memory.  Within an mma k-step the assignment of
//     taps to k-slots is free as long as A and B share it, and the host
//     lays B out for the one that makes A cheap: the K loop goes in
//     super-steps of 128 taps (8 k-steps); lane t of a quad owns taps
//     32t..32t+31 of each of its rows, one 32-bit window w of wire bits
//     (two shared-memory words and a funnel shift), and in k-step j its
//     fp16 pairs are ((w << (2j + kg)) & 0x80008000) ^ 0xBC00BC00, kg = 0,
//     1: a shift and one logic op a register (the wire bit becomes the
//     sign of 1.0).  ops/wire_channelizer.py holds the same arithmetic
//     (fragment_tap, window, a_registers, pack_fragments) for the CPU tests.
//  4. B is staged in shared memory once a block, already in fragment
//     order (one conflict-free 8-byte load a lane and k-step, shared by the
//     warp's four 16-row tiles), and the blocks are persistent: as many as
//     fit the card, each walking tiles of 256 outputs whose ~2 KB of wire
//     bits it stages as byte-swapped words, with plain loads between two
//     barriers: four blocks share a multiprocessor and cover each other's
//     staging, and changing the warps or tiles a block moves the time by
//     a few percent only, so no cp.async double buffer is spent on it.
//
// What sets its pace now: not the tensor cores but the integer pipe that
// builds A, a shift and a logic op a register, 8 an mma, at half the
// fp32 rate.
//
// Error budget against the fp32 contract (the reference pins
// Precision.HIGHEST; the bound held on the card is 2e-5*max|y| +
// 2e-4*|y|): A is exact and every product hi*(+-1), lo*(+-1) is exact;
// hi + lo carries each tap to 2^-22 of itself (2^-25 * 2^-e absolute in
// the far tail, where lo is subnormal), against 2^-24 for the fp32 tap
// of the plain version; the tensor cores' fp32 accumulation does not
// round as IEEE adds do (it truncates), so a chain is only 8 k-steps
// long: after every super-step the mma accumulators are added into IEEE
// fp32 running sums and cleared (23 rounded adds a column at 2891 taps).
// The other tensor-core form (rows of D samples times a D x
// ceil(ntaps/D)*4 tap matrix through wgmma, then a sum along
// anti-diagonals through shared memory) needs that collapse and a halo;
// this form needs neither descriptors nor barriers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMTiles = 4;                      // 16-row mma tiles a warp
constexpr int kWarpRows = 16 * kMTiles;
constexpr int kTile = kWarps * kWarpRows;       // outputs a block tile (256)
constexpr int kSuper = 128;                     // taps a super-step
constexpr uint32_t kSignMask = 0x80008000u;     // the sign bits of an fp16 pair
constexpr uint32_t kMinusOne = 0xBC00BC00u;     // fp16 -1.0, twice

// (w & mask) ^ flip in one LOP3.  Both constants come in as kernel
// arguments: as literals the compiler spends two LOP3s a register (a
// LOP3 takes one immediate), and the logic pipe sets the pace.
__device__ __forceinline__ uint32_t and_xor(uint32_t w, uint32_t mask, uint32_t flip) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;\n" : "=r"(d) : "r"(w), "r"(mask), "r"(flip));
  return d;
}

// D = A * B + D for one m16n8k16 tile, fp16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NT: mma n-tiles of 8 columns (1 for 1-2 channels, 2 for 3-4).
template <int NT>
__global__ void __launch_bounds__(kThreads)
wire_channelizer_cr1_kernel(const uint8_t* __restrict__ raw,
                            const float2* __restrict__ car,    // (n_chan, q), rotated
                            const uint2* __restrict__ frags,   // (n_super, 8, NT, 32)
                            float* __restrict__ out,           // (n_chan, n_out, 2)
                            int n_bytes, int n_out, int n_super, int tile_words,
                            int decim, int q, int n_chan, int n_tiles,
                            float unscale, uint32_t sign_mask, uint32_t minus_one) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_frag = n_super * 8 * NT * 32;
  uint2* s_b = reinterpret_cast<uint2*>(smem);
  uint32_t* s_w = reinterpret_cast<uint32_t*>(s_b + n_frag);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // the fragment's row (and B's column)
  const int t = lane & 3;    // lane of the quad: which 32 taps of a super-step

  for (int i = tid; i < n_frag; i += kThreads) s_b[i] = frags[i];

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long m0 = static_cast<long long>(tile) * kTile;
    // A tile is kTile * decim bits = 32 * decim bytes on: every tile
    // starts on a 4-byte word of the wire.
    const long long word0 = static_cast<long long>(tile) * (kTile / 8) * decim;

    __syncthreads();  // the last tile's windows are all read
    for (int i = tid; i < tile_words; i += kThreads) {
      const long long b = word0 + 4LL * i;
      uint32_t w = 0;
      if (b + 4 <= n_bytes) {
        // Byte-swapped: wire bit n of the word (MSB first in its byte)
        // sits at bit 31 - n.
        w = __byte_perm(*reinterpret_cast<const uint32_t*>(raw + b), 0, 0x0123);
      } else {
        for (int j = 0; j < 4; ++j)
          if (b + j < n_bytes) w |= static_cast<uint32_t>(raw[b + j]) << (24 - 8 * j);
      }
      s_w[i] = w;
    }
    __syncthreads();  // (the first time also: B is staged)

    // This lane's rows: 16*mt + g + 8*h of the warp's 64; the first bit
    // of its window in super-step 0.
    int rowbit[kMTiles][2];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        rowbit[mt][h] = (warp * kWarpRows + mt * 16 + g + 8 * h) * decim + 32 * t;

    float acc[kMTiles][NT][4];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

    for (int S = 0; S < n_super; ++S) {
      uint32_t win[kMTiles][2];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = rowbit[mt][h] + S * kSuper;
          const int wi = p >> 5;
          win[mt][h] = __funnelshift_l(s_w[wi + 1], s_w[wi], p & 31);
        }

      float c[kMTiles][NT][4];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) c[mt][nt][i] = 0.0f;

      const uint2* bp = s_b + S * (8 * NT * 32) + lane;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint2 b[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) b[nt] = bp[(j * NT + nt) * 32];
#pragma unroll
        for (int mt = 0; mt < kMTiles; ++mt) {
          uint32_t a[4];
          a[0] = and_xor(win[mt][0] << (2 * j), sign_mask, minus_one);
          a[1] = and_xor(win[mt][1] << (2 * j), sign_mask, minus_one);
          a[2] = and_xor(win[mt][0] << (2 * j + 1), sign_mask, minus_one);
          a[3] = and_xor(win[mt][1] << (2 * j + 1), sign_mask, minus_one);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_m16n8k16(c[mt][nt], a, b[nt].x, b[nt].y);
        }
      }
      // Flush the short tensor-core chains into IEEE sums.
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = __fadd_rn(acc[mt][nt][i], c[mt][nt][i]);
    }

    // Epilogue.  A lane's accumulator pair (2h, 2h + 1) is (hi, lo) of
    // column pair t of n-tile nt: channel 2*nt + t/2, re for even t, im
    // for odd; the other component is in the neighbouring lane.
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + warp * kWarpRows + mt * 16 + g + 8 * h;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float v = __fadd_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]) * unscale;
          const float other = __shfl_xor_sync(0xffffffffu, v, 1);
          const int ch = 2 * nt + (t >> 1);
          if (m < n_out && ch < n_chan) {
            const float2 rot = __ldg(car + static_cast<long long>(ch) * q + (m * decim) % q);
            // even t: re = re*rx - im*ry; odd t: im = im*rx + re*ry.
            const float cross = other * rot.y;
            const float y = fmaf(v, rot.x, (t & 1) ? cross : -cross);
            out[(static_cast<long long>(ch) * n_out + m) * 2 + (t & 1)] = y;
          }
        }
      }
  }
}

template <int NT>
int launch(const uint8_t* raw, const float2* car, const uint2* frags, float* out,
           int n_bytes, int n_out, int n_super, int tile_words, int decim, int q,
           int n_chan, float unscale, cudaStream_t stream) {
  const size_t smem = sizeof(uint2) * n_super * 8 * NT * 32 + sizeof(uint32_t) * tile_words;
  auto kernel = wire_channelizer_cr1_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // Persistent blocks: as many as the card holds at once.
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_tiles = (n_out + kTile - 1) / kTile;
  const int blocks = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
  kernel<<<blocks, kThreads, smem, stream>>>(raw, car, frags, out, n_bytes, n_out, n_super,
                                             tile_words, decim, q, n_chan, n_tiles, unscale,
                                             kSignMask, kMinusOne);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ais_wire_channelizer_cr1(const void* raw, const void* car,
                                        const void* frags, void* out,
                                        int n_bytes, int n_out, int n_super,
                                        int tile_words, int decim, int q, int n_chan,
                                        float unscale, void* stream) {
  if (reinterpret_cast<uintptr_t>(raw) % 4 != 0 || n_out <= 0 || n_super <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto r = static_cast<const uint8_t*>(raw);
  auto c = static_cast<const float2*>(car);
  auto f = static_cast<const uint2*>(frags);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_chan) {
    case 1:
    case 2:
      return launch<1>(r, c, f, o, n_bytes, n_out, n_super, tile_words, decim, q, n_chan,
                       unscale, s);
    case 3:
    case 4:
      return launch<2>(r, c, f, o, n_bytes, n_out, n_super, tile_words, decim, q, n_chan,
                       unscale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ais_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
