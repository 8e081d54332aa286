// K5, K3, K4: decode -> carrier mix -> polyphase decimating FIR, one
// template whose decode prologue is its only difference.
//
// Replaces, in ais_tpu/ops/pallas_fir.py:
//   K5  pallas_freq_xlating_polyphase (body _chan_kernel): complex64 IQ,
//       and, with no Pallas counterpart, rtl_sdr's cu8 bytes (offset
//       binary I, Q), decoded here rather than by a pass of their own;
//   K3  _pallas_wire_channelizer_ci1 (body _wire_kernel_ci1): ci1 bit
//       pairs, MSB-first I0 Q0 I1 Q1 I2 Q2 I3 Q3, levels +-1 (cd1 arrives
//       here after ci1_from_bytes_cd1);
//   K4  pallas_wire_channelizer, fmt ci2 / ci4 (body _wire_kernel):
//       ci2 bytes I0 Q0 I1 Q1 as 2-bit Lloyd-Max codes, MSB first; ci4
//       bytes (I << 4) | Q as 4-bit two's complement times 1/8.
//
// Computes, for every channel c and output m:
//
//   y[c, m] = sum_{k < ntaps} h[k] * x[m*D + k] * car_c[(m*D + k) mod q]
//
// with x the decoded complex sample and car_c the baseband mixer rotated
// by the runtime start phase: a table of q entries, periodic (q = 96 at
// +-25 kHz / 2.4 Msps) or full-length (q = n_in).  The TPU kernels'
// phase-major transposes, lane permutations, parity folds and
// anti-diagonal collapse exist for the MXU and are not carried over.
//
// What bounds it on an H100: fp32 FMAs (2 a tap, output and channel:
// ~2.7e10 flop at the bench geometry of 56.7 M samples, D = 50, 2891
// taps, 2 channels, against 0.46 GB of input).  An SM starts one warp-wide
// operation a clock and scheduler, and a warp-wide FMA is one of them,
// so the design's aim is an inner loop that is nearly all FMAs, fed from
// registers.  In polyphase form, k = j*D + p:
//
//   y[c, m] = sum_{p < D} sum_{j < J} h[j*D + p] * z_c[(m + j)*D + p]
//
// with z_c[n] = x[n] * car_c[n mod q] and J = ceil(ntaps / D).  For one
// phase p this is a stride-1 FIR of J taps over the rows (of D samples)
// of the mixed input.
//
//   0. As many blocks as the card holds at a time, each taking every
//      gridDim.x-th tile of T outputs: the taps, zero-padded to Jc*R rows
//      of D, are staged once a block, and no block is launched a tile.
//   1. Prologue, once a tile: decode and mix the tile's T + Jc*R rows
//      into shared memory, channels interleaved (one 16-byte load serves
//      two channels).  A lane reads a 32-bit word of wire bytes (2, 4, 8
//      or 16 samples) and the lanes of a warp exchange words by shuffle, so
//      that adjacent lanes mix and store adjacent samples.  The carrier
//      index is advanced and wrapped, not taken modulo q a sample.
//   2. A thread owns one phase p and R consecutive outputs of the tile
//      (item = group*D + p, so adjacent lanes read adjacent samples).
//      It walks the rows its outputs touch, in chunks of R rows: a row's
//      sample is loaded once and used in all R outputs; the taps it needs
//      are a window of 2R registers (the previous chunk's and this
//      one's, swapping roles), one 4-byte load a row.  The chunk's R x R
//      products are fully unrolled, so every register index is static.
//      The first and last chunk are triangles and are peeled so that no
//      product with a tap outside [0, Jc*R) is computed.  At R = 8 and 2
//      channels a row costs one 16-byte load, one 4-byte load and 32
//      FMAs.
//   3. Each thread then holds R partial outputs a channel for its phase;
//      the D partials of an output meet in shared memory (over the
//      samples, which are no longer needed; rows padded by one entry so
//      the writes do not collide), are added in phase order by one
//      thread an output, and stored coalesced.
//
// J, D, T and the thread count are runtime values; R, the channel count
// and optionally D (50, so that the row offsets become immediates) are
// template parameters.  ops/channelizer.py:kernel_plan picks R, T and
// the threads (24 warps at the bench geometry: the same count on each
// of an SM's 4 schedulers) and holds the same index arithmetic for the
// CPU tests.  What holds it at 40 % of the FMA bound: the walk's
// shared-memory loads (about 6 bank cycles a warp and row beside its 8
// cycles of FMAs, and the two overlap only in part) and the
// prologue, a quarter of the time, in which no FMA runs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 768;   // 24 warps, 6 a scheduler: up to 80 registers a thread
constexpr int kAlign = 16;         // samples: a tile is staged from a multiple of it

__device__ __forceinline__ uint32_t load_word(const void* src, long long word,
                                              long long n_bytes) {
  if ((word + 1) * 4 <= n_bytes) return static_cast<const uint32_t*>(src)[word];
  uint32_t w = 0;  // the buffer's last, partial word (or past its end)
  for (int b = 0; b < 4; ++b) {
    const long long i = word * 4 + b;
    if (i < n_bytes) w |= static_cast<uint32_t>(static_cast<const uint8_t*>(src)[i]) << (8 * b);
  }
  return w;
}

// A decoder reads one unit of kSamples samples (a 32-bit word of wire
// bytes, little-endian: byte b at bits 8b..8b+7) and returns sample k.

struct DecodeF32 {  // K5: complex64 samples, one a unit
  static constexpr int kSamples = 1;
  using Word = float2;
  static __device__ __forceinline__ Word load(const void* src, long long unit, long long n_in) {
    return unit < n_in ? static_cast<const float2*>(src)[unit] : make_float2(0.0f, 0.0f);
  }
  static __device__ __forceinline__ float2 sample(Word w, int) { return w; }
};

struct DecodeCu8 {  // K5 on rtl_sdr bytes: 2 samples a word, I then Q, (v - 127.5) / 127.5
  static constexpr int kSamples = 2;
  using Word = uint32_t;
  static __device__ __forceinline__ Word load(const void* src, long long unit, long long n_in) {
    return load_word(src, unit, 2 * n_in);
  }
  static __device__ __forceinline__ float2 sample(Word w, int k) {
    // ops/convert.py:iq_from_bytes_cu8's arithmetic: an exact difference,
    // then one rounding in the product with 1/127.5 rounded to float.
    constexpr float kInv = static_cast<float>(1.0 / 127.5);
    const float i = static_cast<float>((w >> (16 * k)) & 0xFFu);
    const float q = static_cast<float>((w >> (16 * k + 8)) & 0xFFu);
    return make_float2(__fmul_rn(i - 127.5f, kInv), __fmul_rn(q - 127.5f, kInv));
  }
};

struct DecodeCi1 {  // K3: 4 samples a byte, sample s at bits 7-2s (I), 6-2s (Q)
  static constexpr int kSamples = 16;
  using Word = uint32_t;
  static __device__ __forceinline__ Word load(const void* src, long long unit, long long n_in) {
    return load_word(src, unit, n_in >> 2);
  }
  static __device__ __forceinline__ float2 sample(Word w, int k) {
    const int sh = 8 * (k >> 2) + 6 - 2 * (k & 3);
    return make_float2(((w >> (sh + 1)) & 1u) ? 1.0f : -1.0f, ((w >> sh) & 1u) ? 1.0f : -1.0f);
  }
};

// Lloyd-Max levels, as ops/convert.py:CI2_INNER / CI2_OUTER.
__device__ __forceinline__ float ci2_level(unsigned c) {
  const float mag = (c == 0u || c == 3u) ? 1.5104f : 0.4528f;
  return c >= 2u ? mag : -mag;
}

struct DecodeCi2 {  // K4: 2 samples a byte, I0 Q0 I1 Q1 codes from the MSB
  static constexpr int kSamples = 8;
  using Word = uint32_t;
  static __device__ __forceinline__ Word load(const void* src, long long unit, long long n_in) {
    return load_word(src, unit, n_in >> 1);
  }
  static __device__ __forceinline__ float2 sample(Word w, int k) {
    const int sh = 8 * (k >> 1) + ((k & 1) ? 0 : 4);
    return make_float2(ci2_level((w >> (sh + 2)) & 3u), ci2_level((w >> sh) & 3u));
  }
};

struct DecodeCi4 {  // K4: one sample a byte, signed nibbles / 8
  static constexpr int kSamples = 4;
  using Word = uint32_t;
  static __device__ __forceinline__ Word load(const void* src, long long unit, long long n_in) {
    return load_word(src, unit, n_in);
  }
  static __device__ __forceinline__ float2 sample(Word w, int k) {
    // The nibble moved to the top of the word, then shifted down signed.
    const int i = static_cast<int>(w << (24 - 8 * k)) >> 28;
    const int q = static_cast<int>(w << (28 - 8 * k)) >> 28;
    return make_float2(static_cast<float>(i) * 0.125f, static_cast<float>(q) * 0.125f);
  }
};

// The NCH mixed samples at one (row, phase): interleaved in shared memory.
template <int NCH>
__device__ __forceinline__ void load_z(const float2* p, float2 (&z)[NCH]) {
  if constexpr (NCH == 2 || NCH == 4) {
#pragma unroll
    for (int c = 0; c < NCH; c += 2) {
      const float4 v = *reinterpret_cast<const float4*>(p + c);
      z[c] = make_float2(v.x, v.y);
      z[c + 1] = make_float2(v.z, v.w);
    }
  } else {
#pragma unroll
    for (int c = 0; c < NCH; ++c) z[c] = p[c];
  }
}

// One chunk of R rows of a thread's walk.  Row u of the chunk meets
// output i with tap u - i of this chunk (hb) when i <= u, else with tap
// R + u - i of the previous chunk (ha).  FIRST: no previous chunk; LAST:
// no taps of this one (the rows past the last tap chunk).
template <int NCH, int R, bool FIRST, bool LAST>
__device__ __forceinline__ void walk_chunk(const float2* zp, int row_stride,
                                           const float (&ha)[R], const float (&hb)[R],
                                           float2 (&acc)[NCH][R]) {
#pragma unroll
  for (int u = 0; u < R; ++u) {
    if (LAST && u == R - 1) break;  // its only output would be i > u
    float2 z[NCH];
    load_z<NCH>(zp + u * row_stride, z);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (FIRST && i > u) continue;
      if (LAST && i <= u) continue;
      // (both indices stay inside the arrays in the arm not taken)
      const float h = (i <= u) ? hb[(i <= u) ? u - i : 0] : ha[(i <= u) ? 0 : R + u - i];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        acc[c][i].x = fmaf(h, z[c].x, acc[c][i].x);
        acc[c][i].y = fmaf(h, z[c].y, acc[c][i].y);
      }
    }
  }
}

template <class Decode, int NCH, int R, int DC>
__global__ void __launch_bounds__(kMaxThreads, 1)
channelizer_kernel(const void* __restrict__ src,
                   const float2* __restrict__ car,    // (NCH, q), rotated
                   const float* __restrict__ taps,    // (ntaps,)
                   float2* __restrict__ out,          // (NCH, n_out)
                   long long n_in, int n_out, int ntaps, int decim_rt, int q,
                   int tile, int jc, int stage_len, int part_offset) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = DC ? DC : decim_rt;
  float2* s_z = reinterpret_cast<float2*>(smem);                 // (stage_len, NCH)
  float* s_h = reinterpret_cast<float*>(s_z + stage_len * NCH);
  float2* s_part = reinterpret_cast<float2*>(smem + part_offset);  // (D, NCH*tile + 1)

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  // The taps as (jc*R, D) rows, zero past ntaps: once a block.
  for (int i = tid; i < jc * R * D; i += nthreads) s_h[i] = i < ntaps ? taps[i] : 0.0f;

  // A block stays on its multiprocessor and takes every gridDim.x-th tile.
  const int n_tiles = (n_out + tile - 1) / tile;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int m0 = t * tile;
    const long long n0 = static_cast<long long>(m0) * D;
    const long long n0a = n0 & ~static_cast<long long>(kAlign - 1);
    const int off = static_cast<int>(n0 - n0a);
    const int n_stage = off + (tile + jc * R) * D;

    // Decode and mix the tile's rows once, for every channel.  A warp
    // takes 32 units (32*S samples) a round: each lane loads one unit (a
    // word of wire bytes), and in step s lane L handles sample s*32 + L of
    // the round, whose word sits in lane s*(32/S) + L/S: a shuffle away.
    // So adjacent lanes read adjacent carrier entries and store adjacent
    // samples, whatever the format.
    {
      constexpr int S = Decode::kSamples;
      const int lane = tid & 31;
      const int n_units = (n_stage + S - 1) / S;
      const unsigned uq = static_cast<unsigned>(q);
      const unsigned inc_step = 32u % uq;
      const unsigned inc_round = static_cast<unsigned>((static_cast<long long>(nthreads) * S) % q);
      // The carrier index is advanced and wrapped, not taken modulo q a sample.
      unsigned ci =
          static_cast<unsigned>((n0a + static_cast<long long>(tid - lane) * S + lane) % q);
      // Several global loads in flight a thread where a unit is one sample.
#pragma unroll(S == 1 ? 4 : 1)
      // (where lanes exchange words, a warp's lanes leave the loop together)
      for (int u = tid; (S == 1 ? u : u - lane) < n_units; u += nthreads) {
        const int u0 = u - lane;
        const typename Decode::Word w =
            u < n_units ? Decode::load(src, n0a / S + u, n_in) : typename Decode::Word{};
        unsigned cis = ci;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          typename Decode::Word ws = w;
          if constexpr (S > 1) ws = __shfl_sync(0xffffffffu, w, s * (32 / S) + lane / S);
          const int i = u0 * S + s * 32 + lane;
          const float2 x =
              (n0a + i < n_in) ? Decode::sample(ws, lane % S) : make_float2(0.0f, 0.0f);
          float2 z[NCH];
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            const float2 cv = car[static_cast<size_t>(c) * uq + cis];
            z[c] = make_float2(x.x * cv.x - x.y * cv.y, x.x * cv.y + x.y * cv.x);
          }
          if (i < stage_len) {
            float2* dst = s_z + i * NCH;
            if constexpr (NCH == 2 || NCH == 4) {
#pragma unroll
              for (int c = 0; c < NCH; c += 2)
                *reinterpret_cast<float4*>(dst + c) =
                    make_float4(z[c].x, z[c].y, z[c + 1].x, z[c + 1].y);
            } else {
#pragma unroll
              for (int c = 0; c < NCH; ++c) dst[c] = z[c];
            }
          }
          cis += inc_step;
          if (cis >= uq) cis -= uq;
        }
        ci += inc_round;
        if (ci >= uq) ci -= uq;
      }
    }
    __syncthreads();

    const int groups = tile / R;
    const int n_items = groups * D;
    const int part_stride = NCH * tile + 1;
    const int row_stride = D * NCH;
    for (int base = 0; base < n_items; base += nthreads) {
      const int item = base + tid;
      const bool live = item < n_items;
      float2 acc[NCH][R];
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int i = 0; i < R; ++i) acc[c][i] = make_float2(0.0f, 0.0f);
      const int g = item / D;
      const int p = item - g * D;
      if (live) {
        const float2* zp = s_z + (off + g * R * D + p) * NCH;
        const float* hp = s_h + p;
        // Two tap windows that swap roles from chunk to chunk: the previous
        // chunk's taps and this one's.
        float ha[R], hb[R];
#pragma unroll
        for (int u = 0; u < R; ++u) { ha[u] = 0.0f; hb[u] = hp[u * D]; }
        walk_chunk<NCH, R, true, false>(zp, row_stride, ha, hb, acc);
        int k = 1;
        for (; k + 1 < jc; k += 2) {
          zp += R * row_stride;
          hp += R * D;
#pragma unroll
          for (int u = 0; u < R; ++u) ha[u] = hp[u * D];
          walk_chunk<NCH, R, false, false>(zp, row_stride, hb, ha, acc);
          zp += R * row_stride;
          hp += R * D;
#pragma unroll
          for (int u = 0; u < R; ++u) hb[u] = hp[u * D];
          walk_chunk<NCH, R, false, false>(zp, row_stride, ha, hb, acc);
        }
        zp += R * row_stride;
        if (k < jc) {
          hp += R * D;
#pragma unroll
          for (int u = 0; u < R; ++u) ha[u] = hp[u * D];
          walk_chunk<NCH, R, false, false>(zp, row_stride, hb, ha, acc);
          zp += R * row_stride;
          walk_chunk<NCH, R, false, true>(zp, row_stride, ha, hb, acc);
        } else {
          walk_chunk<NCH, R, false, true>(zp, row_stride, hb, ha, acc);
        }
      }
      // The partials overwrite the samples when one pass covers the tile
      // (part_offset 0): every thread must have finished its walk.
      if (part_offset == 0) __syncthreads();
      if (live) {
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
          for (int i = 0; i < R; ++i)
            s_part[p * part_stride + c * tile + g * R + i] = acc[c][i];
      }
    }
    __syncthreads();

    // One thread an output: the D partials in phase order.
    for (int o = tid; o < NCH * tile; o += nthreads) {
      const int c = o / tile;
      const int m = m0 + (o - c * tile);
      float2 sum = make_float2(0.0f, 0.0f);
      for (int ph = 0; ph < D; ++ph) {
        const float2 v = s_part[ph * part_stride + o];
        sum.x += v.x;
        sum.y += v.y;
      }
      if (m < n_out) out[static_cast<long long>(c) * n_out + m] = sum;
    }
    __syncthreads();  // the next tile's samples overwrite the partial sums
  }
}

struct Geometry {
  long long n_in;
  int n_out, ntaps, decim, q, tile, threads;
};

template <class Decode, int NCH, int R, int DC>
int launch(const void* src, const float2* car, const float* taps, float2* out,
           const Geometry& g, cudaStream_t stream) {
  const int D = g.decim;
  const int j = (g.ntaps + D - 1) / D;
  const int jc = (j + R - 1) / R;
  // As ops/channelizer.py:stage_len and smem_bytes.
  const int stage_len = (kAlign + (g.tile + jc * R) * D + kAlign - 1) / kAlign * kAlign;
  const size_t z_bytes = sizeof(float2) * NCH * static_cast<size_t>(stage_len);
  const size_t h_bytes = sizeof(float) * static_cast<size_t>(jc) * R * D;
  const bool one_pass = (g.tile / R) * static_cast<long long>(D) <= g.threads;
  const size_t part_offset = one_pass ? 0 : (z_bytes + h_bytes + 15) / 16 * 16;
  const size_t part_bytes = sizeof(float2) * static_cast<size_t>(D) * (NCH * g.tile + 1);
  const size_t smem = one_pass ? z_bytes + h_bytes : part_offset + part_bytes;
  if (one_pass && part_bytes > z_bytes) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = channelizer_kernel<Decode, NCH, R, DC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // As many blocks as the card holds at a time, each walking its tiles.
  int device = 0, sms = 0, resident = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, g.threads, smem)) !=
          cudaSuccess)
    return static_cast<int>(err);
  if (resident < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const int n_tiles = (g.n_out + g.tile - 1) / g.tile;
  const int blocks = n_tiles < sms * resident ? n_tiles : sms * resident;
  kernel<<<blocks, g.threads, smem, stream>>>(src, car, taps, out, g.n_in, g.n_out, g.ntaps,
                                              D, g.q, g.tile, jc, stage_len,
                                              static_cast<int>(part_offset));
  return static_cast<int>(cudaGetLastError());
}

// The row offsets of the benchmark's decimation are compile-time.
template <class Decode, int NCH, int R>
int launch_decim(const void* src, const float2* car, const float* taps, float2* out,
                 const Geometry& g, cudaStream_t stream) {
  if (g.decim == 50) return launch<Decode, NCH, R, 50>(src, car, taps, out, g, stream);
  return launch<Decode, NCH, R, 0>(src, car, taps, out, g, stream);
}

template <class Decode, int NCH>
int launch_outputs(int r, const void* src, const float2* car, const float* taps, float2* out,
                   const Geometry& g, cudaStream_t stream) {
  switch (r) {
    case 1: return launch<Decode, NCH, 1, 0>(src, car, taps, out, g, stream);
    case 4: return launch_decim<Decode, NCH, 4>(src, car, taps, out, g, stream);
    case 8:
      // 8 outputs of 3 or 4 channels would not fit a thread's registers.
      if constexpr (NCH <= 2) return launch_decim<Decode, NCH, 8>(src, car, taps, out, g, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <class Decode>
int dispatch(const void* src, const void* car, const void* taps, void* out,
             long long n_in, int n_out, int ntaps, int decim, int q, int n_chan,
             int r, int tile, int threads, void* stream) {
  if (n_out <= 0 || ntaps <= 0 || decim <= 0 || q < kAlign || r <= 0 || tile < r || tile % r ||
      threads < 32 || threads > kMaxThreads || threads % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g{n_in, n_out, ntaps, decim, q, tile, threads};
  auto c = static_cast<const float2*>(car);
  auto t = static_cast<const float*>(taps);
  auto o = static_cast<float2*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n_chan) {
    case 1: return launch_outputs<Decode, 1>(r, src, c, t, o, g, s);
    case 2: return launch_outputs<Decode, 2>(r, src, c, t, o, g, s);
    case 3: return launch_outputs<Decode, 3>(r, src, c, t, o, g, s);
    case 4: return launch_outputs<Decode, 4>(r, src, c, t, o, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Every entry point: (input, rotated carrier (n_chan, q) float2 with
// q >= 16, taps, out (n_chan, n_out) float2, n_in samples, n_out, ntaps,
// decim, q, n_chan, R outputs a thread, T outputs a tile, threads a
// block, stream) -> cudaGetLastError().  The input is 4-byte aligned
// (wire bytes) or 8-byte aligned (complex64).

#define AIS_CHANNELIZER_ENTRY(name, Decode)                                              \
  extern "C" int name(const void* in, const void* car, const void* taps, void* out,      \
                      long long n_in, int n_out, int ntaps, int decim, int q,            \
                      int n_chan, int r, int tile, int threads, void* stream) {          \
    return dispatch<Decode>(in, car, taps, out, n_in, n_out, ntaps, decim, q, n_chan, r, \
                            tile, threads, stream);                                      \
  }

AIS_CHANNELIZER_ENTRY(ais_channelizer_f32, DecodeF32)
AIS_CHANNELIZER_ENTRY(ais_wire_channelizer_ci1, DecodeCi1)
AIS_CHANNELIZER_ENTRY(ais_wire_channelizer_ci2, DecodeCi2)
AIS_CHANNELIZER_ENTRY(ais_wire_channelizer_ci4, DecodeCi4)
AIS_CHANNELIZER_ENTRY(ais_wire_channelizer_cu8, DecodeCu8)
