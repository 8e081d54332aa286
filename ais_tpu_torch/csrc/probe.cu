// K6: the toolchain probe, o = 2x + y on an (8, 128) float32 tile.
//
// Replaces tools/tpu_pallas_probe.py:f, the one-tile Pallas kernel that
// checks whether a kernel builds and runs on the device at all.  Here it
// shows that nvcc built this library for sm_90a and that a launch from
// it runs on the card; it is bound by nothing (1024 elements).

#include <cuda_runtime.h>

namespace {

__global__ void probe_kernel(const float* __restrict__ x, const float* __restrict__ y,
                             float* __restrict__ o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = 2.0f * x[i] + y[i];
}

}  // namespace

extern "C" int ais_probe(const void* x, const void* y, void* o, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 128;
  probe_kernel<<<(n + threads - 1) / threads, threads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(o), n);
  return static_cast<int>(cudaGetLastError());
}
