// Two kernels that do no work of their own: the least time a launch can show
// under a timer.  chip_smoke.py times both as it times every kernel, so that
// a kernel moving a few kilobytes reads as "floor + its own work":
//   * empty_kernel: the launch alone;
//   * round_trip_kernel: one thread loads 16 bytes and stores them elsewhere,
//     the launch plus one memory round trip.
// No path runs them.

#include <cuda_runtime.h>

__global__ void empty_kernel() {}

__global__ void round_trip_kernel(const float4* __restrict__ in, float4* __restrict__ out) {
  if (threadIdx.x == 0) out[0] = __ldg(in);
}

// Each launches one block of one warp on `stream`; returns cudaGetLastError().
extern "C" int launch_floor_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" int round_trip_launch(const void* in, void* out, void* stream) {
  round_trip_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(static_cast<const float4*>(in),
                                                         static_cast<float4*>(out));
  return (int)cudaGetLastError();
}
