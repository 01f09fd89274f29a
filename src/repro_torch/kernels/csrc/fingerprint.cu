// Batched per-client model fingerprints on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `fingerprint_pallas` / `_fingerprint_kernel`
// in src/repro/kernels/fingerprint.py.  For each row v of an (m, N) matrix of
// uint32 bit patterns (the fp32 arena rows, read in place):
//
//     A = sum_j mix(v_j) * r^(j+1)      (mod 2^32)
//     B = sum_j mix(v_j) * r^(2(j+1))   (mod 2^32)
//
// with mix(v) = v ^ (v >> 16) and r = 0x85EBCA77.  Output: (m, 2) uint32.
//
// Design.  The TPU kernel streamed a (2, N) weight table beside the data and
// folded (8, 256) lane accumulators across a sequential grid; none of that
// carries over.  Here:
//   * grid (m, chunks): the blocks of one row split its columns; each thread
//     keeps two uint32 sums over a strided range of 16-byte (uint4) loads;
//   * the weights are computed in the kernel, not read: a thread starts at
//     r^(j+1) by modular exponentiation and steps by r^(4 * threads in the
//     row), so the only bytes moved are the rows and the residues;
//   * a warp reduces with __shfl_down_sync, the block through shared memory,
//     and blocks of one row meet by atomicAdd into the zeroed output.
//     Addition mod 2^32 is exact in any order, so every split is bit-exact;
//   * rows start wherever N puts them (N = 6570 leaves every other row 8
//     bytes off a 16-byte boundary), so each row handles its unaligned head
//     and its ragged tail (< 4 elements each) with scalar loads — no padding
//     copy, no bitcast copy.
//
// Bound on the H100 (3.35 TB/s, 80 GB HBM3): memory.  The kernel must read
// m*N*4 bytes and write m*8; about 7.9 us at (1000, 6570), 0.8 us at
// (100, 6570).  At the serving bank (5, 6570) the launch itself dominates.
// This first version aims to be right, not fast.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kBase = 0x85EBCA77u;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t mix(uint32_t v) { return v ^ (v >> 16); }

// b^e mod 2^32 (unsigned arithmetic wraps).
__device__ __forceinline__ uint32_t pow_mod(uint32_t b, unsigned long long e) {
  uint32_t r = 1u;
  while (e) {
    if (e & 1ull) r *= b;
    b *= b;
    e >>= 1;
  }
  return r;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
fingerprint_kernel(const uint32_t* __restrict__ bits, uint32_t* __restrict__ out,
                   long long n) {
  const long long row = blockIdx.x;
  const uint32_t* p = bits + row * n;
  // elements before the row's first 16-byte boundary
  long long head = (long long)(((16u - ((uint32_t)(uintptr_t)p & 15u)) & 15u) >> 2);
  if (head > n) head = n;
  const long long nvec = (n - head) >> 2;
  const long long tail0 = head + 4 * nvec;
  const long long g = (long long)blockIdx.y * kThreads + threadIdx.x;
  const long long stride = (long long)gridDim.y * kThreads;

  uint32_t acc_a = 0u, acc_b = 0u;
  if (g < head) {
    const uint32_t w = pow_mod(kBase, (unsigned long long)g + 1ull);
    const uint32_t x = mix(p[g]);
    acc_a += x * w;
    acc_b += x * (w * w);
  }
  if (g < n - tail0) {
    const long long j = tail0 + g;
    const uint32_t w = pow_mod(kBase, (unsigned long long)j + 1ull);
    const uint32_t x = mix(p[j]);
    acc_a += x * w;
    acc_b += x * (w * w);
  }
  if (g < nvec) {
    const uint4* v = reinterpret_cast<const uint4*>(p + head);
    uint32_t w = pow_mod(kBase, (unsigned long long)(head + 4 * g) + 1ull);
    const uint32_t step = pow_mod(kBase, 4ull * (unsigned long long)stride);
    for (long long q = g; q < nvec; q += stride) {
      const uint4 d = __ldg(v + q);
      const uint32_t w0 = w, w1 = w0 * kBase, w2 = w1 * kBase, w3 = w2 * kBase;
      const uint32_t x0 = mix(d.x), x1 = mix(d.y), x2 = mix(d.z), x3 = mix(d.w);
      acc_a += x0 * w0 + x1 * w1 + x2 * w2 + x3 * w3;
      acc_b += x0 * (w0 * w0) + x1 * (w1 * w1) + x2 * (w2 * w2) + x3 * (w3 * w3);
      w *= step;
    }
  }

  __shared__ uint32_t part_a[kWarps];
  __shared__ uint32_t part_b[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  acc_a = warp_sum(acc_a);
  acc_b = warp_sum(acc_b);
  if (lane == 0) {
    part_a[warp] = acc_a;
    part_b[warp] = acc_b;
  }
  __syncthreads();
  if (warp == 0) {
    acc_a = warp_sum(lane < kWarps ? part_a[lane] : 0u);
    acc_b = warp_sum(lane < kWarps ? part_b[lane] : 0u);
    if (lane == 0) {
      atomicAdd(out + 2 * row, acc_a);
      atomicAdd(out + 2 * row + 1, acc_b);
    }
  }
}

}  // namespace

// bits: (m, n) uint32, contiguous, 4-byte aligned.  out: (m, 2) uint32,
// zeroed by the caller.  chunks: blocks per row (1..65535).  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fingerprint_launch(const void* bits, void* out, long long m,
                                  long long n, int chunks, void* stream) {
  if (m <= 0 || m > 2147483647LL || n <= 0 || chunks <= 0 || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)m, (unsigned)chunks);
  fingerprint_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(bits), static_cast<uint32_t*>(out), n);
  return (int)cudaGetLastError();
}
