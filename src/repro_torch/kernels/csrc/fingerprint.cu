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
// Bound on the H100 (3.35 TB/s HBM3): bytes.  The kernel must read m*N*4
// bytes and write m*8: 7.85 us at (1000, 6570), 0.785 us at (100, 6570),
// 0.04 us at the serving bank (5, 6570).  Below a few hundred rows that is
// far under the floor of any launch (an empty kernel, csrc/launch_floor.cu)
// plus one memory round trip, so the design is about latency: one launch,
// every load of a thread in flight at once, and no barrier that waits on
// work it could have overlapped.
//
// Design.  The TPU kernel streamed a (2, N) weight table beside the data and
// folded lane accumulators across a sequential grid; none of that carries
// over.  Here:
//   * one launch, no zero-fill, no atomics: a row is split over a
//     thread-block cluster of C blocks (C in {1, 2, 4, 8}, a launch
//     attribute chosen by the wrapper so that m*C fills the card); block b
//     of the cluster takes the b-th contiguous span of the row's 16-byte
//     vectors.  The row is on grid.x (row = blockIdx.x / C), so m takes the
//     whole 2^31 - 1 range of grid.x;
//   * the reduction goes through distributed shared memory: each warp adds
//     its lanes (redux.sync) and posts its (A, B) with st.async into block
//     rank 0's mailbox, where a transaction barrier (mbarrier, expecting
//     8 bytes from every warp of the cluster) counts them in; rank 0's
//     warp 0 adds the posts and writes the row once.  Addition mod 2^32 is
//     exact in any order, so every split is bit for bit.  The cluster
//     barrier that makes rank 0's mailbox safe to write (every block of the
//     cluster has started) is split: arrive before the loads, wait after
//     them, so it costs no time of its own; no block waits for another to
//     leave, since nothing reads a peer's shared memory;
//   * a thread issues kUnroll 16-byte loads (ld.global.nc, no L1
//     allocation: each byte is read once) before it uses any, then mixes
//     and accumulates; longer rows loop over such groups;
//   * the weights are computed, not read: r has order 2^29 mod 2^32, so a
//     thread's first weight r^(j+1) is a product over the bits of a 29-bit
//     exponent, formed in registers while the loads are in flight; the step
//     between a thread's loads, r^(4 * kThreads), is a compile-time constant;
//   * rows start wherever N puts them (N = 6570 leaves every other row 8
//     bytes off a 16-byte boundary): each row's unaligned head and ragged
//     tail (< 4 elements each) are scalar loads issued beside the vectors,
//     and the spans are counted in vectors after the head, so every vector
//     load is aligned.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kBase = 0x85EBCA77u;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;             // 16-byte loads in flight per thread
constexpr int kMaxCluster = 8;         // the portable cluster limit
constexpr int kOrderBits = 29;         // r^(2^29) = 1 mod 2^32

__host__ __device__ constexpr uint32_t pow_const(unsigned long long e) {
  uint32_t r = 1u, b = kBase;
  for (; e; e >>= 1, b *= b)
    if (e & 1ull) r *= b;
  return r;
}

// the weight step between a thread's consecutive vector loads
constexpr uint32_t kStep = pow_const(4ull * kThreads);
static_assert(pow_const(1ull << kOrderBits) == 1u, "r must have order 2^29");

__device__ __forceinline__ uint32_t mix(uint32_t v) { return v ^ (v >> 16); }

// r^e mod 2^32 as a product over e's set bits (e mod 2^29 suffices), the
// squares r^(2^k) formed in registers: a __constant__ table of them costs
// constant-cache misses on a cold launch, measured slower
__device__ __forceinline__ uint32_t pow_r(unsigned long long e) {
  const uint32_t bits = (uint32_t)(e & ((1ull << kOrderBits) - 1));
  uint32_t r = 1u, b = kBase;
#pragma unroll
  for (int k = 0; k < kOrderBits; ++k, b *= b)
    if ((bits >> k) & 1u) r *= b;
  return r;
}

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// shared-memory address of a generic pointer into this block's shared memory
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One element j of the row at its own weight (the scalar head and tail).
__device__ __forceinline__ void add_scalar(uint32_t x, long long j, uint32_t& a,
                                           uint32_t& b) {
  const uint32_t w = pow_r((unsigned long long)j + 1ull);
  x = mix(x);
  a += x * w;
  b += x * (w * w);
}

__global__ void __launch_bounds__(kThreads)
fingerprint_kernel(const uint32_t* __restrict__ bits, uint32_t* __restrict__ out,
                   long long n, int log2_cluster) {
  const int nblk = 1 << log2_cluster;
  const unsigned rank = blockIdx.x & (nblk - 1);     // the block's rank in its cluster
  const long long row = blockIdx.x >> log2_cluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // rank 0's mailbox: one (A, B) partial from every warp of the cluster,
  // each delivered by st.async and counted by a transaction barrier
  __shared__ uint2 mailbox[kMaxCluster * kWarps];
  __shared__ alignas(8) unsigned long long mail_bar;
  if (rank == 0 && tid == 0) {
    // one arrival (this one, with the bytes to expect) and the posts' bytes
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&mail_bar)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_addr(&mail_bar)), "r"(8 * kWarps * nblk) : "memory");
  }

  const uint32_t* p = bits + row * n;
  // elements before the row's first 16-byte boundary
  long long head = (long long)(((16u - ((uint32_t)(uintptr_t)p & 15u)) & 15u) >> 2);
  if (head > n) head = n;
  const long long nvec = (n - head) >> 2;
  const long long tail0 = head + 4 * nvec;
  const long long span = (nvec + nblk - 1) >> log2_cluster;
  const long long q_end = min(((long long)rank + 1) * span, nvec);
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  const long long q_first = (long long)rank * span + tid;
  // the scalar head and tail (rank 0), loaded beside the first vectors
  const bool has_head = rank == 0 && tid < head;
  const bool has_tail = rank == 0 && tid >= 4 && tid - 4 < n - tail0;
  const uint32_t hv = has_head ? __ldg(p + tid) : 0u;
  const uint32_t tv = has_tail ? __ldg(p + tail0 + tid - 4) : 0u;

  // this block runs (and rank 0's barrier is set up): the matching wait
  // comes after the loads, so the cluster barrier costs no time of its own
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");

  uint32_t acc_a = 0u, acc_b = 0u, w = 0u;
  for (long long q0 = q_first; q0 < q_end; q0 += (long long)kThreads * kUnroll) {
    uint4 d[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + (long long)u * kThreads;
      d[u] = q < q_end ? load_stream(v + q) : make_uint4(0u, 0u, 0u, 0u);
    }
    // zero vectors past the span add nothing (mix(0) = 0) and keep the step
    if (q0 == q_first) w = pow_r((unsigned long long)(head + 4 * q_first) + 1ull);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint32_t w0 = w, w1 = w0 * kBase, w2 = w1 * kBase, w3 = w2 * kBase;
      const uint32_t x0 = mix(d[u].x), x1 = mix(d[u].y), x2 = mix(d[u].z),
                     x3 = mix(d[u].w);
      acc_a += x0 * w0 + x1 * w1 + x2 * w2 + x3 * w3;
      acc_b += x0 * (w0 * w0) + x1 * (w1 * w1) + x2 * (w2 * w2) + x3 * (w3 * w3);
      w *= kStep;
    }
  }
  if (has_head) add_scalar(hv, tid, acc_a, acc_b);
  if (has_tail) add_scalar(tv, tail0 + tid - 4, acc_a, acc_b);

  // each warp posts its partial into rank 0's mailbox (distributed shared
  // memory) once every block of the cluster has started
  acc_a = __reduce_add_sync(0xffffffffu, acc_a);
  acc_b = __reduce_add_sync(0xffffffffu, acc_b);
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (lane == 0) {
    uint32_t slot, bar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;"
                 : "=r"(slot) : "r"(smem_addr(&mailbox[rank * kWarps + warp])));
    asm volatile("mapa.shared::cluster.u32 %0, %1, 0;"
                 : "=r"(bar) : "r"(smem_addr(&mail_bar)));
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u32 [%0], {%1, %2}, [%3];"
        ::"r"(slot), "r"(acc_a), "r"(acc_b), "r"(bar) : "memory");
  }
  if (rank != 0 || warp != 0) return;     // nothing reads a peer's shared memory
  // rank 0's warp 0 waits for the kWarps * C partials, adds them, writes the row
  uint32_t done = 0u;
  while (!done)
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(&mail_bar)) : "memory");
  const int posts = kWarps * nblk;
  uint2 a = lane < posts ? mailbox[lane] : make_uint2(0u, 0u);
  if (lane + 32 < posts) {
    a.x += mailbox[lane + 32].x;
    a.y += mailbox[lane + 32].y;
  }
  a.x = __reduce_add_sync(0xffffffffu, a.x);
  a.y = __reduce_add_sync(0xffffffffu, a.y);
  if (lane == 0) reinterpret_cast<uint2*>(out)[row] = a;
}

}  // namespace

// bits: (m, n) uint32, contiguous, 4-byte aligned.  out: (m, 2) uint32, 8-byte
// aligned (every element is written).  cluster: blocks per row, 1, 2, 4 or 8.
// Launches one kernel on `stream` with that cluster size (C = 1 too: the
// kernel's cluster instructions need a cluster launch) and returns the
// launch's error or else cudaGetLastError() (0 on success).
extern "C" int fingerprint_launch(const void* bits, void* out, long long m,
                                  long long n, int cluster, void* stream) {
  if (m <= 0 || n < 0 || (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      m > INT_MAX / cluster)
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(m * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int log2_cluster = cluster == 8 ? 3 : cluster == 4 ? 2 : cluster == 2 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fingerprint_kernel,
                                             static_cast<const uint32_t*>(bits),
                                             static_cast<uint32_t*>(out), n, log2_cluster);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}
