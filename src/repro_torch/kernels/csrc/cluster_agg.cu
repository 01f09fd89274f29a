// Cluster-masked FedAvg over flat client rows on Hopper (sm_90a), in the
// fixed summation order of the round engine.
//
// Replaces the Pallas TPU kernel `cluster_agg_pallas` / `_agg_kernel` in
// src/repro/kernels/cluster_agg.py (out = mixing_matrix(labels, C, w) @ rows)
// in the order of the engine's form, src/repro/core/aggregation.py::
// tree_cluster_mean_params, bit for bit the numpy oracle
// src/repro/kernels/ref.py::tree_cluster_mean_ref:
//
//     mean[c, col] = tree_i( wo[i,c] > 0 ? wo[i,c] * rows[i,col] : +0.0 ) / denom[c]
//     out[j, col]  = mean[labels[j], col]     (NaN for a label outside [0, C))
//
// tree_i is the adjacent-pair binary tree over i = 0..p-1, p the next power
// of two >= m, leaves i >= m being +0.0; every padded add is done, because
// -0.0 + +0.0 = +0.0 makes them count.  wo (m, C) and the clamped denom (C,)
// are O(m C) and come from the wrapper.  Rows are float32 or bfloat16; a
// bf16 row is summed as its float32 value and the mean rounded once to bf16
// (the Pallas kernel's astype(float32), dot, astype(out dtype)).
//
// Design.  The TPU kernel kept the (m, m) mixing matrix resident and
// streamed (m, BN) tiles through one MXU product.  Here a block of 16 warps
// owns a strip of 32 columns and every row of it: lane = column, so a warp
// reads 32 neighbouring values of a row at once (one 128-byte line in fp32,
// whatever the row's alignment: N = 6570 puts odd rows 8 bytes off the
// 16-byte grid, where 16-byte copies and TMA cannot go).  The rows are taken
// in chunks of up to kChunk = 256 (a power of two, so each chunk is a
// complete subtree of the oracle's tree); in a chunk, warp g holds the LT =
// chunk / 16 leaves g*LT .. g*LT + LT - 1 in registers, LT a template
// constant.  The block first stages the chunk's wo entries in shared memory
// (all loads in flight), then each warp reads every row of its leaves that
// some cluster of the pass weighs positively (all in flight: one memory
// round trip per chunk); a row weighed by none — zero weight, possibly NaN
// — is never read.  For each cluster the warp sums its leaves by the
// adjacent-pair tree in registers, the 16 warps' subtrees meet in shared
// memory and one warp per cluster finishes the chunk's subtree; chunks
// combine on a stack of partial sums by tree level.  A chunk wholly past m
// is +0.0 in every cluster and is not read.  Then the means are written, each
// output row coalesced across the strip, the labels of 32 rows in one load
// shared by shuffles; the first pass's labels and denominators are loaded
// at the start, beside the weights.  Clusters go in passes of 8, one per
// warp in the finishing step, so shared memory stays fixed for any C.
// At N = 6570 there are 206 strips, fewer than two blocks an SM, so the
// time is latency: the two dependent round trips (weights, then rows) and
// each warp's chain of tree adds and stores.  16 warps a block put more of
// those chains in flight on each SM.  Its time beside torch.matmul's is in
// PERF.md (chip_smoke.py).
// Every product, sum and quotient is an explicit round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fdiv_rn): nvcc never contracts those into an
// FMA, which would move bits.
//
// Bound on the H100 (3.35 TB/s HBM): bytes.  At the main path's
// (100, 6570) fp32 the kernel must read the 2.1 MB of positive-weight rows
// and write 2.63 MB, about 1.4 us; its m * N multiply-adds take about
// 0.02 us at 67 TFLOP/s.  What is left above that is the launch, the two
// dependent round trips (wo, then rows), the trees and the write-out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 32;                    // columns per block: one per lane
constexpr int kChunk = 256;                  // rows per chunk: kWarps * 16 at most
constexpr int kPass = 8;                     // clusters per pass
constexpr int kMaxRows = 1 << 16;
constexpr int kStack = 9;                    // levels of p / kChunk <= 256 chunks

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
// the NaN of a label outside [0, C): the bits of PyTorch's new_full((), nan)
__device__ __forceinline__ void store_nan(float* p) { *p = __int_as_float(0x7fc00000); }
__device__ __forceinline__ void store_nan(__nv_bfloat16* p) {
  *p = __ushort_as_bfloat16((unsigned short)0x7fc0);
}

// LT = leaves per warp in a chunk (chunk = min(p, kChunk) rows, LT = max(1,
// chunk / kWarps)).
template <typename T, int LT>
__global__ void __launch_bounds__(kThreads)
cluster_agg_kernel(const T* __restrict__ rows, const long long* __restrict__ labels,
                   const float* __restrict__ wo, const float* __restrict__ denom,
                   T* __restrict__ out, int m, long long n, int n_clusters, int p) {
  __shared__ float wsh[kChunk][kPass];          // the chunk's wo entries of the pass
  __shared__ bool live[kChunk];                 // some cluster of the pass weighs the row > 0
  __shared__ float part[kPass][kWarps][kCols];  // the warps' subtrees of a chunk
  __shared__ float stack[kPass][kStack][kCols]; // chunk subtrees by tree level
  __shared__ float means[kPass][kCols];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long col = (long long)blockIdx.x * kCols + lane;
  const bool in = col < n;
  const int chunk = min(p, kChunk);
  const int groups = chunk / LT;               // warps holding leaves (<= kWarps)
  const int n_chunks = p / chunk;
  int top = 0;                                 // log2(n_chunks)
  while ((1 << top) < n_chunks) ++top;
  // what the end of the first pass needs, loaded now so that it arrives
  // with the first chunk's weights: this warp's cluster's denominator and
  // the labels of its first 32 output rows
  const float den_first = warp < min(kPass, n_clusters) ? denom[warp] : 1.f;
  const long long lab_first = warp + kWarps * lane < m ? labels[warp + kWarps * lane] : 0;

  for (int c0 = 0; c0 < n_clusters; c0 += kPass) {
    const int pass = min(kPass, n_clusters - c0);
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int base = ch * chunk;
      float total = 0.f;                       // this warp's cluster's chunk subtree
      if (base < m) {                          // uniform over the block
        // round trip 1: the chunk's wo entries, every load in flight
#pragma unroll
        for (int e = 0; e < kChunk * kPass / kThreads; ++e) {
          const int idx = e * kThreads + threadIdx.x;
          const int i = idx / kPass, c = idx % kPass;
          if (i < chunk && c < pass)
            wsh[i][c] = base + i < m ? wo[(long long)(base + i) * n_clusters + c0 + c] : 0.f;
        }
        __syncthreads();
        for (int i = threadIdx.x; i < chunk; i += kThreads) {
          bool any = false;
          for (int c = 0; c < pass; ++c) any |= wsh[i][c] > 0.f;
          live[i] = any;
        }
        __syncthreads();
        if (warp < groups) {
          const int first = warp * LT;         // this warp's leaves in the chunk
          // round trip 2: every row some cluster of the pass weighs > 0
          float x[LT];
#pragma unroll
          for (int j = 0; j < LT; ++j)
            x[j] = (in && live[first + j])
                       ? to_float(rows[(long long)(base + first + j) * n + col]) : 0.f;
          for (int c = 0; c < pass; ++c) {
            float v[LT];
#pragma unroll
            for (int j = 0; j < LT; ++j) {
              const float w = wsh[first + j][c];
              v[j] = w > 0.f ? __fmul_rn(w, x[j]) : 0.f;
            }
#pragma unroll
            for (int s = 1; s < LT; s *= 2)
#pragma unroll
              for (int j = 0; j < LT; j += 2 * s) v[j] = __fadd_rn(v[j], v[j + s]);
            part[c][warp][lane] = v[0];
          }
        }
        __syncthreads();
        if (warp < pass) {                     // warp = the pass's cluster index
          float g[kWarps];
#pragma unroll
          for (int k = 0; k < kWarps; ++k) g[k] = k < groups ? part[warp][k][lane] : 0.f;
#pragma unroll
          for (int s = 1; s < kWarps; s *= 2)
#pragma unroll
            for (int k = 0; k + s < kWarps; k += 2 * s)
              if (s < groups) g[k] = __fadd_rn(g[k], g[k + s]);
          total = g[0];
        }
        __syncthreads();                       // wsh and part are free for the next chunk
      }
      if (warp < pass) {                       // push the chunk's subtree
        int level = 0;
        while ((ch >> level) & 1) {
          total = __fadd_rn(stack[warp][level][lane], total);
          ++level;
        }
        stack[warp][level][lane] = total;
      }
    }
    if (warp < pass)
      means[warp][lane] =
          __fdiv_rn(stack[warp][top][lane], c0 == 0 ? den_first : denom[c0 + warp]);
    __syncthreads();
    // warp g writes output rows g, g + 16, ...: 32 of their labels in one
    // load, shared by shuffles; each row's store is coalesced across the strip
    for (int j0 = warp; j0 < m; j0 += 32 * kWarps) {
      const long long mine = j0 == warp ? lab_first
                             : j0 + kWarps * lane < m ? labels[j0 + kWarps * lane] : 0;
      const int cnt = min(32, (m - j0 + kWarps - 1) / kWarps);
      for (int jj = 0; jj < cnt; ++jj) {
        const long long lab = __shfl_sync(0xffffffffu, mine, jj);
        if (!in) continue;
        T* o = out + (long long)(j0 + kWarps * jj) * n + col;
        if (lab >= c0 && lab < c0 + pass)
          store(o, means[lab - c0][lane]);
        else if (c0 == 0 && (lab < 0 || lab >= n_clusters))
          store_nan(o);
      }
    }
    __syncthreads();                           // means and stack are free for the next pass
  }
}

template <typename T>
int launch(const void* rows, const void* labels, const void* wo, const void* denom,
           void* out, int m, long long n, int n_clusters, cudaStream_t stream) {
  int p = 1;
  while (p < m) p <<= 1;
  const long long blocks = (n + kCols - 1) / kCols;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int lt = p >= kChunk ? kChunk / kWarps : (p >= kWarps ? p / kWarps : 1);
  const T* r = static_cast<const T*>(rows);
  const long long* lab = static_cast<const long long*>(labels);
  const float* w = static_cast<const float*>(wo);
  const float* d = static_cast<const float*>(denom);
  T* o = static_cast<T*>(out);
  const dim3 grid((unsigned)blocks);
  switch (lt) {
    case 1: cluster_agg_kernel<T, 1><<<grid, kThreads, 0, stream>>>(r, lab, w, d, o, m, n, n_clusters, p); break;
    case 2: cluster_agg_kernel<T, 2><<<grid, kThreads, 0, stream>>>(r, lab, w, d, o, m, n, n_clusters, p); break;
    case 4: cluster_agg_kernel<T, 4><<<grid, kThreads, 0, stream>>>(r, lab, w, d, o, m, n, n_clusters, p); break;
    case 8: cluster_agg_kernel<T, 8><<<grid, kThreads, 0, stream>>>(r, lab, w, d, o, m, n, n_clusters, p); break;
    case 16: cluster_agg_kernel<T, 16><<<grid, kThreads, 0, stream>>>(r, lab, w, d, o, m, n, n_clusters, p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// rows: (m, n) float32 (dtype 0) or bfloat16 (dtype 1), labels: (m,) int64,
// wo: (m, C) float32, denom: (C,) float32, out: (m, n) of the rows' dtype;
// all contiguous on one device.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int cluster_agg_launch(const void* rows, const void* labels,
                                  const void* wo, const void* denom, void* out,
                                  int dtype, int m, long long n, int n_clusters,
                                  void* stream) {
  if (m <= 0 || m > kMaxRows || n <= 0 || n_clusters <= 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(rows, labels, wo, denom, out, m, n, n_clusters, s);
  return launch<__nv_bfloat16>(rows, labels, wo, denom, out, m, n, n_clusters, s);
}
