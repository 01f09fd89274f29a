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
// are O(m C) and come from the wrapper.
//
// Design.  The TPU kernel kept the (m, m) mixing matrix resident and
// streamed (m, BN) tiles through one MXU product, in whatever order the MXU
// sums.  Here one thread owns one column: neighbouring threads read
// neighbouring addresses of each row.  For each cluster the thread walks
// i = 0..p-1 once with a stack of partial sums by tree level (17 levels, so
// m <= 2^16): it pushes each leaf and, while bit l of i is set, adds the
// level-l partial (left) to the carry (right) and moves it up a level — the
// pairwise tree in one pass, no scratch.  A row is loaded only for the
// cluster whose weight is positive, so each row is read once in all and a
// zero-weight row (NaN or garbage) is never read.  Then the mean is written
// to every row of that cluster.  Every product, sum and quotient is an
// explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn):
// nvcc never contracts those into an FMA, which would move bits.
//
// Bound on the H100 (3.35 TB/s HBM): bytes.  At the main path's (100, 6570)
// the kernel must read 2.63 MB and write 2.63 MB, about 1.57 us; its
// m * N multiply-adds take about 0.02 us at 67 TFLOP/s.  This first version
// aims to be right: each thread walks its column serially.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kLevels = 17;                  // p <= 2^16

__global__ void __launch_bounds__(kThreads)
cluster_agg_kernel(const float* __restrict__ rows, const int* __restrict__ labels,
                   const float* __restrict__ wo, const float* __restrict__ denom,
                   float* __restrict__ out, int m, long long n, int n_clusters,
                   int p) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= n) return;
  float stack[kLevels];
  for (int c = 0; c < n_clusters; ++c) {
    for (int i = 0; i < p; ++i) {
      float v = 0.f;
      if (i < m) {
        const float w = wo[(long long)i * n_clusters + c];
        if (w > 0.f) v = __fmul_rn(w, rows[(long long)i * n + col]);
      }
      int level = 0;
      while ((i >> level) & 1) {
        v = __fadd_rn(stack[level], v);
        ++level;
      }
      stack[level] = v;
    }
    int top = 0;
    while ((1 << top) < p) ++top;
    const float mean = __fdiv_rn(stack[top], denom[c]);
    for (int j = 0; j < m; ++j)
      if (labels[j] == c) out[(long long)j * n + col] = mean;
  }
  for (int j = 0; j < m; ++j)
    if (labels[j] < 0 || labels[j] >= n_clusters)
      out[(long long)j * n + col] = __int_as_float(0x7fc00000);   // NaN
}

}  // namespace

// rows: (m, n) float32, labels: (m,) int32, wo: (m, C) float32, denom: (C,)
// float32, out: (m, n) float32; all contiguous on one device.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int cluster_agg_launch(const void* rows, const void* labels,
                                  const void* wo, const void* denom, void* out,
                                  int m, long long n, int n_clusters,
                                  void* stream) {
  if (m <= 0 || m > (1 << (kLevels - 1)) || n <= 0 || n_clusters <= 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  int p = 1;
  while (p < m) p <<= 1;
  cluster_agg_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(rows), static_cast<const int*>(labels),
      static_cast<const float*>(wo), static_cast<const float*>(denom),
      static_cast<float*>(out), m, n, n_clusters, p);
  return (int)cudaGetLastError();
}
