// Pearson correlation matrix of prototype rows on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `pearson_matrix_pallas` / `_pearson_kernel`
// in src/repro/kernels/pearson.py (and the engine's jnp form,
// src/repro/core/pearson.py::pearson_matrix).  For x (m, D) float32:
//
//     mu_i      = sum_d x[i, d] / D
//     norm_i    = max(sqrt(sum_d (x[i, d] - mu_i)^2), eps)
//     out[i, j] = clamp(sum_d (x[i,d]-mu_i)(x[j,d]-mu_j) / (norm_i norm_j), -1, 1)
//
// Design.  The TPU kernel padded D to its 128-lane tiles with each row's
// mean (so padding centred to zero) and blocked a gram product on the MXU.
// None of that carries over; here two kernels run from one entry point:
//   * stats: one warp per row, lanes stride over the true D (the ragged
//     edge is masked by the loop bound, no padding), shuffle reductions for
//     the sum and then for the centred sum of squares;
//   * gram: one thread per output (i, j) in 16 x 16 blocks; each block
//     stages 16 centred rows of i and of j through shared memory, 32
//     columns at a time, so a row is read from L2 once per block and not
//     once per thread.
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s fp32): bytes.  At the main
// path's (100, 32) the kernel must read 12.8 KB and write 40 KB, about
// 0.016 us, while its 0.6 MFLOP take about 0.01 us; the two launches
// themselves (a few us) dominate.  This first version aims to be right.

#include <cuda_runtime.h>

namespace {

constexpr int kStatsThreads = 256;           // 8 warps: 8 rows per block
constexpr int kTile = 16;                    // output tile is kTile x kTile
constexpr int kDepth = 32;                   // columns staged per step

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// stats[0, i] = mu_i, stats[1, i] = norm_i
__global__ void __launch_bounds__(kStatsThreads)
row_stats_kernel(const float* __restrict__ x, float* __restrict__ stats,
                 int m, int d, float eps) {
  const int row = blockIdx.x * (kStatsThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= m) return;                       // whole warp leaves together
  const float* p = x + (long long)row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += p[c];
  const float mu = warp_sum(s) / (float)d;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = p[c] - mu;
    ss += v * v;
  }
  ss = warp_sum(ss);
  if (lane == 0) {
    stats[row] = mu;
    stats[m + row] = fmaxf(sqrtf(ss), eps);
  }
}

__global__ void __launch_bounds__(kTile * kTile)
gram_kernel(const float* __restrict__ x, const float* __restrict__ stats,
            float* __restrict__ out, int m, int d) {
  __shared__ float ti[kTile][kDepth + 1];     // +1: no bank conflicts
  __shared__ float tj[kTile][kDepth + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  const int t = ty * kTile + tx;              // 256 threads fill 1024 slots
  float acc = 0.f;
  for (int c0 = 0; c0 < d; c0 += kDepth) {
    for (int s = t; s < 2 * kTile * kDepth; s += kTile * kTile) {
      const int which = s / (kTile * kDepth);  // 0: rows i, 1: rows j
      const int r = (s / kDepth) % kTile;
      const int c = s % kDepth;
      const int row = (which ? j0 : i0) + r;
      float v = 0.f;                          // off the edge: adds nothing
      if (row < m && c0 + c < d) v = x[(long long)row * d + c0 + c] - stats[row];
      float (*tile)[kDepth + 1] = which ? tj : ti;
      tile[r][c] = v;
    }
    __syncthreads();
    const int depth = min(kDepth, d - c0);
    for (int c = 0; c < depth; ++c) acc += ti[ty][c] * tj[tx][c];
    __syncthreads();
  }
  const int i = i0 + ty, j = j0 + tx;
  if (i < m && j < m) {
    const float corr = acc / (stats[m + i] * stats[m + j]);
    out[(long long)i * m + j] = fminf(fmaxf(corr, -1.f), 1.f);
  }
}

}  // namespace

// x: (m, d) float32 contiguous.  stats: (2, m) float32 scratch.  out: (m, m)
// float32.  Launches both kernels on `stream` and returns cudaGetLastError()
// after each (0 on success).
extern "C" int pearson_launch(const void* x, void* stats, void* out, int m,
                              int d, float eps, void* stream) {
  if (m <= 0 || d <= 0 || (m + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int rows_per_block = kStatsThreads / 32;
  row_stats_kernel<<<(m + rows_per_block - 1) / rows_per_block, kStatsThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(stats), m, d, eps);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid((m + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  gram_kernel<<<grid, dim3(kTile, kTile), 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(stats),
      static_cast<float*>(out), m, d);
  return (int)cudaGetLastError();
}
