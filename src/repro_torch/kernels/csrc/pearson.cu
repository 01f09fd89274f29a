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
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s fp32): bytes.  At the main
// path's (100, 32) the kernel must read 12.8 KB and write 40 KB, about
// 0.016 us, and its 0.64 MFLOP take about 0.01 us: the floor is one launch
// (an empty kernel, csrc/launch_floor.cu) plus one memory round trip, so the
// design spends exactly one launch and keeps its own critical path short.
//
// Design.  As the TPU kernel does in each grid cell, a block computes the
// statistics of the rows it needs itself; no statistics pass through global
// memory and no second kernel runs:
//   * a block owns one kTile x kTile output tile (bi, bj) with bi <= bj and
//     writes it and its mirror (bj, bi), so the output is exactly symmetric;
//     blocks below the diagonal leave at once.  kTile = 16: 28 blocks at
//     the path's (100, 32); of 16, 32 and 64 it was the fastest there and
//     at (300, 600);
//   * kTpr neighbouring threads hold one row of the tile's i-rows and
//     j-rows (one set on the diagonal), 4 columns each per group, loaded
//     with every load in flight before any is used: 16-byte loads where
//     D % 4 == 0 and the rows are 16-byte aligned, scalar loads otherwise,
//     the ragged edge masked to zero;
//   * the statistics come from those registers in two passes, as the
//     reference computes them (the mean, then the centred sum of squares; a
//     one-pass sum(x^2)/D - mu^2 loses digits on rows with a large mean),
//     each a sum over the row's kTpr lanes by shuffles: no shared memory and
//     no block barrier;
//   * the centred rows go to shared memory once (padding stays 0; rows 16
//     bytes aligned), one barrier, and the gram is formed on the CUDA cores
//     from 16-byte shared loads, each thread 1..16 outputs in two
//     accumulators (even and odd columns) to halve the dependent chain;
//   * where D fits one chunk of kChunk columns the rows are read once; a
//     wider D streams its chunks three times (sums, centred squares, gram),
//     from L2 after the first pass.
// Tensor cores buy nothing here: at D = 32 the gram is 0.64 MFLOP, and TF32
// products would cost the 1e-5 tolerance.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;                   // output tile side
constexpr int kChunk = 64;                  // columns held at a time
constexpr int kPad = kChunk + 4;            // +4: rows 16-byte aligned, 4 banks apart

struct Smem {
  alignas(16) float x[2][kTile][kPad];      // centred i-rows, j-rows of a chunk
  float norm[2][kTile];
};

// This thread's columns of chunk [c0, c0 + kChunk): groups of 4 columns
// part, part + kTpr, ... (neighbouring threads on neighbouring groups), zero
// past d and for a row that is not live.  Every load is issued before any
// is used.
template <int kTpr, int kGroups>
__device__ __forceinline__ void load_chunk(const float* __restrict__ xr, bool live,
                                           int d, int c0, int part, bool vec4,
                                           float4 (&v)[kGroups]) {
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int c = c0 + 4 * (part + kTpr * k);
    v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!live) continue;
    if (vec4) {                             // d % 4 == 0: a group is whole
      if (c < d) v[k] = __ldg(reinterpret_cast<const float4*>(xr + c));
    } else {
      if (c < d) v[k].x = __ldg(xr + c);
      if (c + 1 < d) v[k].y = __ldg(xr + c + 1);
      if (c + 2 < d) v[k].z = __ldg(xr + c + 2);
      if (c + 3 < d) v[k].w = __ldg(xr + c + 3);
    }
  }
}

// Sum over the kTpr neighbouring lanes that hold one row.
template <int kTpr>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = kTpr / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int kGroups>
__device__ __forceinline__ float chunk_sum(const float4 (&v)[kGroups]) {
  float t = 0.f;
#pragma unroll
  for (int k = 0; k < kGroups; ++k) t += (v[k].x + v[k].y) + (v[k].z + v[k].w);
  return t;
}

// sum of (x - mu)^2 over the columns below d
template <int kTpr, int kGroups>
__device__ __forceinline__ float chunk_centred_squares(const float4 (&v)[kGroups], float mu,
                                                       int d, int c0, int part) {
  float t = 0.f;
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int c = c0 + 4 * (part + kTpr * k);
    const float e[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float cv = c + q < d ? e[q] - mu : 0.f;
      t += cv * cv;
    }
  }
  return t;
}

__global__ void __launch_bounds__(kThreads)
pearson_kernel(const float* __restrict__ x, float* __restrict__ out, int m, int d,
               float eps, bool vec4) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bi > bj) return;                     // written by its mirror tile
  constexpr int kTpr = kThreads / (2 * kTile);        // threads a row
  constexpr int kGroups = kChunk / (4 * kTpr);        // 4-column groups a thread
  constexpr int kOutPer = kTile * kTile / kThreads;   // outputs a thread
  constexpr int kCols = kThreads / kTile;             // threads across a tile row
  static_assert(kTpr >= 1 && kTpr <= 32 && kGroups >= 1, "tile does not fit the block");
  static_assert(kTile * kTile % kThreads == 0 && kTile <= kPad, "tile must cover the block");
  __shared__ Smem s;
  const int tid = threadIdx.x;
  // thread -> (row set, row, part): i-rows then j-rows, kTpr threads a row
  const int set = tid / (kTile * kTpr), r = (tid / kTpr) % kTile, part = tid % kTpr;
  const int sets = bi == bj ? 1 : 2;       // the diagonal tile has one row set
  const int row = (set ? bj : bi) * kTile + r;
  const bool live = set < sets && row < m;
  const float* xr = x + (long long)(live ? row : 0) * d;
  const int nchunks = (d + kChunk - 1) / kChunk;
  const bool resident = nchunks == 1;      // the one chunk stays in registers

  float4 v[kGroups];
  float sum = 0.f;
  for (int ch = 0; ch < nchunks; ++ch) {
    load_chunk<kTpr>(xr, live, d, ch * kChunk, part, vec4, v);
    sum += chunk_sum(v);
  }
  const float mu = row_sum<kTpr>(sum) / (float)d;
  float ss = 0.f;
  for (int ch = 0; ch < nchunks; ++ch) {
    if (!resident) load_chunk<kTpr>(xr, live, d, ch * kChunk, part, vec4, v);
    ss += chunk_centred_squares<kTpr>(v, mu, d, ch * kChunk, part);
  }
  ss = row_sum<kTpr>(ss);
  if (part == 0) s.norm[set][r] = fmaxf(sqrtf(ss), eps);

  // the centred gram: thread (ty, tx) takes row ty of the i-set and rows
  // tx, tx + kCols, ... of the j-set
  const int ty = tid / kCols, tx = tid % kCols;
  const int jset = sets - 1;
  float g[2][kOutPer];                     // even and odd columns: half the chain
#pragma unroll
  for (int k = 0; k < kOutPer; ++k) g[0][k] = g[1][k] = 0.f;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int c0 = ch * kChunk;
    if (!resident) load_chunk<kTpr>(xr, live, d, c0, part, vec4, v);
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int c = 4 * (part + kTpr * k);
      const float4 u = v[k];
      *reinterpret_cast<float4*>(&s.x[set][r][c]) = make_float4(
          c0 + c < d ? u.x - mu : 0.f, c0 + c + 1 < d ? u.y - mu : 0.f,
          c0 + c + 2 < d ? u.z - mu : 0.f, c0 + c + 3 < d ? u.w - mu : 0.f);
    }
    __syncthreads();
    const int depth = min(kChunk, d - c0 + 3) & ~3;   // the padding columns are 0
#pragma unroll 2
    for (int c = 0; c < depth; c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(&s.x[0][ty][c]);
#pragma unroll
      for (int k = 0; k < kOutPer; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(&s.x[jset][tx + k * kCols][c]);
        g[0][k] += a.x * b.x;
        g[1][k] += a.y * b.y;
        g[0][k] += a.z * b.z;
        g[1][k] += a.w * b.w;
      }
    }
    if (ch + 1 < nchunks) __syncthreads();   // before the next chunk lands
  }

  // out: the tile, and its mirror below the diagonal
  const int i = bi * kTile + ty;
#pragma unroll
  for (int k = 0; k < kOutPer; ++k) {
    const int jj = tx + k * kCols, j = bj * kTile + jj;
    const float corr = fminf(fmaxf((g[0][k] + g[1][k]) / (s.norm[0][ty] * s.norm[jset][jj]),
                                   -1.f), 1.f);
    if (i < m && j < m) {
      out[(long long)i * m + j] = corr;
      if (bi != bj) out[(long long)j * m + i] = corr;
    }
  }
}

}  // namespace

// x: (m, d) float32 contiguous.  out: (m, m) float32 (every element is
// written).  Launches one kernel on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int pearson_launch(const void* x, void* out, int m, int d, float eps,
                              void* stream) {
  const int nt = (m + kTile - 1) / kTile;
  if (m <= 0 || d <= 0 || nt > 65535) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const bool vec4 = d % 4 == 0 && ((unsigned long long)xp & 15ull) == 0;
  pearson_kernel<<<dim3(nt, nt), kThreads, 0, (cudaStream_t)stream>>>(
      xp, static_cast<float*>(out), m, d, eps, vec4);
  return (int)cudaGetLastError();
}
