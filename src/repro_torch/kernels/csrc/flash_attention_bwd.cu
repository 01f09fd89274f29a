// Backward of causal / sliding-window GQA flash attention on Hopper (sm_90a),
// for float32 inputs, on the CUDA cores (bf16 inputs take
// csrc/flash_attention_bwd_sm90.cu, on the tensor cores).
//
// The gradient of the function that the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py) computes forward; the reference has
// no Pallas backward (JAX differentiates its jnp attention), and the port's
// forward kernels (csrc/flash_attention_sm90.cu, csrc/flash_attention.cu)
// stay as they are.  For q (B, S, Hq, hd), k and v (B, S, Hkv, hd), query
// head h reading kv head h / G (G = Hq / Hkv), the forward's output O and an
// upstream dO:
//
//     s_ij = q_i . k_j / sqrt(hd)       masked unless j <= i (causal) and
//                                       i - j < window (window > 0)
//     L_i = logsumexp_j s_ij,  P_ij = exp(s_ij - L_i),  Delta_i = dO_i . O_i
//     dv_j = sum_i P_ij dO_i,  dS_ij = P_ij (dO_i . v_j - Delta_i)
//     dq_i = sum_j dS_ij k_j / sqrt(hd),  dk_j = sum_i dS_ij q_i / sqrt(hd)
//
// with dk and dv of a kv head summed over the G query heads that read it.
//
// Design: three launches on one stream, no atomics (each output element is
// written once, by one block, so the result does not depend on scheduling):
//   1. prep_kernel: per block (b, kv head, query tile) L (in log2 units of
//      the scaled scores, by an online max and sum over the live key tiles)
//      and Delta, into float32 scratch (B, Hq, S).  The forward kernels are
//      left as they are, so the backward computes L itself.
//   2. dkdv_kernel: per block (b, kv head, tile of 32 keys), K and V staged
//      once; it walks the query tiles that can see the tile, each tile's 32
//      rows being (position, head) pairs of all G heads of the group (as the
//      forward's rows), so the sum over G happens inside the block:
//      S = Q K^T and dP = dO V^T recomputed, P and dS through shared memory,
//      dV += P^T dO and dK += dS^T Q in registers.
//   3. dq_kernel: per block (b, kv head, query tile) Q and dO staged once;
//      it walks the live key tiles: dQ += dS K in registers.
// Every block loops over its live range only, so the tiles the causal or
// windowed mask empties are never visited; the blocks with the most work
// start first.  Tiles are staged in shared memory by 16-byte loads, every
// load of a tile in flight before the
// first store; rows past S, head dims past hd and rows past the group's
// heads are zero and masked.  The products are float32 FMAs on the CUDA
// cores: 2 x 2 register tiles for S and dP (dot products over a padded
// row), 2 keys (or rows) x up to 16 head dims for the accumulations.
// q, k and v are read through their strides (unit stride over hd, rows on 16
// bytes: the wrapper checks); O, dO, dq are (B, S, Hq, hd) contiguous, dk and
// dv (B, S, Hkv, hd) contiguous.
//
// Bound on the H100: operations.  The gradient needs five products of 2 hd
// flops per live (q, k) pair (S, dP, dV, dQ, dK): at the main path's
// (2, 4096, 8 / 4, 256), causal, 2 * 8 * 8.4 M pairs, 344 GFLOP: 0.35 ms at
// the bf16 tensor-core rate (989 TFLOP/s), 5.1 ms at the float32 CUDA-core
// rate (67 TFLOP/s) this first version runs at.  It does 8 hd flops a pair
// (S and dP twice, in the prep and the dQ pass), and its inner loops read
// shared memory as often as they multiply.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;                   // query rows (position, head) a tile
constexpr int kKeys = 32;                   // keys a tile
constexpr int kPS = kKeys + 1;              // row stride of P and dS in shared memory
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e30f;           // the masked score, as in the forward

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;                               // (B, Hq, S): L in log2 units
  float* delta;                             // (B, Hq, S)
  int S, Hq, Hkv, hd, G, qt, causal, window;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;                              // 1 / sqrt(hd)
};

// four elements, as float32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}
__device__ __forceinline__ float4 axpy4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z),
                     fmaf(a, x.w, y.w));
}

// R rows of D floats (row stride D + 4) into shared memory: row r from
// src(r) (a pointer to its first element, or nullptr for a zero row), head
// dims past hd zero.  Every load in flight before the first store.
template <int D, int R, typename T, typename Src>
__device__ __forceinline__ void stage(float* dst, int hd, Src src) {
  constexpr int C = D / 4, N = R * C, PER = (N + kThreads - 1) / kThreads, ST = D + 4;
  float4 x[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * kThreads;
    x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < N) {
      const int r = e / C, d = (e - r * C) * 4;
      const T* p = src(r);
      if (p != nullptr && d < hd) x[u] = ld4(p + d);
    }
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = threadIdx.x + u * kThreads;
    if (e < N) {
      const int r = e / C, d = (e - r * C) * 4;
      st4(dst + r * ST + d, x[u]);
    }
  }
}

// s[x][y] = A[tr + 16 x] . B[tc + 16 y] over D (rows of stride D + 4)
template <int D>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm, int tr, int tc,
                                         float (&s)[2][2]) {
  constexpr int ST = D + 4;
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y) s[x][y] = 0.f;
  const float* a0p = A + tr * ST;
  const float* a1p = A + (tr + 16) * ST;
  const float* b0p = Bm + tc * ST;
  const float* b1p = Bm + (tc + 16) * ST;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 a0 = ld4(a0p + d), a1 = ld4(a1p + d);
    const float4 b0 = ld4(b0p + d), b1 = ld4(b1p + d);
    s[0][0] = dot4(a0, b0, s[0][0]);
    s[0][1] = dot4(a0, b1, s[0][1]);
    s[1][0] = dot4(a1, b0, s[1][0]);
    s[1][1] = dot4(a1, b1, s[1][1]);
  }
}

// Whether key position kp is live for query position qp.
__device__ __forceinline__ bool live_pair(const Args& a, int qp, int kp) {
  bool ok = kp < a.S;
  if (a.causal) ok = ok && kp <= qp;
  if (a.window > 0) ok = ok && qp - kp < a.window;
  return ok;
}

// The query tile's row r: its position, and its head within the group.
struct QRow {
  int pos, head;
  bool live;
};
__device__ __forceinline__ QRow qrow(const Args& a, int p0, int hk, int r) {
  QRow x;
  x.pos = p0 + r / a.G;
  x.head = hk * a.G + r % a.G;
  x.live = r < a.qt * a.G && x.pos < a.S;
  return x;
}

template <typename T>
__device__ __forceinline__ const T* q_row(const Args& a, int b, const QRow& x) {
  return x.live ? static_cast<const T*>(a.q) + b * a.q_sb + (long long)x.pos * a.q_ss +
                      (long long)x.head * a.q_sh
                : nullptr;
}
// a row of a (B, S, Hq, hd) contiguous tensor
template <typename T>
__device__ __forceinline__ const T* hq_row(const Args& a, const void* base, int b,
                                           const QRow& x) {
  return x.live ? static_cast<const T*>(base) +
                      (((long long)b * a.S + x.pos) * a.Hq + x.head) * a.hd
                : nullptr;
}

// ------------------------------------------------------------------------
// 1. L and Delta, per (b, kv head, query tile)
// ------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(kThreads) prep_kernel(const Args a) {
  constexpr int ST = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = smem + kRows * ST;

  const int b = blockIdx.z, hk = blockIdx.y;
  const int p0 = (gridDim.x - 1 - blockIdx.x) * a.qt;     // longest rows first
  const int p_hi = min(p0 + a.qt, a.S) - 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tc = lane & 15, tr = 2 * warp + (lane >> 4);

  stage<D, kRows, T>(Qs, a.hd, [&](int r) { return q_row<T>(a, b, qrow(a, p0, hk, r)); });

  // Delta = dO . O, a warp a row
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const QRow x = qrow(a, p0, hk, r);
    if (!x.live) continue;
    const T* o = hq_row<T>(a, a.o, b, x);
    const T* g = hq_row<T>(a, a.dout, b, x);
    float acc = 0.f;
    for (int d = 4 * lane; d < a.hd; d += 128) acc = dot4(ld4(o + d), ld4(g + d), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) a.delta[((long long)b * a.Hq + x.head) * a.S + x.pos] = acc;
  }

  const int kv_lo = a.window > 0 ? max(0, p0 - a.window + 1) : 0;
  const int kv_hi = a.causal ? p_hi : a.S - 1;
  const float scale2 = a.scale * kLog2e;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  QRow rows[2] = {qrow(a, p0, hk, tr), qrow(a, p0, hk, tr + 16)};
  for (int t = kv_lo / kKeys; t <= kv_hi / kKeys; ++t) {
    const int j0 = t * kKeys;
    __syncthreads();                        // every warp is done with the last K tile
    stage<D, kKeys, T>(Ks, a.hd, [&](int j) {
      const int kp = j0 + j;
      return kp < a.S ? static_cast<const T*>(a.k) + b * a.k_sb + (long long)kp * a.k_ss +
                            (long long)hk * a.k_sh
                      : nullptr;
    });
    __syncthreads();
    float s[2][2];
    dot_tile<D>(Qs, Ks, tr, tc, s);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      float mx = kMasked;
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        s[x][y] = live_pair(a, rows[x].pos, j0 + tc + 16 * y) ? s[x][y] * scale2 : kMasked;
        mx = fmaxf(mx, s[x][y]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[x], mx);
      float sum = exp2f(s[x][0] - m_new) + exp2f(s[x][1] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[x] = l[x] * exp2f(m[x] - m_new) + sum;
      m[x] = m_new;
    }
  }
  if (tc == 0) {
#pragma unroll
    for (int x = 0; x < 2; ++x)
      if (rows[x].live)
        a.lse[((long long)b * a.Hq + rows[x].head) * a.S + rows[x].pos] = m[x] + log2f(l[x]);
  }
}

// The accumulations' thread layout: each thread owns NK keys (or rows) x
// NC float4 cells of head dims; keys ks + KS n, cells cs + CS c.
template <int D>
struct AccLayout {
  static constexpr int NK = D >= 64 ? 2 : 1;
  static constexpr int KS = kKeys / NK;     // key (row) slots
  static constexpr int CS = kThreads / KS;  // cell slots
  static constexpr int NC = D / 4 / CS;     // cells a thread
  static_assert(NC >= 1 && NC * CS * 4 == D, "D / 4 cells over the cell slots");
};

template <int D>
struct BwdSmem {                            // floats
  static constexpr int ST = D + 4;
  static constexpr int k = 0;
  static constexpr int v = k + kKeys * ST;
  static constexpr int q = v + kKeys * ST;
  static constexpr int g = q + kRows * ST;  // dO
  static constexpr int p = g + kRows * ST;
  static constexpr int ds = p + kRows * kPS;
  static constexpr int lse = ds + kRows * kPS;
  static constexpr int delta = lse + kRows;
  static constexpr size_t bytes = sizeof(float) * (delta + kRows);
};

// Q, dO, L and Delta of the query tile at position p0; 0 L, Delta on dead rows
template <int D, typename T>
__device__ __forceinline__ void stage_query_tile(const Args& a, float* sm, int b, int hk,
                                                 int p0) {
  using L = BwdSmem<D>;
  stage<D, kRows, T>(sm + L::q, a.hd,
                     [&](int r) { return q_row<T>(a, b, qrow(a, p0, hk, r)); });
  stage<D, kRows, T>(sm + L::g, a.hd,
                     [&](int r) { return hq_row<T>(a, a.dout, b, qrow(a, p0, hk, r)); });
  if (threadIdx.x < kRows) {
    const QRow x = qrow(a, p0, hk, threadIdx.x);
    const long long at = ((long long)b * a.Hq + x.head) * a.S + x.pos;
    sm[L::lse + threadIdx.x] = x.live ? a.lse[at] : 0.f;
    sm[L::delta + threadIdx.x] = x.live ? a.delta[at] : 0.f;
  }
}

template <int D, typename T>
__device__ __forceinline__ void stage_kv_tile(const Args& a, float* sm, int b, int hk,
                                              int j0) {
  using L = BwdSmem<D>;
  stage<D, kKeys, T>(sm + L::k, a.hd, [&](int j) {
    const int kp = j0 + j;
    return kp < a.S ? static_cast<const T*>(a.k) + b * a.k_sb + (long long)kp * a.k_ss +
                          (long long)hk * a.k_sh
                    : nullptr;
  });
  stage<D, kKeys, T>(sm + L::v, a.hd, [&](int j) {
    const int kp = j0 + j;
    return kp < a.S ? static_cast<const T*>(a.v) + b * a.v_sb + (long long)kp * a.v_ss +
                          (long long)hk * a.v_sh
                    : nullptr;
  });
}

// P and dS of the staged (query tile, key tile) into shared memory
template <int D>
__device__ __forceinline__ void p_and_ds(const Args& a, float* sm, int hk, int p0, int j0) {
  using L = BwdSmem<D>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tc = lane & 15, tr = 2 * warp + (lane >> 4);
  const float scale2 = a.scale * kLog2e;
  float s[2][2], dp[2][2];
  dot_tile<D>(sm + L::q, sm + L::k, tr, tc, s);
  dot_tile<D>(sm + L::g, sm + L::v, tr, tc, dp);
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = tr + 16 * x;
    const QRow row = qrow(a, p0, hk, r);
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const int j = tc + 16 * y;
      const float p = row.live && live_pair(a, row.pos, j0 + j)
                          ? exp2f(s[x][y] * scale2 - sm[L::lse + r])
                          : 0.f;
      sm[L::p + r * kPS + j] = p;
      sm[L::ds + r * kPS + j] = p * (dp[x][y] - sm[L::delta + r]);
    }
  }
}

// ------------------------------------------------------------------------
// 2. dK and dV, per (b, kv head, key tile)
// ------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(const Args a) {
  using L = BwdSmem<D>;
  using A = AccLayout<D>;
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.z, hk = blockIdx.y;
  const int j0 = blockIdx.x * kKeys;        // causal: the first key tiles see the most rows
  const int ks = threadIdx.x % A::KS, cs = threadIdx.x / A::KS;

  stage_kv_tile<D, T>(a, sm, b, hk, j0);
  const int j_hi = min(j0 + kKeys, a.S) - 1;
  const int q_lo = a.causal ? j0 : 0;
  const int q_hi = a.window > 0 ? min(a.S - 1, j_hi + a.window - 1) : a.S - 1;

  float4 dk[A::NK][A::NC], dv[A::NK][A::NC];
#pragma unroll
  for (int n = 0; n < A::NK; ++n)
#pragma unroll
    for (int c = 0; c < A::NC; ++c) {
      dk[n][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      dv[n][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  for (int tq = q_lo / a.qt; tq <= q_hi / a.qt; ++tq) {
    const int p0 = tq * a.qt;
    __syncthreads();                        // the last query tile is consumed
    stage_query_tile<D, T>(a, sm, b, hk, p0);
    __syncthreads();
    p_and_ds<D>(a, sm, hk, p0, j0);
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q
#pragma unroll 2
    for (int r = 0; r < kRows; ++r) {
      float p[A::NK], ds[A::NK];
#pragma unroll
      for (int n = 0; n < A::NK; ++n) {
        p[n] = sm[L::p + r * kPS + ks + A::KS * n];
        ds[n] = sm[L::ds + r * kPS + ks + A::KS * n];
      }
#pragma unroll
      for (int c = 0; c < A::NC; ++c) {
        const int d = 4 * (cs + A::CS * c);
        const float4 g = ld4(sm + L::g + r * L::ST + d);
        const float4 q = ld4(sm + L::q + r * L::ST + d);
#pragma unroll
        for (int n = 0; n < A::NK; ++n) {
          dv[n][c] = axpy4(p[n], g, dv[n][c]);
          dk[n][c] = axpy4(ds[n], q, dk[n][c]);
        }
      }
    }
  }
#pragma unroll
  for (int n = 0; n < A::NK; ++n) {
    const int kp = j0 + ks + A::KS * n;
    if (kp >= a.S) continue;
    const long long row = (((long long)b * a.S + kp) * a.Hkv + hk) * a.hd;
#pragma unroll
    for (int c = 0; c < A::NC; ++c) {
      const int d = 4 * (cs + A::CS * c);
      if (d >= a.hd) continue;
      const float4 x = dk[n][c];
      st4(static_cast<T*>(a.dk) + row + d,
          make_float4(x.x * a.scale, x.y * a.scale, x.z * a.scale, x.w * a.scale));
      st4(static_cast<T*>(a.dv) + row + d, dv[n][c]);
    }
  }
}

// ------------------------------------------------------------------------
// 3. dQ, per (b, kv head, query tile)
// ------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(const Args a) {
  using L = BwdSmem<D>;
  using A = AccLayout<D>;
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.z, hk = blockIdx.y;
  const int p0 = (gridDim.x - 1 - blockIdx.x) * a.qt;     // longest rows first
  const int p_hi = min(p0 + a.qt, a.S) - 1;
  const int rs = threadIdx.x % A::KS, cs = threadIdx.x / A::KS;

  stage_query_tile<D, T>(a, sm, b, hk, p0);
  const int kv_lo = a.window > 0 ? max(0, p0 - a.window + 1) : 0;
  const int kv_hi = a.causal ? p_hi : a.S - 1;

  float4 dq[A::NK][A::NC];
#pragma unroll
  for (int n = 0; n < A::NK; ++n)
#pragma unroll
    for (int c = 0; c < A::NC; ++c) dq[n][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int t = kv_lo / kKeys; t <= kv_hi / kKeys; ++t) {
    const int j0 = t * kKeys;
    __syncthreads();                        // the last key tile is consumed
    stage_kv_tile<D, T>(a, sm, b, hk, j0);
    __syncthreads();
    p_and_ds<D>(a, sm, hk, p0, j0);
    __syncthreads();
    // dQ += dS K
#pragma unroll 2
    for (int j = 0; j < kKeys; ++j) {
      float ds[A::NK];
#pragma unroll
      for (int n = 0; n < A::NK; ++n) ds[n] = sm[L::ds + (rs + A::KS * n) * kPS + j];
#pragma unroll
      for (int c = 0; c < A::NC; ++c) {
        const float4 kk = ld4(sm + L::k + j * L::ST + 4 * (cs + A::CS * c));
#pragma unroll
        for (int n = 0; n < A::NK; ++n) dq[n][c] = axpy4(ds[n], kk, dq[n][c]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < A::NK; ++n) {
    const QRow x = qrow(a, p0, hk, rs + A::KS * n);
    if (!x.live) continue;
    T* row = static_cast<T*>(a.dq) + (((long long)b * a.S + x.pos) * a.Hq + x.head) * a.hd;
#pragma unroll
    for (int c = 0; c < A::NC; ++c) {
      const int d = 4 * (cs + A::CS * c);
      if (d >= a.hd) continue;
      const float4 g = dq[n][c];
      st4(row + d, make_float4(g.x * a.scale, g.y * a.scale, g.z * a.scale, g.w * a.scale));
    }
  }
}

template <int D, typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  const int nq = (a.S + a.qt - 1) / a.qt, nk = (a.S + kKeys - 1) / kKeys;
  const size_t prep_bytes = sizeof(float) * (kRows + kKeys) * (D + 4);
  const size_t bytes = BwdSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(prep_kernel<D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)prep_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_kernel<D, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
  if (err != cudaSuccess) return (int)err;
  prep_kernel<D, T><<<dim3(nq, a.Hkv, B), kThreads, prep_bytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dkdv_kernel<D, T><<<dim3(nk, a.Hkv, B), kThreads, bytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dq_kernel<D, T><<<dim3(nq, a.Hkv, B), kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const Args& a, int B, cudaStream_t s) {
  if (a.hd <= 32) return launch<32, T>(a, B, s);
  if (a.hd <= 64) return launch<64, T>(a, B, s);
  if (a.hd <= 128) return launch<128, T>(a, B, s);
  return launch<256, T>(a, B, s);
}

}  // namespace

// q (B, S, Hq, hd), k and v (B, S, Hkv, hd), float32, each with unit stride
// over hd, the given element strides over
// (b, s, h), and every row on 16 bytes; out, dout and dq (B, S, Hq, hd) and
// dk, dv (B, S, Hkv, hd) contiguous in the same dtype; lse and delta
// (B, Hq, S) float32 scratch.  Three launches on `stream`; returns the first
// cudaGetLastError() that is not 0 (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    void* dq, void* dk, void* dv, void* lse, void* delta, int B, int S, int Hq, int Hkv,
    int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, int causal, int window,
    float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 16 || hd <= 0 ||
      hd % 4 != 0 || hd > 256 || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse = static_cast<float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.S = S;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.hd = hd;
  a.G = Hq / Hkv;
  a.qt = kRows / a.G;
  a.causal = causal;
  a.window = window;
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_dtype<float>(a, B, s);
}
