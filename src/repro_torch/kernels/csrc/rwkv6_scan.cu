// RWKV6 wkv recurrence with data-dependent decay on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rwkv6_scan` / `_wkv_kernel` in
// src/repro/kernels/rwkv6_scan.py.  Per (batch b, head h), with r, k, v, w
// (B, H, T, hd) float32, u (H, hd), state S (hd_k x hd_v) from s0:
//
//     y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//     S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
//
// returning y (B, H, T, hd) and S_T (B, H, hd, hd).  Calls compose: running
// two halves of a sequence with the state carried gives the whole.
//
// Design.  The TPU kernel kept the (hd, hd) state in a VMEM scratch and
// updated it with (hd, 1) x (1, hd) broadcast products over a fori_loop in
// time, one program per (b, h).  On the H100 that serial form leaves the
// card idle: B * H = 80 blocks on 132 SMs, each a chain of T dependent
// steps (about 400 ns a step at the main path's shape, chip_smoke.py).  So
// for T >= kChunk = 64 the recurrence runs in its chunked-parallel form (as
// RWKV6's own chunked kernels and flash-linear-attention's chunk_rwkv6):
// one block a chunk, B H T / 64 blocks (5120 at the main shape), each
//
//   1. from a zero state: A[t][s] = r_t . (k_s * w_{s+1} ... w_{t-1}) for
//      s < t, with the bonus (sum_i r_t[i] u[i] k_t[i]) on the diagonal
//      (5 hd^2 flops a step, not 7); y_intra = A v; the chunk's own state
//      K_c = sum_s (k_s * w_{s+1} ... w_last) v_s^T and decay D_c = prod_t
//      w_t.  Decays are only ever multiplied: no division by a cumulative
//      decay, no log of a w that may be 0, no factor above 1, and w = 0
//      leaves K_c exactly the last k v^T.  Within sub-chunks of 16 steps,
//      thread (s, p) carries q_s = k_s * (product so far) forward in t
//      (its quarter p of the channels; 15 serial steps at most); across
//      sub-chunks A is a product of r^ (r decayed from its sub-chunk's
//      start), the whole products of the sub-chunks between and k^ (k
//      decayed to its sub-chunk's end).
//   2. takes S_c from the chunk before (s0 at c = 0) and hands on S_{c+1} =
//      diag(D_c) S_c + K_c through global memory (two slots a (b, h), a
//      release flag a chunk; blocks take their chunk from an atomic ticket,
//      (b, h) fastest, so the chunk a block waits on is always running or
//      done), or writes it to sT at the last chunk.  Given a `states`
//      buffer it also stores S_c, the state every chunk starts from, for
//      the backward (csrc/rwkv6_scan_bwd.cu); inference passes null.
//   3. adds y_inter = (r_t * w_start ... w_{t-1}) . S_c and writes y once.
//
// r, k, v, w are staged in shared memory by 16-byte cp.async copies (rows
// must start on 16 bytes: the wrapper checks), a ragged last chunk
// zero-filled with its padded decays set to 1; the products run in 4 x 4
// register tiles over float4 shared loads.  Only the state hand-off is
// serial, and it overlaps the other chunks' work.
// Decode (T = 1) and any T < kChunk keep the recurrent kernel, wkv_kernel:
// one block per (b, h) holding the state in registers, four threads a
// state column.
//
// Bound on the H100: bytes.  At the main path's (2, 40, 4096, 64) the
// function must read r, k, v, w (336 MB) and write y (84 MB), 126 us at
// 3.35 TB/s; its 5 hd^2 + 5 hd flops a step come to 6.8 GFLOP, 102 us at
// 67 TFLOP/s fp32.  The chunked form reads and writes just those bytes
// (the states it hands on stay in L2), but does more arithmetic than the
// recurrence (A and y_intra besides the state products), on the CUDA
// cores.

#include <cuda_runtime.h>

namespace {

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;    // (H, hd) contiguous
  const float* s0;   // (B, H, hd, hd) contiguous
  float* y;
  float* sT;         // (B, H, hd, hd) contiguous
  float* slots;      // (B, H, 2, hd, hd): the states passed between chunks
  unsigned* sync;    // 1 + B H nc, zeroed: the ticket counter, then one flag
                     // a chunk (its S_{c+1} published)
  float* states;     // (B, H, nc, hd, hd): each chunk's S_c, or null
  int H, T, nc;
  long long r_sb, r_sh, r_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, w_sb, w_sh, w_st;
  long long y_sb, y_sh, y_st;
};

// ------------------------------------------------------------------------
// The recurrent kernel (T < kChunk: decode)
// ------------------------------------------------------------------------

constexpr int kParts = 4;                   // threads per state column

template <int HD>
__global__ void __launch_bounds__(kParts * HD)
wkv_kernel(const Args a) {
  constexpr int R = HD / kParts;            // state rows per thread
  constexpr int kSteps = 2048 / HD < 64 ? 2048 / HD : 64;   // steps staged at once
  constexpr int kLoads = kSteps / kParts;   // staged steps each thread loads
  __shared__ float4 rkwu[kSteps][HD];       // (r, k, w, u) of channel i at step tt
  __shared__ float vs[kSteps][HD];

  const int b = blockIdx.x / a.H, h = blockIdx.x - (blockIdx.x / a.H) * a.H;
  const int j = threadIdx.x / kParts, p = threadIdx.x % kParts;
  const long long bh = (long long)b * a.H + h;

  float s[R];                               // S[4 r + p][j]
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = a.s0[(bh * HD + kParts * r + p) * HD + j];
  const float uj = a.u[(long long)h * HD + j];

  const float* rp = a.r + b * a.r_sb + h * a.r_sh + j;
  const float* kp = a.k + b * a.k_sb + h * a.k_sh + j;
  const float* vp = a.v + b * a.v_sb + h * a.v_sh + j;
  const float* wp = a.w + b * a.w_sb + h * a.w_sh + j;
  float* yp = a.y + b * a.y_sb + h * a.y_sh + j;

  for (int t0 = 0; t0 < a.T; t0 += kSteps) {
    const int n = min(kSteps, a.T - t0);
    float rr[kLoads], kk[kLoads], ww[kLoads], vv[kLoads];
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {      // every load of the stage in flight
      const int tt = kParts * l + p;
      if (tt < n) {
        const long long t = t0 + tt;
        rr[l] = rp[t * a.r_st];
        kk[l] = kp[t * a.k_st];
        ww[l] = wp[t * a.w_st];
        vv[l] = vp[t * a.v_st];
      }
    }
    __syncthreads();                        // the previous stage is consumed
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      const int tt = kParts * l + p;
      if (tt < n) {
        rkwu[tt][j] = make_float4(rr[l], kk[l], ww[l], uj);
        vs[tt][j] = vv[l];
      }
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = vs[tt][j];
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 x = rkwu[tt][kParts * r + p];
        const float kv = x.y * vj;
        const float out = x.x * fmaf(x.w, kv, s[r]);
        if (r & 1) acc1 += out; else acc0 += out;
        s[r] = fmaf(s[r], x.z, kv);
      }
      float yj = acc0 + acc1;
      yj += __shfl_xor_sync(0xffffffffu, yj, 1);
      yj += __shfl_xor_sync(0xffffffffu, yj, 2);
      if (p == 0) yp[(t0 + tt) * a.y_st] = yj;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) a.sT[(bh * HD + kParts * r + p) * HD + j] = s[r];
}

// ------------------------------------------------------------------------
// The chunked form (T >= kChunk)
// ------------------------------------------------------------------------

constexpr int kChunk = 64;                  // time steps per chunk (L)
constexpr int kThreads = 4 * kChunk;        // four threads a step in step 1
constexpr int kPad = 4;                     // floats of row padding

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[x][y] += a[x] b[y] over a 4 x 4 register tile
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
}

// rows [t0, t0 + n) of the (b, h) slice of x into dst (kChunk x RS floats,
// HD used), zero-filled past n
template <int HD>
__device__ __forceinline__ void stage_rows(float* dst, const float* x, long long sb,
                                           long long sh, long long st, int b, int h,
                                           int t0, int n) {
  constexpr int RS = HD + kPad, CH = HD / 4;
  const float* base = x + b * sb + h * sh;
  for (int e = threadIdx.x; e < kChunk * CH; e += blockDim.x) {
    const int t = e / CH, d = (e - t * CH) * 4;
    cp_async16(dst + t * RS + d, base + (long long)(t0 + (t < n ? t : 0)) * st + d,
               t < n ? 16 : 0);
  }
}

constexpr int kSub = 16;                    // steps a sub-chunk
constexpr int kSubs = kChunk / kSub;
static_assert(kSubs == 4, "the cross-sub-chunk pairs below are spelled out for 4");

template <int HD>
struct ChunkSmem {                          // floats
  static constexpr int RS = HD + kPad;      // rows of r (then k^T), k, v, w: one a step
  static constexpr int AS = kChunk + kPad;  // At[s][t] = A[t][s]
  static constexpr int TS = kChunk + kPad;  // rows of r^ and k^T: one a channel
  static constexpr int SS = HD + kPad;      // rows of S_c (over k and v, once read)
  static constexpr int k = kChunk * RS > HD * TS ? kChunk * RS : HD * TS;
  static constexpr int v = k + kChunk * RS;
  static constexpr int w = v + kChunk * RS;
  static constexpr int at = w + kChunk * RS;
  static constexpr int rt = at + kChunk * AS;
  static constexpr int f = rt + HD * TS;    // F[g][i], then D_c[i]
  static constexpr size_t bytes = sizeof(float) * (f + (kSubs + 1) * HD);
  static_assert(HD * SS <= 2 * kChunk * RS, "S_c fits over k and v");
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// One chunk (c, b, h) of the chunked form, from a ticket: tickets run (b, h)
// fastest, so chunk c - 1 of the same (b, h) holds an earlier ticket and is
// running or done whenever chunk c waits on it.
//   1. from a zero state, with sub-chunks of 16 steps: A[t][s] for t, s in
//      one sub-chunk by carrying q_s forward (15 serial steps at most); for
//      s in sub-chunk a before t in sub-chunk c', A[t][s] = sum_i r^_t[i]
//      M[i] k^_s[i], r^_t = r_t * (decays from c''s start to t - 1), k^_s =
//      k_s * (decays from s + 1 to a's end), M the whole products F of the
//      sub-chunks between: all products, no factor above 1.  The bonus on
//      A's diagonal; y = A v and K_c = sum_g diag(F_{g+1} ... F_last)
//      sum_{s in g} k^_s v_s^T in registers, D_c = prod_g F_g.
//   2. wait for S_c from chunk c - 1 (s0 at c = 0), publish S_{c+1} =
//      diag(D_c) S_c + K_c (two slots a (b, h): chunk c + 1 writes over S_c
//      only after chunk c has read it), or write it to sT at the last chunk.
//   3. y_t += (r^_t * F_0 ... F_{g(t)-1}) . S_c; write y.
template <int HD>
__global__ void __launch_bounds__(kThreads)
wkv_chunk_kernel(const Args a, int BH) {
  using L = ChunkSmem<HD>;
  constexpr int RS = L::RS, AS = L::AS, TS = L::TS, SS = L::SS;
  constexpr int Q = HD / 4;                 // channels a thread carries in step 1
  constexpr int JT = HD / 4;                // 4-wide column tiles
  constexpr int NY = (kChunk / 4) * JT;     // y tiles (4 steps x 4 columns)
  constexpr int NK = JT * JT;               // state tiles (4 x 4)
  constexpr int PY = (NY + kThreads - 1) / kThreads, PK = (NK + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float sm[];
  float* rs = sm;                           // r, then k^ transposed (kT[i][s])
  float* ks = sm + L::k;                    // k, then k^; then with v: S_c
  float* vs = sm + L::v;
  float* ws = sm + L::w;
  float* At = sm + L::at;
  float* rT = sm + L::rt;
  float* F = sm + L::f;
  float* Dc = F + kSubs * HD;
  float* Ss = ks;
  __shared__ int ticket;

  const int tid = threadIdx.x;
  if (tid == 0) ticket = (int)atomicAdd(a.sync, 1u);
  __syncthreads();
  const int c = ticket / BH, bh = ticket - c * BH, b = bh / a.H, h = bh - b * a.H;
  const int t0 = c * kChunk, n = min(kChunk, a.T - t0);
  // r, k, w first; v, which only the products need, lands behind step 1
  stage_rows<HD>(rs, a.r, a.r_sb, a.r_sh, a.r_st, b, h, t0, n);
  stage_rows<HD>(ks, a.k, a.k_sb, a.k_sh, a.k_st, b, h, t0, n);
  stage_rows<HD>(ws, a.w, a.w_sb, a.w_sh, a.w_st, b, h, t0, n);
  cp_async_commit();
  stage_rows<HD>(vs, a.v, a.v_sb, a.v_sh, a.v_st, b, h, t0, n);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  for (int e = tid; e < (kChunk - n) * HD; e += kThreads)   // padded steps: w = 1
    ws[(n + e / HD) * RS + e % HD] = 1.f;
  __syncthreads();

  // A within sub-chunks, column s by thread (s, p): q_s over channels
  // [i0, i0 + Q), carried to the sub-chunk's end (k^_s)
  {
    const int s = tid >> 2, p = tid & 3, i0 = p * Q;
    float q[Q];
    float bonus = 0.f;
#pragma unroll
    for (int m = 0; m < Q; ++m) {
      q[m] = ks[s * RS + i0 + m];
      bonus = fmaf(rs[s * RS + i0 + m] * a.u[(long long)h * HD + i0 + m], q[m], bonus);
    }
    bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
    bonus += __shfl_xor_sync(0xffffffffu, bonus, 2);
    for (int t = p; t < s; t += 4) At[s * AS + t] = 0.f;
    if (p == 0) At[s * AS + s] = bonus;
    // warp-uniform bounds: a warp's s = 8 w .. 8 w + 7 lie in one sub-chunk
    const int t_end = s | (kSub - 1);
    for (int t = (s & ~7) + 1; t <= t_end; ++t) {
      float rt[Q], wt[Q];
      if constexpr (Q % 4 == 0) {
#pragma unroll
        for (int m = 0; m < Q; m += 4) {
          const float4 x = ld4(rs + t * RS + i0 + m), z = ld4(ws + t * RS + i0 + m);
          rt[m] = x.x; rt[m + 1] = x.y; rt[m + 2] = x.z; rt[m + 3] = x.w;
          wt[m] = z.x; wt[m + 1] = z.y; wt[m + 2] = z.z; wt[m + 3] = z.w;
        }
      } else {
#pragma unroll
        for (int m = 0; m < Q; ++m) {
          rt[m] = rs[t * RS + i0 + m];
          wt[m] = ws[t * RS + i0 + m];
        }
      }
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < Q; ++m) dot[m & 3] = fmaf(rt[m], q[m], dot[m & 3]);
      float d = (dot[0] + dot[1]) + (dot[2] + dot[3]);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      if (t > s) {
#pragma unroll
        for (int m = 0; m < Q; ++m) q[m] *= wt[m];
        if (p == 0) At[s * AS + t] = d;
      }
    }
#pragma unroll
    for (int m = 0; m < Q; ++m) ks[s * RS + i0 + m] = q[m];   // its own k, read above
  }
  // r^ (prefix within each sub-chunk) and the sub-chunks' whole products F
  for (int e = tid; e < kSubs * HD; e += kThreads) {
    const int g = e / HD, i = e - g * HD;
    float pre = 1.f;
#pragma unroll
    for (int x = 0; x < kSub; ++x) {
      const int t = g * kSub + x;
      rT[i * TS + t] = rs[t * RS + i] * pre;
      pre *= ws[t * RS + i];
    }
    F[g * HD + i] = pre;
  }
  __syncthreads();
  float* kT = rs;                           // r is read: k^ transposed in its place
  for (int e = tid; e < kChunk * HD; e += kThreads) {
    const int i = e / kChunk, s = e - i * kChunk;
    kT[i * TS + s] = ks[s * RS + i];
  }
  for (int i = tid; i < HD; i += kThreads) {
    float d = 1.f;
#pragma unroll
    for (int g = 0; g < kSubs; ++g) d *= F[g * HD + i];
    Dc[i] = d;
  }
  __syncthreads();

  // A across sub-chunks: s in sub-chunk sa < tc, t in tc; 4 t x 2 s a thread
  constexpr int kPairs = kSubs * (kSubs - 1) / 2;
  constexpr int kTiles = (kSub / 4) * (kSub / 2);
  for (int e = tid; e < kPairs * kTiles; e += kThreads) {
    const int pr = e / kTiles, tile = e - pr * kTiles;
    // pairs (0, 1) (0, 2) (0, 3) (1, 2) (1, 3) (2, 3)
    const int sa = pr < 3 ? 0 : pr < 5 ? 1 : 2;
    const int tc = pr < 3 ? pr + 1 : pr < 5 ? pr - 1 : 3;
    const int tt = tc * kSub + (tile / (kSub / 2)) * 4;
    const int ss = sa * kSub + (tile % (kSub / 2)) * 2;
    const float* f1 = F + (sa + 1 < tc ? sa + 1 : kSubs) * HD;   // Dc slot: unused
    const float* f2 = F + (sa + 2 < tc ? sa + 2 : kSubs) * HD;
    const bool m1 = sa + 1 < tc, m2 = sa + 2 < tc;
    float acc[4][2] = {};
#pragma unroll 4
    for (int i = 0; i < HD; ++i) {
      const float m = (m1 ? f1[i] : 1.f) * (m2 ? f2[i] : 1.f);
      const float4 rv = ld4(rT + i * TS + tt);
      const float2 kv = *reinterpret_cast<const float2*>(kT + i * TS + ss);
      const float k0 = kv.x * m, k1 = kv.y * m;
      const float r4[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        acc[x][0] = fmaf(r4[x], k0, acc[x][0]);
        acc[x][1] = fmaf(r4[x], k1, acc[x][1]);
      }
    }
#pragma unroll
    for (int y = 0; y < 2; ++y)
      *reinterpret_cast<float4*>(At + (ss + y) * AS + tt) =
          make_float4(acc[0][y], acc[1][y], acc[2][y], acc[3][y]);
  }
  cp_async_wait<0>();                       // v landed
  __syncthreads();

  // y_intra = A v and K_c, in registers
  float yacc[PY][4][4] = {}, kacc[PK][4][4] = {};
#pragma unroll
  for (int x = 0; x < PY; ++x) {
    const int e = tid + x * kThreads;
    if (e >= NY) break;
    const int tt = (e / JT) * 4, j = (e % JT) * 4;
#pragma unroll 4
    for (int s = 0; s < tt + 4; ++s)        // At[s][t] = 0 for s > t
      outer4(yacc[x], ld4(At + s * AS + tt), ld4(vs + s * RS + j));
  }
#pragma unroll
  for (int x = 0; x < PK; ++x) {
    const int e = tid + x * kThreads;
    if (e >= NK) break;
    const int i = (e / JT) * 4, j = (e % JT) * 4;
    for (int g = 0; g < kSubs; ++g) {
      float acc[4][4] = {};
#pragma unroll 4
      for (int s = g * kSub; s < (g + 1) * kSub; ++s)
        outer4(acc, ld4(ks + s * RS + i), ld4(vs + s * RS + j));
      float4 d = make_float4(1.f, 1.f, 1.f, 1.f);
      for (int z = g + 1; z < kSubs; ++z) {
        const float4 fz = ld4(F + z * HD + i);
        d = make_float4(d.x * fz.x, d.y * fz.y, d.z * fz.z, d.w * fz.w);
      }
      const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int z = 0; z < 4; ++z) kacc[x][u][z] = fmaf(dv[u], acc[u][z], kacc[x][u][z]);
    }
  }
  // r^ times the earlier sub-chunks' whole products: the prefix from the
  // chunk's start
  for (int e = tid; e < (kSubs - 1) * HD; e += kThreads) {
    const int g = e / HD + 1, i = e - (g - 1) * HD;
    float pre = 1.f;
    for (int z = 0; z < g; ++z) pre *= F[z * HD + i];
#pragma unroll
    for (int z = 0; z < kSub; ++z) rT[i * TS + g * kSub + z] *= pre;
  }
  __syncthreads();                          // k^, v and A are read: S_c goes over them

  // S_c from chunk c - 1 (s0 at c = 0); S_{c+1} out
  const long long E = (long long)HD * HD;
  const float* s_in = c == 0 ? a.s0 + bh * E : a.slots + (bh * 2 + (c & 1)) * E;
  float* s_out = c + 1 == a.nc ? a.sT + bh * E : a.slots + (bh * 2 + ((c + 1) & 1)) * E;
  if (c > 0) {
    if (tid == 0) {
      const unsigned* flag = a.sync + 1 + (long long)bh * a.nc + (c - 1);
      for (long long spin = 0; ld_acquire(flag) == 0u && spin < (1LL << 22); ++spin)
        __nanosleep(64);
    }
    __syncthreads();
  }
#pragma unroll
  for (int x = 0; x < PK; ++x) {
    const int e = tid + x * kThreads;
    if (e >= NK) break;
    const int i = (e / JT) * 4, j = (e % JT) * 4;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 sc = __ldcg(reinterpret_cast<const float4*>(s_in + (i + u) * HD + j));
      *reinterpret_cast<float4*>(Ss + (i + u) * SS + j) = sc;
      if (a.states != nullptr)
        __stcg(reinterpret_cast<float4*>(a.states + (bh * a.nc + c) * E + (i + u) * HD + j),
               sc);
      const float d = Dc[i + u];
      __stcg(reinterpret_cast<float4*>(s_out + (i + u) * HD + j),
             make_float4(fmaf(d, sc.x, kacc[x][u][0]), fmaf(d, sc.y, kacc[x][u][1]),
                         fmaf(d, sc.z, kacc[x][u][2]), fmaf(d, sc.w, kacc[x][u][3])));
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0 && c + 1 < a.nc) st_release(a.sync + 1 + (long long)bh * a.nc + c, 1u);

  // y = y_intra + r^ . S_c (the two summed apart, then added)
  float* y = a.y + b * a.y_sb + h * a.y_sh;
#pragma unroll
  for (int x = 0; x < PY; ++x) {
    const int e = tid + x * kThreads;
    if (e >= NY) break;
    const int tt = (e / JT) * 4, j = (e % JT) * 4;
    if (tt >= n) continue;
    float acc[4][4] = {};
#pragma unroll 4
    for (int i = 0; i < HD; ++i) outer4(acc, ld4(rT + i * TS + tt), ld4(Ss + i * SS + j));
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (tt + u < n)
        *reinterpret_cast<float4*>(y + (long long)(t0 + tt + u) * a.y_st + j) =
            make_float4(yacc[x][u][0] + acc[u][0], yacc[x][u][1] + acc[u][1],
                        yacc[x][u][2] + acc[u][2], yacc[x][u][3] + acc[u][3]);
  }
}

template <int HD>
int launch(const Args& a, int B, cudaStream_t stream) {
  if (a.T < kChunk) {
    wkv_kernel<HD><<<B * a.H, kParts * HD, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const int BH = B * a.H;
  if (a.slots == nullptr || a.sync == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      wkv_chunk_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)ChunkSmem<HD>::bytes);
  if (err != cudaSuccess) return (int)err;
  wkv_chunk_kernel<HD><<<(unsigned)(a.nc * (long long)BH), kThreads, ChunkSmem<HD>::bytes,
                         stream>>>(a, BH);
  return (int)cudaGetLastError();
}

}  // namespace

// Steps a chunk of the chunked form: T >= this takes it (and the scratch).
extern "C" int rwkv6_scan_chunk() { return kChunk; }

// r, k, v, w: (B, H, T, hd) float32 with unit stride over hd and the given
// element strides over (b, h, t); y likewise (written); u (H, hd), s0 and
// sT (B, H, hd, hd) float32 contiguous.  hd is one of 8, 16, 32, 64, 128.
// For T >= rwkv6_scan_chunk(): slots (B, H, 2, hd, hd) float32 scratch,
// sync (1 + B H nc) uint32 zeroed, nc = ceil(T / chunk), and every row of r,
// k, v, w and y on 16 bytes; else slots and sync may be null.  states: null,
// or (B, H, nc, hd, hd) float32 written with every chunk's starting state
// (chunked form only).  Launches on `stream` and returns cudaGetLastError()
// (0 on success).
extern "C" int rwkv6_scan_launch(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* s0, void* y, void* sT, void* slots, void* sync, int B, int H, int T, int hd,
    long long r_sb, long long r_sh, long long r_st, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st, long long w_sb,
    long long w_sh, long long w_st, long long y_sb, long long y_sh, long long y_st,
    void* states, void* stream) {
  if (B <= 0 || H <= 0 || T < 0 || (long long)B * H > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.y = static_cast<float*>(y);
  a.sT = static_cast<float*>(sT);
  a.slots = static_cast<float*>(slots);
  a.sync = static_cast<unsigned*>(sync);
  a.states = static_cast<float*>(states);
  a.H = H;
  a.T = T;
  a.nc = (T + kChunk - 1) / kChunk;
  a.r_sb = r_sb; a.r_sh = r_sh; a.r_st = r_st;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_st = k_st;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_st = v_st;
  a.w_sb = w_sb; a.w_sh = w_sh; a.w_st = w_st;
  a.y_sb = y_sb; a.y_sh = y_sh; a.y_st = y_st;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return launch<8>(a, B, s);
    case 16: return launch<16>(a, B, s);
    case 32: return launch<32>(a, B, s);
    case 64: return launch<64>(a, B, s);
    case 128: return launch<128>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
