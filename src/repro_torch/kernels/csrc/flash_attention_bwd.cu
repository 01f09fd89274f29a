// Backward of causal / sliding-window GQA flash attention in float32 on
// Hopper (sm_90a), on the tensor cores at float32 accuracy (3xTF32).  bf16
// inputs take csrc/flash_attention_bwd_sm90.cu (TMA, wgmma).
//
// The gradient of the function that the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py) computes forward; the reference has
// no Pallas backward (JAX differentiates its jnp attention).  For q
// (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd), query head h reading kv head
// h / G (G = Hq / Hkv), positions 0 .. Sq - 1 against 0 .. Sk - 1, the
// forward's output O, its per-row log-sum-exp L and an upstream dO:
//
//     s_ij = q_i . k_j / sqrt(hd)       masked unless j <= i (causal) and
//                                       i - j < window (window > 0)
//     P_ij = exp(s_ij - L_i),  Delta_i = dO_i . O_i
//     dv_j = sum_i P_ij dO_i,  dS_ij = P_ij (dO_i . v_j - Delta_i)
//     dq_i = sum_j dS_ij k_j / sqrt(hd),  dk_j = sum_i dS_ij q_i / sqrt(hd)
//
// with dk and dv of a kv head summed over the G query heads that read it.
// L comes from the forward kernel (csrc/flash_attention.cu writes it when
// given an `lse` buffer), in log2 units of the scaled scores, so P is one
// ex2 and no launch here recomputes it.  Sq != Sk is the decoder's
// cross-attention.  A row whose window closes before the keys reach it
// (only where Sq > Sk) was the mean of v forward: its P is 1 / Sk on every
// key, as the plain backward's (the softmax of Sk equal masked scores).
//
// Precision: 3xTF32, the forward's scheme.  Every operand x of the five
// products (S = Q K^T, dP = dO V^T, dV += P^T dO, dK += dS^T Q, dQ += dS K)
// is split as hi = tf32(x), lo = tf32(x - hi) (P and dS too, in registers;
// lo rounded toward zero, see split()), and each product is
// lo hi' + hi lo' + hi hi' on mma.sync m16n8k8 TF32, summed in float32.
// One TF32 term a product misses the float32 check (1e-4 of max |want|);
// three hold it (tests/test_torch_lm_grad.py emulates both).
//
// Design: three launches on one stream, no atomics (each output element is
// written once, by one block, so the result does not depend on scheduling):
//   1. delta_kernel: Delta = rowsum(dO * O), a warp a row, float32 (B, Hq, Sq)
//      scratch.  Bytes-bound: it reads dO and O once.
//   2. dkdv_kernel: one block of 8 warps per (b, kv head, KT keys): KG
//      groups of 16 keys x DS slices of the head dims (KT = 32, DS = 4 at
//      hd 256; KT = 64, DS = 2 below).  K and V are staged once; tiles of
//      R = 32 query rows, each row a (position, head of the group) pair as
//      in the forward, so the sum over the group's heads stays in the block,
//      come through one buffer for dO (with L and Delta) and one for Q,
//      copied in turn: dO of tile i + 1 lands while dK of tile i runs, Q
//      while dP^T runs.  Per tile a warp computes S^T = K Q^T and
//      dP^T = V dO^T for its 16 keys and all 32 rows over its slice of the
//      head dims; the DS partial sums meet in shared memory, where each warp
//      adds up its rows', forms P^T and dS^T and writes them.  Then each
//      warp adds P^T dO and dS^T Q over the 32 rows into 32 keys x its
//      slice of the head dims of dV and dK (two 16-key tiles share each B
//      fragment; 32 + 32 accumulator registers at hd 256).
//   3. dq_kernel: one block per (b, kv head, 64 query rows), Q and dO staged
//      once, kv tiles of KQ keys (32 at hd 256, 64 below).  Warps 0-3
//      compute S = Q K^T and warps 4-7 dP = dO V^T, each warp 32 rows x
//      half the tile's keys; dP goes to the S warp of the same rows and keys
//      through shared memory, which turns it into dS there, and every warp
//      adds dS K into 32 rows x a quarter of the head dims of dQ (two 16-row
//      tiles share each B fragment).  K and V have one buffer each, copied
//      by the warps that read them in phase 1: V of tile t + 1 lands while
//      dS and dQ of tile t run; K of tile t + 1 is copied after dQ of tile
//      t, and while the S warps wait for it the dP warps compute.
// Shared memory sets the tiles: at hd 256 a 32-row float32 tile is 33 KB,
// so dK / dV holds K, V, Q and dO of 32 rows each (172 KB with the partial
// sums), dQ 64 rows of Q and dO and 32 keys of K and V (205 KB).  Giving
// dK / dV's warps one product each as dQ's have, over 64-row tiles and the
// whole head dim (no partial sums), was slower on the card: it takes about
// 40 more registers a thread.
// Tiles that the causal or window mask empties are never loaded: each block
// walks its live range only, and the blocks with the most tiles start first
// (the first key tiles, the last query tiles; the tile index is the slowest
// of the block index).  Copies zero-fill positions past Sq or Sk, head dims
// past hd and rows past the group's heads, which the mask drops.
//
// Accumulation.  The tensor cores' float32 accumulation truncates: summed
// straight in the mma accumulator over the 8192 rows that see the first key
// of a causal (2, 4096, 8 / 4, 256) layer, dK and dV drifted up to the
// float32 check's limit on the card, linearly in the number of rows.  So
// each query tile's products go into a zeroed accumulator that is added to
// the sum by an FADD.
//
// Fragments.  Where the contraction runs along a row in shared memory (S^T,
// dP^T, S, dP: over the head dims), ldmatrix loads the fragments of 32-bit
// values (an 8 x 8 b16 matrix is 8 rows of 4 floats, which is the TF32 A / B
// fragment layout).  Where it runs across rows (dV, dK over query rows, dQ
// over keys), the A fragment comes from P^T / dS^T / dS in shared memory,
// its columns (t, t + 4) taken from the adjacent pair (2t, 2t + 1) as one
// 8-byte load, and B as two scalar loads from rows 2t and 2t + 1: the same
// permutation of the contraction on both sides, so the sum is unchanged.
// Row strides are padded (Q, K, V, dO by 4 floats, P and dS by 8) so that
// every ldmatrix phase, 8-byte and scalar fragment load hits 32 distinct
// banks.  Operands are split where they are loaded: holding K and V (or Q
// and dO) split in shared memory, which doubles the bytes each fragment
// load moves, was slower on the card in both kernels.  mma.sync issues
// TF32 below the rate wgmma reaches, and the splits, loads and barriers
// between the mmas hold the kernel further below the bound.
// q, k and v are read through their strides (unit stride over hd, rows on 16
// bytes: the wrapper checks); O, dO and dq are (B, Sq, Hq, hd) contiguous,
// dk and dv (B, Sk, Hkv, hd) contiguous; L and Delta (B, Hq, Sq) float32.
// hd is padded to the instance D in {32, 64, 128, 256}.
//
// Bound on the H100: operations.  The gradient needs five products of 2 hd
// flops per live (q, k) pair (S, dP, dV, dQ, dK): at the main path's
// (2, 4096, 8 / 4, 256), causal, 2 * 8 * 8.4 M pairs, 344 GFLOP, each as
// three TF32 products (494 TFLOP/s dense): 2.09 ms (0.91 ms at window
// 1024).  This kernel does seven products a pair (S and dP in both the dK /
// dV and the dQ pass); its times beside the bound and SDPA's backward are in
// PERF.md (chip_smoke.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const float* o;
  const float* dout;
  const float* lse;                         // (B, Hq, Sq): L in log2 units
  float* dq;
  float* dk;
  float* dv;
  float* delta;                             // (B, Hq, Sq)
  int B, Sq, Sk, Hq, Hkv, hd, G, causal, window;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;                              // 1 / sqrt(hd)
  float inv_sk;                             // 1 / Sk: P of a row with no live key
};

// The tiles of the instance for head dimension D, and its shared memory
// (offsets in floats).
template <int D>
struct Cfg {
  static constexpr int ST = D + 4;          // row stride of Q, K, V, dO tiles
  static constexpr int DC = D / 4;          // 16-byte chunks a row
  // dK / dV.  S^T and dP^T: KG key groups of 16 keys x DS slices of the
  // head dims; dV and dK: MG groups of 32 keys x 8 / MG slices
  static constexpr int DS = D >= 256 ? 4 : 2;
  static constexpr int KG = 8 / DS;
  static constexpr int KT = 16 * KG;        // keys a block
  static constexpr int R = 32;              // query rows a tile
  static constexpr int NT = R / 8;          // 8-row tiles of S^T
  static constexpr int DW = D / DS;         // head dims of a slice
  static constexpr int XS = R + 8;          // row stride of P^T and dS^T
  static constexpr int MG = KT / 32;
  static constexpr int N3 = D / 8 / (8 / MG);   // 8-column tiles of dV, dK a warp
  static constexpr int PART = 2 * NT * 4 * 32;    // a warp's partial S^T and dP^T
  static constexpr int kv_k = 0;            // K, V; Q, dO; P^T, dS^T; partials; L, Delta
  static constexpr int kv_v = kv_k + KT * ST;
  static constexpr int kv_q = kv_v + KT * ST;
  static constexpr int kv_g = kv_q + R * ST;
  static constexpr int kv_p = kv_g + R * ST;
  static constexpr int kv_s = kv_p + KT * XS;
  static constexpr int kv_part = kv_s + KT * XS;
  static constexpr int kv_l = kv_part + 8 * PART;
  static constexpr int kv_d = kv_l + R;
  static constexpr size_t kv_bytes = sizeof(float) * (kv_d + R);
  // dQ: 64 rows, kv tiles of KQ keys.  S and dP: 4 warps each, 32 rows x
  // half the keys a warp; dQ: MQ groups of M3 16-row tiles x 8 / MQ slices
  static constexpr int RQ = 64;
  static constexpr int KQ = D >= 256 ? 32 : 64;
  static constexpr int NK = KQ / 16;        // 8-key tiles of S or dP a warp (half the keys)
  static constexpr int M3 = D >= 64 ? 2 : 1;
  static constexpr int MQ = RQ / 16 / M3;
  static constexpr int NO = D / 8 / (8 / MQ);   // 8-column tiles of dQ a warp
  static constexpr int QX = KQ + 8;         // row stride of dS
  static constexpr int q_q = 0;
  static constexpr int q_g = q_q + RQ * ST;
  static constexpr int q_k = q_g + RQ * ST;
  static constexpr int q_v = q_k + KQ * ST;
  static constexpr int q_ds = q_v + KQ * ST;
  static constexpr size_t q_bytes = sizeof(float) * (q_ds + RQ * QX);
  static_assert(NT % DS == 0 && N3 >= 1 && NO >= 1 && NK >= 2 && NK % 2 == 0 && MG * 32 == KT,
                "tile shapes");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the `count` threads of named barrier `id` (1..15; 0 is __syncthreads)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// x = hi + lo, hi = tf32(x), lo = tf32(x - hi): TF32 bit patterns.  hi is
// rounded to nearest with ties away from zero (cvt.rna.tf32.f32's rounding)
// by adding half of the 13 dropped bits and masking them; lo is cut to TF32
// (rounded toward zero), which is what the tensor cores read of any float32
// operand (on the card, a raw x - hi and a masked one gave the same results
// bit for bit).  cvt.rna.tf32.f32 compiles to a compare-and-select sequence
// on sm_90, which these integer operations avoid.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}
template <int N>
__device__ __forceinline__ void split_all(const uint32_t (&x)[N], uint32_t (&hi)[N],
                                          uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(__uint_as_float(x[i]), hi[i], lo[i]);
}

// c (16 x 8) += a (16 x 8) b (8 x 8), TF32 operands, fp32 sums.  Fragments
// (lane = 4 g + t): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// b0 (t, g), b1 (t + 4, g); c0, c1 (g, 2t + {0, 1}), c2, c3 (g + 8, ...).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// c += a b at float32 accuracy: lo hi' + hi lo' + hi hi', small terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(c, al, bh);
  mma(c, ah, bl);
  mma(c, ah, bh);
}

// c0 += a b (first 8-row tile of b_frag2), c1 += a b' (the second)
__device__ __forceinline__ void mma3x2(float (&c0)[4], float (&c1)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const uint32_t (&bh)[4],
                                       const uint32_t (&bl)[4]) {
  const uint32_t h0[2] = {bh[0], bh[1]}, l0[2] = {bl[0], bl[1]};
  const uint32_t h1[2] = {bh[2], bh[3]}, l1[2] = {bl[2], bl[3]};
  mma3(c0, ah, al, h0, l0);
  mma3(c1, ah, al, h1, l1);
}

// ldmatrix of four 8 x 8 b16 matrices: 8 rows of 4 floats each
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// The B fragments of two 8-row tiles (rows n of B^T, 8 along the row) at
// `base`: lane l gives row l % 8 + 8 (l / 16), column 4 ((l / 8) % 2);
// b0, b1 of the first tile, then of the second.
template <int STRIDE>
__device__ __forceinline__ void b_frag2(const float* base, int lane, uint32_t (&hi)[4],
                                        uint32_t (&lo)[4]) {
  uint32_t x[4];
  ldsm4(x, base + ((lane & 7) + ((lane >> 4) << 3)) * STRIDE + ((lane >> 3) & 1) * 4);
  split_all(x, hi, lo);
}
// The A fragment (16 rows x 8 along the row) at `base` (row 0, column 0 of
// the step), rows STRIDE floats apart, split: lane l gives row l % 16,
// column 4 (l / 16); matrices (rows 0-7, 0-3), (8-15, 0-3), (0-7, 4-7),
// (8-15, 4-7) are a0..a3
template <int STRIDE>
__device__ __forceinline__ void a_frag(const float* base, int lane, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  uint32_t x[4];
  ldsm4(x, base + (lane & 15) * STRIDE + (lane >> 4) * 4);
  split_all(x, hi, lo);
}
// The A fragment of rows (g, g + 8) whose columns (t, t + 4) are the
// adjacent pair (2t, 2t + 1) of an 8-wide step: one 8-byte load a row, split
__device__ __forceinline__ void a_pairs(const float* row_g, const float* row_g8,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 x = *reinterpret_cast<const float2*>(row_g);
  const float2 y = *reinterpret_cast<const float2*>(row_g8);
  split(x.x, hi[0], lo[0]);
  split(y.x, hi[1], lo[1]);
  split(x.y, hi[2], lo[2]);
  split(y.y, hi[3], lo[3]);
}
// The B fragment matching a_pairs: rows 2t and 2t + 1 of the step, column g,
// split
__device__ __forceinline__ void b_pairs(const float* row_2t, int stride, uint32_t (&hi)[2],
                                        uint32_t (&lo)[2]) {
  split(row_2t[0], hi[0], lo[0]);
  split(row_2t[stride], hi[1], lo[1]);
}

// acc (M 16-row tiles x N 8-column tiles) += A B over K8 8-wide steps: A
// rows (g, g + 8) of tile m at a_row[m] (rows xs floats apart), its columns
// taken in adjacent pairs (a_pairs); B rows 2t, 2t + 1 of each step at b_col
// (rows bst apart, tile n at + 8 n).  Each split B fragment serves all M tiles.
template <int M, int N, int K8>
__device__ __forceinline__ void mma_rows(float (&acc)[M][N][4], const float* const (&a_row)[M],
                                         int xs, const float* b_col, int bst, int tg) {
#pragma unroll 2
  for (int kk = 0; kk < K8; ++kk) {
    uint32_t ah[M][4], al[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m)
      a_pairs(a_row[m] + kk * 8 + 2 * tg, a_row[m] + 8 * xs + kk * 8 + 2 * tg, ah[m], al[m]);
    const float* bk = b_col + (kk * 8 + 2 * tg) * bst;
#pragma unroll
    for (int n = 0; n < N; ++n) {
      uint32_t bh[2], bl[2];
      b_pairs(bk + n * 8, bst, bh, bl);
#pragma unroll
      for (int m = 0; m < M; ++m) mma3(acc[m][n], ah[m], al[m], bh, bl);
    }
  }
}

__device__ __forceinline__ bool live_pair(const Args& a, int qp, int kp) {
  bool ok = kp < a.Sk;
  if (a.causal) ok = ok && kp <= qp;
  if (a.window > 0) ok = ok && qp - kp < a.window;
  return ok;
}

// whether the row at position qp (< Sq) has no live key: its window closes
// before the keys reach it (only where Sq > Sk)
__device__ __forceinline__ bool dead_row(const Args& a, int qp) {
  return a.window > 0 && qp - a.window + 1 > a.Sk - 1;
}

// P of a pair the mask drops: 1 / Sk on the keys of a row with no live key
// (the forward's mean of v), else 0
__device__ __forceinline__ float dropped_p(const Args& a, int qp, int kp) {
  return kp < a.Sk && dead_row(a, qp) ? a.inv_sk : 0.f;
}

// ------------------------------------------------------------------------
// 1. Delta = rowsum(dO * O), a warp a row (position, query head)
// ------------------------------------------------------------------------
__global__ void __launch_bounds__(256) delta_kernel(const Args a, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* o = a.o + row * a.hd;
  const float* g = a.dout + row * a.hd;
  float acc = 0.f;
  for (int d = 4 * lane; d < a.hd; d += 128) {
    const float4 x = ld4(o + d), y = ld4(g + d);
    acc = fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, acc))));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long bs = row / a.Hq;              // b * Sq + position
    const int h = (int)(row - bs * a.Hq);
    const long long b = bs / a.Sq;
    a.delta[(b * a.Hq + h) * a.Sq + (bs - b * a.Sq)] = acc;
  }
}

// Rows [0, n) of a query-side tile into shared memory (row stride ST): row
// r is position p0 + r / G, head hk G + r % G; q through its strides (dout
// false) or dO, contiguous (dout true); zero past the group's rows, Sq and hd.
template <int D>
__device__ __forceinline__ void copy_rows(const Args& a, bool dout, int b, int hk, int p0,
                                          int nrows, int n, float* dst) {
  using C = Cfg<D>;
  for (int e = threadIdx.x; e < n * C::DC; e += kThreads) {
    const int r = e / C::DC, d = (e - r * C::DC) * 4;
    const int pos = p0 + r / a.G, head = hk * a.G + r % a.G;
    const bool live = r < nrows && pos < a.Sq && d < a.hd;
    const float* src = !live ? a.q
                       : dout ? a.dout + (((long long)b * a.Sq + pos) * a.Hq + head) * a.hd + d
                              : a.q + b * a.q_sb + (long long)pos * a.q_ss +
                                    (long long)head * a.q_sh + d;
    cp_async16(dst + r * C::ST + d, src, live ? 16 : 0);
  }
}

// Keys [j0, j0 + n) of k or v into shared memory, zero past Sk and hd, by
// `count` threads of which this is number `t`
template <int D>
__device__ __forceinline__ void copy_keys(const Args& a, const float* x, long long sb,
                                          long long ss, long long sh, int b, int hk, int j0,
                                          int n, float* dst, int t, int count) {
  using C = Cfg<D>;
  for (int e = t; e < n * C::DC; e += count) {
    const int j = e / C::DC, d = (e - j * C::DC) * 4;
    const int kp = j0 + j;
    const bool live = kp < a.Sk && d < a.hd;
    const float* src = live ? x + b * sb + (long long)kp * ss + hk * sh + d : x;
    cp_async16(dst + j * C::ST + d, src, live ? 16 : 0);
  }
}

// ------------------------------------------------------------------------
// 2. dK and dV, per (b, kv head, KT keys)
// ------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(const Args a) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) float sm[];
  float* Ks = sm + C::kv_k;
  float* Vs = sm + C::kv_v;
  float* Qs = sm + C::kv_q;
  float* Gs = sm + C::kv_g;
  float* Pt = sm + C::kv_p;
  float* St = sm + C::kv_s;
  float* Ls = sm + C::kv_l;
  float* Dt = sm + C::kv_d;
  // block = tile (B Hkv) + b Hkv + hk: the tile index is the slowest, so
  // the first key tiles, which see the most rows when causal, start first
  const int heads = a.Hkv * a.B;
  const int tile = blockIdx.x / heads, hb = blockIdx.x - tile * heads;
  const int b = hb / a.Hkv, hk = hb - b * a.Hkv;
  const int j0 = tile * C::KT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int kg = warp % C::KG, dsl = warp / C::KG;
  const int key0 = kg * 16;                 // S^T, dP^T: the warp's 16 keys
  const int col0 = dsl * C::DW;             // ... and its slice of the head dims
  const int key3 = (warp % C::MG) * 32;     // dV, dK: the warp's 32 keys
  const int col3 = (warp / C::MG) * C::N3 * 8;        // ... and head dims
  const int qt = C::R / a.G;                // positions a query tile
  const int nrows = qt * a.G;
  // the query rows that see these keys: from the diagonal (causal) to the
  // window's end, or to Sq - 1 where the last rows have no live key (they
  // see every key)
  const int j_hi = min(j0 + C::KT, a.Sk) - 1;
  const int q_lo = a.causal ? j0 : 0;
  const int q_hi = a.window > 0 && !dead_row(a, a.Sq - 1)
                       ? min(a.Sq - 1, j_hi + a.window - 1) : a.Sq - 1;
  const int tq_lo = q_lo / qt, tq_hi = q_hi / qt;

  // dO, L and Delta of query tile tq: one commit group; its Q: the next
  auto stage_g = [&](int tq) {
    const int p0 = tq * qt;
    copy_rows<D>(a, true, b, hk, p0, nrows, C::R, Gs);
    if (tid < C::R) {
      const int pos = p0 + tid / a.G, head = hk * a.G + tid % a.G;
      const bool live = tid < nrows && pos < a.Sq;
      const long long at = live ? ((long long)b * a.Hq + head) * a.Sq + pos : 0;
      cp_async4(Ls + tid, a.lse + at, live ? 4 : 0);
      cp_async4(Dt + tid, a.delta + at, live ? 4 : 0);
    }
    cp_async_commit();
  };
  auto stage_q = [&](int tq) {
    copy_rows<D>(a, false, b, hk, tq * qt, nrows, C::R, Qs);
    cp_async_commit();
  };
  copy_keys<D>(a, a.k, a.k_sb, a.k_ss, a.k_sh, b, hk, j0, C::KT, Ks, tid, kThreads);
  copy_keys<D>(a, a.v, a.v_sb, a.v_ss, a.v_sh, b, hk, j0, C::KT, Vs, tid, kThreads);
  stage_g(tq_lo);                           // with K and V: one group
  stage_q(tq_lo);

  float dk[2][C::N3][4], dv[2][C::N3][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < C::N3; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) dk[m][n][x] = dv[m][n][x] = 0.f;
  const float* const p_rows[2] = {Pt + (key3 + g) * C::XS, Pt + (key3 + 16 + g) * C::XS};
  const float* const s_rows[2] = {St + (key3 + g) * C::XS, St + (key3 + 16 + g) * C::XS};
  const float scale2 = a.scale * kLog2e;
  const int grp = 1 + kg, grp_threads = 32 * C::DS;   // the key group's named barrier
  // the warp's partial sums of S^T and dP^T, lane-major: value (m, n, x) of
  // lane l at ((m NT + n) 4 + x) 32 + l
  float* part = sm + C::kv_part + warp * (2 * C::NT * 4 * 32);

  // out (16 keys x R rows) = A B^T over the warp's DW head dims
  auto product = [&](const float* As, const float* Bs, float (&out)[C::NT][4]) {
#pragma unroll
    for (int n = 0; n < C::NT; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) out[n][x] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < C::DW / 8; ++kk) {
      const int k8 = col0 + kk * 8;
      uint32_t ah[4], al[4];
      a_frag<C::ST>(As + key0 * C::ST + k8, lane, ah, al);
#pragma unroll
      for (int n = 0; n < C::NT; n += 2) {
        uint32_t bh[4], bl[4];
        b_frag2<C::ST>(Bs + n * 8 * C::ST + k8, lane, bh, bl);
        mma3x2(out[n], out[n + 1], ah, al, bh, bl);
      }
    }
  };

  for (int tq = tq_lo; tq <= tq_hi; ++tq) {
    cp_async_wait<1>();                     // dO, L and Delta of tile tq landed
    __syncthreads();
    // dP^T = V dO^T while Q lands, then S^T = K Q^T: partial sums over the
    // warp's head dims, handed to the key group through shared memory
    float acc[C::NT][4];
    product(Vs, Gs, acc);
#pragma unroll
    for (int n = 0; n < C::NT; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) part[((C::NT + n) * 4 + x) * 32 + lane] = acc[n][x];
    cp_async_wait<0>();                     // Q of tile tq landed
    __syncthreads();
    product(Ks, Qs, acc);
#pragma unroll
    for (int n = 0; n < C::NT; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) part[(n * 4 + x) * 32 + lane] = acc[n][x];
    named_sync(grp, grp_threads);           // the key group's partial sums are in

    // the warp's NT / DS row tiles: S^T and dP^T summed over the group, then
    // P^T = 2^(S^T scale log2(e) - L), dS^T = P^T (dP^T - Delta)
    const int p0 = tq * qt;
#pragma unroll
    for (int u = 0; u < C::NT / C::DS; ++u) {
      const int n = dsl * (C::NT / C::DS) + u;
      float p[4], ds[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int w = 0; w < C::DS; ++w) {
          const float* pw = sm + C::kv_part + (kg + w * C::KG) * (2 * C::NT * 4 * 32);
          s += pw[(n * 4 + x) * 32 + lane];
          dp += pw[((C::NT + n) * 4 + x) * 32 + lane];
        }
        const int kp = j0 + key0 + g + 8 * (x >> 1);
        const int r = n * 8 + 2 * tg + (x & 1);
        const int pos = p0 + r / a.G;
        const bool row = r < nrows && pos < a.Sq;
        p[x] = row && live_pair(a, pos, kp) ? exp2f(s * scale2 - Ls[r])
               : row ? dropped_p(a, pos, kp) : 0.f;
        ds[x] = p[x] * (dp - Dt[r]);
      }
      const int i = (key0 + g) * C::XS + n * 8 + 2 * tg;
      *reinterpret_cast<float2*>(Pt + i) = make_float2(p[0], p[1]);
      *reinterpret_cast<float2*>(Pt + i + 8 * C::XS) = make_float2(p[2], p[3]);
      *reinterpret_cast<float2*>(St + i) = make_float2(ds[0], ds[1]);
      *reinterpret_cast<float2*>(St + i + 8 * C::XS) = make_float2(ds[2], ds[3]);
    }
    __syncthreads();                        // P^T and dS^T of all keys are in

    // dV += P^T dO, then dK += dS^T Q: the warp's 32 keys x N3 8-column
    // tiles over the R rows.  A tile's products go into a zeroed
    // accumulator that is then added to the sum by an FADD: the tensor
    // cores' float32 accumulation truncates, and a sum over thousands of
    // rows straight in the mma accumulator drifts by about one ulp of the
    // sum a step.
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float tile[2][C::N3][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < C::N3; ++n)
#pragma unroll
          for (int x = 0; x < 4; ++x) tile[mt][n][x] = 0.f;
      mma_rows<2, C::N3, C::R / 8>(tile, m == 0 ? p_rows : s_rows, C::XS,
                                   (m == 0 ? Gs : Qs) + col3 + g, C::ST, tg);
      float (&sum)[2][C::N3][4] = m == 0 ? dv : dk;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < C::N3; ++n)
#pragma unroll
          for (int x = 0; x < 4; ++x) sum[mt][n][x] += tile[mt][n][x];
      __syncthreads();                      // every warp is done with dO (m 0) / Q (m 1)
      if (tq < tq_hi) {
        if (m == 0) stage_g(tq + 1);
        else stage_q(tq + 1);
      } else {
        cp_async_commit();                  // an empty group keeps the count
      }
    }
  }
  cp_async_wait<0>();                       // no tile (causal keys past Sq): the first copies

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int kp = j0 + key3 + mt * 16 + g + 8 * x;
      if (kp >= a.Sk) continue;
      const long long row = (((long long)b * a.Sk + kp) * a.Hkv + hk) * a.hd;
#pragma unroll
      for (int n = 0; n < C::N3; ++n) {
        const int d = col3 + n * 8 + 2 * tg;
        if (d >= a.hd) continue;
        *reinterpret_cast<float2*>(a.dk + row + d) =
            make_float2(dk[mt][n][2 * x] * a.scale, dk[mt][n][2 * x + 1] * a.scale);
        *reinterpret_cast<float2*>(a.dv + row + d) =
            make_float2(dv[mt][n][2 * x], dv[mt][n][2 * x + 1]);
      }
    }
}

// ------------------------------------------------------------------------
// 3. dQ, per (b, kv head, 64 query rows)
// ------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(const Args a) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm + C::q_q;
  float* Gs = sm + C::q_g;
  float* Ks = sm + C::q_k;
  float* Vs = sm + C::q_v;
  float* Xs = sm + C::q_ds;                 // dP, then dS, (RQ, KQ)
  // block = tile (B Hkv) + b Hkv + hk, the tile index the slowest, the
  // last query tiles (the longest rows) first
  const int heads = a.Hkv * a.B;
  const int tile = blockIdx.x / heads, hb = blockIdx.x - tile * heads;
  const int b = hb / a.Hkv, hk = hb - b * a.Hkv;
  const int qt = C::RQ / a.G;
  const int nq = (a.Sq + qt - 1) / qt;
  const int p0 = (nq - 1 - tile) * qt;
  const int p_hi = min(p0 + qt, a.Sq) - 1;
  const int nrows = qt * a.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  // S = Q K^T on warps 0-3 (which copy the K tiles), dP = dO V^T on warps
  // 4-7 (which copy the V tiles): each warp 32 rows x half the tile's keys
  const bool is_dp = warp >= 4;
  const int gtid = tid & 127;               // the thread in its product's group
  const int row1 = ((warp >> 1) & 1) * 32;
  const int key1 = (warp & 1) * (C::KQ / 2);
  const int row3 = (warp % C::MQ) * C::M3 * 16;   // dQ: the warp's rows
  const int col3 = (warp / C::MQ) * C::NO * 8;    // ... and head dims
  // the live kv range, or every key where the last row has none live
  const bool dead = dead_row(a, p_hi);
  const int kv_lo = a.window > 0 && !dead ? max(0, p0 - a.window + 1) : 0;
  const int kv_hi = a.causal && !dead ? min(p_hi, a.Sk - 1) : a.Sk - 1;
  const int t_lo = kv_lo / C::KQ, t_hi = kv_hi / C::KQ;
  const float* As = is_dp ? Gs : Qs;
  float* Bs = is_dp ? Vs : Ks;
  const float* bx = is_dp ? a.v : a.k;
  const long long b_sb = is_dp ? a.v_sb : a.k_sb, b_ss = is_dp ? a.v_ss : a.k_ss,
                  b_sh = is_dp ? a.v_sh : a.k_sh;

  copy_rows<D>(a, false, b, hk, p0, nrows, C::RQ, Qs);
  copy_rows<D>(a, true, b, hk, p0, nrows, C::RQ, Gs);
  copy_keys<D>(a, bx, b_sb, b_ss, b_sh, b, hk, t_lo * C::KQ, C::KQ, Bs, gtid, 128);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();                          // Q, dO and both first tiles are in

  // the lane's rows of S (rows 16 m + g + 8 y of the warp's 32): position,
  // L, Delta
  int pos[2][2];
  bool live[2][2];
  float lse[2][2], dlt[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const int r = row1 + 16 * m + g + 8 * y;
      pos[m][y] = p0 + r / a.G;
      live[m][y] = r < nrows && pos[m][y] < a.Sq;
      const long long at = ((long long)b * a.Hq + hk * a.G + r % a.G) * a.Sq + pos[m][y];
      lse[m][y] = live[m][y] && !is_dp ? a.lse[at] : 0.f;
      dlt[m][y] = live[m][y] && !is_dp ? a.delta[at] : 0.f;
    }

  float dq[C::M3][C::NO][4];
#pragma unroll
  for (int m = 0; m < C::M3; ++m)
#pragma unroll
    for (int n = 0; n < C::NO; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) dq[m][n][x] = 0.f;
  const float scale2 = a.scale * kLog2e;
  const float* ds_rows[C::M3];
#pragma unroll
  for (int m = 0; m < C::M3; ++m) ds_rows[m] = Xs + (row3 + 16 * m + g) * C::QX;

  for (int t = t_lo; t <= t_hi; ++t) {
    if (t > t_lo) {
      cp_async_wait<0>();                   // this group's tile t landed
      named_sync(1 + is_dp, 128);
    }
    // out (2 x 16 rows x NK 8-key tiles) = A B^T over D, even and odd steps
    // in two partial sums
    float part[2][2][C::NK][4];
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < C::NK; ++n)
#pragma unroll
          for (int x = 0; x < 4; ++x) part[e][m][n][x] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 8; kk += 2) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k8 = (kk + e) * 8;
        uint32_t ah[2][4], al[2][4];
        a_frag<C::ST>(As + row1 * C::ST + k8, lane, ah[0], al[0]);
        a_frag<C::ST>(As + (row1 + 16) * C::ST + k8, lane, ah[1], al[1]);
#pragma unroll
        for (int n = 0; n < C::NK; n += 2) {
          uint32_t bh[4], bl[4];
          b_frag2<C::ST>(Bs + (key1 + n * 8) * C::ST + k8, lane, bh, bl);
          mma3x2(part[e][0][n], part[e][0][n + 1], ah[0], al[0], bh, bl);
          mma3x2(part[e][1][n], part[e][1][n + 1], ah[1], al[1], bh, bl);
        }
      }
    }
    if (is_dp) {
      named_sync(2, 128);                   // every dP warp is done with V of tile t
      if (t < t_hi) {
        copy_keys<D>(a, bx, b_sb, b_ss, b_sh, b, hk, (t + 1) * C::KQ, C::KQ, Bs, gtid, 128);
        cp_async_commit();
      }
      // dP to shared memory, for the S warp of the same rows and keys
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < C::NK; ++n) {
          const int i = (row1 + 16 * m + g) * C::QX + key1 + n * 8 + 2 * tg;
          *reinterpret_cast<float2*>(Xs + i) =
              make_float2(part[0][m][n][0] + part[1][m][n][0], part[0][m][n][1] + part[1][m][n][1]);
          *reinterpret_cast<float2*>(Xs + i + 8 * C::QX) =
              make_float2(part[0][m][n][2] + part[1][m][n][2], part[0][m][n][3] + part[1][m][n][3]);
        }
      named_sync(3, 256);
    } else {
      named_sync(3, 256);                   // dP is in
      // dS = P (dP - Delta), P = 2^(S scale log2(e) - L), in place of dP
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < C::NK; ++n) {
          const int i = (row1 + 16 * m + g) * C::QX + key1 + n * 8 + 2 * tg;
          float ds[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int y = x >> 1;
            const int kp = t * C::KQ + key1 + n * 8 + 2 * tg + (x & 1);
            const float s = part[0][m][n][x] + part[1][m][n][x];
            const float p = !live[m][y] ? 0.f
                            : live_pair(a, pos[m][y], kp) ? exp2f(s * scale2 - lse[m][y])
                                                          : dropped_p(a, pos[m][y], kp);
            ds[x] = p * (Xs[i + 8 * C::QX * y + (x & 1)] - dlt[m][y]);
          }
          *reinterpret_cast<float2*>(Xs + i) = make_float2(ds[0], ds[1]);
          *reinterpret_cast<float2*>(Xs + i + 8 * C::QX) = make_float2(ds[2], ds[3]);
        }
    }
    __syncthreads();                        // dS of all rows and keys is in

    // dQ += dS K: the warp's M3 16-row tiles x NO 8-column tiles over the
    // KQ keys
    mma_rows<C::M3, C::NO, C::KQ / 8>(dq, ds_rows, C::QX, Ks + col3 + g, C::ST, tg);
    __syncthreads();                        // every warp is done with K of tile t and dS
    if (!is_dp && t < t_hi) {
      copy_keys<D>(a, bx, b_sb, b_ss, b_sh, b, hk, (t + 1) * C::KQ, C::KQ, Bs, gtid, 128);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int m = 0; m < C::M3; ++m)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = row3 + m * 16 + g + 8 * x;
      const int p = p0 + r / a.G;
      if (r >= nrows || p >= a.Sq) continue;
      float* dst = a.dq + (((long long)b * a.Sq + p) * a.Hq + hk * a.G + r % a.G) * a.hd;
#pragma unroll
      for (int n = 0; n < C::NO; ++n) {
        const int d = col3 + n * 8 + 2 * tg;
        if (d < a.hd)
          *reinterpret_cast<float2*>(dst + d) =
              make_float2(dq[m][n][2 * x] * a.scale, dq[m][n][2 * x + 1] * a.scale);
      }
    }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::kv_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::q_bytes);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * a.Sq * a.Hq;
  delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(a, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // one-dimensional grids, the tile index the slowest (see the kernels)
  const int nk = (a.Sk + C::KT - 1) / C::KT;
  dkdv_kernel<D><<<(unsigned)((long long)nk * a.Hkv * B), kThreads, C::kv_bytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int qt = C::RQ / a.G, nq = (a.Sq + qt - 1) / qt;
  dq_kernel<D><<<(unsigned)((long long)nq * a.Hkv * B), kThreads, C::q_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd), float32, each with unit
// stride over hd, the given element strides over (b, s, h), and every row on
// 16 bytes; out, dout and dq (B, Sq, Hq, hd) and dk, dv (B, Sk, Hkv, hd)
// contiguous float32; lse (B, Hq, Sq) float32 from the forward kernel;
// delta (B, Hq, Sq) float32 scratch.  Three launches on `stream`; returns
// the first cudaGetLastError() that is not 0 (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, void* dq, void* dk, void* dv, void* delta, int B, int Sq, int Sk,
    int Hq, int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    int causal, int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 16 ||
      hd <= 0 || hd % 4 != 0 || hd > 256 || lse == nullptr ||
      // the grids: B Hkv ceil(Sq / qt) dQ blocks, qt >= 4; B Hkv ceil(Sk / 32)
      (long long)B * Hkv * ((Sq + 3) / 4) > 2147483647LL ||
      (long long)B * Hkv * ((Sk + 31) / 32) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(out);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.delta = static_cast<float*>(delta);
  a.B = B;
  a.Sq = Sq;
  a.Sk = Sk;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.hd = hd;
  a.G = Hq / Hkv;
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
  a.inv_sk = 1.f / (float)Sk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 32) return launch<32>(a, B, s);
  if (hd <= 64) return launch<64>(a, B, s);
  if (hd <= 128) return launch<128>(a, B, s);
  return launch<256>(a, B, s);
}
