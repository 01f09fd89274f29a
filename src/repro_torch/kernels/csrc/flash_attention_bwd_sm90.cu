// Backward of causal / sliding-window GQA flash attention in bfloat16 on
// Hopper's tensor cores (sm_90a): TMA copies, mbarriers, wgmma.
//
// The gradient of the function that the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py) computes forward; the reference has
// no Pallas backward (JAX differentiates its jnp attention).  Float32 inputs
// keep csrc/flash_attention_bwd.cu.  For q (B, S, Hq, hd), k and v
// (B, S, Hkv, hd), query head h reading kv head h / G (G = Hq / Hkv), the
// forward's output O, its per-row log-sum-exp L and an upstream dO:
//
//     s_ij = q_i . k_j / sqrt(hd)       masked unless j <= i (causal) and
//                                       i - j < window (window > 0)
//     P_ij = exp(s_ij - L_i),  Delta_i = dO_i . O_i
//     dv_j = sum_i P_ij dO_i,  dS_ij = P_ij (dO_i . v_j - Delta_i)
//     dq_i = sum_j dS_ij k_j / sqrt(hd),  dk_j = sum_i dS_ij q_i / sqrt(hd)
//
// with dk and dv of a kv head summed over the G query heads that read it.
// L comes from the forward kernel (csrc/flash_attention_sm90.cu writes it
// when given an `lse` buffer), in log2 units of the scaled scores, so P is
// one ex2 and no launch here recomputes it.
//
// Design: three launches on one stream, no atomics on any output (each
// element is written once, by one CTA, so results do not depend on
// scheduling):
//   1. delta_kernel: Delta = rowsum(dO * O), a warp a row, float32 (B, Hq, S)
//      scratch.  Bytes-bound: it reads dO and O once.
//   2. dkdv_kernel: one CTA of two warpgroups per (b, kv head, 64 keys).  K
//      and V are copied once by TMA; tiles of 64 query rows, each row a
//      (position, head of the group) pair as in the forward, come through a
//      two-stage TMA ring of Q and dO, so the sum over the group's heads
//      stays in the CTA.  Per tile, warpgroup w takes query rows 32 w ..
//      32 w + 31: S^T = K Q^T and dP^T = V dO^T as wgmma m64n32k16 with both
//      operands K-major; then P^T = ex2(S^T scale log2(e) - L) and dS^T =
//      P^T (dP^T - Delta) in registers, written to shared memory as bf16 in
//      the 128-byte swizzled layout wgmma reads.  After a barrier of both
//      warpgroups, each takes its own head dims (64-dim boxes w, w + 2) of
//      dV += P^T dO and dK += dS^T Q (m64n64k16, A K-major from shared
//      memory, B MN-major: the transpose bit, as the forward reads V).  At
//      hd 256 the two accumulators of 64 keys are 2 x 64 x 256 float32, 256
//      registers a thread for one warpgroup: split over two, 128 each.
//   3. dq_kernel: one CTA of two warpgroups per (b, kv head, 128 query
//      rows), Q and dO copied once, kv tiles of 32 keys through a two-stage
//      ring: S = Q K^T and dP = dO V^T (m64n32k16), P and dS in registers,
//      dQ += dS K with dS as the A operand from registers (the accumulator
//      layout of S is wgmma's A layout) and K MN-major.  The two warpgroups
//      take turns to start their products (the forward's ping-pong).  Keys
//      per tile are 32 so that Q, dO and the ring fit shared memory at
//      hd 256 (64 + 64 + 64 KB).
// Precision.  P and dS enter the tensor cores as two bf16 terms each, hi =
// bf16(x) and lo = bf16(x - hi), two wgmmas into one accumulator: one
// rounding of P and dS to bf16 puts up to 1.9 times chip_smoke.py's
// per-element limit on dq, dk and dv (tests/test_torch_lm_grad.py emulates
// both schemes), two terms about 0.7 of it.  S and dP are products of bf16
// inputs, exact in float32.
// Tiles that the causal or window mask empties are never loaded: each CTA
// walks its live range only, and the CTAs with the most tiles start first
// (the first key tiles, the last query tiles).  TMA's zero fill covers
// positions past S and head dims past hd; rows past the group's G P rows of
// a tile are zeroed once and masked.
// q, k and v are read through their strides (multiples of 16 bytes: the
// wrapper checks); O, dO and dq are (B, S, Hq, hd) contiguous, dk and dv
// (B, S, Hkv, hd) contiguous; L and Delta (B, Hq, S) float32.
//
// Bound on the H100: operations.  The gradient needs five products of 2 hd
// flops per live (q, k) pair (S, dP, dV, dQ, dK): at the main path's
// (2, 4096, 8 / 4, 256), causal, 2 * 8 * 8.4 M pairs, 344 GFLOP, 0.35 ms at
// the bf16 tensor-core rate (989 TFLOP/s).  This kernel does ten (S and dP
// twice, dV, dK and dQ in two terms); its times beside the bound and
// SDPA's backward are in PERF.md (chip_smoke.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKeys = 64;                  // keys per dK / dV CTA
constexpr int kTileRows = 64;              // query rows per dK / dV tile
constexpr int kRows = 128;                 // query rows per dQ CTA
constexpr int kKeysQ = 32;                 // keys per dQ kv tile
constexpr int kChunk = 64;                 // head dims per TMA box: one 128-byte row
constexpr int kStages = 2;
constexpr int kThreads = 256;              // two warpgroups
constexpr int kMaxGroup = 16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kRowBytes = 128;
constexpr uint32_t kBox64 = 64 * kRowBytes;    // 64 rows of 64 head dims
constexpr uint32_t kBox32 = 32 * kRowBytes;
constexpr uint32_t kBox128 = 128 * kRowBytes;

struct Params {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;
  float* delta;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int S, Hq, Hkv, hd, G, P, nt, causal, window;   // P: positions a tile; nt: tiles
  float scale;
  float scale_log2;   // scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ------------------------------------------------------------ //
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// until the phase of the given parity has completed; a wait that outlasts
// about 10 s of clock cycles traps, so a fault fails the launch instead of
// holding the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  }
}

// -- TMA ------------------------------------------------------------------ //
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -- wgmma ---------------------------------------------------------------- //
// shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// byte offset (the stride between 64-element atoms along M/N of an MN-major
// operand; unused for K-major), stride byte offset 1024 (8 rows of 128 bytes)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pin register values here, so the compiler moves no write of a wgmma
// operand past wgmma.fence and no read of an accumulator before wait_group
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WGMMA_D16(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define WGMMA_D16_LIST \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define WGMMA_D32(d)                                                                      \
  WGMMA_D16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),         \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),      \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WGMMA_D32_LIST                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "   \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d += A B, m64n32k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_n32_ss(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WGMMA_D16_LIST
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D16(d)
      : "l"(da), "l"(db), "r"(1));
}

// d += A B, m64n64k16, A K-major and B MN-major in shared memory
__device__ __forceinline__ void wgmma_ss_tb(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32_LIST
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : WGMMA_D32(d)
      : "l"(da), "l"(db), "r"(1));
}

// d += A B, m64n64k16, A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// x as two bf16 terms, packed in pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// whether key position kp is live for query position qp (< S both)
__device__ __forceinline__ bool live(const Params& a, int qp, int kp) {
  bool ok = kp < a.S && qp < a.S;
  if (a.causal) ok = ok && kp <= qp;
  if (a.window > 0) ok = ok && qp - kp < a.window;
  return ok;
}

// ------------------------------------------------------------------------
// 1. Delta = rowsum(dO * O), a warp a row (position, query head)
// ------------------------------------------------------------------------
__global__ void __launch_bounds__(256) delta_kernel(const Params a, long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const __nv_bfloat16* o = a.o + row * a.hd;
  const __nv_bfloat16* g = a.dout + row * a.hd;
  float acc = 0.f;
  for (int d = 8 * lane; d < a.hd; d += 256) {
    const uint4 x = *reinterpret_cast<const uint4*>(o + d);
    const uint4 y = *reinterpret_cast<const uint4*>(g + d);
    const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc = fmaf(__uint_as_float(xs[j] << 16), __uint_as_float(ys[j] << 16), acc);
      acc = fmaf(__uint_as_float(xs[j] & 0xffff0000u), __uint_as_float(ys[j] & 0xffff0000u),
                 acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long bs = row / a.Hq;              // b * S + position
    const int h = (int)(row - bs * a.Hq);
    const long long b = bs / a.S;
    a.delta[(b * a.Hq + h) * a.S + (bs - b * a.S)] = acc;
  }
}

// ------------------------------------------------------------------------
// 2. dK and dV, per (b, kv head, 64 keys)
// ------------------------------------------------------------------------
template <int NCH>
struct KvSmem {                            // byte offsets; NCH = ceil(hd / 64)
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = k + NCH * kBox64;
  static constexpr uint32_t q = v + NCH * kBox64;             // kStages x NCH boxes
  static constexpr uint32_t g = q + kStages * NCH * kBox64;   // dO, likewise
  static constexpr uint32_t p = g + kStages * NCH * kBox64;   // P^T hi, lo; dS^T hi, lo
  static constexpr uint32_t bars = p + 4 * kBox64;
  static constexpr uint32_t bytes = bars + 8 * (1 + kStages) + 1024;   // + alignment
};

template <int NCH>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
            const Params a) {
  using L = KvSmem<NCH>;
  constexpr int NB = (NCH + 1) / 2;        // 64-dim boxes of dK, dV a warpgroup
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sk = smem_u32(smem + L::k), sv = smem_u32(smem + L::v),
                 sq = smem_u32(smem + L::q), sg = smem_u32(smem + L::g),
                 sp = smem_u32(smem + L::p), sbar = smem_u32(smem + L::bars);
  auto q_full = [&](int st) { return sbar + 8 * (1 + st); };

  const int G = a.G, nrows = a.G * a.P;
  const int j0 = blockIdx.x * kKeys;       // causal: the first key tiles see the most rows
  const int hk = blockIdx.y, b = blockIdx.z;
  const int j_hi = min(j0 + kKeys, a.S) - 1;
  const int q_lo = a.causal ? j0 : 0;
  const int q_hi = a.window > 0 ? min(a.S - 1, j_hi + a.window - 1) : a.S - 1;
  const int t_lo = q_lo / a.P, t_hi = q_hi / a.P;
  const int tid = threadIdx.x;

  // query tile t (positions t P ..) of Q and dO into stage st
  auto load_tile = [&](int t, int st) {
    mbar_expect_tx(q_full(st), 2 * NCH * nrows * kRowBytes);
    for (int c = 0; c < NCH; ++c) {
      tma_load_4d(sq + (st * NCH + c) * kBox64, &tq, q_full(st), c * kChunk, hk * G, t * a.P, b);
      tma_load_4d(sg + (st * NCH + c) * kBox64, &tg, q_full(st), c * kChunk, hk * G, t * a.P, b);
    }
  };

  // rows past G P of every stage are never copied: zero them once
  if (nrows < kTileRows) {
    for (int i = nrows * (kRowBytes / 4) + tid; i < kTileRows * (kRowBytes / 4); i += kThreads)
      for (int x = 0; x < 2 * kStages * NCH; ++x)
        reinterpret_cast<uint32_t*>(smem + L::q + x * kBox64)[i] = 0u;
  }
  if (tid == 0) {
    for (int x = 0; x < 1 + kStages; ++x) mbar_init(sbar + 8 * x, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(sbar, 2 * NCH * kBox64);
    for (int c = 0; c < NCH; ++c) {
      tma_load_4d(sk + c * kBox64, &tk, sbar, c * kChunk, hk, j0, b);
      tma_load_4d(sv + c * kBox64, &tv, sbar, c * kChunk, hk, j0, b);
    }
    for (int t = t_lo; t <= min(t_hi, t_lo + kStages - 1); ++t) load_tile(t, t - t_lo);
  }

  const int cw = tid / 128, ctid = tid % 128;     // warpgroup, thread in it
  const int warp = ctid / 32, lane = ctid % 32;
  // accumulator rows (keys) kr0 and kr0 + 8; columns (query rows of the
  // tile) 32 cw + 8 jj + kc (+ 1)
  const int kr0 = warp * 16 + lane / 4;
  const int kc = 2 * (lane % 4);
  // this thread's eight columns: position within the tile, and the offset
  // of its (b, head) row of L and Delta
  int col_pos[8], col_row[8];
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const int r = 32 * cw + 8 * (x / 2) + kc + (x & 1);
    col_pos[x] = r < nrows ? r / G : 1 << 29;      // a dead row: never live
    col_row[x] = (b * a.Hq + hk * G + r % G) * a.S;
  }

  float dv[NB][32], dk[NB][32];
#pragma unroll
  for (int cb = 0; cb < NB; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[cb][i] = dk[cb][i] = 0.f;

  mbar_wait(sbar, 0);
  for (int t = t_lo; t <= t_hi; ++t) {
    const int it = t - t_lo, st = it % kStages;
    const uint32_t phase = (it / kStages) & 1;
    const int p0 = t * a.P;
    float lc[8], dc[8];
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int pos = p0 + col_pos[x];
      lc[x] = pos < a.S ? __ldg(a.lse + col_row[x] + pos) : 0.f;
      dc[x] = pos < a.S ? __ldg(a.delta + col_row[x] + pos) : 0.f;
    }
    // S^T = K Q^T and dP^T = V dO^T over this warpgroup's 32 query rows
    float s[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
    mbar_wait(q_full(st), phase);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t rows = (st * NCH + c) * kBox64 + cw * 32 * kRowBytes + kk * 32;
        wgmma_n32_ss(s, desc_sw128(sk + c * kBox64 + kk * 32, 16), desc_sw128(sq + rows, 16));
        wgmma_n32_ss(dp, desc_sw128(sv + c * kBox64 + kk * 32, 16), desc_sw128(sg + rows, 16));
      }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T, dS^T; as two bf16 terms each into shared memory, [key][row] in
    // the 128-byte swizzle (16-byte chunk index ^ key % 8)
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const int half = (i >> 1) & 1, x = 2 * (i / 4);
      const int key = kr0 + 8 * half;
      float pv[2], dsv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = p0 + col_pos[x + e];
        const bool ok = live(a, pos, j0 + key);
        pv[e] = ok ? ex2(s[i + e] * a.scale_log2 - lc[x + e]) : 0.f;
        dsv[e] = pv[e] * (dp[i + e] - dc[x + e]);
      }
      const uint32_t col = 32 * cw + 8 * (i / 4) + kc;
      const uint32_t off = key * kRowBytes + ((col * 2) ^ ((key & 7) << 4));
      uint32_t hi, lo;
      split2(pv[0], pv[1], hi, lo);
      *reinterpret_cast<uint32_t*>(smem + L::p + off) = hi;
      *reinterpret_cast<uint32_t*>(smem + L::p + kBox64 + off) = lo;
      split2(dsv[0], dsv[1], hi, lo);
      *reinterpret_cast<uint32_t*>(smem + L::p + 2 * kBox64 + off) = hi;
      *reinterpret_cast<uint32_t*>(smem + L::p + 3 * kBox64 + off) = lo;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, 256;\n" ::: "memory");   // both halves written

    // dV += P^T dO, dK += dS^T Q over this warpgroup's head-dim boxes
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      fence_regs(dv[cb]);
      fence_regs(dk[cb]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int cb = 0; cb < NB; ++cb) {
        const int c = cw + 2 * cb;
        // known true at compile time for even NCH: a runtime condition around
        // the wgmmas makes ptxas serialise them
        if (NCH % 2 == 0 || c < NCH) {
          const uint32_t box = (st * NCH + c) * kBox64 + kk * 16 * kRowBytes;
          const uint64_t dg = desc_sw128(sg + box, kBox64), dq = desc_sw128(sq + box, kBox64);
          wgmma_ss_tb(dv[cb], desc_sw128(sp + kk * 32, 16), dg);
          wgmma_ss_tb(dv[cb], desc_sw128(sp + kBox64 + kk * 32, 16), dg);
          wgmma_ss_tb(dk[cb], desc_sw128(sp + 2 * kBox64 + kk * 32, 16), dq);
          wgmma_ss_tb(dk[cb], desc_sw128(sp + 3 * kBox64 + kk * 32, 16), dq);
        }
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      fence_regs(dv[cb]);
      fence_regs(dk[cb]);
    }
    // both warpgroups are done with stage st and with P^T, dS^T
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (tid == 0 && t + kStages <= t_hi) load_tile(t + kStages, st);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = j0 + kr0 + 8 * half;
    if (key >= a.S) continue;
    const long long row = (((long long)b * a.S + key) * a.Hkv + hk) * a.hd;
#pragma unroll
    for (int cb = 0; cb < NB; ++cb) {
      const int c = cw + 2 * cb;
      if (c >= NCH) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = c * kChunk + 8 * j + kc;
        if (d < a.hd) {
          const int i = 4 * j + 2 * half;
          *reinterpret_cast<__nv_bfloat162*>(a.dk + row + d) =
              __floats2bfloat162_rn(dk[cb][i] * a.scale, dk[cb][i + 1] * a.scale);
          *reinterpret_cast<__nv_bfloat162*>(a.dv + row + d) =
              __floats2bfloat162_rn(dv[cb][i], dv[cb][i + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------------
// 3. dQ, per (b, kv head, 128 query rows)
// ------------------------------------------------------------------------
template <int NCH>
struct QSmem {
  static constexpr uint32_t q = 0;
  static constexpr uint32_t g = q + NCH * kBox128;
  static constexpr uint32_t k = g + NCH * kBox128;            // kStages x NCH boxes
  static constexpr uint32_t v = k + kStages * NCH * kBox32;
  static constexpr uint32_t bars = v + kStages * NCH * kBox32;
  static constexpr uint32_t done = bars + 8 * (1 + kStages);
  static constexpr uint32_t bytes = done + 4 * kStages + 1024;
};

template <int NCH>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
          const Params a) {
  using L = QSmem<NCH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sq = smem_u32(smem + L::q), sg = smem_u32(smem + L::g),
                 sk = smem_u32(smem + L::k), sv = smem_u32(smem + L::v),
                 sbar = smem_u32(smem + L::bars);
  auto kv_full = [&](int st) { return sbar + 8 * (1 + st); };
  unsigned* done = reinterpret_cast<unsigned*>(smem + L::done);

  const int G = a.G, nrows = a.G * a.P;
  const int qb = a.nt - 1 - (int)blockIdx.x;      // most kv tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q_lo = qb * a.P;
  const int q_hi = min(q_lo + a.P, a.S) - 1;
  const int kv_lo = a.window > 0 ? max(0, q_lo - a.window + 1) : 0;
  const int kv_hi = a.causal ? q_hi : a.S - 1;
  const int t_lo = kv_lo / kKeysQ, t_hi = kv_hi / kKeysQ;
  const int tid = threadIdx.x;

  auto load_tile = [&](int t, int st) {
    mbar_expect_tx(kv_full(st), 2 * NCH * kBox32);
    for (int c = 0; c < NCH; ++c) {
      tma_load_4d(sk + (st * NCH + c) * kBox32, &tk, kv_full(st), c * kChunk, hk, t * kKeysQ, b);
      tma_load_4d(sv + (st * NCH + c) * kBox32, &tv, kv_full(st), c * kChunk, hk, t * kKeysQ, b);
    }
  };

  for (int i = nrows * (kRowBytes / 4) + tid; i < kRows * (kRowBytes / 4); i += kThreads)
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      reinterpret_cast<uint32_t*>(smem + L::q + c * kBox128)[i] = 0u;
      reinterpret_cast<uint32_t*>(smem + L::g + c * kBox128)[i] = 0u;
    }
  if (tid == 0) {
    for (int x = 0; x < 1 + kStages; ++x) mbar_init(sbar + 8 * x, 1);
    for (int st = 0; st < kStages; ++st) done[st] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(sbar, 2 * NCH * nrows * kRowBytes);
    for (int c = 0; c < NCH; ++c) {
      tma_load_4d(sq + c * kBox128, &tq, sbar, c * kChunk, hk * G, q_lo, b);
      tma_load_4d(sg + c * kBox128, &tg, sbar, c * kChunk, hk * G, q_lo, b);
    }
    for (int t = t_lo; t <= min(t_hi, t_lo + kStages - 1); ++t) load_tile(t, t - t_lo);
  }

  const int cw = tid / 128, ctid = tid % 128;
  const int warp = ctid / 32, lane = ctid % 32;
  const int r0 = cw * 64 + warp * 16 + lane / 4, r1 = r0 + 8;
  const int pos0 = r0 < nrows ? q_lo + r0 / G : 1 << 29;   // a dead row: never live
  const int pos1 = r1 < nrows ? q_lo + r1 / G : 1 << 29;
  const int kc = 2 * (lane % 4);
  float l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;
  {
    const long long row0 = ((long long)b * a.Hq + hk * G + r0 % G) * a.S;
    const long long row1 = ((long long)b * a.Hq + hk * G + r1 % G) * a.S;
    if (pos0 < a.S) l0 = a.lse[row0 + pos0], d0 = a.delta[row0 + pos0];
    if (pos1 < a.S) l1 = a.lse[row1 + pos1], d1 = a.delta[row1 + pos1];
  }
  const uint32_t q_rows = sq + cw * 64 * kRowBytes, g_rows = sg + cw * 64 * kRowBytes;

  float dq[NCH][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[c][i] = 0.f;
  auto my_turn = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(3 + cw) : "memory"); };
  auto your_turn = [&]() { asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - cw) : "memory"); };
  if (cw == 1) your_turn();                         // warpgroup 0 goes first

  mbar_wait(sbar, 0);
  for (int t = t_lo; t <= t_hi; ++t) {
    const int it = t - t_lo, st = it % kStages;
    const uint32_t phase = (it / kStages) & 1;
    const int k0 = t * kKeysQ;
    // S = Q K^T and dP = dO V^T over the head dims
    float s[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
    mbar_wait(kv_full(st), phase);
    my_turn();
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t kv = (st * NCH + c) * kBox32 + kk * 32;
        wgmma_n32_ss(s, desc_sw128(q_rows + c * kBox128 + kk * 32, 16),
                     desc_sw128(sk + kv, 16));
        wgmma_n32_ss(dp, desc_sw128(g_rows + c * kBox128 + kk * 32, 16),
                     desc_sw128(sv + kv, 16));
      }
    wgmma_commit();
    your_turn();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS = P (dP - Delta) as two bf16 terms of A fragments: registers
    // 4 kk .. 4 kk + 3 are the fragment of keys 16 kk .. 16 kk + 15
    uint32_t hi[8], lo[8];
#pragma unroll
    for (int i = 0; i < 16; i += 2) {
      const bool second = i & 2;
      const int pos = second ? pos1 : pos0;
      const float lr = second ? l1 : l0, dr = second ? d1 : d0;
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + 8 * (i / 4) + kc + e;
        const float p = live(a, pos, kp) ? ex2(s[i + e] * a.scale_log2 - lr) : 0.f;
        ds[e] = p * (dp[i + e] - dr);
      }
      split2(ds[0], ds[1], hi[i / 2], lo[i / 2]);
    }

    // dQ += dS K: 16 keys a k-step, 64 head dims an instruction
    my_turn();
    fence_regs(hi);
    fence_regs(lo);
#pragma unroll
    for (int c = 0; c < NCH; ++c) fence_regs(dq[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const uint64_t dk =
            desc_sw128(sk + (st * NCH + c) * kBox32 + kk * 16 * kRowBytes, kBox32);
        wgmma_rs_tb(dq[c], hi + 4 * kk, dk);
        wgmma_rs_tb(dq[c], lo + 4 * kk, dk);
      }
    wgmma_commit();
    if (cw == 0 || t < t_hi) your_turn();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NCH; ++c) fence_regs(dq[c]);
    // this warpgroup is done with stage st; the second one to be refills it
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    if (ctid == 0 && (atomicAdd(done + st, 1u) & 1u) && t + kStages <= t_hi)
      load_tile(t + kStages, st);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0, pos = half ? pos1 : pos0;
    if (pos >= a.S) continue;
    __nv_bfloat16* row = a.dq + (((long long)b * a.S + pos) * a.Hq + hk * G + r % G) * a.hd;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = c * kChunk + 8 * j + kc;
        if (d < a.hd)
          *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(
              dq[c][4 * j + 2 * half] * a.scale, dq[c][4 * j + 2 * half + 1] * a.scale);
      }
  }
}

// cuTensorMapEncodeTiled of libcuda, found through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-d map over (hd, H, S, B) of bf16 with element strides (sh, ss, sb),
// boxes of (64, box_h, box_s, 1), 128-byte swizzle, zero fill out of bounds
bool encode(EncodeTiled enc, CUtensorMap* map, const void* base, int hd, int H, int S, int B,
            long long sh, long long ss, long long sb, int box_h, int box_s) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kChunk, (cuuint32_t)box_h, (cuuint32_t)box_s, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

struct Maps {                              // over q, k, v, dO: the dK / dV and dQ boxes
  alignas(64) CUtensorMap q64, k64, v64, g64, q128, k32, v32, g128;
};

template <int NCH>
int launch(const Maps& m, Params a, int B, cudaStream_t stream) {
  const int kv_bytes = (int)KvSmem<NCH>::bytes, q_bytes = (int)QSmem<NCH>::bytes;
  cudaError_t err = cudaFuncSetAttribute(dkdv_kernel<NCH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kv_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq_kernel<NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               q_bytes);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * a.S * a.Hq;
  delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(a, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  a.P = kTileRows / a.G;
  dkdv_kernel<NCH><<<dim3((a.S + kKeys - 1) / kKeys, a.Hkv, B), kThreads, kv_bytes, stream>>>(
      m.q64, m.k64, m.v64, m.g64, a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  a.P = kRows / a.G;
  a.nt = (a.S + a.P - 1) / a.P;
  dq_kernel<NCH><<<dim3(a.nt, a.Hkv, B), kThreads, q_bytes, stream>>>(m.q128, m.k32, m.v32,
                                                                     m.g128, a);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, Hq, hd), k and v (B, S, Hkv, hd) bfloat16, each with unit stride
// over hd and the given element strides over (b, s, h), every stride times 2
// and every pointer a multiple of 16 bytes; hd a multiple of 8 up to 256,
// Hq / Hkv <= 16.  out, dout and dq (B, S, Hq, hd) and dk, dv (B, S, Hkv, hd)
// contiguous bfloat16; lse (B, Hq, S) float32 from the forward kernel; delta
// (B, Hq, S) float32 scratch.  Three launches on `stream`; returns the first
// cudaGetLastError() that is not 0 (0 on success), cudaErrorInvalidValue for
// a shape it does not take, or cudaErrorNotSupported if libcuda's tensor-map
// encoder is missing or refuses a map.
extern "C" int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, void* dq, void* dk, void* dv, void* delta, int B, int S, int Hq, int Hkv,
    int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, int causal, int window,
    float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup || hd <= 0 ||
      hd % 8 != 0 || hd > 4 * kChunk || B > 65535 || Hkv > 65535 ||
      (long long)B * Hq * S > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  // the tensor maps are encoded by libcuda's cuTensorMapEncodeTiled, which
  // needs a current context; a thread that made no runtime call yet (the
  // autograd engine's device thread) may have none, and the encoder then
  // returns CUDA_ERROR_INVALID_CONTEXT: bind the current device's primary
  // context
  int device;
  cudaError_t bound = cudaGetDevice(&device);
  if (bound == cudaSuccess) bound = cudaSetDevice(device);
  if (bound != cudaSuccess) return (int)bound;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  Params a;
  a.o = static_cast<const __nv_bfloat16*>(out);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.S = S;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.hd = hd;
  a.G = Hq / Hkv;
  a.P = 0;
  a.nt = 0;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  const int G = a.G;
  const long long g_ss = (long long)Hq * hd, g_sb = (long long)S * Hq * hd;
  Maps m;
  if (!encode(enc, &m.q64, q, hd, Hq, S, B, q_sh, q_ss, q_sb, G, kTileRows / G) ||
      !encode(enc, &m.g64, dout, hd, Hq, S, B, hd, g_ss, g_sb, G, kTileRows / G) ||
      !encode(enc, &m.k64, k, hd, Hkv, S, B, k_sh, k_ss, k_sb, 1, kKeys) ||
      !encode(enc, &m.v64, v, hd, Hkv, S, B, v_sh, v_ss, v_sb, 1, kKeys) ||
      !encode(enc, &m.q128, q, hd, Hq, S, B, q_sh, q_ss, q_sb, G, kRows / G) ||
      !encode(enc, &m.g128, dout, hd, Hq, S, B, hd, g_ss, g_sb, G, kRows / G) ||
      !encode(enc, &m.k32, k, hd, Hkv, S, B, k_sh, k_ss, k_sb, 1, kKeysQ) ||
      !encode(enc, &m.v32, v, hd, Hkv, S, B, v_sh, v_ss, v_sb, 1, kKeysQ))
    return (int)cudaErrorNotSupported;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((hd + kChunk - 1) / kChunk) {
    case 1: return launch<1>(m, a, B, s);
    case 2: return launch<2>(m, a, B, s);
    case 3: return launch<3>(m, a, B, s);
    case 4: return launch<4>(m, a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
