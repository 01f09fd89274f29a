// Backward of causal / sliding-window GQA flash attention in bfloat16 on
// Hopper's tensor cores (sm_90a): TMA copies, mbarriers, wgmma.
//
// The gradient of the function that the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py) computes forward; the reference has
// no Pallas backward (JAX differentiates its jnp attention).  Float32 inputs
// keep csrc/flash_attention_bwd.cu.  For q (B, Sq, Hq, hd), k and v
// (B, Sk, Hkv, hd), query head h reading kv head h / G (G = Hq / Hkv),
// positions 0 .. Sq - 1 against 0 .. Sk - 1, the forward's output O, its
// per-row log-sum-exp L and an upstream dO:
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
// one ex2 and no launch here recomputes it.  Sq != Sk is the decoder's
// cross-attention.  A row whose window closes before the keys reach it
// (only where Sq > Sk) was the mean of v forward: its P is 1 / Sk on every
// key, as the plain backward's (the softmax of Sk equal masked scores).
//
// Design (dkdv_kernel / dq_kernel, the template for hd 65 .. 256; hd <= 64
// takes dkdv_hd64_kernel / dq_hd64_kernel, below, by the wrapper's plan,
// repro_torch.kernels.flash_attention.bwd_sm90_plan): three launches on one
// stream, no atomics on any output (each element is written once, by one
// CTA, so results do not depend on scheduling):
//   1. delta_kernel: Delta = rowsum(dO * O), hd / 8 lanes a row (a 16-byte
//      chunk a lane, up to a warp), float32 (B, Hq, Sq) scratch.
//      Bytes-bound: it reads dO and O once.
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
// positions past Sq or Sk and head dims past hd; rows past the group's G P
// rows of a tile are zeroed once and masked.
// q, k and v are read through their strides (multiples of 16 bytes: the
// wrapper checks); O, dO and dq are (B, Sq, Hq, hd) contiguous, dk and dv
// (B, Sk, Hkv, hd) contiguous; L and Delta (B, Hq, Sq) float32.
//
// Bound on the H100: operations.  The gradient needs five products of 2 hd
// flops per live (q, k) pair (S, dP, dV, dQ, dK): at the main path's
// (2, 4096, 8 / 4, 256), causal, 2 * 8 * 8.4 M pairs, 344 GFLOP, 0.35 ms at
// the bf16 tensor-core rate (989 TFLOP/s).  This kernel does ten (S and dP
// twice, dV, dK and dQ in two terms), as do the hd-64 kernels; the times
// beside the bound and SDPA's backward are in PERF.md (chip_smoke.py).

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
  int Sq, Sk, Hq, Hkv, hd, G, P, nt, causal, window;   // P: positions a tile; nt: tiles
  float scale;
  float scale_log2;   // scale * log2(e)
  float inv_sk;       // 1 / Sk: P of a row with no live key
  // the hd-64 kernels: L and Delta of every query row in dK / dV tile order
  // (ld_nt tiles of 64 rows a (b, kv head)), or null
  float2* ld;
  int ld_nt;
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

// whether key position kp is live for query position qp (kp < Sk, qp < Sq)
__device__ __forceinline__ bool live(const Params& a, int qp, int kp) {
  bool ok = kp < a.Sk && qp < a.Sq;
  if (a.causal) ok = ok && kp <= qp;
  if (a.window > 0) ok = ok && qp - kp < a.window;
  return ok;
}

// whether the row at position qp has no live key: its window closes before
// the keys reach it (only where Sq > Sk)
__device__ __forceinline__ bool dead_row(const Params& a, int qp) {
  return a.window > 0 && qp - a.window + 1 > a.Sk - 1;
}

// P of a pair the mask drops: 1 / Sk on the keys of a row (< Sq) with no
// live key (the forward's mean of v), else 0
__device__ __forceinline__ float dropped_p(const Params& a, int qp, int kp) {
  return qp < a.Sq && kp < a.Sk && dead_row(a, qp) ? a.inv_sk : 0.f;
}

// the query rows that see keys j0 .. j_hi: from the diagonal (causal) to the
// window's end, or to Sq - 1 where the last rows have no live key (they see
// every key)
__device__ __forceinline__ int2 query_range(const Params& a, int j0, int j_hi) {
  const int q_lo = a.causal ? j0 : 0;
  const int q_hi = a.window > 0 && !dead_row(a, a.Sq - 1)
                       ? min(a.Sq - 1, j_hi + a.window - 1) : a.Sq - 1;
  return make_int2(q_lo, q_hi);
}

// the keys that rows q_lo .. q_hi see: the live range, or every key where
// the last row has none live
__device__ __forceinline__ int2 key_range(const Params& a, int q_lo, int q_hi) {
  const bool dead = dead_row(a, q_hi);
  const int kv_lo = a.window > 0 && !dead ? max(0, q_lo - a.window + 1) : 0;
  const int kv_hi = a.causal && !dead ? min(q_hi, a.Sk - 1) : a.Sk - 1;
  return make_int2(kv_lo, kv_hi);
}

// ------------------------------------------------------------------------
// 1. Delta = rowsum(dO * O), a warp a row (position, query head)
// ------------------------------------------------------------------------
// lanes a row: one 16-byte chunk a lane (hd / 8 of them), rounded up to a
// power of two (32 at hd > 128)
__host__ __device__ __forceinline__ int delta_lanes(int hd) {
  int n = 1;
  while (n < 32 && 8 * n < hd) n *= 2;
  return n;
}

__global__ void __launch_bounds__(256) delta_kernel(const Params a, long long rows) {
  const int lanes = delta_lanes(a.hd), lane = threadIdx.x % lanes;
  const long long row = ((long long)blockIdx.x * 256 + threadIdx.x) / lanes;
  if (row >= rows) return;                         // whole groups of lanes leave together
  const __nv_bfloat16* o = a.o + row * a.hd;
  const __nv_bfloat16* g = a.dout + row * a.hd;
  float acc = 0.f;
  for (int d = 8 * lane; d < a.hd; d += 8 * lanes) {
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
  // the group's sum: its lanes are aligned within the warp, and a warp's
  // rows all lie below `rows` or past it together unless the last block is
  // ragged, where the lanes past it have left: shuffle among the group only
  const unsigned group = lanes == 32 ? 0xffffffffu
                                     : ((1u << lanes) - 1u) << (threadIdx.x % 32 / lanes * lanes);
  for (int off = lanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(group, acc, off);
  if (lane == 0) {
    const long long bs = row / a.Hq;              // b * Sq + position
    const int h = (int)(row - bs * a.Hq);
    const long long b = bs / a.Sq;
    const int pos = (int)(bs - b * a.Sq);
    const long long at = (b * a.Hq + h) * a.Sq + pos;
    a.delta[at] = acc;
    if (a.ld != nullptr) {                        // row (pos, h) of its 64-row tile
      const int P = kTileRows / a.G, hk = h / a.G, t = pos / P;
      a.ld[((b * a.Hkv + hk) * a.ld_nt + t) * kTileRows + (pos - t * P) * a.G + h % a.G] =
          make_float2(a.lse[at], acc);
    }
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
  const int2 qr = query_range(a, j0, min(j0 + kKeys, a.Sk) - 1);
  const int t_lo = qr.x / a.P, t_hi = qr.y / a.P;
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
    col_row[x] = (b * a.Hq + hk * G + r % G) * a.Sq;
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
      lc[x] = pos < a.Sq ? __ldg(a.lse + col_row[x] + pos) : 0.f;
      dc[x] = pos < a.Sq ? __ldg(a.delta + col_row[x] + pos) : 0.f;
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
        pv[e] = live(a, pos, j0 + key) ? ex2(s[i + e] * a.scale_log2 - lc[x + e])
                                       : dropped_p(a, pos, j0 + key);
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
    if (key >= a.Sk) continue;
    const long long row = (((long long)b * a.Sk + key) * a.Hkv + hk) * a.hd;
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
  const int q_hi = min(q_lo + a.P, a.Sq) - 1;
  const int2 kr = key_range(a, q_lo, q_hi);
  const int t_lo = kr.x / kKeysQ, t_hi = kr.y / kKeysQ;
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
    const long long row0 = ((long long)b * a.Hq + hk * G + r0 % G) * a.Sq;
    const long long row1 = ((long long)b * a.Hq + hk * G + r1 % G) * a.Sq;
    if (pos0 < a.Sq) l0 = a.lse[row0 + pos0], d0 = a.delta[row0 + pos0];
    if (pos1 < a.Sq) l1 = a.lse[row1 + pos1], d1 = a.delta[row1 + pos1];
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
        const float p = live(a, pos, kp) ? ex2(s[i + e] * a.scale_log2 - lr)
                                         : dropped_p(a, pos, kp);
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
    if (pos >= a.Sq) continue;
    __nv_bfloat16* row = a.dq + (((long long)b * a.Sq + pos) * a.Hq + hk * G + r % G) * a.hd;
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

// ------------------------------------------------------------------------
// head_dim <= 64: dkdv_hd64_kernel and dq_hd64_kernel
// ------------------------------------------------------------------------
// The template above lays the dK / dV CTA out for hd 256, where the two
// accumulators of 64 keys take 256 registers a thread and are split by
// head-dim boxes over the two warpgroups.  At hd 64 there is one box: the
// second warpgroup's products sat under a runtime condition (which ptxas
// serialises), so one warpgroup issued every dV / dK wgmma while the other
// waited; every tile passed P^T and dS^T through shared memory between two
// CTA-wide barriers; and dQ walked 32-key tiles (kernel_ablation.py
// flash_bwd times each of these at whisper's shapes).  These two kernels:
//   * dK / dV: a CTA of two warpgroups owns 128 keys, 64 a warpgroup, so
//     each warpgroup's accumulators (dV and dK, 64 keys x 64 head dims, 64
//     registers a thread) are its own and no product is conditional.  Both
//     walk the same query tiles of 64 rows (a two-stage TMA ring of Q, dO
//     and the tile's L and Delta).  Per tile a warpgroup computes S^T = K
//     Q^T and dP^T = V dO^T (m64n64k16), forms P^T and dS^T in registers
//     and feeds them to dV += P^T dO and dK += dS^T Q as wgmma's A operand
//     from registers (the accumulator layout of S^T is the A layout of a
//     k-step over the tile's rows), B MN-major from the ring: no shared-
//     memory round trip and no barrier between the warpgroups; the last
//     warp done with a stage refills it.  K and V are S^T's and dP^T's A
//     operand from registers too (ldmatrix once), so those products read
//     only Q and dO from shared memory.
//   * L and Delta of a tile's rows: delta_kernel also writes them in tile
//     order (`ld`, a float2 a row, 64 rows a tile), and the tile's 512 bytes
//     come with Q and dO by one bulk copy, so the softmax reads them from
//     shared memory.
//   * dQ: a CTA of two warpgroups owns 128 query rows, 64 a warpgroup, and
//     walks kv tiles of 64 keys (S and dP m64n64k16, dQ += dS K with dS from
//     registers), two CTAs an SM within 128 registers a thread.
//   * Only tiles on the diagonal, the window's edge or with a row without a
//     live key are masked per element, and in dQ those past Sk (in dK / dV
//     rows past Sq and keys past Sk add nothing to what is stored); a
//     warpgroup whose keys (dK / dV) or rows (dQ) all lie past Sk or Sq
//     returns at once.
//   * Each warpgroup walks its tiles in turn: issuing S^T_{t+1} behind the
//     products of tile t, as the forward does, read no faster here
//     (PERF.md).
// P and dS go in as two bf16 terms, as in the template; dK, dV and dQ are
// each written once.
constexpr int kKeys64 = 128;               // keys per dK / dV CTA, 64 a warpgroup
constexpr int kKeysQ64 = 64;               // keys per dQ kv tile
constexpr int kStages64 = 2;
constexpr uint32_t kLdBytes = kTileRows * 8;   // a tile's L and Delta
constexpr int kDq64CtasPerSm = 2;          // at most 128 registers a thread

// atomicAdd on a shared-memory word by its 32-bit address
__device__ __forceinline__ unsigned atom_add_shared(uint32_t addr, unsigned v) {
  unsigned old;
  asm volatile("atom.shared::cta.add.u32 %0, [%1], %2;\n" : "=r"(old) : "r"(addr), "r"(v)
               : "memory");
  return old;
}

// a bulk copy of `bytes` (a multiple of 16) from global to shared memory,
// completing on an mbarrier
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// d (+)= A B, m64n64k16, A and B K-major in shared memory; scale_d 0
// ignores d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A B, m64n64k16, A from registers, B K-major in shared memory;
// scale_d 0 ignores d
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WGMMA_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// this warp's A fragments of 16 rows x 64 head dims (four k-steps) of a
// 128-byte swizzled tile at `rows` (1024-byte aligned): rows row0 ..
// row0 + 15, by ldmatrix (matrix m of a k-step: rows + 8 (m & 1), head
// dims + 8 (m >> 1))
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[16], uint32_t rows, int row0,
                                             int lane) {
  const int m = lane / 8, r = row0 + (m & 1) * 8 + lane % 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t at = rows + r * kRowBytes + (((2 * kk + (m >> 1)) ^ (r & 7)) << 4);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(f[4 * kk]), "=r"(f[4 * kk + 1]), "=r"(f[4 * kk + 2]),
                   "=r"(f[4 * kk + 3])
                 : "r"(at)
                 : "memory");
  }
}

// d (64 x 64) = A B^T over 64 head dims, A from registers (load_a_frags),
// B rows at b_rows K-major in the 128-byte swizzle
__device__ __forceinline__ void issue_frags64(float (&d)[32], const uint32_t (&a)[16],
                                              uint32_t b_rows) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(d, a + 4 * kk, desc_sw128(b_rows + kk * 32, 16), kk);
}

// d (64 x 64) = A B^T over 64 head dims: A rows at a_rows, B rows at
// b_rows, both K-major in the 128-byte swizzle (a k-step 32 bytes along
// the rows); the first k-step ignores what d held
__device__ __forceinline__ void issue_rows64(float (&d)[32], uint32_t a_rows, uint32_t b_rows) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss(d, desc_sw128(a_rows + kk * 32, 16), desc_sw128(b_rows + kk * 32, 16), kk);
}

// d += (hi + lo) B over 64 rows of B: hi and lo the A fragments of four
// k-steps (registers 4 kk .. 4 kk + 3), B MN-major at b_rows (16 rows a
// k-step)
__device__ __forceinline__ void issue_two_terms(float (&d)[32], const uint32_t (&hi)[16],
                                                const uint32_t (&lo)[16], uint32_t b_rows) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_sw128(b_rows + kk * 16 * kRowBytes, kBox64);
    wgmma_rs_tb(d, hi + 4 * kk, db);
    wgmma_rs_tb(d, lo + 4 * kk, db);
  }
}

struct Kv64Smem {
  static constexpr uint32_t k = 0;                          // 128 keys
  static constexpr uint32_t v = k + kBox128;
  static constexpr uint32_t q = v + kBox128;                // kStages64 tiles of 64 rows
  static constexpr uint32_t g = q + kStages64 * kBox64;     // dO, likewise
  static constexpr uint32_t ld = g + kStages64 * kBox64;    // L and Delta, likewise
  static constexpr uint32_t pos = ld + kStages64 * kLdBytes;   // int a tile row
  static constexpr uint32_t bars = pos + 4 * kTileRows;
  static constexpr uint32_t done = bars + 8 * (1 + kStages64);
  static constexpr uint32_t bytes = done + 4 * kStages64 + 1024;
};

__global__ void __launch_bounds__(kThreads, 1)
dkdv_hd64_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                 const Params a) {
  using L = Kv64Smem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sk = smem_u32(smem + L::k), sv = smem_u32(smem + L::v),
                 sq = smem_u32(smem + L::q), sg = smem_u32(smem + L::g),
                 sld = smem_u32(smem + L::ld), sbar = smem_u32(smem + L::bars),
                 sdone = smem_u32(smem + L::done);
  const int* row_pos = reinterpret_cast<const int*>(smem + L::pos);
  auto q_full = [&](int st) { return sbar + 8 * (1 + st); };

  const int G = a.G, nrows = a.G * a.P;
  const int j0 = blockIdx.x * kKeys64;     // causal: the first key tiles see the most rows
  const int hk = blockIdx.y, b = blockIdx.z;
  const int2 qr = query_range(a, j0, min(j0 + kKeys64, a.Sk) - 1);
  const int t_lo = qr.x / a.P, t_hi = qr.y / a.P;
  const int tid = threadIdx.x;
  // the warpgroups with a key below Sk, and the warps that release a stage
  const int busy = j0 + 64 < a.Sk ? 2 : 1;
  const unsigned last_warp = 4u * busy - 1u;
  const float2* ld = a.ld + ((long long)b * a.Hkv + hk) * a.ld_nt * kTileRows;

  auto load_tile = [&](int t, int st) {
    mbar_expect_tx(q_full(st), 2 * nrows * kRowBytes + kLdBytes);
    tma_load_4d(sq + st * kBox64, &tq, q_full(st), 0, hk * G, t * a.P, b);
    tma_load_4d(sg + st * kBox64, &tg, q_full(st), 0, hk * G, t * a.P, b);
    bulk_load(sld + st * kLdBytes, ld + t * kTileRows, kLdBytes, q_full(st));
  };

  // rows past G P of every stage are never copied: zero them once
  for (int i = nrows * (kRowBytes / 4) + tid; i < kTileRows * (kRowBytes / 4); i += kThreads)
#pragma unroll
    for (int x = 0; x < 2 * kStages64; ++x)
      reinterpret_cast<uint32_t*>(smem + L::q + x * kBox64)[i] = 0u;
  // tile row r: its position within the tile (past every position where it
  // is a padding row)
  if (tid < kTileRows)
    reinterpret_cast<int*>(smem + L::pos)[tid] = tid < nrows ? tid / G : 1 << 29;
  if (tid == 0) {
    for (int x = 0; x < 1 + kStages64; ++x) mbar_init(sbar + 8 * x, 1);
    for (int st = 0; st < kStages64; ++st)
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(sdone + 4 * st), "r"(0u) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(sbar, 2 * kBox128);
    tma_load_4d(sk, &tk, sbar, 0, hk, j0, b);
    tma_load_4d(sv, &tv, sbar, 0, hk, j0, b);
    for (int t = t_lo; t <= min(t_hi, t_lo + kStages64 - 1); ++t) load_tile(t, t - t_lo);
  }

  const int cw = tid / 128;
  if (cw >= busy) return;                          // every key past Sk
  const int ctid = tid % 128, warp = ctid / 32, lane = ctid % 32;
  // accumulator rows (keys) kr0 and kr0 + 8 of the warpgroup's 64; columns
  // (tile rows) 8 j + kc (+ 1)
  const int wk0 = j0 + cw * 64;                    // the warpgroup's first key
  const int kr0 = warp * 16 + lane / 4, kc = 2 * (lane % 4);
  const int key[2] = {wk0 + kr0, wk0 + kr0 + 8};
  const uint32_t k_rows = sk + cw * 64 * kRowBytes, v_rows = sv + cw * 64 * kRowBytes;

  float dv[32], dk[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dv[i] = dk[i] = 0.f;
  float s[32], dp[32];
  uint32_t p_hi[16], p_lo[16], ds_hi[16], ds_lo[16];
  uint32_t kf[16], vf[16];                         // K, V: S^T's and dP^T's A operand

  mbar_wait(sbar, 0);
  load_a_frags(kf, k_rows, warp * 16, lane);
  load_a_frags(vf, v_rows, warp * 16, lane);
  fence_regs(kf);
  fence_regs(vf);
  // each query tile in turn; none where no row sees these keys (causal,
  // keys past Sq): zeros
  for (int t = t_lo; t <= t_hi; ++t) {
    const int it = t - t_lo, st = it % kStages64, p0 = t * a.P;
    const uint32_t q_st = sq + st * kBox64, g_st = sg + st * kBox64;
    // S^T = K Q^T and dP^T = V dO^T over this warpgroup's 64 keys
    mbar_wait(q_full(st), (it / kStages64) & 1);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    issue_frags64(s, kf, q_st);
    issue_frags64(dp, vf, g_st);
    wgmma_commit();
    // whether a pair of the tile may be masked: the diagonal, the window's
    // edge or a row with no live key.  Rows past Sq or the group's need no
    // mask: their Q, dO, L and Delta are zeros, so P^T = 1 and dS^T = 0 add
    // nothing; nor do keys past Sk, whose dK and dV rows are never stored
    const int last = min(p0 + a.P, a.Sq) - 1;
    const bool edge = (a.causal && p0 < wk0 + 63) ||
                      (a.window > 0 && (last - wk0 >= a.window || dead_row(a, last)));
    const float2* lds = reinterpret_cast<const float2*>(smem + L::ld + st * kLdBytes);
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P^T = ex2(S^T scale log2(e) - L), dS^T = P^T (dP^T - Delta), each as
    // two bf16 terms of A fragments: element i is key key[(i >> 1) & 1],
    // column 8 (i >> 2) + kc + (i & 1)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      float pv[2], dsv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * (i >> 2) + kc + e;
        const float2 ldc = lds[col];               // L, Delta of the column's row
        float p = ex2(fmaf(s[i + e], a.scale_log2, -ldc.x));
        if (edge) {
          const int pos = p0 + row_pos[col];
          const int kp = key[(i >> 1) & 1];
          p = live(a, pos, kp) ? p : dropped_p(a, pos, kp);
        }
        pv[e] = p;
        dsv[e] = p * (dp[i + e] - ldc.y);
      }
      split2(pv[0], pv[1], p_hi[i / 2], p_lo[i / 2]);
      split2(dsv[0], dsv[1], ds_hi[i / 2], ds_lo[i / 2]);
    }

    // dV += P^T dO, dK += dS^T Q over the tile's 64 rows
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
    issue_two_terms(dv, p_hi, p_lo, g_st);
    issue_two_terms(dk, ds_hi, ds_lo, q_st);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(ds_hi);
    fence_regs(ds_lo);
    // this warp is done with stage st: the last of the busy warps refills it
    if (lane == 0 && (atom_add_shared(sdone + 4 * st, 1u) & last_warp) == last_warp &&
        t + kStages64 <= t_hi)
      load_tile(t + kStages64, st);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (key[half] >= a.Sk) continue;
    const long long row = (((long long)b * a.Sk + key[half]) * a.Hkv + hk) * a.hd;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 8 * j + kc;
      if (d < a.hd) {
        const int i = 4 * j + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(a.dk + row + d) =
            __floats2bfloat162_rn(dk[i] * a.scale, dk[i + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(a.dv + row + d) =
            __floats2bfloat162_rn(dv[i], dv[i + 1]);
      }
    }
  }
}

struct Q64Smem {
  static constexpr uint32_t q = 0;                          // 128 rows
  static constexpr uint32_t g = q + kBox128;
  static constexpr uint32_t k = g + kBox128;                // kStages64 tiles of 64 keys
  static constexpr uint32_t v = k + kStages64 * kBox64;
  static constexpr uint32_t bars = v + kStages64 * kBox64;
  static constexpr uint32_t done = bars + 8 * (1 + kStages64);
  static constexpr uint32_t bytes = done + 4 * kStages64 + 1024;
};

__global__ void __launch_bounds__(kThreads, kDq64CtasPerSm)
dq_hd64_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
               const Params a) {
  using L = Q64Smem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sq = smem_u32(smem + L::q), sg = smem_u32(smem + L::g),
                 sk = smem_u32(smem + L::k), sv = smem_u32(smem + L::v),
                 sbar = smem_u32(smem + L::bars), sdone = smem_u32(smem + L::done);
  auto kv_full = [&](int st) { return sbar + 8 * (1 + st); };

  const int G = a.G, nrows = a.G * a.P;
  const int qb = a.nt - 1 - (int)blockIdx.x;      // most kv tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q_lo = qb * a.P;
  const int q_hi = min(q_lo + a.P, a.Sq) - 1;
  const int2 kr = key_range(a, q_lo, q_hi);
  const int t_lo = kr.x / kKeysQ64, t_hi = kr.y / kKeysQ64;
  const int tid = threadIdx.x;
  // the warpgroups with a row below Sq (the second's first row is 64), and
  // the warps that release a stage
  const int busy = 64 < nrows && q_lo + 64 / G <= q_hi ? 2 : 1;
  const unsigned last_warp = 4u * busy - 1u;

  auto load_tile = [&](int t, int st) {
    mbar_expect_tx(kv_full(st), 2 * kBox64);
    tma_load_4d(sk + st * kBox64, &tk, kv_full(st), 0, hk, t * kKeysQ64, b);
    tma_load_4d(sv + st * kBox64, &tv, kv_full(st), 0, hk, t * kKeysQ64, b);
  };

  for (int i = nrows * (kRowBytes / 4) + tid; i < kRows * (kRowBytes / 4); i += kThreads) {
    reinterpret_cast<uint32_t*>(smem + L::q)[i] = 0u;
    reinterpret_cast<uint32_t*>(smem + L::g)[i] = 0u;
  }
  if (tid == 0) {
    for (int x = 0; x < 1 + kStages64; ++x) mbar_init(sbar + 8 * x, 1);
    for (int st = 0; st < kStages64; ++st)
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(sdone + 4 * st), "r"(0u) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(sbar, 2 * nrows * kRowBytes);
    tma_load_4d(sq, &tq, sbar, 0, hk * G, q_lo, b);
    tma_load_4d(sg, &tg, sbar, 0, hk * G, q_lo, b);
    for (int t = t_lo; t <= min(t_hi, t_lo + kStages64 - 1); ++t) load_tile(t, t - t_lo);
  }

  const int cw = tid / 128;
  if (cw >= busy) return;                          // every row past Sq
  const int lane = tid % 32;
  const int r0 = tid / 32 * 16 + lane / 4, r1 = r0 + 8;   // cw * 64 + warp * 16 + lane / 4
  const int pos0 = r0 < nrows ? q_lo + r0 / G : 1 << 29;  // a padding row: never live
  const int pos1 = r1 < nrows ? q_lo + r1 / G : 1 << 29;
  const int kc = 2 * (lane % 4);
  float l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;
  {
    const long long row0 = ((long long)b * a.Hq + hk * G + r0 % G) * a.Sq;
    const long long row1 = ((long long)b * a.Hq + hk * G + r1 % G) * a.Sq;
    if (pos0 < a.Sq) l0 = a.lse[row0 + pos0], d0 = a.delta[row0 + pos0];
    if (pos1 < a.Sq) l1 = a.lse[row1 + pos1], d1 = a.delta[row1 + pos1];
  }
  const uint32_t q_rows = sq + cw * 64 * kRowBytes, g_rows = sg + cw * 64 * kRowBytes;

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  float s[32], dp[32];
  uint32_t hi[16], lo[16];

  mbar_wait(sbar, 0);
  for (int t = t_lo; t <= t_hi; ++t) {
    const int it = t - t_lo, st = it % kStages64, k0 = t * kKeysQ64;
    const uint32_t k_st = sk + st * kBox64, v_st = sv + st * kBox64;
    // S = Q K^T and dP = dO V^T over this warpgroup's 64 rows
    mbar_wait(kv_full(st), (it / kStages64) & 1);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    issue_rows64(s, q_rows, k_st);
    issue_rows64(dp, g_rows, v_st);
    wgmma_commit();
    const bool edge = k0 + kKeysQ64 > a.Sk || (a.causal && k0 + kKeysQ64 - 1 > q_lo) ||
                      (a.window > 0 && (q_hi - k0 >= a.window || dead_row(a, q_hi)));
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // dS = P (dP - Delta) as two bf16 terms of A fragments: element i is row
    // (i & 2 ? r1 : r0), key k0 + 8 (i >> 2) + kc + (i & 1)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const bool second = i & 2;
      const float lr = second ? l1 : l0, dr = second ? d1 : d0;
      float ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p = ex2(fmaf(s[i + e], a.scale_log2, -lr));
        if (edge) {
          const int pos = second ? pos1 : pos0, kp = k0 + 8 * (i >> 2) + kc + e;
          p = live(a, pos, kp) ? p : dropped_p(a, pos, kp);
        }
        ds[e] = p * (dp[i + e] - dr);
      }
      split2(ds[0], ds[1], hi[i / 2], lo[i / 2]);
    }

    // dQ += dS K over the tile's 64 keys
    fence_regs(hi);
    fence_regs(lo);
    fence_regs(dq);
    wgmma_fence();
    issue_two_terms(dq, hi, lo, k_st);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    fence_regs(hi);
    fence_regs(lo);
    // this warp is done with stage st: the last of the busy warps refills it
    if (lane == 0 && (atom_add_shared(sdone + 4 * st, 1u) & last_warp) == last_warp &&
        t + kStages64 <= t_hi)
      load_tile(t + kStages64, st);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0, pos = half ? pos1 : pos0;
    if (pos >= a.Sq) continue;
    __nv_bfloat16* row = a.dq + (((long long)b * a.Sq + pos) * a.Hq + hk * G + r % G) * a.hd;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = 8 * j + kc;
      if (d < a.hd)
        *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(
            dq[4 * j + 2 * half] * a.scale, dq[4 * j + 2 * half + 1] * a.scale);
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
  alignas(64) CUtensorMap q64, k64, v64, g64, q128, k32, v32, g128, k128, v128;
};

// the plan's kernels (repro_torch.kernels.flash_attention.bwd_sm90_plan: 0
// the hd-64 pair for hd <= 64, 1 the template at ceil(hd / 64) = 2 .. 4
// boxes) at head_dim hd, with their dynamic shared memory, the keys of a
// dK / dV CTA and their maps; null where the plan's kernels do not take hd
struct Chosen {
  const void* dkdv;
  int kv_bytes;
  const void* dq;
  int q_bytes;
  int keys;
  const CUtensorMap *kq, *kk, *kv, *kg, *qq, *qk, *qv, *qg;
};
Chosen choose(int kernel, int hd, const Maps* m) {
  const int nch = (hd + kChunk - 1) / kChunk;
  Chosen c{};
  if (kernel == 0 && nch == 1) {
    c = {(const void*)dkdv_hd64_kernel, (int)Kv64Smem::bytes, (const void*)dq_hd64_kernel,
         (int)Q64Smem::bytes, kKeys64};
    if (m) c.kk = &m->k128, c.kv = &m->v128, c.qk = &m->k64, c.qv = &m->v64;
  } else if (kernel == 1 && nch >= 2 && nch <= 4) {
    const void* kv[3] = {(const void*)dkdv_kernel<2>, (const void*)dkdv_kernel<3>,
                         (const void*)dkdv_kernel<4>};
    const void* q[3] = {(const void*)dq_kernel<2>, (const void*)dq_kernel<3>,
                        (const void*)dq_kernel<4>};
    const int kvb[3] = {(int)KvSmem<2>::bytes, (int)KvSmem<3>::bytes, (int)KvSmem<4>::bytes};
    const int qb[3] = {(int)QSmem<2>::bytes, (int)QSmem<3>::bytes, (int)QSmem<4>::bytes};
    c = {kv[nch - 2], kvb[nch - 2], q[nch - 2], qb[nch - 2], kKeys};
    if (m) c.kk = &m->k64, c.kv = &m->v64, c.qk = &m->k32, c.qv = &m->v32;
  }
  if (m) c.kq = &m->q64, c.kg = &m->g64, c.qq = &m->q128, c.qg = &m->g128;
  return c;
}

int launch(const Chosen& c, Params a, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(c.dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         c.kv_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(c.dq, cudaFuncAttributeMaxDynamicSharedMemorySize, c.q_bytes);
  // the tiles' rows past Sq or the group's read L = Delta = 0
  if (err == cudaSuccess && a.ld != nullptr)
    err = cudaMemsetAsync(a.ld, 0, (size_t)B * a.Hkv * a.ld_nt * kLdBytes, stream);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * a.Sq * a.Hq;
  const long long per_block = 256 / delta_lanes(a.hd);
  delta_kernel<<<(unsigned)((rows + per_block - 1) / per_block), 256, 0, stream>>>(a, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  a.P = kTileRows / a.G;
  {
    void* args[] = {(void*)c.kq, (void*)c.kk, (void*)c.kv, (void*)c.kg, &a};
    cudaLaunchKernel(c.dkdv, dim3((a.Sk + c.keys - 1) / c.keys, a.Hkv, B), dim3(kThreads),
                     args, c.kv_bytes, stream);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  a.P = kRows / a.G;
  a.nt = (a.Sq + a.P - 1) / a.P;
  {
    void* args[] = {(void*)c.qq, (void*)c.qk, (void*)c.qv, (void*)c.qg, &a};
    cudaLaunchKernel(c.dq, dim3(a.nt, a.Hkv, B), dim3(kThreads), args, c.q_bytes, stream);
  }
  return (int)cudaGetLastError();
}

// where the hd-64 kernels' L and Delta start in the delta buffer (floats:
// past B Hq Sq, on 16 bytes), and the buffer's length
long long ld_offset(int B, int Sq, int Hq) { return ((long long)B * Hq * Sq + 3) / 4 * 4; }
long long scratch_floats(int B, int Sq, int Hq, int Hkv, int kernel) {
  const int G = Hq / Hkv, P = kTileRows / G;
  return kernel == 0 ? ld_offset(B, Sq, Hq) + 2LL * B * Hkv * ((Sq + P - 1) / P) * kTileRows
                     : (long long)B * Hq * Sq;
}

}  // namespace

// The floats of the delta scratch buffer that flash_attention_bwd_sm90_launch
// takes for these sizes and `kernel`: Delta (B, Hq, Sq), and for the hd-64
// kernels each row's L and Delta again in dK / dV tile order; 0 for a shape
// it does not take.
extern "C" long long flash_attention_bwd_sm90_scratch(int B, int Sq, int Hq, int Hkv,
                                                      int kernel) {
  if (B <= 0 || Sq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup) return 0;
  return scratch_floats(B, Sq, Hq, Hkv, kernel);
}

// q (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd) bfloat16, each with unit
// stride over hd and the given element strides over (b, s, h), every stride
// times 2 and every pointer a multiple of 16 bytes; hd a multiple of 8 up to
// 256, Hq / Hkv <= 16.  out, dout and dq (B, Sq, Hq, hd) and dk, dv (B, Sk,
// Hkv, hd) contiguous bfloat16; lse (B, Hq, Sq) float32 from the forward
// kernel; delta float32 scratch of flash_attention_bwd_sm90_scratch floats;
// `kernel` the wrapper's plan (choose).  Three launches on `stream`; returns the first
// cudaGetLastError() that is not 0 (0 on success), cudaErrorInvalidValue
// for a shape or a kernel it does not take, or cudaErrorNotSupported if
// libcuda's tensor-map encoder is missing or refuses a map.
extern "C" int flash_attention_bwd_sm90_launch(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, void* dq, void* dk, void* dv, void* delta, int B, int Sq, int Sk, int Hq,
    int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh, int causal,
    int window, float scale, int kernel, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup ||
      hd <= 0 || hd % 8 != 0 || hd > 4 * kChunk || B > 65535 || Hkv > 65535 ||
      (long long)B * Hq * Sq > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (choose(kernel, hd, nullptr).dkdv == nullptr) return (int)cudaErrorInvalidValue;
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
  a.Sq = Sq;
  a.Sk = Sk;
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
  a.inv_sk = 1.f / (float)Sk;
  // the hd-64 kernels' tile-ordered L and Delta, past Delta in its buffer
  a.ld = nullptr;
  a.ld_nt = (Sq + kTileRows / a.G - 1) / (kTileRows / a.G);
  if (kernel == 0) a.ld = reinterpret_cast<float2*>(a.delta + ld_offset(B, Sq, Hq));
  const int G = a.G;
  const long long g_ss = (long long)Hq * hd, g_sb = (long long)Sq * Hq * hd;
  Maps m;
  if (!encode(enc, &m.q64, q, hd, Hq, Sq, B, q_sh, q_ss, q_sb, G, kTileRows / G) ||
      !encode(enc, &m.g64, dout, hd, Hq, Sq, B, hd, g_ss, g_sb, G, kTileRows / G) ||
      !encode(enc, &m.k64, k, hd, Hkv, Sk, B, k_sh, k_ss, k_sb, 1, kKeys) ||
      !encode(enc, &m.v64, v, hd, Hkv, Sk, B, v_sh, v_ss, v_sb, 1, kKeys) ||
      !encode(enc, &m.q128, q, hd, Hq, Sq, B, q_sh, q_ss, q_sb, G, kRows / G) ||
      !encode(enc, &m.g128, dout, hd, Hq, Sq, B, hd, g_ss, g_sb, G, kRows / G) ||
      !encode(enc, &m.k32, k, hd, Hkv, Sk, B, k_sh, k_ss, k_sb, 1, kKeysQ) ||
      !encode(enc, &m.v32, v, hd, Hkv, Sk, B, v_sh, v_ss, v_sb, 1, kKeysQ) ||
      !encode(enc, &m.k128, k, hd, Hkv, Sk, B, k_sh, k_ss, k_sb, 1, kKeys64) ||
      !encode(enc, &m.v128, v, hd, Hkv, Sk, B, v_sh, v_ss, v_sb, 1, kKeys64))
    return (int)cudaErrorNotSupported;
  return launch(choose(kernel, hd, &m), a, B, static_cast<cudaStream_t>(stream));
}

// The registers a thread and the CTAs an SM of the dK / dV (which 0) or dQ
// (which 1) kernel that flash_attention_bwd_sm90_launch runs for `kernel`
// at head_dim hd: 0 on success, cudaErrorInvalidValue where the plan's
// kernels do not take hd.
extern "C" int flash_attention_bwd_sm90_occupancy(int kernel, int hd, int which,
                                                  int* registers, int* ctas_per_sm) {
  const Chosen c = choose(kernel, hd, nullptr);
  if (c.dkdv == nullptr || which < 0 || which > 1) return (int)cudaErrorInvalidValue;
  const void* fn = which ? c.dq : c.dkdv;
  const int bytes = which ? c.q_bytes : c.kv_bytes;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, fn, kThreads, bytes);
  if (err == cudaSuccess) *registers = attr.numRegs;
  return (int)err;
}
