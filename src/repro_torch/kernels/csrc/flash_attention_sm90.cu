// Causal / sliding-window GQA flash attention in bfloat16 on Hopper's tensor
// cores (sm_90a): TMA copies, mbarriers, wgmma, warp specialisation.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py for bf16 inputs (float32 inputs keep
// csrc/flash_attention.cu: the tensor cores would take them as TF32).  For
// q (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd), query head h reading kv head
// h / (Hq / Hkv), positions 0 .. Sq - 1 against 0 .. Sk - 1, the same
// function as the Pallas kernel:
//
//     s[q, k]  = (q_q . k_k) / sqrt(hd), in float32   masked to -1e30 unless
//                                                    k <= q (causal) and
//                                                    q - k < window (window > 0)
//     out[q]   = sum_k softmax_k(s[q, :]) v_k         divided by max(l, 1e-30)
//
// with the Pallas kernel's running (max, sum, accumulator): m' = max(m,
// max_k s), p = exp(s - m'), l = l e^(m - m') + sum p, acc = acc e^(m - m')
// + p V.  bf16 products are exact in float32 and the tensor cores sum them
// in float32, so both products are the reference's float32 products up to
// the order of the sums.
//
// Sq != Sk is the decoder's cross-attention over the encoder's frames (Sq
// decoder tokens, Sk = 1500 at whisper's width).  Keys past Sk score -inf
// (p = 0).  A row whose mask drops every key (a window that closes before
// position Sk - 1, so only where Sq > Sk) is the softmax of Sk equal scores
// -1e30, the mean of v, as in the plain version: a CTA holding such a row
// walks every kv tile, and its L is -1e30 log2(e).
//
// Design.  A CTA of two warpgroups owns kRows = 128 query rows: row r is
// (position q_lo + r / G, query head hk * G + r % G), so every kv tile it
// stages serves all G heads of kv head hk.  Each warpgroup owns 64 rows and
// runs the products; there is no producer warp (see the registers below):
// thread 0 copies Q and the first two kv tiles, and afterwards the
// warpgroup that is second to finish with a stage refills it, so neither
// waits for the other.
//   * Q: one TMA box per 64 head dims over (hd, Hq, Sq, B), box (64, G,
//     128 / G, 1): it lands the rows in exactly the order above.  Where G
//     does not divide 128 (G = 5, 6, ...), the last rows are zeroed once and
//     never stored.
//   * K and V: tiles of 64 keys, one TMA box per 64 head dims over
//     (hd, Hkv, Sk, B), in a ring of two stages with a full barrier each for
//     K and for V.
//     The copies use 128-byte swizzle (each box row is 64 bf16 = 128 bytes),
//     the layout wgmma reads without bank conflicts.  TMA's zero fill covers
//     keys past Sk, query rows past Sq and head dims past hd (hd = 120, or
//     below 64).
//   * S = Q K^T: wgmma m64n64k16 with both operands K-major in shared memory
//     (descriptors advanced 32 bytes a k-step inside the swizzled rows), then
//     scaled in float32 (by 1/sqrt(hd) log2(e), below).
//   * Online softmax on the accumulator fragments: each thread holds 2 rows
//     x 16 columns of S; row max by two shuffles.  Scores are kept in units
//     of log2 (one multiply by scale * log2(e)), so p = ex2(s - m) is one
//     MUFU op; the masked value and the running max's start are both -1e30
//     in those units, so a row with no live key yet gives p = 1 as in the
//     reference (wiped by the first live key's correction, ex2(-1e30) = 0).  A warp whose 16 rows
//     all kept their max skips rescaling O (a multiply by 1.0, exact).
//     Tiles wholly inside the live band are not masked per element; only
//     those crossing the diagonal, the window edge or Sk are.  Dead tiles
//     are never loaded: the CTA loops over its live kv range only.
//   * O += P V: wgmma m64n64k16 with P from registers (the S fragment of 16
//     keys is exactly the A fragment of a k-step) and V MN-major from shared
//     memory (the transpose bit of 16-bit wgmma), one instruction per 64
//     head dims.  Precision: P goes in as two bf16 terms, P_hi = bf16(p) and
//     P_lo = bf16(p - P_hi), two wgmmas into one accumulator, so P carries
//     about 2^-17 relative error instead of bf16's 2^-9 (at window 1024 one
//     rounding of P would put about 3e-5 on outputs near zero, over the
//     2e-5 the check allows beside one rounding of the output).  That is
//     1.5x the operations the bound counts.
//   * The two warpgroups take turns to start their products (two named
//     barriers passed back and forth, FA3's ping-pong), so one's softmax
//     runs while the other's products hold the tensor cores.
//   * O stays in registers: at hd 256 128 fp32 a thread, 241 in all.
//     An SM's registers sit in four 16K banks, one per warp scheduler, so a
//     CTA of 9 or 12 warps (a producer warp or warpgroup beside them) puts 3
//     warps on one bank and gets 168 registers a thread: a first version
//     with a producer warpgroup handing its registers over by setmaxnreg
//     (24 / 240), and a second with one producer warp, both compiled at
//     168, spilled and serialised their wgmmas.  8 warps get up to 255.
//   * The CTAs with the most kv tiles (the last query blocks, causal) start
//     first.
// That is flash_sm90_kernel, for hd 129 .. 256.  hd 65 .. 128 takes
// flash_sm90_narrow_kernel (below), the same layout of rows and the same
// arithmetic with 128-key tiles, each warpgroup's softmax overlapped with
// its own products instead of the ping-pong, and the scale folded into the
// exponent's FFMA; hd <= 64 takes flash_sm90_hd64_kernel (below), two CTAs
// an SM.  The wrapper's plan names the kernel
// (repro_torch.kernels.flash_attention.sm90_plan).
// q, k and v are read through their strides (multiples of 16 bytes, as TMA
// requires; the wrapper checks); out (B, Sq, Hq, hd) is contiguous.  Given
// an `lse` buffer, the epilogue also writes each row's log-sum-exp L = m +
// log2(l) of the scaled scores in log2 units, float32 (B, Hq, Sq), which the
// backward (csrc/flash_attention_bwd_sm90.cu) takes instead of recomputing
// it; the inference path passes null and writes nothing more.
//
// Bound on the H100: operations.  At the main path's (2, 4096, 8 / 4, 256)
// the kernel must move about 100 MB (30 us at 3.35 TB/s) but do 4 hd flops
// for each of the 2 * 8 * 8.4 M live (q, k) pairs of a causal layer, 137
// GFLOP: 139 us at the bf16 tensor-core rate (989 TFLOP/s), 61 us for a
// window of 1024.  This kernel does 1.5x that (P in two terms); its
// times on an H100 beside SDPA's are in PERF.md (chip_smoke.py).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 128;                 // query rows per CTA
constexpr int kKeys = 64;                  // keys per kv tile
constexpr int kChunk = 64;                 // head dims per TMA box: one 128-byte row
constexpr int kStages = 2;
constexpr int kThreads = 256;              // two warpgroups
constexpr int kMaxGroup = 16;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = kNegInf * kLog2e;  // a masked score, in log2 units
constexpr uint32_t kRowBytes = 128;
constexpr uint32_t kQBox = kRows * kRowBytes;   // 64 head dims of the 128 query rows
constexpr uint32_t kKvBox = kKeys * kRowBytes;  // 64 head dims of a kv tile
// hd <= 128 (flash_sm90_narrow_kernel): wider kv tiles, a deeper ring
constexpr int kNarrowKeys = 128;
constexpr int kNarrowStages = 2;
constexpr uint32_t kKvBoxN = kNarrowKeys * kRowBytes;

struct Params {
  __nv_bfloat16* out;
  float* lse;         // (B, Hq, Sq) L = m + log2(l) a row, or null
  int Sq, Sk, Hq, Hkv, hd, G, P, nq, causal, window;
  float scale;
  float scale_log2;   // scale * log2(e)
};

// byte offsets into the 1024-byte aligned dynamic shared memory; NCH =
// ceil(hd / 64) boxes per row
template <int NCH>
struct Smem {
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = NCH * kQBox;
  static constexpr uint32_t v = k + kStages * NCH * kKvBox;
  static constexpr uint32_t bars = v + kStages * NCH * kKvBox;
  static constexpr uint32_t done = bars + 8 * (1 + 2 * kStages);   // per-stage counters
  static constexpr uint32_t bytes = done + 4 * kStages + 1024;     // + alignment
};

// whether the row at position pos has no live key: its window closes
// before the keys reach it (only where Sq > Sk)
__device__ __forceinline__ bool dead_row(const Params& a, int pos) {
  return a.window > 0 && pos - a.window + 1 > a.Sk - 1;
}

// the CTA's kv tiles of kk keys for its positions q_lo .. q_hi: the live
// range, or every tile where its last row has no live key
__device__ __forceinline__ int2 kv_tiles(const Params& a, int q_lo, int q_hi, int kk) {
  const bool dead = dead_row(a, q_hi);
  const int kv_lo = a.window > 0 && !dead ? max(0, q_lo - a.window + 1) : 0;
  const int kv_hi = a.causal && !dead ? min(q_hi, a.Sk - 1) : a.Sk - 1;
  return make_int2(kv_lo / kk, kv_hi / kk);
}

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
// until the phase of the given parity has completed.  A wait that outlasts
// about 10 s of clock cycles (no real one takes microseconds) traps: the
// launch then fails with an error instead of holding the card forever.
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
// byte offset (the stride between 64-element atoms along M/N for an MN-major
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
// pin register values at this point of the program, so the compiler moves
// no write of a wgmma operand past wgmma.fence and no read of an accumulator
// before wgmma.wait_group
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

#define WGMMA_D32(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),      \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define WGMMA_D32_LIST                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "   \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

#define WGMMA_D64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
  "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define WGMMA_D64_LIST \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d += A B, m64n64k16, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D32(d)
      : "l"(da), "l"(db), "r"(1));
}

// d += A B, m64n64k16, A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
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

// query rows past G * P are never copied: zero them for the products
template <int NCH>
__device__ __forceinline__ void zero_padded_rows(unsigned char* q, int nrows, int tid) {
  for (int i = nrows * (kRowBytes / 4) + tid; i < kRows * (kRowBytes / 4); i += kThreads)
#pragma unroll
    for (int c = 0; c < NCH; ++c) reinterpret_cast<uint32_t*>(q + c * kQBox)[i] = 0u;
}

// The epilogue of both kernels, for this thread's rows r0 and r0 + 8 (at
// positions pos0, pos1; running max m in log2 units, its share l of the
// row sum): the row sums over the 4 lanes of a row, L = m + log2(l) into
// `lse` when given, and out = O / max(l, 1e-30) in bf16, by a quotient an
// element or (kReciprocal) by O times one reciprocal a row, within an ulp
// of float32 (the quotient's slow path costs a call an element).  o(j, e)
// is element e of the accumulator's column block j: head dims 8 j + kc and
// 8 j + kc + 1 of row r0 (e = 0, 1) and of row r0 + 8 (e = 2, 3).
template <int NCH, bool kReciprocal, typename Acc>
__device__ __forceinline__ void write_rows(const Params& a, const Acc& o, float m0, float m1,
                                           float l0, float l1, int r0, int pos0, int pos1,
                                           int kc, int b, int hk, int nrows) {
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int G = a.G;
  if (a.lse != nullptr && kc == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half, pos = half ? pos1 : pos0;
      if (r < nrows && pos < a.Sq)
        a.lse[((long long)b * a.Hq + hk * G + r % G) * a.Sq + pos] =
            half ? m1 + log2f(l1) : m0 + log2f(l0);
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half, pos = half ? pos1 : pos0;
    if (r >= nrows || pos >= a.Sq) continue;
    const float den = fmaxf(half ? l1 : l0, 1e-30f), inv = 1.f / den;
    __nv_bfloat16* orow =
        a.out + (((long long)b * a.Sq + pos) * a.Hq + hk * G + r % G) * a.hd;
#pragma unroll
    for (int j = 0; j < 8 * NCH; ++j) {
      const int d = 8 * j + kc;
      const float x = o(j, 2 * half), y = o(j, 2 * half + 1);
      if (d < a.hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            kReciprocal ? __floats2bfloat162_rn(x * inv, y * inv)
                        : __floats2bfloat162_rn(x / den, y / den);
    }
  }
}

template <int NCH>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params a) {
  using L = Smem<NCH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sq = smem_u32(smem + L::q), sk = smem_u32(smem + L::k),
                 sv = smem_u32(smem + L::v), sbar = smem_u32(smem + L::bars);
  // barriers: Q full, then K full and V full per stage
  auto k_full = [&](int st) { return sbar + 8 * (1 + st); };
  auto v_full = [&](int st) { return sbar + 8 * (1 + kStages + st); };
  // warpgroups done with each stage, counted across its uses
  unsigned* done = reinterpret_cast<unsigned*>(smem + L::done);

  const int G = a.G, nrows = a.G * a.P;
  const int qb = a.nq - 1 - (int)blockIdx.x;      // most kv tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q_lo = qb * a.P;
  const int q_hi = min(q_lo + a.P, a.Sq) - 1;
  const int2 tiles = kv_tiles(a, q_lo, q_hi, kKeys);
  const int t_lo = tiles.x, t_hi = tiles.y;
  const int tid = threadIdx.x;

  // kv tile t into stage st
  auto load_tile = [&](int t, int st) {
    mbar_expect_tx(k_full(st), NCH * kKvBox);
    for (int c = 0; c < NCH; ++c)
      tma_load_4d(sk + (st * NCH + c) * kKvBox, &tk, k_full(st), c * kChunk, hk, t * kKeys, b);
    mbar_expect_tx(v_full(st), NCH * kKvBox);
    for (int c = 0; c < NCH; ++c)
      tma_load_4d(sv + (st * NCH + c) * kKvBox, &tv, v_full(st), c * kChunk, hk, t * kKeys, b);
  };

  zero_padded_rows<NCH>(smem + L::q, nrows, tid);
  if (tid == 0) {
    mbar_init(sbar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      done[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");   // zeros seen by wgmma
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(sbar, NCH * nrows * kRowBytes);
    for (int c = 0; c < NCH; ++c)
      tma_load_4d(sq + c * kQBox, &tq, sbar, c * kChunk, hk * G, q_lo, b);
    for (int t = t_lo; t <= min(t_hi, t_lo + kStages - 1); ++t) load_tile(t, t - t_lo);
  }

  const int cw = tid / 128, ctid = tid % 128;      // warpgroup, thread in it
  const int warp = ctid / 32, lane = ctid % 32;
  // this thread's rows of the accumulators (r0 and r0 + 8) and its first
  // column in each 8-column block (kc and kc + 1)
  const int r0 = cw * 64 + warp * 16 + lane / 4, r1 = r0 + 8;
  const int pos0 = q_lo + r0 / G, pos1 = q_lo + r1 / G;
  const int kc = 2 * (lane % 4);
  const uint32_t q_rows = sq + cw * 64 * kRowBytes;   // this warpgroup's 64 rows

  float o[NCH][32];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;
  // the warpgroups take turns to start their products: bar.sync on this
  // warpgroup's barrier waits for the other's bar.arrive
  auto my_turn = [&]() { asm volatile("bar.sync %0, 256;\n" ::"r"(3 + cw) : "memory"); };
  auto your_turn = [&]() { asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - cw) : "memory"); };
  if (cw == 1) your_turn();                         // warpgroup 0 goes first

  mbar_wait(sbar, 0);
  for (int t = t_lo; t <= t_hi; ++t) {
    const int it = t - t_lo, st = it % kStages;
    const uint32_t phase = (it / kStages) & 1;
    const int k0 = t * kKeys;
    // S = Q K^T over the head dims, k-steps of 16 (those past hd read zeros)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    mbar_wait(k_full(st), phase);
    my_turn();
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, desc_sw128(q_rows + c * kQBox + kk * 32, 16),
                 desc_sw128(sk + (st * NCH + c) * kKvBox + kk * 32, 16));
    wgmma_commit();
    your_turn();
    wgmma_wait_all();
    fence_regs(s);

    // scale, mask where the tile crosses an edge of the live band (a masked
    // key scores kMasked, one past Sk -inf), row max
    const bool edge = k0 + kKeys > a.Sk || (a.causal && k0 + kKeys - 1 > q_lo) ||
                      (a.window > 0 && q_hi - k0 >= a.window);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * a.scale_log2;
      if (edge) {
        const int kp = k0 + 8 * (i / 4) + kc + (i & 1);
        const int pos = (i & 2) ? pos1 : pos0;
        bool ok = kp < a.Sk;
        if (a.causal) ok = ok && kp <= pos;
        if (a.window > 0) ok = ok && pos - kp < a.window;
        x = ok ? x : kp < a.Sk ? kMasked : __int_as_float(0xff800000);
      }
      s[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float corr0 = ex2(m0 - mx0), corr1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = ex2(s[i] - ((i & 2) ? m1 : m0));
      s[i] = p;
      if (i & 2) sum1 += p; else sum0 += p;
    }
    l0 = l0 * corr0 + sum0;                  // this thread's share of the row sums
    l1 = l1 * corr1 + sum1;
    if (__any_sync(0xffffffffu, corr0 != 1.f || corr1 != 1.f)) {
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= (i & 2) ? corr1 : corr0;
    }

    // P as bf16 A fragments, high and low terms: the accumulator layout of
    // S is wgmma's A layout, so registers 4 kk .. 4 kk + 3 (two values of s
    // each) are the fragment of k-step kk, keys 16 kk .. 16 kk + 15
    uint32_t p_hi[16], p_lo[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(s[2 * q], s[2 * q + 1]);
      const float2 hf = __bfloat1622float2(h);
      p_hi[q] = bf16x2_bits(h);
      p_lo[q] = bf16x2_bits(__floats2bfloat162_rn(s[2 * q] - hf.x, s[2 * q + 1] - hf.y));
    }

    // O += P V: 16 keys a k-step, 64 head dims an instruction
    mbar_wait(v_full(st), phase);
    my_turn();
    fence_regs(p_hi);
    fence_regs(p_lo);
#pragma unroll
    for (int c = 0; c < NCH; ++c) fence_regs(o[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const uint64_t dv =
            desc_sw128(sv + (st * NCH + c) * kKvBox + kk * 16 * kRowBytes, kKvBox);
        wgmma_rs(o[c], p_hi + 4 * kk, dv);
        wgmma_rs(o[c], p_lo + 4 * kk, dv);
      }
    wgmma_commit();
    if (cw == 0 || t < t_hi) your_turn();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < NCH; ++c) fence_regs(o[c]);
    // this warpgroup is done with stage st; the second one to be refills it
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
    if (ctid == 0 && (atomicAdd(done + st, 1u) & 1u) && t + kStages <= t_hi)
      load_tile(t + kStages, st);
  }

  // column block j of O: 8 blocks a chunk of 64 head dims
  write_rows<NCH, false>(
      a, [&](int j, int e) { return o[j / 8][4 * (j % 8) + e]; }, m0, m1, l0, l1, r0,
      pos0, pos1, kc, b, hk, nrows);
}

// -- head_dim <= 128 ------------------------------------------------------ //
// d += A B, m64n128k16, A and B K-major in shared memory; scale_d 0 ignores d
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D64_LIST
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, m64n128k16, A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WGMMA_D64_LIST
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WGMMA_D64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// until every committed group but the last has completed
__device__ __forceinline__ void wgmma_wait_all_but_last() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// O += P V for one k-step of 16 keys: 64 NCH head dims in one instruction
template <int NCH>
__device__ __forceinline__ void wgmma_pv(float (&o)[32 * NCH], const uint32_t* p, uint64_t dv) {
  if constexpr (NCH == 2) wgmma_rs128(o, p, dv); else wgmma_rs(o, p, dv);
}

// The kernel for hd 65 .. 128 (NCH = 2; at NCH = 1 it was hd <= 64's until
// flash_sm90_hd64_kernel, and kernel_ablation.py still builds it so).  At
// these widths the tensor
// cores do half the work a (q, k) pair that they do at hd 256, while the
// softmax's work a pair stays, so it no longer hides behind the other
// warpgroup's products alone.  What changes from flash_sm90_kernel:
//   * kv tiles of kNarrowKeys = 128 keys in a ring of kNarrowStages = 2
//     (160 KB of shared memory at hd 128): S is one m64n128k16 per 16 head
//     dims, O += P V one m64n128k16 (hd 128) per 16 keys and term, half the
//     instructions and barrier trips per flop.  (Three stages measured no
//     faster: kernel_ablation.py.)
//   * Each warpgroup overlaps its own softmax with its products (FA3's
//     intra-warpgroup pipelining): it issues S_j = Q K_j^T, rescales O by
//     tile j - 1's correction while that runs, and issues O += P_{j-1}
//     V_{j-1}, as two commit groups; it waits for S_j alone, runs the
//     softmax of tile j while P_{j-1} V_{j-1} still runs, then waits for
//     that and makes P_j.  The registers of S_j (64), P_{j-1} in two bf16
//     terms (64) and O (64) are live together.  The two warpgroups take no
//     turns: with the overlap, the ping-pong measured no faster.
//   * K and V stages are released apart, K_j once S_j is in and V_j once
//     its product is, each warp counting itself: the last of the CTA's 8
//     warps refills the stage, so a K copy is in flight about a tile
//     sooner than with one release a stage.
//   * Scores stay raw until the exponent: the row max is taken on q.k, the
//     running max m in log2 units is max(m, max(q.k) scale log2(e)), and
//     p = ex2(q.k scale log2(e) - m) is one FFMA and one MUFU.  Masked
//     scores are -inf, so p = 0 there; a row that has seen no live key
//     keeps m = -1e30 log2(e), l = 0 and O = 0, and the first live key's
//     correction ex2(-1e30 log2(e) - m) = 0 leaves them so.  A row with no
//     live key at all (dead_row) scores 0 on every key below Sk instead:
//     p = 1 there, the plain version's mean of v, and its L is written as
//     -1e30 log2(e).
//   * The first product of S_j starts from zero (scale-d 0): S needs no
//     clearing.
// d (+)= A B, m64n64k16, A and B K-major in shared memory; scale_d 0 ignores d
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// S = Q K^T of a K-key tile (K = 128: one m64n128k16 per 16 head dims; 64:
// m64n64k16), issued (the caller commits): the first product starts from
// zero
template <int NCH, int K = kNarrowKeys>
__device__ __forceinline__ void issue_qk(float (&s)[K / 2], uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dq = desc_sw128(q_rows + c * kQBox + kk * 32, 16),
                     dk = desc_sw128(k_tile + c * K * kRowBytes + kk * 32, 16);
      if constexpr (K == 128)
        wgmma_ss128(s, dq, dk, c | kk);
      else
        wgmma_ss64(s, dq, dk, c | kk);
    }
}

// O += P V of a K-key tile, P in two bf16 terms, issued (the caller commits)
template <int NCH, int K = kNarrowKeys>
__device__ __forceinline__ void issue_pv(float (&o)[32 * NCH], const uint32_t (&p_hi)[K / 4],
                                         const uint32_t (&p_lo)[K / 4], uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t dv = desc_sw128(v_tile + kk * 16 * kRowBytes, K * kRowBytes);
    wgmma_pv<NCH>(o, p_hi + 4 * kk, dv);
    wgmma_pv<NCH>(o, p_lo + 4 * kk, dv);
  }
}

// a thread's two rows of the online softmax: running max (log2 units) and
// its share of the row sums, the rows' positions, its first column
struct Rows {
  float m0, m1, l0, l1;
  int pos0, pos1, kc;
};

// the online softmax of the tile at key k0 on s: mask where the tile
// crosses an edge of the live band (q_lo .. q_hi the CTA's positions),
// move the running max, p = ex2(s c - m) into s; returns the corrections
// of the two rows
__device__ __forceinline__ float2 online_softmax(float (&s)[64], Rows& r, const Params& a,
                                                 int k0, int q_lo, int q_hi) {
  const bool edge = k0 + kNarrowKeys > a.Sk || (a.causal && k0 + kNarrowKeys - 1 > q_lo) ||
                    (a.window > 0 && q_hi - k0 >= a.window);
  const float ninf = __int_as_float(0xff800000);   // -inf
  float mx0 = ninf, mx1 = ninf;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (edge) {
      const int kp = k0 + 8 * (i / 4) + r.kc + (i & 1);
      const int pos = (i & 2) ? r.pos1 : r.pos0;
      bool ok = kp < a.Sk;
      if (a.causal) ok = ok && kp <= pos;
      if (a.window > 0) ok = ok && pos - kp < a.window;
      s[i] = ok ? s[i] : kp < a.Sk && dead_row(a, pos) ? 0.f : ninf;
    }
    if (i & 2) mx1 = fmaxf(mx1, s[i]); else mx0 = fmaxf(mx0, s[i]);
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float n0 = fmaxf(r.m0, mx0 * a.scale_log2), n1 = fmaxf(r.m1, mx1 * a.scale_log2);
  const float2 corr = make_float2(ex2(r.m0 - n0), ex2(r.m1 - n1));
  r.m0 = n0;
  r.m1 = n1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float p = ex2(fmaf(s[i], a.scale_log2, (i & 2) ? -n1 : -n0));
    s[i] = p;
    if (i & 2) sum1 += p; else sum0 += p;
  }
  r.l0 = r.l0 * corr.x + sum0;
  r.l1 = r.l1 * corr.y + sum1;
  return corr;
}

// P as bf16 A fragments, high and low terms (see flash_sm90_kernel)
template <int N>
__device__ __forceinline__ void make_p(const float (&s)[N], uint32_t (&p_hi)[N / 2],
                                       uint32_t (&p_lo)[N / 2]) {
#pragma unroll
  for (int q = 0; q < N / 2; ++q) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(s[2 * q], s[2 * q + 1]);
    const float2 hf = __bfloat1622float2(h);
    p_hi[q] = bf16x2_bits(h);
    p_lo[q] = bf16x2_bits(__floats2bfloat162_rn(s[2 * q] - hf.x, s[2 * q + 1] - hf.y));
  }
}

template <int NCH>
struct NarrowSmem {
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = NCH * kQBox;
  static constexpr uint32_t v = k + kNarrowStages * NCH * kKvBoxN;
  static constexpr uint32_t bars = v + kNarrowStages * NCH * kKvBoxN;
  static constexpr uint32_t done = bars + 8 * (1 + 2 * kNarrowStages);   // K, V counters
  static constexpr uint32_t bytes = done + 8 * kNarrowStages + 1024;
};

template <int NCH>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_narrow_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv, const Params a) {
  using L = NarrowSmem<NCH>;
  constexpr int kStg = kNarrowStages, kK = kNarrowKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sq = smem_u32(smem + L::q), sk = smem_u32(smem + L::k),
                 sv = smem_u32(smem + L::v), sbar = smem_u32(smem + L::bars);
  auto k_full = [&](int st) { return sbar + 8 * (1 + st); };
  auto v_full = [&](int st) { return sbar + 8 * (1 + kStg + st); };
  // warps done with each K and each V stage, counted across its uses
  unsigned* k_done = reinterpret_cast<unsigned*>(smem + L::done);
  unsigned* v_done = k_done + kStg;

  const int G = a.G, nrows = a.G * a.P;
  const int qb = a.nq - 1 - (int)blockIdx.x;      // most kv tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q_lo = qb * a.P;
  const int q_hi = min(q_lo + a.P, a.Sq) - 1;
  const int2 tiles = kv_tiles(a, q_lo, q_hi, kK);
  const int t_lo = tiles.x, t_hi = tiles.y;
  const int tid = threadIdx.x;

  // K or V of kv tile t into stage st
  auto load_k = [&](int t, int st) {
    mbar_expect_tx(k_full(st), NCH * kKvBoxN);
    for (int c = 0; c < NCH; ++c)
      tma_load_4d(sk + (st * NCH + c) * kKvBoxN, &tk, k_full(st), c * kChunk, hk, t * kK, b);
  };
  auto load_v = [&](int t, int st) {
    mbar_expect_tx(v_full(st), NCH * kKvBoxN);
    for (int c = 0; c < NCH; ++c)
      tma_load_4d(sv + (st * NCH + c) * kKvBoxN, &tv, v_full(st), c * kChunk, hk, t * kK, b);
  };

  zero_padded_rows<NCH>(smem + L::q, nrows, tid);
  if (tid == 0) {
    mbar_init(sbar, 1);
    for (int st = 0; st < kStg; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      k_done[st] = v_done[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(sbar, NCH * nrows * kRowBytes);
    for (int c = 0; c < NCH; ++c)
      tma_load_4d(sq + c * kQBox, &tq, sbar, c * kChunk, hk * G, q_lo, b);
    for (int t = t_lo; t <= min(t_hi, t_lo + kStg - 1); ++t) {
      load_k(t, t - t_lo);
      load_v(t, t - t_lo);
    }
  }

  const int cw = tid / 128, ctid = tid % 128;
  const int warp = ctid / 32, lane = ctid % 32;
  const int r0 = cw * 64 + warp * 16 + lane / 4, r1 = r0 + 8;
  const uint32_t q_rows = sq + cw * 64 * kRowBytes;
  Rows rw{kMasked, kMasked, 0.f, 0.f, q_lo + r0 / G, q_lo + r1 / G, 2 * (lane % 4)};
  const int pos0 = rw.pos0, pos1 = rw.pos1, kc = rw.kc;

  float o[32 * NCH];
#pragma unroll
  for (int i = 0; i < 32 * NCH; ++i) o[i] = 0.f;
  float s[64];
  uint32_t p_hi[32], p_lo[32];

  // this warp is done with K (or V) of tile t in stage st: the last of the
  // CTA's 8 warps to be refills the stage with tile t + kStg
  auto release_k = [&](int t, int st) {
    if (lane == 0 && (atomicAdd(k_done + st, 1u) & 7u) == 7u && t + kStg <= t_hi)
      load_k(t + kStg, st);
  };
  auto release_v = [&](int t, int st) {
    if (lane == 0 && (atomicAdd(v_done + st, 1u) & 7u) == 7u && t + kStg <= t_hi)
      load_v(t + kStg, st);
  };

  mbar_wait(sbar, 0);
  // the first tile: S alone
  mbar_wait(k_full(0), 0);
  fence_regs(s);
  wgmma_fence();
  issue_qk<NCH>(s, q_rows, sk);
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(s);
  release_k(t_lo, 0);
  float2 corr = online_softmax(s, rw, a, t_lo * kK, q_lo, q_hi);
  make_p(s, p_hi, p_lo);

  // O is rescaled by tile t - 1's correction while S_t runs, then P_{t-1}
  // V_{t-1} is issued; K_t is released once S_t is in, V_{t-1} once its
  // product is
  for (int t = t_lo + 1; t <= t_hi; ++t) {
    const int it = t - t_lo, st = it % kStg, pst = (it - 1) % kStg;
    mbar_wait(k_full(st), (it / kStg) & 1);
    mbar_wait(v_full(pst), ((it - 1) / kStg) & 1);
    fence_regs(s);
    wgmma_fence();
    issue_qk<NCH>(s, q_rows, sk + st * NCH * kKvBoxN);
    wgmma_commit();
    if (__any_sync(0xffffffffu, corr.x != 1.f || corr.y != 1.f)) {
#pragma unroll
      for (int i = 0; i < 32 * NCH; ++i) o[i] *= (i & 2) ? corr.y : corr.x;
    }
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(o);
    wgmma_fence();
    issue_pv<NCH>(o, p_hi, p_lo, sv + pst * NCH * kKvBoxN);
    wgmma_commit();
    wgmma_wait_all_but_last();                  // S_t; P_{t-1} V_{t-1} may still run
    fence_regs(s);
    release_k(t, st);
    corr = online_softmax(s, rw, a, t * kK, q_lo, q_hi);
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
    release_v(t - 1, pst);
    make_p(s, p_hi, p_lo);
  }
  {
    const int it = t_hi - t_lo, st = it % kStg;
    mbar_wait(v_full(st), (it / kStg) & 1);
#pragma unroll
    for (int i = 0; i < 32 * NCH; ++i) o[i] *= (i & 2) ? corr.y : corr.x;
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(o);
    wgmma_fence();
    issue_pv<NCH>(o, p_hi, p_lo, sv + st * NCH * kKvBoxN);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }

  // a row with no live key scored 0 on its keys: its L is the masked value's
  write_rows<NCH, true>(
      a, [&](int j, int e) { return o[4 * j + e]; }, dead_row(a, pos0) ? kMasked : rw.m0,
      dead_row(a, pos1) ? kMasked : rw.m1, rw.l0, rw.l1, r0, pos0, pos1, kc, b, hk, nrows);
}

// -- head_dim <= 64 ------------------------------------------------------- //
// At hd 64 a (q, k) pair costs the tensor cores 4 hd = 256 flops (384 with
// P in two terms) beside one exponential and about ten other instructions
// of softmax.  flash_sm90_narrow_kernel at NCH = 1 (hd 64's earlier path,
// 192 registers, one CTA and two warps a scheduler) overlapped each
// warpgroup's softmax with its own products, and still ran at 25% of the
// bound: its softmax cost 29% of its time unhidden, the second P term 21%,
// the exponentials alone 6% (kernel_ablation.py at whisper's shapes).  Its
// overlap holds S_j, P_{j-1} in two terms and O together, which leaves one
// CTA an SM.  This kernel keeps fewer registers live and puts more warps
// on each scheduler instead:
//   * 64-key tiles (S one m64n64k16 a k-step, O += P V eight a tile), so a
//     thread holds 32 scores, P in 32 registers and O in 32, within 128
//     registers: two CTAs (four warpgroups) an SM, whose products and
//     softmaxes interleave.  (128-key tiles need more than 128 registers:
//     ptxas spills and serialises the wgmmas.)
//   * Each warpgroup walks its tiles in order (softmax of S_t, O += P_t
//     V_t), and issues S_{t+1} right behind P_t V_t, so that it is queued
//     on the tensor cores while the warpgroup waits for its product.
//   * A row's exponent reference m moves only where the row max passes it
//     by more than kHd64Slack = 8 (log2 units): p stays below 2^8, and O and
//     l are rescaled about once a row instead of at every new maximum.
//     The output O / l and L = m + log2(l) do not depend on m.
//   * The row max and the row sum in two partial chains a row.
//   * A warpgroup whose 64 rows all lie past Sq (the last block of Sq = 448
//     rows, 3.5 blocks of 128) returns at once; the stages' refills count
//     only the warps that remain.
//   * A CTA's start and epilogue overlap the other CTA's work, which short
//     CTAs (the causal 448-row decoder: two to seven kv tiles) need.
// Otherwise the narrow kernel's layout and arithmetic: 128 rows a CTA, a
// ring of two stages (48 KB of shared memory), the scale in the exponent's
// FFMA, P in two bf16 terms, K and V released apart.
constexpr int kHd64CtasPerSm = 2;
constexpr int kHd64Keys = 64;        // keys a kv tile
constexpr int kHd64Chains = 2;       // partial chains a row for the max and the sum
constexpr float kHd64Slack = 8.f;     // log2 units the row max may pass its reference by

// x, opaque to the compiler: what is computed from it is computed where it
// is used (a descriptor a k-step), not hoisted into registers for the loop
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// the online softmax of the hd-64 kernel on a K-key tile: online_softmax's
// function with the row max and the row sum in kHd64Chains partial chains a
// row.  Element i of s is row (i & 2) / 2's column 8 (i / 4) + kc + (i & 1);
// chain c of a row takes the elements with (i / 4) % kHd64Chains == c
template <int K>
__device__ __forceinline__ float2 online_softmax64(float (&s)[K / 2], Rows& r, const Params& a,
                                                   int k0, int q_lo, int q_hi) {
  constexpr int N = K / 2, C = kHd64Chains;
  const bool edge = k0 + K > a.Sk || (a.causal && k0 + K - 1 > q_lo) ||
                    (a.window > 0 && q_hi - k0 >= a.window);
  const float ninf = __int_as_float(0xff800000);   // -inf
  if (edge) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int kp = k0 + 8 * (i / 4) + r.kc + (i & 1);
      const int pos = (i & 2) ? r.pos1 : r.pos0;
      bool ok = kp < a.Sk;
      if (a.causal) ok = ok && kp <= pos;
      if (a.window > 0) ok = ok && pos - kp < a.window;
      s[i] = ok ? s[i] : kp < a.Sk && dead_row(a, pos) ? 0.f : ninf;
    }
  }
  float mx[2][C];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int row = 0; row < 2; ++row)
      mx[row][c] = fmaxf(s[4 * c + 2 * row], s[4 * c + 2 * row + 1]);
#pragma unroll
  for (int i = 4 * C; i < N; ++i) {
    float& m = mx[(i & 2) / 2][(i / 4) % C];
    m = fmaxf(m, s[i]);
  }
  float mx0 = mx[0][0], mx1 = mx[1][0];
#pragma unroll
  for (int c = 1; c < C; ++c) {
    mx0 = fmaxf(mx0, mx[0][c]);
    mx1 = fmaxf(mx1, mx[1][c]);
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // the exponents' reference moves only where the row max passes it by more
  // than kHd64Slack: p then stays below 2^kHd64Slack, and O and l are rarely
  // rescaled (every output is O / l, L = m + log2(l), whatever m is)
  mx0 *= a.scale_log2;
  mx1 *= a.scale_log2;
  const float n0 = mx0 > r.m0 + kHd64Slack ? mx0 : r.m0;
  const float n1 = mx1 > r.m1 + kHd64Slack ? mx1 : r.m1;
  const float2 corr = make_float2(ex2(r.m0 - n0), ex2(r.m1 - n1));
  r.m0 = n0;
  r.m1 = n1;
  float sum[2][C] = {};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int row = (i & 2) / 2, c = (i / 4) % C;
    const float p = ex2(fmaf(s[i], a.scale_log2, row ? -n1 : -n0));
    s[i] = p;
    sum[row][c] += p;
  }
  float sum0 = sum[0][0], sum1 = sum[1][0];
#pragma unroll
  for (int c = 1; c < C; ++c) {
    sum0 += sum[0][c];
    sum1 += sum[1][c];
  }
  r.l0 = r.l0 * corr.x + sum0;
  r.l1 = r.l1 * corr.y + sum1;
  return corr;
}

// atomicAdd on a shared-memory word by its 32-bit address
__device__ __forceinline__ unsigned atom_add_shared(uint32_t addr, unsigned v) {
  unsigned old;
  asm volatile("atom.shared::cta.add.u32 %0, [%1], %2;\n" : "=r"(old) : "r"(addr), "r"(v)
               : "memory");
  return old;
}

template <int K>
struct Hd64Smem {
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = kQBox;
  static constexpr uint32_t v = k + kNarrowStages * K * kRowBytes;
  static constexpr uint32_t bars = v + kNarrowStages * K * kRowBytes;
  static constexpr uint32_t done = bars + 8 * (1 + 2 * kNarrowStages);   // K, V counters
  static constexpr uint32_t bytes = done + 8 * kNarrowStages + 1024;
};

__global__ void __launch_bounds__(kThreads, kHd64CtasPerSm)
flash_sm90_hd64_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Params a) {
  constexpr int kStg = kNarrowStages, kK = kHd64Keys;
  constexpr uint32_t kTile = kK * kRowBytes;
  using L = Hd64Smem<kK>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sm0 = base + ((1024 - (base & 1023)) & 1023);
  const uint32_t sq = sm0 + L::q, sk = sm0 + L::k, sv = sm0 + L::v, sbar = sm0 + L::bars;
  auto k_full = [&](int st) { return sbar + 8 * (1 + st); };
  auto v_full = [&](int st) { return sbar + 8 * (1 + kStg + st); };
  // warps done with each K and each V stage, counted across its uses
  auto k_done = [&](int st) { return sm0 + L::done + 4 * st; };
  auto v_done = [&](int st) { return sm0 + L::done + 4 * (kStg + st); };

  const int G = a.G, nrows = a.G * a.P;
  const int qb = a.nq - 1 - (int)blockIdx.x;      // most kv tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q_lo = qb * a.P;
  const int q_hi = min(q_lo + a.P, a.Sq) - 1;
  const int2 tiles = kv_tiles(a, q_lo, q_hi, kK);
  const int t_lo = tiles.x, t_hi = tiles.y;
  const int tid = threadIdx.x;
  // the warpgroups with a row below Sq (the second's first row is 64), and
  // the warps that release each stage
  const int busy = q_lo + 64 / G <= q_hi ? 2 : 1;
  const unsigned last_warp = 4u * busy - 1u;

  auto load_k = [&](int t, int st) {
    mbar_expect_tx(k_full(st), kTile);
    tma_load_4d(sk + st * kTile, &tk, k_full(st), 0, hk, t * kK, b);
  };
  auto load_v = [&](int t, int st) {
    mbar_expect_tx(v_full(st), kTile);
    tma_load_4d(sv + st * kTile, &tv, v_full(st), 0, hk, t * kK, b);
  };

  zero_padded_rows<1>(smem_raw + (sm0 - base) + L::q, nrows, tid);
  if (tid == 0) {
    mbar_init(sbar, 1);
    for (int st = 0; st < kStg; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(k_done(st)), "r"(0u) : "memory");
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(v_done(st)), "r"(0u) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(sbar, nrows * kRowBytes);
    tma_load_4d(sq, &tq, sbar, 0, hk * G, q_lo, b);
    for (int t = t_lo; t <= min(t_hi, t_lo + kStg - 1); ++t) {
      load_k(t, t - t_lo);
      load_v(t, t - t_lo);
    }
  }

  const int cw = tid / 128;
  if (cw >= busy) return;                          // every row past Sq
  const int lane = tid % 32;
  const int r0 = tid / 32 * 16 + lane / 4;         // cw * 64 + warp * 16 + lane / 4
  const uint32_t q_rows = sq + cw * 64 * kRowBytes;
  Rows rw{kMasked, kMasked, 0.f, 0.f, q_lo + r0 / G, q_lo + (r0 + 8) / G, 2 * (lane % 4)};

  // this warp is done with K (or V) of tile t in stage st: the last of the
  // busy warps refills the stage with tile t + kStg
  auto release_k = [&](int t, int st) {
    if (lane == 0 && (atom_add_shared(k_done(st), 1u) & last_warp) == last_warp &&
        t + kStg <= t_hi)
      load_k(t + kStg, st);
  };
  auto release_v = [&](int t, int st) {
    if (lane == 0 && (atom_add_shared(v_done(st), 1u) & last_warp) == last_warp &&
        t + kStg <= t_hi)
      load_v(t + kStg, st);
  };

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float s[kK / 2];
  uint32_t p_hi[kK / 4], p_lo[kK / 4];

  mbar_wait(sbar, 0);
  // tile t's softmax, then P_t V_t issued (S_t issued before)
  auto tile = [&](int t) {
    const int it = t - t_lo, st = it % kStg;
    wgmma_wait_all();                              // S_t
    fence_regs(s);
    release_k(t, st);
    const float2 corr = online_softmax64<kK>(s, rw, a, t * kK, q_lo, q_hi);
    if (__any_sync(0xffffffffu, corr.x != 1.f || corr.y != 1.f)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= (i & 2) ? corr.y : corr.x;
    }
    make_p(s, p_hi, p_lo);
    mbar_wait(v_full(st), (it / kStg) & 1);
    fence_regs(p_hi);
    fence_regs(p_lo);
    fence_regs(o);
    wgmma_fence();
    issue_pv<1, kK>(o, p_hi, p_lo, sv + st * kTile);
    wgmma_commit();
  };
  // S_t = Q K_t^T issued (the descriptors of Q computed where they are used)
  auto issue_s = [&](int t) {
    const int it = t - t_lo, st = it % kStg;
    mbar_wait(k_full(st), (it / kStg) & 1);
    fence_regs(s);
    wgmma_fence();
    issue_qk<1, kK>(s, opaque(q_rows), sk + st * kTile);
    wgmma_commit();
  };
  issue_s(t_lo);
  for (int t = t_lo; t < t_hi; ++t) {
    tile(t);
    issue_s(t + 1);                                // behind P_t V_t
    wgmma_wait_all_but_last();                     // P_t V_t
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
    release_v(t, (t - t_lo) % kStg);
  }
  tile(t_hi);
  wgmma_wait_all();
  fence_regs(o);

  // a row with no live key scored 0 on its keys: its L is the masked value's
  write_rows<1, true>(
      a, [&](int j, int e) { return o[4 * j + e]; }, dead_row(a, rw.pos0) ? kMasked : rw.m0,
      dead_row(a, rw.pos1) ? kMasked : rw.m1, rw.l0, rw.l1, r0, rw.pos0, rw.pos1, rw.kc, b,
      hk, nrows);
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

// the kernel of the wrapper's plan (repro_torch.kernels.flash_attention.
// sm90_plan: 0 flash_sm90_hd64_kernel for hd <= 64, 1 the narrow kernel for
// hd 65 .. 128, 2 flash_sm90_kernel for hd 129 .. 256) at head_dim hd, with
// its dynamic shared memory; null where that kernel does not take hd
struct Chosen {
  const void* fn;
  int bytes;
};
Chosen choose(int kernel, int hd) {
  const int nch = (hd + kChunk - 1) / kChunk;
  if (kernel == 0 && nch == 1)
    return {(const void*)flash_sm90_hd64_kernel, (int)Hd64Smem<kHd64Keys>::bytes};
  if (kernel == 1 && nch == 2)
    return {(const void*)flash_sm90_narrow_kernel<2>, (int)NarrowSmem<2>::bytes};
  if (kernel == 2 && nch == 3) return {(const void*)flash_sm90_kernel<3>, (int)Smem<3>::bytes};
  if (kernel == 2 && nch == 4) return {(const void*)flash_sm90_kernel<4>, (int)Smem<4>::bytes};
  return {nullptr, 0};
}

}  // namespace

// q (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd) bfloat16, each with unit
// stride over hd and the given element strides over (b, s, h), every stride
// times 2 and every pointer a multiple of 16 bytes; hd a multiple of 8 up to
// 256, Hq / Hkv <= 16; out (B, Sq, Hq, hd) contiguous bfloat16; lse null or
// (B, Hq, Sq) float32, written with each row's L; `kernel` the wrapper's
// plan (choose).  Launches on `stream` and returns cudaGetLastError() (0 on
// success), cudaErrorInvalidValue for a shape or a kernel it does not take
// (hd past the planned kernel's), or cudaErrorNotSupported if libcuda's
// tensor-map encoder is missing or refuses a map.
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk, int Hq,
    int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh, int causal,
    int window, float scale, int kernel, void* lse, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kMaxGroup ||
      hd <= 0 ||
      hd % 8 != 0 || hd > 4 * kChunk || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  const Chosen chosen = choose(kernel, hd);
  if (chosen.fn == nullptr) return (int)cudaErrorInvalidValue;
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
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse = static_cast<float*>(lse);
  a.Sq = Sq;
  a.Sk = Sk;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.hd = hd;
  a.G = Hq / Hkv;
  a.P = kRows / a.G;
  a.nq = (Sq + a.P - 1) / a.P;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.scale_log2 = scale * kLog2e;
  // a kv tile's keys
  const int keys = kernel == 0 ? kHd64Keys : kernel == 1 ? kNarrowKeys : kKeys;
  alignas(64) CUtensorMap tq, tk, tv;
  if (!encode(enc, &tq, q, hd, Hq, Sq, B, q_sh, q_ss, q_sb, a.G, a.P) ||
      !encode(enc, &tk, k, hd, Hkv, Sk, B, k_sh, k_ss, k_sb, 1, keys) ||
      !encode(enc, &tv, v, hd, Hkv, Sk, B, v_sh, v_ss, v_sb, 1, keys))
    return (int)cudaErrorNotSupported;
  const cudaError_t err = cudaFuncSetAttribute(
      chosen.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, chosen.bytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&tq, &tk, &tv, &a};
  cudaLaunchKernel(chosen.fn, dim3(a.nq, a.Hkv, B), dim3(kThreads), args, chosen.bytes,
                   static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The registers a thread and the CTAs an SM of the kernel that
// flash_attention_sm90_launch runs for `kernel` at head_dim hd: 0 on
// success, cudaErrorInvalidValue where that kernel does not take hd.
extern "C" int flash_attention_sm90_occupancy(int kernel, int hd, int* registers,
                                              int* ctas_per_sm) {
  const Chosen chosen = choose(kernel, hd);
  if (chosen.fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncSetAttribute(chosen.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, chosen.bytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, chosen.fn);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, chosen.fn, kThreads,
                                                        chosen.bytes);
  if (err == cudaSuccess) *registers = attr.numRegs;
  return (int)err;
}
