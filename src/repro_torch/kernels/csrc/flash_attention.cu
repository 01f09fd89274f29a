// Causal / sliding-window GQA flash attention in float32 on Hopper (sm_90a),
// on the tensor cores at float32 accuracy (3xTF32).
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py for float32 inputs (bf16 inputs go
// to csrc/flash_attention_sm90.cu).  For q (B, Sq, Hq, hd), k and v
// (B, Sk, Hkv, hd), query head h reading kv head h / (Hq / Hkv), positions
// 0 .. Sq - 1 against 0 .. Sk - 1:
//
//     s[q, k]  = (q_q . k_k) / sqrt(hd)            masked to -1e30 unless
//                                                  k <= q (causal) and
//                                                  q - k < window (window > 0)
//     out[q]   = sum_k softmax_k(s[q, :]) v_k      divided by max(l, 1e-30)
//
// with the running (max, sum, accumulator) of the Pallas kernel, in the
// same order: m' = max(m, max_k s), p = exp(s - m'), l = l e^(m - m') + sum p,
// acc = acc e^(m - m') + p V, m starting at the masked value (here in log2
// units: scores are scaled by log2 e and exponentiated with exp2).  Given an
// `lse` buffer it also writes each row's log-sum-exp L = m + log2(l), in
// those units, float32 (B, Hq, Sq): the backward (csrc/flash_attention_bwd.cu)
// takes it instead of recomputing it.
//
// Sq != Sk is the decoder's cross-attention over the encoder's frames.  A
// row whose mask drops every key (a window that closes before position
// Sk - 1, so only where Sq > Sk) is the softmax of Sk equal scores -1e30,
// the mean of v, as in the plain version: a block holding such a row walks
// every kv tile.
//
// Precision: 3xTF32.  The tensor cores take float32 operands as TF32 (10
// mantissa bits), 2^-11 relative per product: one such product puts about
// 1.5e-3 on the outputs, far outside the float32 tolerance (2e-5).  So
// every operand x is split as hi = tf32(x), lo = tf32(x - hi), and each
// product is hi hi' + hi lo' + lo hi' (CUTLASS's fast-accurate float32
// scheme), summed in float32: the dropped lo lo' and lo's rounding leave
// about 2^-22 per product, near float32's own.  Both products go through
// the split: S = Q K^T and O += P V (P split in registers).
//
// Design.  The TPU kernel walked a sequential grid (B, Hq, nq, nk) with the
// running state in VMEM scratch and skipped dead kv blocks with pl.when.
// Here one block of 8 warps owns kRows = 64 query rows, qt = 64 / G query
// positions times the G query heads that share one kv head, so every kv
// tile a block stages serves all G heads (and is read from L2 by 8x fewer
// blocks than with 16 rows).  The block computes its first and last live
// kv tile from its position range and loops over only those; blocks start
// with the longest rows (the causal diagonal's far end).
//
// A kv tile is 64 keys.  K and V are staged by 16-byte cp.async copies in
// turn: V of tile t lands while Q K^T of tile t runs, K of tile t + 1 while
// P V of tile t runs.  The products are mma.sync m16n8k8 TF32 with
// hand-loaded fragments, so V is read in its (S, hd) layout (TF32 wgmma has
// no transpose bit).  Within each 8-wide step of the contraction the
// fragment's columns (t, t + 4) are read from the adjacent pair (2t, 2t + 1)
// of Q, K and P: one 8-byte shared load each, and the sum is unchanged.
// Row strides are padded (Q, K by 8 floats, V by 4, P by 8) so that every
// fragment load hits 32 distinct banks.
//
// Registers: O for 16 rows x 256 columns would be 128 fp32 registers a
// thread.  So the warps work in pairs on 16 rows: the pair splits the 64
// keys of Q K^T (32 each) and the head dimension of O (D / 2 each).  The
// pair exchanges its row maxima and then P (16 x 64) through shared memory,
// behind a 64-thread named barrier; each warp keeps the row sums of its own
// keys, added up once at the end.  At D = 256: 64 registers of O, 16 of S.
//
// Keys past Sk and head dimensions past hd are zero-filled by the copies and
// masked out of the softmax (p = 0: their score is -inf, below the running
// max's start), so neither length need be a multiple of a tile and hd is
// padded to the instance D in {32, 64, 128, 256}.  q, k and v are read
// in the model's (B, S, H, hd) layout through their strides: no
// transposes; every row must start on 16 bytes (the wrapper checks).  At D = 256 the block's shared
// memory is 221 KB, dynamic, raised with cudaFuncSetAttribute per launch.
//
// Bound on the H100: operations.  At the LM path's (2, 4096, 8 / 4, 256)
// the kernel must move about 200 MB (60 us at 3.35 TB/s) and do 4 * hd
// flops for each of the 2 * 8 * 8.4 M live (q, k) pairs of a causal layer,
// 137 GFLOP; as three TF32 products on the tensor cores (494 TFLOP/s
// dense) that is 0.83 ms, 0.36 ms for a window of 1024 (on the CUDA cores,
// at 67 TFLOP/s, 2.05 and 0.90 ms).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 64;                   // query rows (position, head) a block
constexpr int kKeys = 64;                   // keys a tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf = -1e30f * kLog2e;  // the masked score, in log2 units

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* out;
  float* lse;                               // (B, Hq, Sq) L = m + log2(l) a row, or null
  int Sq, Sk, Hq, Hkv, hd, qt, causal, window;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

// shared memory of the instance for head dimension D (floats)
template <int D>
struct Smem {
  static constexpr int QS = D + 8;          // Q and K row stride: 8-byte fragment loads
  static constexpr int VS = D + 4;          // V row stride: 4-byte fragment loads
  static constexpr int PS = kKeys + 8;      // P row stride
  static constexpr int k = kRows * QS;
  static constexpr int v = k + kKeys * QS;
  static constexpr int p = v + kKeys * VS;
  static constexpr int red = p + kRows * PS;   // row maxima, then row sums, per half
  static constexpr size_t bytes = sizeof(float) * (red + 4 * kRows);
};

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

// the 64 threads of warp pair `pair` (warps pair and pair + 4)
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair));
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// x = hi + lo, hi = tf32(x), lo = tf32(x - hi): TF32 bit patterns in fp32 registers
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
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

// the A fragment of rows (g, g + 8) at columns (2t, 2t + 1) of an 8-wide step
__device__ __forceinline__ void load_a(const float* row_g, const float* row_g8,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 x = ld2(row_g), y = ld2(row_g8);
  split(x.x, hi[0], lo[0]);
  split(y.x, hi[1], lo[1]);
  split(x.y, hi[2], lo[2]);
  split(y.y, hi[3], lo[3]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const Args a) {
  using L = Smem<D>;
  constexpr int DC = D / 4;                 // 16-byte chunks per smem row
  constexpr int NO = D / 16;                // O's 8-column tiles per warp
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = smem + L::k;
  float* Vs = smem + L::v;
  float* Ps = smem + L::p;
  float* red = smem + L::red;

  const int G = a.Hq / a.Hkv;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * a.qt;   // longest rows first
  const int q_hi = min(q_lo + a.qt, a.Sq) - 1;
  const int nrows = a.qt * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int pair = warp & 3, half = warp >> 2;
  const int row0 = pair * 16;               // the pair's 16 rows

  // live kv range of the block's positions [q_lo, q_hi]; every tile where
  // a row has no live key (its last row is the first to have none)
  const bool dead = a.window > 0 && q_hi - a.window + 1 > a.Sk - 1;
  const int kv_lo = a.window > 0 && !dead ? max(0, q_lo - a.window + 1) : 0;
  const int kv_hi = a.causal && !dead ? min(q_hi, a.Sk - 1) : a.Sk - 1;
  const int t_lo = kv_lo / kKeys, t_hi = kv_hi / kKeys;

  // row r of the block: position q_lo + r / G, query head hk * G + r % G;
  // columns past hd and rows past the block's zero-filled
  for (int e = tid; e < kRows * DC; e += kThreads) {
    const int r = e / DC, d = (e - r * DC) * 4;
    const int qp = q_lo + r / G;
    const bool live = r < nrows && qp < a.Sq && d < a.hd;
    const float* src = live ? a.q + b * a.q_sb + qp * a.q_ss +
                                  (long long)(hk * G + r % G) * a.q_sh + d
                            : a.q;
    cp_async16(Qs + r * L::QS + d, src, live ? 16 : 0);
  }
  // tile t of k or v (keys t * kKeys ..) into dst, zero-filled past Sk and hd
  auto copy_tile = [&](float* dst, int stride, const float* x, long long sb, long long ss,
                       long long sh, int t) {
    for (int e = tid; e < kKeys * DC; e += kThreads) {
      const int j = e / DC, d = (e - j * DC) * 4;
      const int kp = t * kKeys + j;
      const bool live = kp < a.Sk && d < a.hd;
      const float* src = live ? x + b * sb + kp * ss + hk * sh + d : x;
      cp_async16(dst + j * stride + d, src, live ? 16 : 0);
    }
    cp_async_commit();
  };
  copy_tile(Ks, L::QS, a.k, a.k_sb, a.k_ss, a.k_sh, t_lo);   // with Q: one group
  copy_tile(Vs, L::VS, a.v, a.v_sb, a.v_ss, a.v_sh, t_lo);

  int qpos[2];
  float m[2], l[2], o[NO][4];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    qpos[x] = q_lo + (row0 + g + 8 * x) / G;
    m[x] = kNegInf;
    l[x] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int x = 0; x < 4; ++x) o[n][x] = 0.f;
  const float scale2 = a.scale * kLog2e;
  const float ninf = __int_as_float(0xff800000);   // -inf
  const float* q_g = Qs + (row0 + g) * L::QS + 2 * tg;
  const float* p_g = Ps + (row0 + g) * L::PS + 2 * tg;

  for (int t = t_lo; t <= t_hi; ++t) {
    cp_async_wait<1>();                     // K of tile t (and Q) landed
    __syncthreads();

    // S (16 rows x the pair half's 32 keys) = Q K^T
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) s[n][x] = 0.f;
    const float* k_g = Ks + (half * 32 + g) * L::QS + 2 * tg;
#pragma unroll 4
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
      load_a(q_g + kk * 8, q_g + 8 * L::QS + kk * 8, ah, al);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float2 kb = ld2(k_g + n * 8 * L::QS + kk * 8);
        uint32_t bh[2], bl[2];
        split(kb.x, bh[0], bl[0]);
        split(kb.y, bh[1], bl[1]);
        mma3(s[n], ah, al, bh, bl);
      }
    }
    __syncthreads();                        // every warp is done with K of tile t
    if (t < t_hi) copy_tile(Ks, L::QS, a.k, a.k_sb, a.k_ss, a.k_sh, t + 1);
    else cp_async_commit();                 // an empty group keeps the count

    // mask, scale to log2 units, and the pair's row maxima: a masked key
    // scores -1e30, a key past Sk -inf (p = 0 even in a row with no live key)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int kp = t * kKeys + half * 32 + n * 8 + 2 * tg + (x & 1);
        const int qp = qpos[x >> 1];
        bool ok = kp < a.Sk;
        if (a.causal) ok = ok && kp <= qp;
        if (a.window > 0) ok = ok && qp - kp < a.window;
        s[n][x] = ok ? s[n][x] * scale2 : kp < a.Sk ? kNegInf : ninf;
        mx[x >> 1] = fmaxf(mx[x >> 1], s[n][x]);
      }
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
      mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
      if (tg == 0) red[half * kRows + row0 + g + 8 * x] = mx[x];
    }
    pair_sync(pair);
    float corr[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float m_new =
          fmaxf(m[x], fmaxf(mx[x], red[(half ^ 1) * kRows + row0 + g + 8 * x]));
      corr[x] = exp2f(m[x] - m_new);
      m[x] = m_new;
      l[x] *= corr[x];
    }
    // P = exp2(s - m) into shared memory; this lane's part of the row sums
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float p[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        p[x] = exp2f(s[n][x] - m[x >> 1]);
        l[x >> 1] += p[x];
      }
      float* dst = Ps + (row0 + g) * L::PS + half * 32 + n * 8 + 2 * tg;
      *reinterpret_cast<float2*>(dst) = make_float2(p[0], p[1]);
      *reinterpret_cast<float2*>(dst + 8 * L::PS) = make_float2(p[2], p[3]);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    cp_async_wait<1>();                     // V of tile t landed
    __syncthreads();                        // ... for every warp, and P for the pair

    // O (16 rows x the half's D / 2 columns) += P V
    const float* v_t = Vs + (2 * tg) * L::VS + half * (D / 2) + g;
#pragma unroll 2
    for (int kk = 0; kk < kKeys / 8; ++kk) {
      uint32_t ah[4], al[4];
      load_a(p_g + kk * 8, p_g + 8 * L::PS + kk * 8, ah, al);
      const float* vk = v_t + kk * 8 * L::VS;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bh[2], bl[2];
        split(vk[n * 8], bh[0], bl[0]);
        split(vk[n * 8 + L::VS], bh[1], bl[1]);
        mma3(o[n], ah, al, bh, bl);
      }
    }
    __syncthreads();                        // every warp is done with V of tile t
    if (t < t_hi) copy_tile(Vs, L::VS, a.v, a.v_sb, a.v_ss, a.v_sh, t + 1);
  }

  // the row sums over both halves' keys
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
    if (tg == 0) red[2 * kRows + half * kRows + row0 + g + 8 * x] = l[x];
  }
  pair_sync(pair);
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = row0 + g + 8 * x;
    if (r >= nrows || qpos[x] >= a.Sq) continue;
    const float l_row = l[x] + red[2 * kRows + (half ^ 1) * kRows + r];
    const float den = fmaxf(l_row, 1e-30f);
    if (a.lse != nullptr && half == 0 && tg == 0)
      a.lse[((long long)b * a.Hq + hk * G + r % G) * a.Sq + qpos[x]] = m[x] + log2f(l_row);
    float* dst = a.out + (((long long)b * a.Sq + qpos[x]) * a.Hq + hk * G + r % G) * a.hd;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = half * (D / 2) + n * 8 + 2 * tg;
      if (d < a.hd)
        *reinterpret_cast<float2*>(dst + d) =
            make_float2(o[n][2 * x] / den, o[n][2 * x + 1] / den);
    }
  }
}

template <int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Smem<D>::bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + a.qt - 1) / a.qt, a.Hkv, B);
  flash_kernel<D><<<grid, kThreads, Smem<D>::bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Sq, Hq, hd), k and v (B, Sk, Hkv, hd) float32, each with unit stride
// over hd, the given element strides over (b, s, h), and every row starting
// on 16 bytes (hd, the strides times 4 and the pointers multiples of 16);
// out (B, Sq, Hq, hd) contiguous float32; lse null or (B, Hq, Sq) float32,
// written with each row's L.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk, int Hq,
    int Hkv, int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, int causal, int window,
    float scale, void* lse, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 16 || hd <= 0 ||
      hd % 4 != 0 || hd > 256 || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.out = static_cast<float*>(out);
  a.lse = static_cast<float*>(lse);
  a.Sq = Sq;
  a.Sk = Sk;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.hd = hd;
  a.qt = kRows / (Hq / Hkv);
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
  if (hd <= 32) return launch<32>(a, B, s);
  if (hd <= 64) return launch<64>(a, B, s);
  if (hd <= 128) return launch<128>(a, B, s);
  return launch<256>(a, B, s);
}
