// Backward of the RWKV6 wkv recurrence on Hopper (sm_90a), float32,
// chunk-parallel in time.
//
// The gradient of the function that the Pallas TPU kernel `rwkv6_scan`
// (src/repro/kernels/rwkv6_scan.py) computes forward; the reference has no
// Pallas backward (JAX differentiates its lax.scan).  Per (batch b, head h),
// for the forward
//
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// from S_0 = s0, and upstream dy_t and dS_T, it carries dS backward in time:
//
//     dr_t = S_{t-1} dy_t + u * k_t (v_t . dy_t)     du += r_t * k_t (v_t . dy_t)
//     dk_t = r_t * u (v_t . dy_t) + dS_t v_t          dw_t = rowsum(dS_t * S_{t-1})
//     dv_t = (sum_i r_t u k_t) dy_t + dS_t^T k_t      dS_{t-1} = diag(w_t) dS_t + r_t dy_t^T
//
// ending with ds0 = dS_0, du summed over t and then over b.
//
// Design: one launch, one block a chunk of kChunk = 64 steps, B H nc blocks
// (5120 at the main path's (2, 40, 4096, 64)), mirroring the forward's
// chunked form (csrc/rwkv6_scan.cu).  Only the hand-off of dS from chunk
// to chunk is serial; each chunk walks its own 64 steps.  A block
//   1. stages its chunk's r, k, v, w, dy in shared memory (a ragged last
//      chunk zero-filled, its padded decays 1) and computes its local term
//      Lambda_c = sum_t (r_t * w_start ... w_{t-1}) dy_t^T and decay D_c =
//      prod_t w_t: decays only ever multiplied, no factor above 1;
//   2. takes dS at its end from chunk c + 1 (dS_T at the last chunk) and
//      publishes dS at its start, diag(D_c) dS_end + Lambda_c, for chunk
//      c - 1 (two slots a (b, h), a release flag a chunk), or writes it to
//      ds0 at chunk 0.  Blocks take their chunk from an atomic ticket in
//      reverse chunk order, (b, h) fastest, so the chunk a block waits on
//      holds an earlier ticket and is running or done: the forward's
//      argument for freedom from deadlock, reversed;
//   3. walks its steps backward from dS_end.  S_{t-1} cannot be had from S_t
//      by dividing by w_t (w may be 0, and tiny decays would blow the state
//      up), so it walks forward once from S_c, the state the chunk starts
//      from (s0 at chunk 0, else from the forward kernel's `states`
//      output), storing the state every kSub = 8 steps in shared memory,
//      and then for each sub-chunk in reverse recomputes its 8 states into
//      registers and steps back through them.
// du's per-chunk sums go to scratch, and the last block of each head (by
// an atomic ticket: no atomic touches a gradient) adds them in (b, chunk)
// order.
//
// Threads.  A block holds the chunk's whole state and its gradient: a
// thread owns 8 columns of one row i (4 cg .. 4 cg + 3 and hd / 2 + 4 cg ..
// hd / 2 + 4 cg + 3: two 16-byte loads of v_t and dy_t a step), NG = hd / 8
// threads a row, so the sums over a row (dr, dk, dw: over the value
// columns) are 8 FMAs and a shuffle over the row's NG lanes, in a fixed
// order.  The sum over the rows for dv (over the key channels) is taken
// within each warp by a reduce-scatter of shuffles, then across warps in
// warp order through shared memory once a sub-chunk.
//
// r, k, v, w and dy are read through their strides (B, H, T, hd) with unit
// stride over hd and every row on 16 bytes (the wrapper checks); dr, dk,
// dv, dw written through theirs; u (H, hd), s0, dsT, ds0 (B, H, hd, hd)
// contiguous.  hd is 16, 32 or 64.
//
// Bound on the H100: operations.  At the main path's (2, 40, 4096, 64) the
// gradient must read r, k, v, w, dy (420 MB) and write dr, dk, dv, dw
// (336 MB): 0.23 ms at 3.35 TB/s.  Its arithmetic is about 12 hd^2 flops a
// step (the state recomputed, dS carried, four products), 16 GFLOP, 0.24 ms
// at 67 TFLOP/s.  This kernel also reads each chunk's S_c (84 MB) and does
// the state recompute a second time (the sub-chunk boundaries, then the
// states within each sub-chunk).

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;                  // steps a block (the forward's chunk)
constexpr int kSub = 8;                     // steps whose states a thread keeps in registers
constexpr int kSubs = kChunk / kSub;
constexpr int kCols = 8;                    // state columns a thread

enum { R, K, V, W, DY, DR, DK, DV, DW, NSEQ };

struct Args {
  const float* in[5];                       // r, k, v, w, dy
  float* out[4];                            // dr, dk, dv, dw
  long long sb[NSEQ], sh[NSEQ], st[NSEQ];   // element strides over (b, h, t)
  const float* u;
  const float* s0;
  const float* dsT;
  const float* states;                      // (B, H, nc, hd, hd): S_c (read for c >= 1)
  float* du;
  float* ds0;
  float* slots;                             // (B, H, 2, hd, hd): dS handed between chunks
  float* du_part;                           // (B, H, nc, hd)
  unsigned* sync;                           // zeroed: ticket, B H nc flags, H head tickets
  int B, H, T, nc;
};

template <int HD>
struct Layout {
  static constexpr int NG = HD / kCols;     // threads a row
  static constexpr int RPW = 32 / NG;       // rows a warp
  static constexpr int NW = HD / RPW;       // warps
  static constexpr int NT = 32 * NW;
};

template <int HD>
struct Smem {                               // floats
  using L = Layout<HD>;
  static constexpr int seq = kChunk * HD;               // one staged sequence
  static constexpr int vdy = 5 * seq;                   // v_t . dy_t a step
  static constexpr int bonus = vdy + kChunk;            // sum_i r_t u k_t a step
  static constexpr int dv = bonus + kChunk;             // (NW, kSub, HD) dv partials
  static constexpr int subs = dv + L::NW * kSub * HD;   // states at steps 8, 16, .., 56
  static constexpr size_t bytes = sizeof(float) * (subs + (kSubs - 1) * HD * HD);
};

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

// rows [t0, t0 + n) of sequence x of the (b, h) slice into dst (kChunk rows
// of HD floats) by 16-byte cp.async copies, zero-filled past n; the caller
// commits and waits
template <int HD>
__device__ __forceinline__ void stage_rows(float* dst, const Args& a, int x, int b, int h,
                                           int t0, int n) {
  constexpr int C = HD / 4;
  const float* base = a.in[x] + b * a.sb[x] + h * a.sh[x];
  for (int e = threadIdx.x; e < kChunk * C; e += Layout<HD>::NT) {
    const int t = e / C, d = (e - t * C) * 4;
    cp_async16(dst + t * HD + d, base + (long long)(t0 + (t < n ? t : 0)) * a.st[x] + d,
               t < n ? 16 : 0);
  }
}

// A thread's 8 columns of a row: col(m) = 4 cg + m and hd / 2 + 4 cg + m - 4,
// two 16-byte loads, the NG threads of a row on consecutive 16 bytes.
template <int HD>
__device__ __forceinline__ int col(int m, int cg) {
  return (m < 4 ? 0 : HD / 2) + 4 * cg + (m & 3);
}
__device__ __forceinline__ void unpack(float* x, float4 v) {
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
template <int HD>
__device__ __forceinline__ void ld8(float (&x)[kCols], const float* row, int cg) {
  unpack(x, *reinterpret_cast<const float4*>(row + 4 * cg));
  unpack(x + 4, *reinterpret_cast<const float4*>(row + HD / 2 + 4 * cg));
}
template <int HD>
__device__ __forceinline__ void st8(float* row, const float (&x)[kCols], int cg) {
  *reinterpret_cast<float4*>(row + 4 * cg) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(row + HD / 2 + 4 * cg) = make_float4(x[4], x[5], x[6], x[7]);
}
// the same through L2 only (state handed between blocks)
template <int HD>
__device__ __forceinline__ void ld8_cg(float (&x)[kCols], const float* row, int cg) {
  unpack(x, __ldcg(reinterpret_cast<const float4*>(row + 4 * cg)));
  unpack(x + 4, __ldcg(reinterpret_cast<const float4*>(row + HD / 2 + 4 * cg)));
}
template <int HD>
__device__ __forceinline__ void st8_cg(float* row, const float (&x)[kCols], int cg) {
  __stcg(reinterpret_cast<float4*>(row + 4 * cg), make_float4(x[0], x[1], x[2], x[3]));
  __stcg(reinterpret_cast<float4*>(row + HD / 2 + 4 * cg), make_float4(x[4], x[5], x[6], x[7]));
}

// S_t = diag(w_t) S_{t-1} + k_t v_t^T on this thread's 8 elements of row i
template <int HD>
__device__ __forceinline__ void state_step(float (&s)[kCols], const float* ks, const float* vs,
                                           const float* ws, int t, int i, int cg) {
  const float kt = ks[t * HD + i], wt = ws[t * HD + i];
  float vt[kCols];
  ld8<HD>(vt, vs + t * HD, cg);
#pragma unroll
  for (int m = 0; m < kCols; ++m) s[m] = fmaf(s[m], wt, kt * vt[m]);
}

// Sums of N values over LANES lanes at lane distance STRIDE, as a
// reduce-scatter: at each level a lane keeps half its values, sends the
// other half to its partner and adds what comes back; once one value is
// left, plain xor sums.  `which` is the lane's index among the LANES lanes;
// `base` comes back as the index of the lane's first summed value, and
// kLeft<N, LANES> values are left.  So the dv sum of a warp's RPW = 4 rows
// over 8 columns takes 4 + 2 shuffles (not 2 x 8), leaving each lane 2
// column sums.  A fixed order: no sum depends on timing.  (The same for
// the three row sums, 4 shuffles for 9, ran slower on the H100: the
// selects cost more than the shuffles saved.)
template <int LANES, int STRIDE, int CNT, int N>
__device__ __forceinline__ void reduce_scatter(float (&pv)[N], int which, int& base) {
  if constexpr (LANES > 1) {
    const bool up = which & 1;
    if constexpr (CNT > 1) {
      constexpr int H = CNT / 2;
#pragma unroll
      for (int q = 0; q < H; ++q) {
        const float send = up ? pv[q] : pv[q + H];
        const float keep = up ? pv[q + H] : pv[q];
        pv[q] = keep + __shfl_xor_sync(0xffffffffu, send, STRIDE);
      }
      base += up ? H : 0;
      reduce_scatter<LANES / 2, STRIDE * 2, H>(pv, which >> 1, base);
    } else {
      pv[0] += __shfl_xor_sync(0xffffffffu, pv[0], STRIDE);
      reduce_scatter<LANES / 2, STRIDE * 2, 1>(pv, which >> 1, base);
    }
  }
}
template <int N, int LANES>
constexpr int kLeft = LANES >= N ? 1 : N / LANES;

template <int HD>
__global__ void __launch_bounds__(Layout<HD>::NT, 1) bwd_chunk_kernel(const Args a, int BH) {
  using L = Layout<HD>;
  using M = Smem<HD>;
  extern __shared__ __align__(16) float sm[];
  const float* rs = sm;
  const float* ks = sm + M::seq;
  const float* vs = sm + 2 * M::seq;
  const float* ws = sm + 3 * M::seq;
  const float* dys = sm + 4 * M::seq;
  float* vdy = sm + M::vdy;
  float* bonus = sm + M::bonus;
  float* dvp = sm + M::dv;
  float* subs = sm + M::subs;
  __shared__ int ticket, last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) ticket = (int)atomicAdd(a.sync, 1u);
  __syncthreads();
  const int c = a.nc - 1 - ticket / BH, bh = ticket % BH, b = bh / a.H, h = bh - b * a.H;
  const int t0 = c * kChunk, n = min(kChunk, a.T - t0);
  const int rl = lane / L::NG, cg = lane % L::NG, i = warp * L::RPW + rl;
  const long long E = (long long)HD * HD;
  const float ui = a.u[h * HD + i];
  unsigned* flags = a.sync + 1;

  for (int x = 0; x < 5; ++x) stage_rows<HD>(sm + x * M::seq, a, x, b, h, t0, n);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  for (int e = tid; e < (kChunk - n) * HD; e += L::NT)      // padded steps: w = 1
    sm[W * M::seq + n * HD + e] = 1.f;
  __syncthreads();
  for (int t = warp; t < n; t += L::NW) {
    float p = 0.f, q = 0.f;
    for (int j = lane; j < HD; j += 32) {
      p = fmaf(vs[t * HD + j], dys[t * HD + j], p);
      q = fmaf(rs[t * HD + j] * a.u[h * HD + j], ks[t * HD + j], q);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      p += __shfl_xor_sync(0xffffffffu, p, off);
      q += __shfl_xor_sync(0xffffffffu, q, off);
    }
    if (lane == 0) {
      vdy[t] = p;
      bonus[t] = q;
    }
  }

  // 1. Lambda_c and D_c: r decayed from the chunk's start
  float g[kCols];                           // dS[i][col(m)] at the chunk's end
  {
    float lam[kCols] = {}, pre = 1.f;
    for (int t = 0; t < n; ++t) {             // padded steps: r = 0, w = 1
      const float rt = rs[t * HD + i] * pre;
      float dyt[kCols];
      ld8<HD>(dyt, dys + t * HD, cg);
#pragma unroll
      for (int m = 0; m < kCols; ++m) lam[m] = fmaf(rt, dyt[m], lam[m]);
      pre *= ws[t * HD + i];
    }
    // 2. dS at the end from chunk c + 1 (dS_T at the last); dS at the start out
    const float* src = a.dsT + bh * E;
    if (c + 1 < a.nc) {
      if (tid == 0) {
        const unsigned* flag = flags + (long long)bh * a.nc + c + 1;
        const long long start = clock64();
        while (ld_acquire(flag) == 0u) {
          __nanosleep(64);
          if (clock64() - start > (1ll << 34)) __trap();   // about 10 s: a fault
        }
      }
      __syncthreads();
      src = a.slots + (bh * 2 + ((c + 1) & 1)) * E;
    }
    ld8_cg<HD>(g, src + i * HD, cg);
#pragma unroll
    for (int m = 0; m < kCols; ++m) lam[m] = fmaf(pre, g[m], lam[m]);
    st8_cg<HD>((c == 0 ? a.ds0 + bh * E : a.slots + (bh * 2 + (c & 1)) * E) + i * HD, lam, cg);
    if (c > 0) {
      __threadfence();
      __syncthreads();
      if (tid == 0) st_release(flags + (long long)bh * a.nc + c, 1u);
    }
  }

  // 3. the state every kSub steps of the chunk, from S_c
  const int nsub = (n + kSub - 1) / kSub;
  const float* s_c =
      (c == 0 ? a.s0 + bh * E : a.states + ((long long)bh * a.nc + c) * E) + i * HD;
  {
    float s[kCols];
    ld8_cg<HD>(s, s_c, cg);
    for (int z = 0; z < nsub; ++z) {
      if (z > 0) st8<HD>(subs + (z - 1) * HD * HD + i * HD, s, cg);
      if (z + 1 == nsub) break;
      for (int t = z * kSub; t < (z + 1) * kSub; ++t) state_step<HD>(s, ks, vs, ws, t, i, cg);
    }
  }
  __syncthreads();                          // vdy and bonus are in

  float du = 0.f;
  float* dr = a.out[DR - DR] + b * a.sb[DR] + h * a.sh[DR] + i;
  float* dk = a.out[DK - DR] + b * a.sb[DK] + h * a.sh[DK] + i;
  float* dw = a.out[DW - DR] + b * a.sb[DW] + h * a.sh[DW] + i;
  float* dv = a.out[DV - DR] + b * a.sb[DV] + h * a.sh[DV];
  for (int z = nsub - 1; z >= 0; --z) {
    // the sub-chunk's states before each of its steps (this thread's own
    // elements of the boundaries: no sync)
    float hist[kSub][kCols];
    {
      float s[kCols];
      if (z == 0)
        ld8_cg<HD>(s, s_c, cg);
      else
        ld8<HD>(s, subs + (z - 1) * HD * HD + i * HD, cg);
#pragma unroll
      for (int x = 0; x < kSub; ++x) {
#pragma unroll
        for (int m = 0; m < kCols; ++m) hist[x][m] = s[m];
        if (z * kSub + x < n) state_step<HD>(s, ks, vs, ws, z * kSub + x, i, cg);
      }
    }
#pragma unroll
    for (int x = kSub - 1; x >= 0; --x) {
      const int t = z * kSub + x;
      if (t >= n) continue;                 // uniform over the block
      const float rt = rs[t * HD + i], kt = ks[t * HD + i], wt = ws[t * HD + i];
      float dyt[kCols], vt[kCols];
      ld8<HD>(dyt, dys + t * HD, cg);
      ld8<HD>(vt, vs + t * HD, cg);
      float pr = 0.f, pk = 0.f, pw = 0.f, pv[kCols];
#pragma unroll
      for (int m = 0; m < kCols; ++m) {
        pr = fmaf(hist[x][m], dyt[m], pr);
        pk = fmaf(g[m], vt[m], pk);
        pw = fmaf(g[m], hist[x][m], pw);
        pv[m] = g[m] * kt;
        g[m] = fmaf(g[m], wt, rt * dyt[m]);   // dS_{t-1}
      }
#pragma unroll
      for (int off = 1; off < L::NG; off <<= 1) {
        pr += __shfl_xor_sync(0xffffffffu, pr, off);
        pk += __shfl_xor_sync(0xffffffffu, pk, off);
        pw += __shfl_xor_sync(0xffffffffu, pw, off);
      }
      int base = 0;                         // pv[0 ..] hold columns col(base ..)
      reduce_scatter<L::RPW, L::NG, kCols>(pv, rl, base);
      const float vd = vdy[t];
      if (cg == 0) {
        dr[(long long)(t0 + t) * a.st[DR]] = pr + ui * kt * vd;
        dk[(long long)(t0 + t) * a.st[DK]] = rt * ui * vd + pk;
        dw[(long long)(t0 + t) * a.st[DW]] = pw;
        du = fmaf(rt * kt, vd, du);
      }
      if (L::RPW <= kCols || rl < kCols) {
#pragma unroll
        for (int q = 0; q < kLeft<kCols, L::RPW>; ++q)
          dvp[(warp * kSub + x) * HD + col<HD>(base + q, cg)] = pv[q];
      }
    }
    __syncthreads();                        // the sub-chunk's dv partials are in
    for (int e = tid; e < kSub * HD; e += L::NT) {
      const int x = e / HD, j = e - x * HD, t = z * kSub + x;
      if (t >= n) continue;
      float acc = bonus[t] * dys[t * HD + j];
      for (int ww = 0; ww < L::NW; ++ww) acc += dvp[(ww * kSub + x) * HD + j];
      dv[(long long)(t0 + t) * a.st[DV] + j] = acc;
    }
    __syncthreads();                        // before the next sub-chunk overwrites them
  }
  if (cg == 0) a.du_part[((long long)bh * a.nc + c) * HD + i] = du;

  // the last block of head h to finish sums du over (b, chunk), in that order
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(flags + (long long)BH * a.nc + h, 1u) == (unsigned)(a.B * a.nc - 1);
  __syncthreads();
  if (last) {
    __threadfence();
    for (int e = tid; e < HD; e += L::NT) {
      float acc = 0.f;
      for (int bb = 0; bb < a.B; ++bb)
        for (int cc = 0; cc < a.nc; ++cc)
          acc += __ldcg(a.du_part + (((long long)bb * a.H + h) * a.nc + cc) * HD + e);
      a.du[h * HD + e] = acc;
    }
  }
}

template <int HD>
int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = Smem<HD>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      bwd_chunk_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int BH = a.B * a.H;
  bwd_chunk_kernel<HD><<<(unsigned)((long long)a.nc * BH), Layout<HD>::NT, bytes, stream>>>(a,
                                                                                        BH);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, dy: (B, H, T, hd) float32 read through element strides over
// (b, h, t) with unit stride over hd and rows on 16 bytes; dr, dk, dv, dw
// written through theirs; u (H, hd), s0, dsT, ds0 (B, H, hd, hd) contiguous;
// du (H, hd).  states: (B, H, nc, hd, hd) float32 with every chunk's starting
// state (the forward kernel's output), nc = ceil(T / 64); read only for
// chunks >= 1, so it may be null when T <= 64.  Scratch: slots (B, H, 2, hd,
// hd), du_part (B, H, nc, hd) float32; sync (1 + B H nc + H) uint32 zeroed.
// hd is 16, 32 or 64, T >= 1.  One launch on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w, const void* dy, void* dr,
    void* dk, void* dv, void* dw, const void* u, const void* s0, const void* dsT,
    const void* states, void* du, void* ds0, void* slots, void* du_part, void* sync, int B,
    int H, int T, int hd, long long r_sb, long long r_sh, long long r_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh, long long v_st,
    long long w_sb, long long w_sh, long long w_st, long long dy_sb, long long dy_sh,
    long long dy_st, long long dr_sb, long long dr_sh, long long dr_st, long long dk_sb,
    long long dk_sh, long long dk_st, long long dv_sb, long long dv_sh, long long dv_st,
    long long dw_sb, long long dw_sh, long long dw_st, void* stream) {
  const int nc = (T + kChunk - 1) / kChunk;
  if (B <= 0 || H <= 0 || T <= 0 || (long long)B * H * nc > 2147483647LL ||
      (nc > 1 && states == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  const void* ins[5] = {r, k, v, w, dy};
  void* outs[4] = {dr, dk, dv, dw};
  for (int x = 0; x < 5; ++x) a.in[x] = static_cast<const float*>(ins[x]);
  for (int x = 0; x < 4; ++x) a.out[x] = static_cast<float*>(outs[x]);
  const long long strides[NSEQ][3] = {
      {r_sb, r_sh, r_st},   {k_sb, k_sh, k_st},    {v_sb, v_sh, v_st},
      {w_sb, w_sh, w_st},   {dy_sb, dy_sh, dy_st}, {dr_sb, dr_sh, dr_st},
      {dk_sb, dk_sh, dk_st}, {dv_sb, dv_sh, dv_st}, {dw_sb, dw_sh, dw_st}};
  for (int x = 0; x < NSEQ; ++x) {
    a.sb[x] = strides[x][0];
    a.sh[x] = strides[x][1];
    a.st[x] = strides[x][2];
  }
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.dsT = static_cast<const float*>(dsT);
  a.states = static_cast<const float*>(states);
  a.du = static_cast<float*>(du);
  a.ds0 = static_cast<float*>(ds0);
  a.slots = static_cast<float*>(slots);
  a.du_part = static_cast<float*>(du_part);
  a.sync = static_cast<unsigned*>(sync);
  a.B = B;
  a.H = H;
  a.T = T;
  a.nc = nc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(a, s);
    case 32: return launch<32>(a, s);
    case 64: return launch<64>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
