// Backward of the RWKV6 wkv recurrence on Hopper (sm_90a), float32.
//
// The gradient of the function that the Pallas TPU kernel `rwkv6_scan`
// (src/repro/kernels/rwkv6_scan.py) computes forward; the reference has no
// Pallas backward (JAX differentiates its lax.scan), and the port's forward
// kernels (csrc/rwkv6_scan.cu) stay as they are.  Per (batch b, head h), for
// the forward
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
// Recovering the states.  S_{t-1} cannot be had from S_t by dividing by w_t
// (w may be 0, and tiny decays would blow the state up).  So:
//   1. bounds_kernel walks forward once and stores the state at every chunk
//      boundary (every kChunk = 64 steps): (B, H, ceil(T / 64), hd, hd).
//   2. bwd_kernel walks the chunks in reverse.  For each chunk it stages the
//      chunk's r, k, w, v, dy in shared memory, walks forward from the
//      chunk's boundary state storing the state at every kSub = 8 steps
//      (global scratch that stays in L2), then for each sub-chunk in reverse
//      recomputes its 8 states into registers and steps back through them.
//
// Threads.  One block a (b, h) holds the whole state and its gradient: a
// thread owns 8 columns (j = cg + NG m) of one row i, NG = hd / 8 threads a
// row, so the sums over a row (dr, dk, dw: over the value columns) are 8 FMAs
// and a shuffle over the row's NG lanes, in a fixed order.  The sum over the
// rows for dv (over the key channels) is taken within each warp by shuffles,
// then across warps in warp order through shared memory once a sub-chunk.
// du's per-batch sums go to scratch, and the last block of each head (by an
// atomic ticket: no atomic touches a gradient) adds them in batch order.
// The columns of the state are independent, so a later version may split a
// (b, h) over several blocks; here (B H = 80 blocks at the main shape) the
// serial chain of steps bounds the time, not the SMs in use.
//
// r, k, v, w and dy are read through their strides (B, H, T, hd) with unit
// stride over hd and every row on 16 bytes (the wrapper checks); dr, dk, dv,
// dw written through theirs; u (H, hd), s0, dsT, ds0 (B, H, hd, hd)
// contiguous.  hd is 16, 32 or 64.
//
// Bound on the H100: bytes.  At the main path's (2, 40, 4096, 64) the
// gradient must read r, k, v, w, dy (420 MB) and write dr, dk, dv, dw
// (336 MB): 0.23 ms at 3.35 TB/s.  Its arithmetic is about 12 hd^2 flops a
// step (the state recomputed, dS carried, four products), 16 GFLOP, 0.24 ms
// at 67 TFLOP/s.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;                  // steps between stored states; one staged chunk
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
  float* du;
  float* ds0;
  float* bounds;                            // (B, H, nc, hd, hd)
  float* subs;                              // (B, H, kSubs, hd, hd)
  float* du_part;                           // (B, H, hd)
  unsigned* tickets;                        // (H,) zeroed
  int B, H, T, nc;
};

template <int HD>
struct Layout {
  static constexpr int NG = HD / kCols;     // threads a row
  static constexpr int RPW = 32 / NG;       // rows a warp
  static constexpr int NW = HD / RPW;       // warps
  static constexpr int NT = 32 * NW;
  static constexpr int RS = HD + 4;         // staged row stride (floats)
};

// rows [t0, t0 + n) of sequence x of the (b, h) slice into dst (kChunk rows of
// stride HD + 4), zero past n; every load in flight before the first store
template <int HD>
__device__ __forceinline__ void stage_rows(float* dst, const Args& a, int x, int b, int h,
                                           int t0, int n) {
  using L = Layout<HD>;
  constexpr int C = HD / 4, N = kChunk * C, PER = (N + L::NT - 1) / L::NT;
  const float* base = a.in[x] + b * a.sb[x] + h * a.sh[x];
  float4 v[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int e = threadIdx.x + p * L::NT;
    const int t = e / C, d = (e - t * C) * 4;
    v[p] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < N && t < n)
      v[p] = *reinterpret_cast<const float4*>(base + (long long)(t0 + t) * a.st[x] + d);
  }
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    const int e = threadIdx.x + p * L::NT;
    if (e < N) {
      const int t = e / C, d = (e - t * C) * 4;
      *reinterpret_cast<float4*>(dst + t * L::RS + d) = v[p];
    }
  }
}

// ------------------------------------------------------------------------
// 1. The state at every chunk boundary
// ------------------------------------------------------------------------
template <int HD>
__global__ void __launch_bounds__(Layout<HD>::NT) bounds_kernel(const Args a) {
  using L = Layout<HD>;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;
  float* ws = ks + kChunk * L::RS;
  float* vs = ws + kChunk * L::RS;
  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = warp * L::RPW + lane / L::NG, cg = lane % L::NG;
  const long long E = (long long)HD * HD;

  float s[kCols];
#pragma unroll
  for (int m = 0; m < kCols; ++m) s[m] = a.s0[bh * E + i * HD + cg + L::NG * m];
  for (int c = 0; c < a.nc; ++c) {
    float* dst = a.bounds + (bh * (long long)a.nc + c) * E + i * HD + cg;
#pragma unroll
    for (int m = 0; m < kCols; ++m) dst[L::NG * m] = s[m];
    if (c + 1 == a.nc) break;               // the last chunk's end state is not needed
    const int t0 = c * kChunk;              // a whole chunk: only the last may be short
    __syncthreads();
    stage_rows<HD>(ks, a, K, b, h, t0, kChunk);
    stage_rows<HD>(ws, a, W, b, h, t0, kChunk);
    stage_rows<HD>(vs, a, V, b, h, t0, kChunk);
    __syncthreads();
    for (int t = 0; t < kChunk; ++t) {
      const float kt = ks[t * L::RS + i], wt = ws[t * L::RS + i];
#pragma unroll
      for (int m = 0; m < kCols; ++m)
        s[m] = fmaf(s[m], wt, kt * vs[t * L::RS + cg + L::NG * m]);
    }
  }
}

// ------------------------------------------------------------------------
// 2. The reverse walk
// ------------------------------------------------------------------------
template <int HD>
struct BwdSmem {                            // floats
  using L = Layout<HD>;
  static constexpr int seq = kChunk * L::RS;            // one staged sequence
  static constexpr int vdy = 5 * seq;                   // v_t . dy_t a step
  static constexpr int bonus = vdy + kChunk;            // sum_i r_t u k_t a step
  static constexpr int dv = bonus + kChunk;             // (NW, kSub, HD) dv partials
  static constexpr size_t bytes = sizeof(float) * (dv + L::NW * kSub * HD);
};

template <int HD>
__global__ void __launch_bounds__(Layout<HD>::NT, 1) bwd_kernel(const Args a) {
  using L = Layout<HD>;
  using M = BwdSmem<HD>;
  extern __shared__ __align__(16) float sm[];
  const float* rs = sm;
  const float* ks = sm + M::seq;
  const float* vs = sm + 2 * M::seq;
  const float* ws = sm + 3 * M::seq;
  const float* dys = sm + 4 * M::seq;
  float* vdy = sm + M::vdy;
  float* bonus = sm + M::bonus;
  float* dvp = sm + M::dv;

  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rl = lane / L::NG, cg = lane % L::NG, i = warp * L::RPW + rl;
  const long long E = (long long)HD * HD;
  const float ui = a.u[h * HD + i];

  float g[kCols];                           // dS[i][cg + NG m], from dS_T
#pragma unroll
  for (int m = 0; m < kCols; ++m) g[m] = a.dsT[bh * E + i * HD + cg + L::NG * m];
  float du = 0.f;
  float* dr = a.out[DR - DR] + b * a.sb[DR] + h * a.sh[DR] + i;
  float* dk = a.out[DK - DR] + b * a.sb[DK] + h * a.sh[DK] + i;
  float* dw = a.out[DW - DR] + b * a.sb[DW] + h * a.sh[DW] + i;
  float* dv = a.out[DV - DR] + b * a.sb[DV] + h * a.sh[DV];
  float* sub = a.subs + bh * kSubs * E + i * HD + cg;

  for (int c = a.nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n = min(kChunk, a.T - t0);
    __syncthreads();                        // the last chunk's staged rows are consumed
    for (int x = 0; x < 5; ++x) stage_rows<HD>(sm + x * M::seq, a, x, b, h, t0, n);
    __syncthreads();
    for (int t = warp; t < n; t += L::NW) {
      float p = 0.f, q = 0.f;
      for (int j = lane; j < HD; j += 32) {
        p = fmaf(vs[t * L::RS + j], dys[t * L::RS + j], p);
        q = fmaf(rs[t * L::RS + j] * a.u[h * HD + j], ks[t * L::RS + j], q);
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
    // the state at every kSub steps of the chunk, from its boundary
    const int nsub = (n + kSub - 1) / kSub;
    {
      float s[kCols];
      const float* src = a.bounds + (bh * (long long)a.nc + c) * E + i * HD + cg;
#pragma unroll
      for (int m = 0; m < kCols; ++m) s[m] = src[L::NG * m];
      for (int z = 0; z < nsub; ++z) {
#pragma unroll
        for (int m = 0; m < kCols; ++m) sub[z * E + L::NG * m] = s[m];
        for (int t = z * kSub; t < min(n, (z + 1) * kSub); ++t) {
          const float kt = ks[t * L::RS + i], wt = ws[t * L::RS + i];
#pragma unroll
          for (int m = 0; m < kCols; ++m)
            s[m] = fmaf(s[m], wt, kt * vs[t * L::RS + cg + L::NG * m]);
        }
      }
    }
    __syncthreads();                        // vdy and bonus are in
    for (int z = nsub - 1; z >= 0; --z) {
      // the sub-chunk's states before each of its steps (its own writes: no sync)
      float hist[kSub][kCols];
      {
        float s[kCols];
#pragma unroll
        for (int m = 0; m < kCols; ++m) s[m] = sub[z * E + L::NG * m];
#pragma unroll
        for (int x = 0; x < kSub; ++x) {
          const int t = z * kSub + x;
#pragma unroll
          for (int m = 0; m < kCols; ++m) hist[x][m] = s[m];
          if (t < n) {
            const float kt = ks[t * L::RS + i], wt = ws[t * L::RS + i];
#pragma unroll
            for (int m = 0; m < kCols; ++m)
              s[m] = fmaf(s[m], wt, kt * vs[t * L::RS + cg + L::NG * m]);
          }
        }
      }
#pragma unroll
      for (int x = kSub - 1; x >= 0; --x) {
        const int t = z * kSub + x;
        if (t >= n) continue;               // uniform over the block
        const float rt = rs[t * L::RS + i], kt = ks[t * L::RS + i], wt = ws[t * L::RS + i];
        float pr = 0.f, pk = 0.f, pw = 0.f, pv[kCols];
#pragma unroll
        for (int m = 0; m < kCols; ++m) {
          const int j = cg + L::NG * m;
          const float dyj = dys[t * L::RS + j];
          pr = fmaf(hist[x][m], dyj, pr);
          pk = fmaf(g[m], vs[t * L::RS + j], pk);
          pw = fmaf(g[m], hist[x][m], pw);
          pv[m] = g[m] * kt;
          g[m] = fmaf(g[m], wt, rt * dyj);  // dS_{t-1}
        }
#pragma unroll
        for (int off = 1; off < L::NG; off <<= 1) {
          pr += __shfl_xor_sync(0xffffffffu, pr, off);
          pk += __shfl_xor_sync(0xffffffffu, pk, off);
          pw += __shfl_xor_sync(0xffffffffu, pw, off);
        }
#pragma unroll
        for (int off = L::NG; off < 32; off <<= 1)
#pragma unroll
          for (int m = 0; m < kCols; ++m) pv[m] += __shfl_xor_sync(0xffffffffu, pv[m], off);
        const float vd = vdy[t];
        if (cg == 0) {
          dr[(long long)(t0 + t) * a.st[DR]] = pr + ui * kt * vd;
          dk[(long long)(t0 + t) * a.st[DK]] = rt * ui * vd + pk;
          dw[(long long)(t0 + t) * a.st[DW]] = pw;
          du = fmaf(rt * kt, vd, du);
        }
        if (rl == 0) {
#pragma unroll
          for (int m = 0; m < kCols; ++m) dvp[(warp * kSub + x) * HD + cg + L::NG * m] = pv[m];
        }
      }
      __syncthreads();                      // the sub-chunk's dv partials are in
      for (int e = tid; e < kSub * HD; e += L::NT) {
        const int x = e / HD, j = e - x * HD, t = z * kSub + x;
        if (t >= n) continue;
        float acc = bonus[t] * dys[t * L::RS + j];
        for (int ww = 0; ww < L::NW; ++ww) acc += dvp[(ww * kSub + x) * HD + j];
        dv[(long long)(t0 + t) * a.st[DV] + j] = acc;
      }
      __syncthreads();                      // before the next sub-chunk overwrites them
    }
  }
#pragma unroll
  for (int m = 0; m < kCols; ++m) a.ds0[bh * E + i * HD + cg + L::NG * m] = g[m];
  if (cg == 0) a.du_part[bh * HD + i] = du;

  // the last block of head h to finish sums du over the batch, in batch order
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(a.tickets + h, 1u) == (unsigned)(a.B - 1);
  __syncthreads();
  if (last) {
    __threadfence();
    for (int e = tid; e < HD; e += L::NT) {
      float acc = 0.f;
      for (int bb = 0; bb < a.B; ++bb)
        acc += __ldcg(a.du_part + ((long long)bb * a.H + h) * HD + e);
      a.du[h * HD + e] = acc;
    }
  }
}

template <int HD>
int launch(const Args& a, cudaStream_t stream) {
  using L = Layout<HD>;
  const size_t bounds_bytes = sizeof(float) * 3 * kChunk * L::RS;
  const size_t bytes = BwdSmem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(bounds_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bounds_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(a.B * a.H);
  bounds_kernel<HD><<<blocks, L::NT, bounds_bytes, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  bwd_kernel<HD><<<blocks, L::NT, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w, dy: (B, H, T, hd) float32 read through element strides over
// (b, h, t) with unit stride over hd and rows on 16 bytes; dr, dk, dv, dw
// written through theirs; u (H, hd), s0, dsT, ds0 (B, H, hd, hd) contiguous;
// du (H, hd).  Scratch: bounds (B, H, ceil(T / 64), hd, hd), subs (B, H, 8,
// hd, hd), du_part (B, H, hd) float32, tickets (H) uint32 zeroed.  hd is 16,
// 32 or 64, T >= 1.  Two launches on `stream`; returns the first
// cudaGetLastError() that is not 0 (0 on success).
extern "C" int rwkv6_scan_bwd_launch(
    const void* r, const void* k, const void* v, const void* w, const void* dy, void* dr,
    void* dk, void* dv, void* dw, const void* u, const void* s0, const void* dsT, void* du,
    void* ds0, void* bounds, void* subs, void* du_part, void* tickets, int B, int H, int T,
    int hd, long long r_sb, long long r_sh, long long r_st, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st, long long w_sb,
    long long w_sh, long long w_st, long long dy_sb, long long dy_sh, long long dy_st,
    long long dr_sb, long long dr_sh, long long dr_st, long long dk_sb, long long dk_sh,
    long long dk_st, long long dv_sb, long long dv_sh, long long dv_st, long long dw_sb,
    long long dw_sh, long long dw_st, void* stream) {
  if (B <= 0 || H <= 0 || T <= 0 || (long long)B * H > 2147483647LL)
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
  a.du = static_cast<float*>(du);
  a.ds0 = static_cast<float*>(ds0);
  a.bounds = static_cast<float*>(bounds);
  a.subs = static_cast<float*>(subs);
  a.du_part = static_cast<float*>(du_part);
  a.tickets = static_cast<unsigned*>(tickets);
  a.B = B;
  a.H = H;
  a.T = T;
  a.nc = (T + kChunk - 1) / kChunk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(a, s);
    case 32: return launch<32>(a, s);
    case 64: return launch<64>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
