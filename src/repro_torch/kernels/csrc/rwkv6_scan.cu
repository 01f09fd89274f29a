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
// time, one program per (b, h).  Here one block per (b, h) holds the state
// in registers: four threads share column j of S, thread (j, p) holding
// the hd / 4 rows i = 4 r + p, and the four are neighbouring lanes, so
// their partial sums of y_t[j] meet in two shuffles.  A step is hd / 4
// serial channel updates per thread, not hd, and the block has 4 hd
// threads to hide the latency of each one (a single thread per column
// left two warps per SM waiting on every shared-memory load: 5.1 ms at
// the main path's shape; a first version, which also loaded one chunk
// element per iteration, 2.7 ms).  Every thread needs all of r_t, k_t, w_t
// (and u), so the block stages a chunk of time steps in shared memory,
// each channel's (r, k, w, u) packed into one float4 that a quarter-warp
// reads as four neighbouring broadcasts: thread (j, p) loads element j of
// steps p, p + 4, ... of the chunk into registers first (all in flight at
// once, one round trip), then stores them, synchronises, and the block
// walks the chunk serially.  r, k, v, w and y are addressed through their
// own strides over (b, h, t) with unit stride over hd, so the model's
// (B, S, H, hd) projections are read without a transpose and y is written
// where the model wants it.
//
// Bound on the H100: bytes.  At the main path's (2, 40, 4096, 64) the
// kernel must read r, k, v, w (336 MB) and write y (84 MB), 126 us at
// 3.35 TB/s.  The function needs 5 hd^2 + 5 hd flops a step (r.S, and
// w*S + k v^T; the bonus r.((u*k) v^T) factorises to (sum_i r_i u_i k_i) v),
// 6.8 GFLOP, 102 us at 67 TFLOP/s fp32.  This version adds the bonus per
// state element, as the formula above writes it.  But the recurrence is
// serial in T: 80 blocks on 132 SMs, each 4096 dependent steps, so
// latency, not either peak, sets this version's time.  Decode calls it at
// T = 1.

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
  int H, T;
  long long r_sb, r_sh, r_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, w_sb, w_sh, w_st;
  long long y_sb, y_sh, y_st;
};

constexpr int kParts = 4;                   // threads per state column

template <int HD>
__global__ void __launch_bounds__(kParts * HD)
wkv_kernel(const Args a) {
  constexpr int R = HD / kParts;            // state rows per thread
  constexpr int kChunk = 2048 / HD < 64 ? 2048 / HD : 64;   // steps per chunk
  constexpr int kLoads = kChunk / kParts;   // chunk steps each thread loads
  __shared__ float4 rkwu[kChunk][HD];       // (r, k, w, u) of channel i at step tt
  __shared__ float vs[kChunk][HD];

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

  for (int t0 = 0; t0 < a.T; t0 += kChunk) {
    const int n = min(kChunk, a.T - t0);
    float rr[kLoads], kk[kLoads], ww[kLoads], vv[kLoads];
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {      // every load of the chunk in flight
      const int tt = kParts * l + p;
      if (tt < n) {
        const long long t = t0 + tt;
        rr[l] = rp[t * a.r_st];
        kk[l] = kp[t * a.k_st];
        ww[l] = wp[t * a.w_st];
        vv[l] = vp[t * a.v_st];
      }
    }
    __syncthreads();                        // the previous chunk is consumed
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

template <int HD>
int launch(const Args& a, int B, cudaStream_t stream) {
  wkv_kernel<HD><<<B * a.H, kParts * HD, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, w: (B, H, T, hd) float32 with unit stride over hd and the given
// element strides over (b, h, t); y likewise (written); u (H, hd), s0 and
// sT (B, H, hd, hd) float32 contiguous.  hd is one of 8, 16, 32, 64, 128.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int rwkv6_scan_launch(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* s0, void* y, void* sT, int B, int H, int T, int hd,
    long long r_sb, long long r_sh, long long r_st, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st, long long w_sb,
    long long w_sh, long long w_st, long long y_sb, long long y_sh, long long y_st,
    void* stream) {
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
  a.H = H;
  a.T = T;
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
