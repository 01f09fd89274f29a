// The gradient of Mamba's selective scan (csrc/selective_scan.cu) on Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the reference differentiates its `lax.scan`
// over time (src/repro/models/mamba.py:68-77) by autodiff.  Eager PyTorch
// autograd through a step loop would keep every state and every exp(dt A)
// of (B, S, d_inner, d_state), 17 GB for one of jamba's layers.  Per
// (batch b, channel d), with a_t = exp(dt_t A) and g_t the gradient reaching
// the state h_t after step t, from g = dh_T:
//
//     g_t     = g_{t+1} a_{t+1} + dy_t C_t        (g_{S} a_{S} := dh_T)
//     dC_t    = sum_d dy_t[d] h_t[d]              dB_t = sum_d g_t[d] dt_t[d] x_t[d]
//     u_t     = sum_n g_t[n] B_t[n]               dx_t = u_t dt_t + dy_t D
//     ddt_t   = u_t x_t + sum_n g_t h_{t-1} a_t A
//     dA      = sum_{b, t} g_t h_{t-1} a_t dt_t   dD = sum_{b, t} dy_t x_t
//     dh0     = g_0 a_0
//
// Bound on the H100: bytes.  At jamba's prefill (2, 4096, 16384, 16), x in
// bf16, it must read dt, x and dy and write ddt and dx (2.15 GB; B, C, A,
// D, h0, dh_T, dB, dC, dA, dD and dh0 are small), 0.64 ms at 3.35 TB/s; its
// B S di kN = 2.1 G exponentials take 0.51 ms of the SFUs.  A simple design
// that is right (first version):
//   * The forward's grid: a block is kChannels = 64 channels of one b, four
//     lanes a channel, four states a lane (the forward's Lane).  It walks
//     its chunks of kChunk = 16 steps in reverse.  Each chunk starts from
//     the state the forward stored there (`states`, (B, ceil(S / kChunk),
//     di, kN); h0 when S <= kChunk), its 16 states are recomputed into
//     registers with the forward's arithmetic (one ex2.approx a state a
//     step, so they are the forward's states bit for bit), then the steps
//     are walked backward with g in registers (a second exponential a
//     state a step).  Two exponentials a state a step: about 1.03 ms of
//     SFU time, twice the function's bound.
//   * Each chunk's dt, x, dy, B_t and C_t are staged in shared memory by
//     plain loads, zeros past S (a zero step leaves h and g as they are).
//   * u_t and the sum over n for ddt_t: the four lanes' partial sums,
//     reduced four steps at a time by the forward's shuffle reduce-scatter.
//   * No atomics; fixed-order sums.  dB_t and dC_t sum over all channels:
//     each warp reduces its 8 channels by a reduce-scatter of shuffles, each
//     block sums its 8 warps in order and writes one partial a (b, t, n)
//     to part_bc (nblk, B, S, 2 kN).  dA and dD sum over b and t: each
//     lane sums its steps in registers, in order, into part_a (B, di, kN)
//     and part_d (B, di).  A second launch of this source
//     (scan_bwd_reduce_kernel) sums the partials over the blocks and over b
//     in a fixed order.  Two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;                      // d_state: the wrapper refuses any other
constexpr int kLanes = 4;                   // lanes a channel
constexpr int kPer = kN / kLanes;           // states a lane
constexpr int kChannels = 64;               // channels a block
constexpr int kThreads = kChannels * kLanes;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 2;             // blocks an SM at once (up to 128 registers)
constexpr int kChunk = 16;                  // steps a chunk: the forward's states interval
constexpr int kReduceThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowStep = kThreads / kChannels;     // steps a staging pass covers
constexpr int kBcStep = kThreads / (2 * kN);
static_assert(kPer == 4 && kChunk % kLanes == 0 && kChunk % kRowStep == 0 &&
              kChunk % kBcStep == 0 && 32 / kLanes == 8, "");

struct Args {
  const float *dt, *Bm, *Cm, *A, *D, *h0, *dy, *dhT, *states;
  const void* x;
  float *ddt, *part_bc, *part_a, *part_d, *dh0;
  void* dx;
  int B, S, di;
  long long dt_sb, dt_ss, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, dy_sb, dy_ss;
};

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_x(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_x(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the forward's: the partial sums v[i] of kLanes consecutive steps on each
// lane of a channel; lane g comes back with step g's total
__device__ __forceinline__ float lane_sums(float (&v)[kLanes], int g) {
#pragma unroll
  for (int m = kLanes / 2; m >= 1; m /= 2) {
#pragma unroll
    for (int i = 0; i < m; ++i) {
      const bool upper = g & m;
      const float keep = upper ? v[i + m] : v[i], send = upper ? v[i] : v[i + m];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
  return v[0];
}

// v: this lane's 2 kPer values (dB of its kPer states, then dC); the sum of
// each over the warp's 8 channels (lane bits 2-4) by a reduce-scatter: lane
// (channel c, group g) comes back with the total of value idx = c's bits
// 4, 3, 2 read as 4, 2, 1
__device__ __forceinline__ float channel_sums(float (&v)[2 * kPer], int lane) {
#pragma unroll
  for (int m = 16, half = kPer; m >= kLanes; m /= 2, half /= 2) {
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const bool upper = lane & m;
      const float keep = upper ? v[i + half] : v[i], send = upper ? v[i] : v[i + half];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
  }
  return v[0];
}

template <typename XT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) scan_bwd_kernel(const Args a) {
  __shared__ float sdt[kChunk][kChannels], sx[kChunk][kChannels], sdy[kChunk][kChannels];
  __shared__ float4 sbc[kChunk][2 * kN / 4];              // B_t, then C_t
  __shared__ float spart[kWarps][kChunk][2 * kN];         // each warp's dB_t | dC_t
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cl = warp * (32 / kLanes) + lane / kLanes, g = lane % kLanes;
  const int d = blockIdx.x * kChannels + cl;
  const bool live = d < a.di;
  const long long row = live ? d : 0;      // dead lanes walk channel 0, store nothing
  const int nchunks = (a.S + kChunk - 1) / kChunk;

  float A[kPer], a2[kPer], gr[kPer], dA[kPer];
  {
    const float4 av = *reinterpret_cast<const float4*>(a.A + row * kN + kPer * g);
    const float4 gv = *reinterpret_cast<const float4*>(
        a.dhT + ((long long)b * a.di + row) * kN + kPer * g);
    A[0] = av.x; A[1] = av.y; A[2] = av.z; A[3] = av.w;
    gr[0] = gv.x; gr[1] = gv.y; gr[2] = gv.z; gr[3] = gv.w;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    a2[k] = A[k] * kLog2e;
    dA[k] = 0.0f;
  }
  const float Dd = a.D[row];
  float dD = 0.0f;

  // the staging loads: channel lc at steps ls + j kRowStep; element (sb, kb)
  // of B_t | C_t at steps sb + j kBcStep
  const int lc = tid % kChannels, ls = tid / kChannels;
  const bool lc_live = blockIdx.x * kChannels + lc < a.di;
  const long long lrow = blockIdx.x * kChannels + lc;
  const int sb = tid / (2 * kN), kb = tid % (2 * kN);
  const XT* xg = static_cast<const XT*>(a.x);
  XT* dxg = static_cast<XT*>(a.dx);

  for (int c = nchunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, n = min(kChunk, a.S - t0);
    __syncthreads();                      // the last chunk's shared reads are done
#pragma unroll
    for (int j = 0; j < kChunk / kRowStep; ++j) {
      const int s = ls + j * kRowStep;
      const bool ok = lc_live && s < n;
      const long long t = t0 + s;
      sdt[s][lc] = ok ? a.dt[b * a.dt_sb + t * a.dt_ss + lrow] : 0.0f;
      sx[s][lc] = ok ? load_x(xg + b * a.x_sb + t * a.x_ss + lrow) : 0.0f;
      sdy[s][lc] = ok ? a.dy[b * a.dy_sb + t * a.dy_ss + lrow] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kChunk / kBcStep; ++j) {
      const int s = sb + j * kBcStep;
      const long long t = t0 + s;
      float v = 0.0f;
      if (s < n)
        v = kb < kN ? a.Bm[b * a.b_sb + t * a.b_ss + kb]
                    : a.Cm[b * a.c_sb + t * a.c_ss + kb - kN];
      reinterpret_cast<float*>(&sbc[s][0])[kb] = v;
    }
    __syncthreads();

    // the chunk's states, recomputed as the forward computed them:
    // hs[i] is the state before step t0 + i (hs[0] the stored start)
    float hs[kChunk + 1][kPer];
    {
      const float* src = a.states ? a.states + (((long long)b * nchunks + c) * a.di + row) * kN
                                  : a.h0 + ((long long)b * a.di + row) * kN;
      const float4 hv = *reinterpret_cast<const float4*>(src + kPer * g);
      hs[0][0] = hv.x; hs[0][1] = hv.y; hs[0][2] = hv.z; hs[0][3] = hv.w;
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const float dx = sdt[i][cl] * sx[i][cl];
      const float4 bq = sbc[i][g];
      const float bt[kPer] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        hs[i + 1][k] = fmaf(hs[i][k], ex2(sdt[i][cl] * a2[k]), dx * bt[k]);
    }

    // the steps backward, kLanes at a time: lane g finishes step s0 + g
#pragma unroll
    for (int s0 = kChunk - kLanes; s0 >= 0; s0 -= kLanes) {
      float vu[kLanes], vq[kLanes];
#pragma unroll
      for (int i = kLanes - 1; i >= 0; --i) {
        const int s = s0 + i;
        const float dt = sdt[s][cl], xv = sx[s][cl], dyv = sdy[s][cl];
        const float4 bq = sbc[s][g], cq = sbc[s][kN / 4 + g];
        const float bt[kPer] = {bq.x, bq.y, bq.z, bq.w};
        const float ct[kPer] = {cq.x, cq.y, cq.z, cq.w};
        const float dtx = dt * xv;
        float u = 0.0f, q = 0.0f, v[2 * kPer];
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const float at = ex2(dt * a2[k]);
          gr[k] = fmaf(dyv, ct[k], gr[k]);                 // g_t
          const float gh = gr[k] * (hs[s][k] * at);        // g_t h_{t-1} a_t
          dA[k] = fmaf(gh, dt, dA[k]);
          q = fmaf(gh, A[k], q);
          u = fmaf(gr[k], bt[k], u);
          v[k] = gr[k] * dtx;                              // dB_t's term
          v[kPer + k] = dyv * hs[s + 1][k];                // dC_t's term
          gr[k] *= at;                                     // g_t a_t: step t - 1's carry
        }
        dD = fmaf(dyv, xv, dD);
        vu[i] = u;
        vq[i] = q;
        // this warp's sum over its 8 channels of one of the 32 values
        const float tot = channel_sums(v, lane);
        const int idx = ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
        spart[warp][s][(idx < kPer ? 0 : kN) + kPer * g + (idx % kPer)] = tot;
      }
      const float u = lane_sums(vu, g), q = lane_sums(vq, g);
      const int s = s0 + g;
      if (live && t0 + s < a.S) {
        const float dt = sdt[s][cl], xv = sx[s][cl];
        const long long o = ((long long)b * a.S + t0 + s) * a.di + d;
        a.ddt[o] = fmaf(u, xv, q);
        store_x(dxg + o, fmaf(u, dt, sdy[s][cl] * Dd));
      }
    }
    __syncthreads();
    // the block's sum over its warps, in order, of each (step, value)
    for (int p = tid; p < kChunk * 2 * kN; p += kThreads) {
      const int s = p / (2 * kN), j = p % (2 * kN);
      if (t0 + s < a.S) {
        float tot = spart[0][s][j];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) tot += spart[w][s][j];
        a.part_bc[(((long long)blockIdx.x * a.B + b) * a.S + t0 + s) * (2 * kN) + j] = tot;
      }
    }
  }

  if (live) {
    const long long o = ((long long)b * a.di + d) * kN + kPer * g;
    *reinterpret_cast<float4*>(a.dh0 + o) = make_float4(gr[0], gr[1], gr[2], gr[3]);
    *reinterpret_cast<float4*>(a.part_a + o) = make_float4(dA[0], dA[1], dA[2], dA[3]);
    if (g == 0) a.part_d[(long long)b * a.di + d] = dD;
  }
}

// The second launch: dB, dC (B, S, kN) summed over the nblk channel blocks,
// dA (di, kN) and dD (di) over b, each in order
__global__ void __launch_bounds__(kReduceThreads) scan_bwd_reduce_kernel(
    const float* part_bc, const float* part_a, const float* part_d, float* dB, float* dC,
    float* dA, float* dD, int B, int S, int di, int nblk) {
  const long long n_bc = (long long)B * S * 2 * kN, n_a = (long long)di * kN;
  const long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i < n_bc) {
    float tot = part_bc[i];
    for (int k = 1; k < nblk; ++k) tot += part_bc[(long long)k * n_bc + i];
    const long long bt = i / (2 * kN);
    const int j = (int)(i % (2 * kN));
    (j < kN ? dB : dC)[bt * kN + j % kN] = tot;
  } else if (i < n_bc + n_a) {
    const long long e = i - n_bc;
    float tot = part_a[e];
    for (int k = 1; k < B; ++k) tot += part_a[(long long)k * n_a + e];
    dA[e] = tot;
  } else if (i < n_bc + n_a + di) {
    const long long e = i - n_bc - n_a;
    float tot = part_d[e];
    for (int k = 1; k < B; ++k) tot += part_d[(long long)k * di + e];
    dD[e] = tot;
  }
}

}  // namespace

// the steps a chunk, which must be the forward's states interval
extern "C" int selective_scan_bwd_chunk() { return kChunk; }

// dt, x, dy: (B, S, di) with unit stride over di and the given element
// strides over (b, t); x float32 or (x_bf16) bf16, the rest float32.  Bm,
// Cm: (B, S, N) with unit stride over N.  A (di, N), D (di), h0, dhT, dh0
// (B, di, N) contiguous on 16 bytes; states null (S <= 16) or (B, ceil(S /
// 16), di, N) from selective_scan_launch.  Writes ddt and dx (B, S, di)
// contiguous (dx in x's type), dB and dC (B, S, N), dA (di, N), dD (di),
// dh0.  Scratch (float32, contiguous): part_bc (ceil(di / 64), B, S, 2 N),
// part_a (B, di, N), part_d (B, di).  N must be 16.  Two launches on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int selective_scan_bwd_launch(
    const void* dt, const void* x, const void* Bm, const void* Cm, const void* A,
    const void* D, const void* h0, const void* dy, const void* dhT, const void* states,
    void* ddt, void* dx, void* dB, void* dC, void* dA, void* dD, void* dh0,
    void* part_bc, void* part_a, void* part_d, int B, int S, int di, int N, int x_bf16,
    long long dt_sb, long long dt_ss, long long x_sb, long long x_ss, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, long long dy_sb, long long dy_ss,
    void* stream) {
  if (N != kN || B <= 0 || B > 65535 || S <= 0 || di <= 0 || (!states && S > kChunk))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.dt = static_cast<const float*>(dt);
  a.x = x;
  a.Bm = static_cast<const float*>(Bm);
  a.Cm = static_cast<const float*>(Cm);
  a.A = static_cast<const float*>(A);
  a.D = static_cast<const float*>(D);
  a.h0 = static_cast<const float*>(h0);
  a.dy = static_cast<const float*>(dy);
  a.dhT = static_cast<const float*>(dhT);
  a.states = static_cast<const float*>(states);
  a.ddt = static_cast<float*>(ddt);
  a.dx = dx;
  a.dh0 = static_cast<float*>(dh0);
  a.part_bc = static_cast<float*>(part_bc);
  a.part_a = static_cast<float*>(part_a);
  a.part_d = static_cast<float*>(part_d);
  a.B = B;
  a.S = S;
  a.di = di;
  a.dt_sb = dt_sb; a.dt_ss = dt_ss; a.x_sb = x_sb; a.x_ss = x_ss;
  a.b_sb = b_sb; a.b_ss = b_ss; a.c_sb = c_sb; a.c_ss = c_ss;
  a.dy_sb = dy_sb; a.dy_ss = dy_ss;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nblk = (di + kChannels - 1) / kChannels;
  const dim3 grid(nblk, B);
  if (x_bf16)
    scan_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(a);
  else
    scan_bwd_kernel<float><<<grid, kThreads, 0, st>>>(a);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long total = (long long)B * S * 2 * kN + (long long)di * kN + di;
  scan_bwd_reduce_kernel<<<(unsigned)((total + kReduceThreads - 1) / kReduceThreads),
                           kReduceThreads, 0, st>>>(static_cast<const float*>(part_bc),
                           static_cast<const float*>(part_a),
                           static_cast<const float*>(part_d), static_cast<float*>(dB),
                           static_cast<float*>(dC), static_cast<float*>(dA),
                           static_cast<float*>(dD), B, S, di, nblk);
  return (int)cudaGetLastError();
}
