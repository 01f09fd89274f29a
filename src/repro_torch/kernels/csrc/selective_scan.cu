// Mamba's selective scan on Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference runs this recurrence as a
// `lax.scan` over time in src/repro/models/mamba.py (`mamba_apply`, and the
// single step of `mamba_decode`), which eager PyTorch would run as a loop
// of several launches a step or through (B, S, d_inner, d_state) tensors
// of exp(dt A) and (dt x) B (8.6 GB each in float32 at jamba's prefill).
// Per (batch b, channel d), with the state h (kN = 16 values) from h0:
//
//     h_n   <- h_n * exp(dt_t A[d][n]) + (dt_t x_t) B_t[n]
//     y_t    = sum_n h_n C_t[n] + x_t D[d]
//
// for dt (B, S, di) float32, x (B, S, di) float32 or bf16, B_t and C_t
// (B, S, kN) float32, A (di, kN), D (di), h0 (B, di, kN) float32; it writes
// y (B, S, di) float32 and h_T (B, di, kN) float32.
//
// Design.  The recurrence is elementwise over channels, so one thread owns
// one (b, d) and keeps its kN states and its row of A in registers; a block
// is kThreads consecutive channels of one b.  Time runs in chunks of kChunk
// steps: the block stages the chunk's B_t and C_t (shared by all its
// channels) in shared memory, and each thread loads its own dt and x for
// the chunk into registers first (kChunk independent loads in flight, each
// coalesced over the block's channels), then walks the steps.  y is written
// once, coalesced; h0 and h_T are read and written once.
//
// Bound on the H100: operations.  At jamba's prefill (2, 4096, 16384, 16)
// the function must read dt (537 MB) and x in bf16 (268 MB) and write y
// (537 MB), 0.40 ms at 3.35 TB/s; its B S di kN = 2.1 G exponentials take
// 0.51 ms of the SFUs (16 a clock an SM, 132 SMs at 1.98 GHz), beside
// about 7 flops each on the CUDA cores (0.22 ms at 67 TFLOP/s).  This
// simple design spends one exp per state a step, as the function does; it
// has B di / kThreads blocks (256 at that shape), two a SM, which is
// enough for an SFU-bound loop whose loads are batched a chunk at a time.
// Decode (S = 1) moves only the state, 4.2 MB, below the launch floor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kN = 16;        // d_state: the wrapper refuses any other
constexpr int kThreads = 128;
constexpr int kChunk = 32;

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename XT>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const float* __restrict__ dt, const XT* __restrict__ x,
    const float* __restrict__ Bm, const float* __restrict__ Cm,
    const float* __restrict__ A, const float* __restrict__ D,
    const float* __restrict__ h0, float* __restrict__ y, float* __restrict__ hT,
    int S, int di, long long dt_sb, long long dt_ss, long long x_sb, long long x_ss,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss,
    long long y_sb, long long y_ss) {
  __shared__ float sB[kChunk][kN];
  __shared__ float sC[kChunk][kN];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool live = d < di;
  const int dd = live ? d : 0;        // dead lanes read channel 0, store nothing

  float a[kN], h[kN];
  const float4* a4 = reinterpret_cast<const float4*>(A + (long long)dd * kN);
  const float4* h4 = reinterpret_cast<const float4*>(h0 + ((long long)b * di + dd) * kN);
#pragma unroll
  for (int i = 0; i < kN / 4; ++i) {
    const float4 av = a4[i], hv = h4[i];
    a[4 * i] = av.x; a[4 * i + 1] = av.y; a[4 * i + 2] = av.z; a[4 * i + 3] = av.w;
    h[4 * i] = hv.x; h[4 * i + 1] = hv.y; h[4 * i + 2] = hv.z; h[4 * i + 3] = hv.w;
  }
  const float Dd = D[dd];

  const float* dt_b = dt + b * dt_sb + dd;
  const XT* x_b = x + b * x_sb + dd;
  const float* B_b = Bm + b * b_sb;
  const float* C_b = Cm + b * c_sb;
  float* y_b = y + b * y_sb + dd;

  for (int t0 = 0; t0 < S; t0 += kChunk) {
    const int n = min(kChunk, S - t0);
    __syncthreads();                  // the last chunk's B and C are read
    for (int i = threadIdx.x; i < 2 * kChunk * kN; i += kThreads) {
      const int s = (i / kN) % kChunk, k = i % kN;
      const bool is_c = i >= kChunk * kN;
      float v = 0.0f;
      if (s < n) {
        const long long t = t0 + s;
        v = is_c ? C_b[t * c_ss + k] : B_b[t * b_ss + k];
      }
      (is_c ? sC : sB)[s][k] = v;
    }
    float dts[kChunk], xs[kChunk];
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const long long t = t0 + s;
      dts[s] = s < n ? dt_b[t * dt_ss] : 0.0f;
      xs[s] = s < n ? load_x(x_b + t * x_ss) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      if (s < n) {
        const float dx = dts[s] * xs[s];
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          h[k] = h[k] * expf(dts[s] * a[k]) + dx * sB[s][k];
          acc += h[k] * sC[s][k];
        }
        if (live) y_b[(t0 + s) * y_ss] = acc + xs[s] * Dd;
      }
    }
  }

  if (live) {
    float4* o4 = reinterpret_cast<float4*>(hT + ((long long)b * di + d) * kN);
#pragma unroll
    for (int i = 0; i < kN / 4; ++i)
      o4[i] = make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
  }
}

}  // namespace

// dt, x: (B, S, di) with unit stride over di and the given element strides
// over (b, t); x float32 or (x_bf16) bf16, the rest float32.  Bm, Cm: (B,
// S, N) with unit stride over N; y (B, S, di) likewise (written).  A (di,
// N), D (di), h0 and hT (B, di, N) contiguous.  N must be 16.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int selective_scan_launch(
    const void* dt, const void* x, const void* Bm, const void* Cm, const void* A,
    const void* D, const void* h0, void* y, void* hT, int B, int S, int di, int N,
    int x_bf16, long long dt_sb, long long dt_ss, long long x_sb, long long x_ss,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss, long long y_sb,
    long long y_ss, void* stream) {
  if (N != kN || B <= 0 || B > 65535 || S < 0 || di <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((di + kThreads - 1) / kThreads, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_B = static_cast<const float*>(Bm);
  const float* f_C = static_cast<const float*>(Cm);
  const float* f_A = static_cast<const float*>(A);
  const float* f_D = static_cast<const float*>(D);
  const float* f_h0 = static_cast<const float*>(h0);
  float* f_y = static_cast<float*>(y);
  float* f_hT = static_cast<float*>(hT);
  if (x_bf16)
    selective_scan_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        f_dt, static_cast<const __nv_bfloat16*>(x), f_B, f_C, f_A, f_D, f_h0, f_y, f_hT,
        S, di, dt_sb, dt_ss, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, y_sb, y_ss);
  else
    selective_scan_kernel<float><<<grid, kThreads, 0, st>>>(
        f_dt, static_cast<const float*>(x), f_B, f_C, f_A, f_D, f_h0, f_y, f_hT,
        S, di, dt_sb, dt_ss, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, y_sb, y_ss);
  return (int)cudaGetLastError();
}
