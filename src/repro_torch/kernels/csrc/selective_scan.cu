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
// Bound on the H100: operations.  At jamba's prefill (2, 4096, 16384, 16)
// the function must read dt (537 MB) and x in bf16 (268 MB) and write y
// (537 MB), 0.40 ms at 3.35 TB/s; its B S di kN = 2.1 G exponentials take
// 0.51 ms of the SFUs (16 a clock an SM, 132 SMs at 1.98 GHz), beside
// about 6 flops each on the CUDA cores (0.19 ms at 67 TFLOP/s).  The walk
// is serial in time and elementwise over channels; the design keeps the
// SMs issuing math rather than waiting or computing addresses:
//   * Four lanes a channel, kPer = 4 states a lane: a block is kChannels =
//     64 channels of one b in 256 threads, so jamba's prefill is 512 blocks,
//     four an SM at once (at most 64 registers a thread), 32 warps.  A
//     lane keeps its 4 states and A[d][4g .. 4g + 3] log2(e) in registers.
//     y_t is the 4 lanes' partial sums, reduced kLanes steps at a time by
//     a reduce-scatter of shuffles (three a group, the same order on every
//     run), after which lane g holds step g's y and stores it.
//   * One SFU op an exponential: exp(dt A) = ex2.approx(dt (A log2 e)), one
//     FMUL and one MUFU (the accurate expf is about eight more).
//   * Time in chunks of kChunk steps staged in shared memory, a ring of
//     kBufs buffers: dt, B_t and C_t go in by cp.async a chunk ahead of the
//     walk (issued before it), x (bf16 has no 2-byte cp.async) through
//     registers two chunks ahead; one __syncthreads a chunk.  (A ring of 4,
//     copies three chunks ahead, measured no faster: kernel_ablation.py.)
//     Steps past S are staged as zeros, which leave h as it is, so the walk
//     has no branch a step.
//   * Every address in the loop advances by a pointer step: indexing by
//     t * stride costs about as many instructions in 64-bit address
//     arithmetic (and kernel parameters reloaded under the 64-register
//     budget) as the recurrence itself.
//   * S <= kDecodeMaxS (decode: S = 1) takes another kernel, one instance
//     per S, of the same layout with no shared memory and no barrier: every
//     load of the call (A, h0, D, and each step's dt, x, B_t, C_t) is
//     issued at once, then the walk, then the stores: one memory round
//     trip.  The C entry point picks by S; either way one launch a call.
//   * For the gradient (csrc/selective_scan_bwd.cu), the chunked form can
//     also store the state every kStatesEvery = 8 steps starts from, states
//     (B, ceil(S / kStatesEvery), di, kN) float32 (1.07 GB at jamba's
//     prefill): a separate instance (kStates), whose walk is the same
//     arithmetic, so y and h_T are those of the call without states, bit
//     for bit.  The backward holds a span of kStatesEvery steps' states and
//     exponentials in registers, which 16 steps would not fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;                      // d_state: the wrapper refuses any other
constexpr int kLanes = 4;                   // lanes a channel
constexpr int kPer = kN / kLanes;           // states a lane
constexpr int kChannels = 64;               // channels a block
constexpr int kThreads = kChannels * kLanes;
constexpr int kBlocksPerSM = 4;             // blocks an SM at once (the register budget)
constexpr int kChunk = 16;                  // steps a staged chunk
constexpr int kStatesEvery = 8;             // the states interval (kStates)
constexpr int kBufs = 2;                    // chunks staged at once: the walk's and the next
constexpr int kDecodeMaxS = 4;              // S up to this takes the decode form
constexpr float kLog2e = 1.4426950408889634f;
// each thread's share of a chunk's copies
constexpr int kTileLoads = kChunk * kChannels / kThreads;   // dt, and x
constexpr int kBcLoads = kChunk * 2 * kN / kThreads;        // B_t and C_t
static_assert(kChunk * kChannels % kThreads == 0 && kChunk * 2 * kN % kThreads == 0 &&
              kChunk % kLanes == 0 && kDecodeMaxS % kLanes == 0 && kPer % 4 == 0 &&
              kChunk % kStatesEvery == 0 && kStatesEvery % kLanes == 0, "");

struct Args {
  const float *dt, *Bm, *Cm, *A, *D, *h0;
  const void* x;
  float *y, *hT, *states;
  int S, di;
  long long dt_sb, dt_ss, x_sb, x_ss, b_sb, b_ss, c_sb, c_ss, y_sb, y_ss;
};

__device__ __forceinline__ float load_x(const float* p) { return *p; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a 4-byte copy into shared memory that bypasses registers; zeros when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int N>
struct Int {
  static constexpr int value = N;
};

// this thread's place: channel cl of the block's kChannels and state group
// g (states kPer g .. kPer g + kPer - 1); the lanes of a channel are
// adjacent, so the y sum is a shuffle by kLanes / 2, ..., 1
struct Lane {
  int cl, g, d;
  bool live;
  __device__ Lane(int di) {
    const int lane = threadIdx.x % 32;
    cl = (threadIdx.x / 32) * (32 / kLanes) + lane / kLanes;
    g = lane % kLanes;
    d = blockIdx.x * kChannels + cl;
    live = d < di;
  }
};

// a lane's part of the walk: its states, its row of A in log2 units, and D
// on lane 0 (0 on the others, so y_t's skip term is added once)
struct Walker {
  float h[kPer], a2[kPer], Dl;

  __device__ __forceinline__ Walker(const Args& a, const Lane& ln, int b) {
    const long long row = ln.live ? ln.d : 0;
    const float4* av = reinterpret_cast<const float4*>(a.A + row * kN + kPer * ln.g);
    const float4* hv = reinterpret_cast<const float4*>(
        a.h0 + ((long long)b * a.di + row) * kN + kPer * ln.g);
#pragma unroll
    for (int i = 0; i < kPer / 4; ++i) {
      const float4 x = av[i], y = hv[i];
      a2[4 * i] = x.x * kLog2e; a2[4 * i + 1] = x.y * kLog2e;
      a2[4 * i + 2] = x.z * kLog2e; a2[4 * i + 3] = x.w * kLog2e;
      h[4 * i] = y.x; h[4 * i + 1] = y.y; h[4 * i + 2] = y.z; h[4 * i + 3] = y.w;
    }
    Dl = ln.g == 0 ? a.D[row] : 0.0f;
  }

  // one step: the states, and this lane's partial sum of y_t
  __device__ __forceinline__ float step(float dt, float x, const float* bt, const float* ct) {
    const float dx = dt * x;
    float acc = x * Dl;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      h[k] = fmaf(h[k], ex2(dt * a2[k]), dx * bt[k]);
      acc = fmaf(h[k], ct[k], acc);
    }
    return acc;
  }

  // this lane's states into row ln.d of a (rows, kN) float32 array
  __device__ __forceinline__ void store_row(float* base, const Lane& ln) const {
    if (!ln.live) return;
    float4* o = reinterpret_cast<float4*>(base + (long long)ln.d * kN + kPer * ln.g);
#pragma unroll
    for (int i = 0; i < kPer / 4; ++i)
      o[i] = make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
  }

  __device__ __forceinline__ void store(const Args& a, const Lane& ln, int b) const {
    if (!ln.live) return;
    float4* o = reinterpret_cast<float4*>(a.hT + ((long long)b * a.di + ln.d) * kN + kPer * ln.g);
#pragma unroll
    for (int i = 0; i < kPer / 4; ++i)
      o[i] = make_float4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
  }
};

// the partial sums v[i] of kLanes consecutive steps on each lane of a
// channel: lane g comes back with step g's total (a reduce-scatter by
// shuffles, halving the steps each round)
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

template <typename XT, bool kStates>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) scan_chunked_kernel(const Args a) {
  __shared__ float2 sdx[kBufs][kChunk][kChannels];       // (dt, x)
  __shared__ float sbc[kBufs][kChunk][2 * kN];           // B_t, then C_t
  const int b = blockIdx.y, tid = threadIdx.x;
  const Lane ln(a.di);
  Walker w(a, ln, b);
  const int nchunks = (a.S + kChunk - 1) / kChunk;
  // the states rows: the state before step r kStatesEvery, r < nrows
  float* const st_base =
      kStates ? a.states + (long long)b * ((a.S + kStatesEvery - 1) / kStatesEvery) * a.di * kN
              : nullptr;

  // Every address below advances by a pointer step: no index arithmetic
  // in the loop.  The loader copies channel lc at steps ls + j kRowStep of
  // a chunk (dt by cp.async, x through registers), and element (sb, k) of
  // B_t | C_t at steps sb + j kBcStep.
  constexpr int kRowStep = kThreads / kChannels, kBcStep = kThreads / (2 * kN);
  const int lc = tid % kChannels, ls = tid / kChannels;
  const bool lc_live = blockIdx.x * kChannels + lc < a.di;
  const int sb = tid / (2 * kN), kb = tid % (2 * kN);
  const long long bc_ss = kb < kN ? a.b_ss : a.c_ss;
  const float* bc_src = (kb < kN ? a.Bm + b * a.b_sb + kb : a.Cm + b * a.c_sb + kb - kN) +
                        sb * bc_ss;
  const float* dt_src = a.dt + b * a.dt_sb + blockIdx.x * kChannels + lc + ls * a.dt_ss;
  const XT* x_src =
      static_cast<const XT*>(a.x) + b * a.x_sb + blockIdx.x * kChannels + lc + ls * a.x_ss;
  // lane g stores y of step s0 + g of each group of kLanes steps
  float* y_dst = a.y + b * a.y_sb + ln.d + ln.g * a.y_ss;
  const long long dt_step = kRowStep * a.dt_ss, x_step = kRowStep * a.x_ss,
                  bc_step = kBcStep * bc_ss, y_step = kLanes * a.y_ss;

  // dt, B_t and C_t of chunk c (the next one in order) into its buffer by
  // cp.async; steps past S are zeros: dt = 0 and B_t = 0 leave h as it is
  // (h e^0 + 0), and such steps store nothing
  auto copy = [&](int c) {
    const int n = min(kChunk, a.S - c * kChunk), buf = c % kBufs;
    const float* p = dt_src;
#pragma unroll
    for (int j = 0; j < kTileLoads; ++j, p += dt_step)
      cp_async4(&sdx[buf][ls + j * kRowStep][lc].x, p, lc_live && ls + j * kRowStep < n);
    p = bc_src;
#pragma unroll
    for (int j = 0; j < kBcLoads; ++j, p += bc_step)
      cp_async4(&sbc[buf][sb + j * kBcStep][kb], p, sb + j * kBcStep < n);
    dt_src += kChunk * a.dt_ss;
    bc_src += kChunk * bc_ss;
  };
  // x of the next chunk in order (no 2-byte cp.async: through registers)
  float xr[2][kTileLoads];
  auto load_x_chunk = [&](float (&r)[kTileLoads], int c) {
    const int n = min(kChunk, a.S - c * kChunk);
    const XT* p = x_src;
#pragma unroll
    for (int j = 0; j < kTileLoads; ++j, p += x_step)
      r[j] = lc_live && ls + j * kRowStep < n ? load_x(p) : 0.0f;
    x_src += kChunk * a.x_ss;
  };
  auto stage_x = [&](const float (&r)[kTileLoads], int c) {
#pragma unroll
    for (int j = 0; j < kTileLoads; ++j) sdx[c % kBufs][ls + j * kRowStep][lc].y = r[j];
  };

  // dt, B, C run kBufs - 1 chunks ahead of the walk, x 2: chunk c's walk
  // finds chunk c + 1 staged after it, copies c + kBufs - 1, and loads the
  // x of c + 2 into the register set c % 2, staged after the walk of c + 1
#pragma unroll
  for (int c = 0; c < kBufs - 1; ++c) {
    if (c < nchunks) copy(c);
    cp_async_commit();
  }
  load_x_chunk(xr[0], 0);
  stage_x(xr[0], 0);
  load_x_chunk(xr[1], 1);
  cp_async_wait<kBufs - 2>();
  __syncthreads();

  auto chunk = [&](int c, auto parity) {
    constexpr int p = decltype(parity)::value;      // c % 2
    const int buf = c % kBufs, t0 = c * kChunk;
    // the state chunk c starts from, for the gradient
    if constexpr (kStates) w.store_row(st_base + (long long)(t0 / kStatesEvery) * a.di * kN, ln);
    // the buffer of c + kBufs - 1 was last read in the walk of c - 1
    if (c + kBufs - 1 < nchunks) copy(c + kBufs - 1);
    cp_async_commit();
    if (c + 2 < nchunks) load_x_chunk(xr[p], c + 2);
    const float2* dx_row = &sdx[buf][0][ln.cl];
    const float4* bc_row = reinterpret_cast<const float4*>(&sbc[buf][0][kPer * ln.g]);
#pragma unroll
    for (int s0 = 0; s0 < kChunk; s0 += kLanes) {
      float v[kLanes];
#pragma unroll
      for (int i = 0; i < kLanes; ++i) {
        const float2 dx = dx_row[(s0 + i) * kChannels];
        float bt[kPer], ct[kPer];
#pragma unroll
        for (int q = 0; q < kPer / 4; ++q) {
          const float4 bq = bc_row[(s0 + i) * (2 * kN / 4) + q];
          const float4 cq = bc_row[(s0 + i) * (2 * kN / 4) + kN / 4 + q];
          bt[4 * q] = bq.x; bt[4 * q + 1] = bq.y; bt[4 * q + 2] = bq.z; bt[4 * q + 3] = bq.w;
          ct[4 * q] = cq.x; ct[4 * q + 1] = cq.y; ct[4 * q + 2] = cq.z; ct[4 * q + 3] = cq.w;
        }
        v[i] = w.step(dx.x, dx.y, bt, ct);
      }
      const float yt = lane_sums(v, ln.g);
      if (ln.live && t0 + s0 + ln.g < a.S) *y_dst = yt;
      y_dst += y_step;
      // the state a states row starts from, inside the chunk
      const int t1 = s0 + kLanes;
      if (kStates && t1 % kStatesEvery == 0 && t1 < kChunk && t0 + t1 < a.S)
        w.store_row(st_base + (long long)((t0 + t1) / kStatesEvery) * a.di * kN, ln);
    }
    // the buffer of c + 1 was last read in the walk of c + 1 - kBufs
    if (c + 1 < nchunks) stage_x(xr[1 - p], c + 1);
    cp_async_wait<kBufs - 2>();                     // c + 1's copies are in
    __syncthreads();
  };
  for (int c = 0; c < nchunks; c += 2) {
    chunk(c, Int<0>{});
    if (c + 1 < nchunks) chunk(c + 1, Int<1>{});
  }
  w.store(a, ln, b);
}

// S = NS <= kDecodeMaxS: every load issued up front, no shared memory, no
// barrier
template <int NS, typename XT>
__global__ void __launch_bounds__(kThreads) scan_decode_kernel(const Args a) {
  // NS steps, padded with no-op steps to whole groups of kLanes (at least one)
  constexpr int kSteps = NS == 0 ? kLanes : (NS + kLanes - 1) / kLanes * kLanes;
  const int b = blockIdx.y;
  const Lane ln(a.di);
  const long long dd = ln.live ? ln.d : 0;     // dead lanes read channel 0, store nothing
  const XT* x = static_cast<const XT*>(a.x);
  Walker w(a, ln, b);
  float dts[kSteps], xs[kSteps], bt[kSteps][kPer], ct[kSteps][kPer];
#pragma unroll
  for (int t = 0; t < kSteps; ++t) {
    const bool ok = t < NS;                      // zeros past S: no-op steps
    dts[t] = ok ? a.dt[b * a.dt_sb + t * a.dt_ss + dd] : 0.0f;
    xs[t] = ok ? load_x(x + b * a.x_sb + t * a.x_ss + dd) : 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      bt[t][k] = ok ? a.Bm[b * a.b_sb + t * a.b_ss + kPer * ln.g + k] : 0.0f;
      ct[t][k] = ok ? a.Cm[b * a.c_sb + t * a.c_ss + kPer * ln.g + k] : 0.0f;
    }
  }
#pragma unroll
  for (int s0 = 0; s0 < kSteps; s0 += kLanes) {
    float v[kLanes];
#pragma unroll
    for (int i = 0; i < kLanes; ++i) v[i] = w.step(dts[s0 + i], xs[s0 + i], bt[s0 + i], ct[s0 + i]);
    const float yt = lane_sums(v, ln.g);
    const int t = s0 + ln.g;
    if (ln.live && t < NS) a.y[b * a.y_sb + t * a.y_ss + ln.d] = yt;
  }
  w.store(a, ln, b);
}

template <typename XT>
int launch(const Args& a, int B, cudaStream_t st) {
  const dim3 grid((a.di + kChannels - 1) / kChannels, B);
  if (a.states) {
    scan_chunked_kernel<XT, true><<<grid, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  switch (a.S) {
    case 0: scan_decode_kernel<0, XT><<<grid, kThreads, 0, st>>>(a); break;
    case 1: scan_decode_kernel<1, XT><<<grid, kThreads, 0, st>>>(a); break;
    case 2: scan_decode_kernel<2, XT><<<grid, kThreads, 0, st>>>(a); break;
    case 3: scan_decode_kernel<3, XT><<<grid, kThreads, 0, st>>>(a); break;
    case 4: scan_decode_kernel<4, XT><<<grid, kThreads, 0, st>>>(a); break;
    default: scan_chunked_kernel<XT, false><<<grid, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dt, x: (B, S, di) with unit stride over di and the given element strides
// over (b, t); x float32 or (x_bf16) bf16, the rest float32.  Bm, Cm: (B,
// S, N) with unit stride over N; y (B, S, di) likewise (written).  A (di,
// N), D (di), h0 and hT (B, di, N) contiguous, A, h0 and hT on 16 bytes.
// N must be 16.  states: null, or (B, ceil(S / kStatesEvery), di, N)
// float32 contiguous on 16 bytes, written with the state before every
// kStatesEvery-th step (S > kDecodeMaxS only).  Launches one kernel on `stream` (the decode form
// for S <= 4 without states, else the chunked one above) and returns
// cudaGetLastError() (0 on success).
extern "C" int selective_scan_launch(
    const void* dt, const void* x, const void* Bm, const void* Cm, const void* A,
    const void* D, const void* h0, void* y, void* hT, void* states, int B, int S,
    int di, int N,
    int x_bf16, long long dt_sb, long long dt_ss, long long x_sb, long long x_ss,
    long long b_sb, long long b_ss, long long c_sb, long long c_ss, long long y_sb,
    long long y_ss, void* stream) {
  if (N != kN || B <= 0 || B > 65535 || S < 0 || di <= 0 ||
      (states && S <= kDecodeMaxS))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.dt = static_cast<const float*>(dt);
  a.x = x;
  a.Bm = static_cast<const float*>(Bm);
  a.Cm = static_cast<const float*>(Cm);
  a.A = static_cast<const float*>(A);
  a.D = static_cast<const float*>(D);
  a.h0 = static_cast<const float*>(h0);
  a.y = static_cast<float*>(y);
  a.hT = static_cast<float*>(hT);
  a.states = static_cast<float*>(states);
  a.S = S;
  a.di = di;
  a.dt_sb = dt_sb; a.dt_ss = dt_ss; a.x_sb = x_sb; a.x_ss = x_ss;
  a.b_sb = b_sb; a.b_ss = b_ss; a.c_sb = c_sb; a.c_ss = c_ss;
  a.y_sb = y_sb; a.y_ss = y_ss;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(a, B, st) : launch<float>(a, B, st);
}

// the steps between two rows of states
extern "C" int selective_scan_states_every() { return kStatesEvery; }
