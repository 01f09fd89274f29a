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
// B S di kN = 2.1 G exponentials take 0.51 ms of the SFUs.  What binds it
// is the instruction stream: about 14 float32 operations a state a step
// (recompute 5, walk 9) and 5.5 more for the sums over channels and over
// states, issued at 16 warps an SM.  The design:
//   * The forward's grid: a block is kChannels = 64 channels of one b, four
//     lanes a channel, four states a lane.  It walks spans of kStatesEvery
//     = 8 steps in reverse.  Each span starts from the state the forward
//     stored there (`states`, (B, ceil(S / 8), di, kN); h0 when S <= 8); a
//     forward pass recomputes the span's 8 states into registers (32 a
//     lane) with the forward's arithmetic, so they are the forward's bit for
//     bit, then a backward pass walks the steps with g in registers.  16-step
//     spans would need 64 registers for the states alone.
//   * Each pass takes its own exponential (the same ex2 of the same product,
//     so the same bits): the walk's second one costs 2 instructions a state
//     a step, while keeping the first ones costs more (kernel_ablation.py:
//     in registers the kernel spills, in shared memory it waits on it).
//   * Staging one span ahead: the next span's dt and dy (cp.async, into one
//     float4 (dt, x, dy, -) a channel a step) and B_t | C_t go in while a
//     span is walked, x through registers, the next span's start state
//     into registers; one __syncthreads a span.  Steps past S are staged
//     as zeros: a zero step leaves h and g as they are.
//   * dB_t and dC_t sum over all channels, with no atomics and in a fixed
//     order.  A lane's slot k holds state 4 g + (k ^ p), p its lane bits 4
//     and 3: B_t | C_t are staged in the four slot orders, side by side
//     (256 bytes a step, no bank conflict), so the warp's sum over its 8
//     channels is a reduce-scatter without selects (two, one, one shuffle
//     a kind a step, four steps at a time; dC_t in the forward pass, dB_t
//     in the backward one).  Each warp writes its 32 sums a step to shared
//     memory; after the span's barrier the block sums its 8 warps in order
//     and writes one partial a (b, t, n) to part_bc (nblk, B, S, 2 kN).
//   * u_t and the sum over n for ddt_t: the four lanes' partial sums,
//     reduced four steps at a time by the forward's shuffle reduce-scatter;
//     ddt and dx go through shared memory and out in 16-byte stores of
//     four channels.  dA and dD: each lane sums its steps in registers, in
//     order, into part_a (B, di, kN) and part_d (B, di).  A second launch
//     of this source (scan_bwd_reduce_kernel) sums the partials over the
//     blocks and over b in a fixed order.  Two runs give the same bits.

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
constexpr int kStatesEvery = 8;             // steps a span: the forward's states interval
constexpr int kSpans = 2;                   // spans a staged chunk
constexpr int kChunk = kSpans * kStatesEvery;
constexpr int kBufs = 2;                    // chunks staged at once: the walk's and the next
constexpr int kPerms = 4;                   // slot orders p of B_t | C_t
constexpr int kReduceThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// each thread's share of a chunk's copies: dt, dy and x at steps ls + j
// kRowStep; element kb of B_t | C_t at steps sb + j kBcStep; and of its
// block sums
constexpr int kRowStep = kThreads / kChannels;
constexpr int kTileLoads = kChunk / kRowStep;
constexpr int kBcStep = kThreads / (2 * kN);
constexpr int kBcLoads = kChunk / kBcStep;
// the staged outputs: a row of kChannels, padded so that the four steps a
// warp writes at once fall on distinct banks
constexpr int kOutPad = kChannels + 8;
static_assert(kPer == 4 && kStatesEvery % kLanes == 0 && kChunk % kRowStep == 0 &&
              kChunk % kBcStep == 0 && 32 / kLanes == 8 && kPerms == 4, "");

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// v[i]: this lane's terms of its kPer slots at kLanes steps i, slot k
// holding state 4 g + (k ^ p) (p = lane bits 4, 3).  Lanes 16 apart hold
// the same states in slots that differ by 2, lanes 8 apart by 1, so each
// round keeps slot j and adds the partner's slot j + half: tot[i] is the
// sum over the warp's 8 channels of the state in slot 0 (4 g + p) at step
// i, the same bits on both lanes of each pair 4 apart (the tree ((c0 + c4)
// + (c2 + c6)) + ((c1 + c5) + (c3 + c7)) over the warp's channels, taken
// in an order that commutes).  The steps' rounds interleave.
__device__ __forceinline__ void channel_sums(float (&v)[kLanes][kPer], float (&tot)[kLanes]) {
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    v[i][0] += __shfl_xor_sync(0xffffffffu, v[i][2], 16);
    v[i][1] += __shfl_xor_sync(0xffffffffu, v[i][3], 16);
  }
#pragma unroll
  for (int i = 0; i < kLanes; ++i) v[i][0] += __shfl_xor_sync(0xffffffffu, v[i][1], 8);
#pragma unroll
  for (int i = 0; i < kLanes; ++i) tot[i] = v[i][0] + __shfl_xor_sync(0xffffffffu, v[i][0], 4);
}

// a chunk's staged ddt and dx rows to device memory: four channels a
// thread, one 16-byte (ddt, float32 dx) or 8-byte (bf16 dx) store when the
// row allows it, else one element a store
__device__ __forceinline__ void store4(float* p, float4 v, bool vec, int n) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
  for (int i = 0; i < n; ++i) p[i] = e[i];
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v, bool vec, int n) {
  if (vec) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 w;
    w.x = *reinterpret_cast<const uint32_t*>(&lo);
    w.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = w;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
  for (int i = 0; i < n; ++i) p[i] = __float2bfloat16_rn(e[i]);
}

// the block's shared memory (dynamic: sizeof(Smem) passes the default 48 KB)
struct Smem {
  float4 dxy[kBufs][kChunk][kChannels];          // (dt, x, dy, -) a channel a step
  float4 bq[kBufs][kChunk][kPerms * kPer];       // B_t in each slot order, side by side
  float4 cq[kBufs][kChunk][kPerms * kPer];       // C_t likewise
  float part[kBufs][kWarps][kChunk][2 * kN];     // each warp's dB_t | dC_t sums
  float out[kBufs][2][kChunk][kOutPad];          // ddt, then dx, staged for the stores
};

template <typename XT>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) scan_bwd_kernel(const Args a) {
  extern __shared__ float4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cl = warp * (32 / kLanes) + lane / kLanes, g = lane % kLanes;
  const int p = (lane >> 3) & 3;       // the state 4 g + p its channel sums come back with
  const int so = p;                    // its slot order: slot k holds state 4 g + (k ^ so)
  const int d = blockIdx.x * kChannels + cl;
  const bool live = d < a.di;
  const long long row = live ? d : 0;      // dead lanes walk channel 0, store nothing
  const int nspans = (a.S + kStatesEvery - 1) / kStatesEvery;
  const int nchunks = (a.S + kChunk - 1) / kChunk;

  // slot k: state kPer g + (k ^ so) of the lane's channel
  float a2[kPer], gr[kPer], dA[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int n = kPer * g + (k ^ so);
    a2[k] = a.A[row * kN + n] * kLog2e;
    gr[k] = a.dhT[((long long)b * a.di + row) * kN + n];
    dA[k] = 0.0f;
  }
  const float Dd = a.D[row];
  float dD = 0.0f;

  // Staging, walking chunks last to first: every source pointer starts at
  // the last chunk and steps back one chunk a copy.
  const int lc = tid % kChannels, ls = tid / kChannels;
  const bool lc_live = blockIdx.x * kChannels + lc < a.di;
  const long long lrow = blockIdx.x * kChannels + lc;
  const int sb = tid / (2 * kN), kb = tid % (2 * kN);
  const long long last = (long long)(nchunks - 1) * kChunk;
  const float* dt_src = a.dt + b * a.dt_sb + (last + ls) * a.dt_ss + lrow;
  const float* dy_src = a.dy + b * a.dy_sb + (last + ls) * a.dy_ss + lrow;
  const XT* x_src = static_cast<const XT*>(a.x) + b * a.x_sb + (last + ls) * a.x_ss + lrow;
  const long long bc_ss = kb < kN ? a.b_ss : a.c_ss;
  const float* bc_src =
      (kb < kN ? a.Bm + b * a.b_sb + kb : a.Cm + b * a.c_sb + kb - kN) + (last + sb) * bc_ss;
  // element kb's place in slot order q: its state's slot in group (kb mod kN) / 4
  const int bc_at = (kb % kN) & ~3;

  // dt, dy and B_t | C_t of chunk c into its buffer; zeros past S
  auto copy = [&](int c) {
    const int n = min(kChunk, a.S - c * kChunk), buf = c % kBufs;
#pragma unroll
    for (int j = 0; j < kTileLoads; ++j) {
      const int s = ls + j * kRowStep;
      const bool ok = lc_live && s < n;
      cp_async4(&sm.dxy[buf][s][lc].x, dt_src + j * kRowStep * a.dt_ss, ok);
      cp_async4(&sm.dxy[buf][s][lc].z, dy_src + j * kRowStep * a.dy_ss, ok);
    }
#pragma unroll
    for (int j = 0; j < kBcLoads; ++j) {
      const int s = sb + j * kBcStep;
      float* const bc_row = reinterpret_cast<float*>(kb < kN ? &sm.bq[buf][s][0] : &sm.cq[buf][s][0]);
#pragma unroll
      for (int q = 0; q < kPerms; ++q)
        cp_async4(bc_row + q * kN + (bc_at | ((kb & 3) ^ q)), bc_src + j * kBcStep * bc_ss,
                  s < n);
    }
    dt_src -= kChunk * a.dt_ss;
    dy_src -= kChunk * a.dy_ss;
    bc_src -= kChunk * bc_ss;
  };
  // x of chunk c (no 2-byte cp.async: through registers)
  auto load_x_chunk = [&](float (&r)[kTileLoads], int c) {
    const int n = min(kChunk, a.S - c * kChunk);
#pragma unroll
    for (int j = 0; j < kTileLoads; ++j)
      r[j] = lc_live && ls + j * kRowStep < n ? load_x(x_src + j * kRowStep * a.x_ss) : 0.0f;
    x_src -= kChunk * a.x_ss;
  };
  auto stage_x = [&](const float (&r)[kTileLoads], int c) {
#pragma unroll
    for (int j = 0; j < kTileLoads; ++j) sm.dxy[c % kBufs][ls + j * kRowStep][lc].y = r[j];
  };
  // the state each span starts from, in slot order: the states rows (h0
  // when there are none), last span first
  const float* st_src = (a.states ? a.states + (((long long)b * nspans + nspans - 1) * a.di + row) * kN
                                  : a.h0 + ((long long)b * a.di + row) * kN) + kPer * g;
  auto load_start = [&](float (&h)[kPer]) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) h[k] = st_src[k ^ so];
    st_src -= (long long)a.di * kN;
  };
  // the staged outputs: thread i stores four channels, 4 (i mod 16) on, of
  // row i / 16 of each chunk's ddt and dx
  const int o_row = tid / (kChannels / 4), o_ch = 4 * (tid % (kChannels / 4));
  const int o_n = o_row < kChunk ? min(4, a.di - (int)(blockIdx.x * kChannels + o_ch)) : 0;
  const bool o_vec = (a.di & 3) == 0 && o_n == 4;
  long long o_at = ((long long)b * a.S + last + o_row) * a.di + blockIdx.x * kChannels + o_ch;
  static_assert(kThreads >= kChunk * (kChannels / 4), "a (row, four channels) a thread");
  // the block sums: thread (s, kb) writes value kb of steps t0 + s + j kBcStep
  float* bc_dst = a.part_bc + (((long long)blockIdx.x * a.B + b) * a.S + last) * (2 * kN) + tid;
  // this lane's place in each warp's sums: value 4 g + p (dB), kN + 4 g + p (dC)
  float* const part_at = &sm.part[0][warp][0][kPer * g + p];

  float hstart[kPer], xr[kTileLoads];
  copy(nchunks - 1);
  cp_async_commit();
  load_x_chunk(xr, nchunks - 1);
  stage_x(xr, nchunks - 1);
  load_start(hstart);
  cp_async_wait_all();
  __syncthreads();

  for (int c = nchunks - 1; c >= 0; --c) {
    const int buf = c % kBufs;
    // the next chunk in order: its copies and its x
    if (c > 0) {
      copy(c - 1);
      load_x_chunk(xr, c - 1);
    }
    cp_async_commit();

    // the chunk's spans, last first (the last chunk's second span only if
    // it holds a step)
    for (int h = c * kChunk + kStatesEvery < a.S ? kSpans - 1 : 0; h >= 0; --h) {
      const int sp = c * kSpans + h;
      // the start state of the span after this one in order
      float hnext[kPer];
      if (sp > 0) load_start(hnext);
      // this lane's rows of the span's buffers (a constant offset a step)
      const int r0 = h * kStatesEvery;
      const float4* const fr = &sm.dxy[buf][r0][cl];
      const float4* const br = &sm.bq[buf][r0][so * kPer + g];
      const float4* const cr = &sm.cq[buf][r0][so * kPer + g];
      float* const part = part_at + (buf * kWarps * kChunk + r0) * 2 * kN;
      float* const ddt_row = &sm.out[buf][0][r0][cl];
      float* const dx_row = &sm.out[buf][1][r0][cl];

      // the span's states, as the forward computed them: hs[i] the state
      // before step i of the span
      float hs[kStatesEvery][kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) hs[0][k] = hstart[k];
#pragma unroll
      for (int s0 = 0; s0 < kStatesEvery; s0 += kLanes) {
        float v[kLanes][kPer], tot[kLanes];
#pragma unroll
        for (int i = 0; i < kLanes; ++i) {
          const int s = s0 + i;
          const float4 f = fr[s * kChannels];
          const float4 bq = br[s * kPerms * kPer];
          const float bt[kPer] = {bq.x, bq.y, bq.z, bq.w};
          const float dtx = f.x * f.y;
          float e[kPer];
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            e[k] = ex2(f.x * a2[k]);
            const float hk = fmaf(hs[s][k], e[k], dtx * bt[k]);
            if (s + 1 < kStatesEvery) hs[s + 1][k] = hk;
            v[i][k] = f.z * hk;                              // dC_t's term
          }
        }
        // both lanes of each pair 4 apart write the same sum
        channel_sums(v, tot);
#pragma unroll
        for (int i = 0; i < kLanes; ++i) part[(s0 + i) * 2 * kN + kN] = tot[i];
      }

      // the steps backward, kLanes at a time: lane g finishes step s0 + g
#pragma unroll
      for (int s0 = kStatesEvery - kLanes; s0 >= 0; s0 -= kLanes) {
        float vu[kLanes], vq[kLanes], v[kLanes][kPer], tot[kLanes];
#pragma unroll
        for (int i = kLanes - 1; i >= 0; --i) {
          const int s = s0 + i;
          const float4 f = fr[s * kChannels];
          const float4 bq = br[s * kPerms * kPer], cq = cr[s * kPerms * kPer];
          const float bt[kPer] = {bq.x, bq.y, bq.z, bq.w};
          const float ct[kPer] = {cq.x, cq.y, cq.z, cq.w};
          const float dtx = f.x * f.y;
          float u = 0.0f, q = 0.0f;
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            gr[k] = fmaf(f.z, ct[k], gr[k]);                 // g_t
            u = fmaf(gr[k], bt[k], u);
            v[i][k] = gr[k] * dtx;                           // dB_t's term
            gr[k] *= ex2(f.x * a2[k]);                       // g_t a_t: step t - 1's carry
            const float gh = gr[k] * hs[s][k];               // g_t a_t h_{t-1}
            dA[k] = fmaf(gh, f.x, dA[k]);
            q = fmaf(gh, a2[k], q);                          // in units of ln 2
          }
          dD = fmaf(f.z, f.y, dD);
          vu[i] = u;
          vq[i] = q;
        }
        channel_sums(v, tot);
#pragma unroll
        for (int i = 0; i < kLanes; ++i) part[(s0 + i) * 2 * kN] = tot[i];
        const float u = lane_sums(vu, g), q = lane_sums(vq, g);
        const float4 f = fr[(s0 + g) * kChannels];
        ddt_row[(s0 + g) * kOutPad] = fmaf(u, f.y, q * kLn2);
        dx_row[(s0 + g) * kOutPad] = fmaf(u, f.x, f.z * Dd);
      }
      if (sp > 0) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) hstart[k] = hnext[k];
      }
    }
    if (c > 0) stage_x(xr, c - 1);
    cp_async_wait_all();                    // chunk c - 1's copies are in
    __syncthreads();
    // the chunk's outputs, and the block's sum over its warps, in order, of
    // each (step, value)
    if (c * kChunk + o_row < a.S && o_n > 0) {
      store4(a.ddt + o_at, *reinterpret_cast<const float4*>(&sm.out[buf][0][o_row][o_ch]),
             o_vec, o_n);
      store4(static_cast<XT*>(a.dx) + o_at,
             *reinterpret_cast<const float4*>(&sm.out[buf][1][o_row][o_ch]), o_vec, o_n);
    }
    o_at -= (long long)kChunk * a.di;
#pragma unroll
    for (int i = 0; i < kBcLoads; ++i) {
      const int s = sb + i * kBcStep;
      if (c * kChunk + s < a.S) {
        float tot = sm.part[buf][0][s][kb];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) tot += sm.part[buf][w][s][kb];
        bc_dst[i * kBcStep * 2 * kN] = tot;
      }
    }
    bc_dst -= kChunk * 2 * kN;
  }

  if (live) {
    const long long o = ((long long)b * a.di + d) * kN + kPer * g;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      a.dh0[o + (k ^ so)] = gr[k];
      a.part_a[o + (k ^ so)] = dA[k];
    }
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

// the steps a span, which must be the forward's states interval
extern "C" int selective_scan_bwd_states_every() { return kStatesEvery; }
// the channels a block: part_bc holds ceil(di / this) partials a (b, t)
extern "C" int selective_scan_bwd_block_channels() { return kChannels; }

// dt, x, dy: (B, S, di) with unit stride over di and the given element
// strides over (b, t); x float32 or (x_bf16) bf16, the rest float32.  Bm,
// Cm: (B, S, N) with unit stride over N.  A (di, N), D (di), h0, dhT, dh0
// (B, di, N) contiguous; states null (S <= 8) or (B, ceil(S / 8), di, N)
// from selective_scan_launch.  Writes ddt and dx (B, S, di) contiguous (dx
// in x's type), dB and dC (B, S, N), dA (di, N), dD (di), dh0.  Scratch
// (float32, contiguous): part_bc (ceil(di / kChannels), B, S, 2 N), part_a (B, di,
// N), part_d (B, di).  N must be 16.  Two launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int selective_scan_bwd_launch(
    const void* dt, const void* x, const void* Bm, const void* Cm, const void* A,
    const void* D, const void* h0, const void* dy, const void* dhT, const void* states,
    void* ddt, void* dx, void* dB, void* dC, void* dA, void* dD, void* dh0,
    void* part_bc, void* part_a, void* part_d, int B, int S, int di, int N, int x_bf16,
    long long dt_sb, long long dt_ss, long long x_sb, long long x_ss, long long b_sb,
    long long b_ss, long long c_sb, long long c_ss, long long dy_sb, long long dy_ss,
    void* stream) {
  if (N != kN || B <= 0 || B > 65535 || S <= 0 || di <= 0 || (!states && S > kStatesEvery))
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
  auto run = [&](auto kernel) {
    // static and dynamic shared memory together pass the default 48 KB
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
    if (err) return err;
    kernel<<<grid, kThreads, sizeof(Smem), st>>>(a);
    return (int)cudaGetLastError();
  };
  int err = x_bf16 ? run(scan_bwd_kernel<__nv_bfloat16>) : run(scan_bwd_kernel<float>);
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
