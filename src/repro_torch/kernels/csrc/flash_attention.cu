// Causal / sliding-window GQA flash attention in float32 on Hopper (sm_90a),
// online softmax on the CUDA cores.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py for float32 inputs (bf16 inputs go
// to csrc/flash_attention_sm90.cu, on the tensor cores, which would take
// float32 as TF32).  For q (B, S, Hq, hd), k and v (B, S, Hkv, hd), query
// head h reading kv head h / (Hq / Hkv):
//
//     s[q, k]  = (q_q * 1/sqrt(hd)) . k_k          masked to -1e30 unless
//                                                  k <= q (causal) and
//                                                  q - k < window (window > 0)
//     out[q]   = sum_k softmax_k(s[q, :]) v_k      divided by max(l, 1e-30)
//
// with the running (max, sum, accumulator) of the Pallas kernel, in the
// same order: m' = max(m, max_k s), p = exp(s - m'), l = l e^(m - m') + sum p,
// acc = acc e^(m - m') + p V.
//
// Design.  The TPU kernel walked a sequential grid (B, Hq, nq, nk) with the
// running state in VMEM scratch and skipped dead kv blocks with pl.when.
// Here one block of 4 warps owns kRows = 16 query rows: qt = 16 / G query
// positions times the G query heads that share one kv head, so every kv
// tile a block stages in shared memory serves all G heads of its group.
// The block computes its first and last live kv tile from its position
// range (the window's lower edge, the causal upper edge) and loops over
// only those: dead tiles cost nothing, as with pl.when.
//
// A kv tile is 32 keys, copied from device memory into shared memory by
// 16-byte cp.async copies, two tiles in flight: the
// next tile's copy runs while the block computes on this one, so the
// copy's latency is hidden (a first version loaded the tiles with
// synchronous 2-byte loads and spent most of its time waiting on them).
// Keys past S are zero-filled by the copy and masked, so S need not be a
// multiple of any tile (the Pallas kernel asserts S % block == 0; the
// model path does not guarantee it).  q is scaled and converted to fp32
// once per block.  Lane j computes the scores of key j against the warp's
// 4 rows, reading its key row 16 bytes at a time (rows are padded by 16
// bytes, so each quarter-warp's loads hit distinct banks) and the query
// rows as broadcasts; the warp reduces max and sum with shuffles, and each
// lane owns the head dimensions d = lane + 32 c of its rows' accumulators
// (ceil(hd / 32) <= 8 registers a row).  q, k and v are read in the
// model's (B, S, H, hd) layout through their strides: no transposes; every
// row must start on 16 bytes (the wrapper checks).  At hd = 256 the two
// stages and the query rows take 148 KB of shared memory, above the 48 KB
// static limit: it is dynamic shared memory, raised with
// cudaFuncSetAttribute before each launch.
//
// Bound on the H100: operations.  At the LM path's (2, 4096, 8 / 4, 256)
// the kernel must move about 200 MB (60 us at 3.35 TB/s) but do 4 * hd
// flops for each of the 2 * 8 * 8.4 M live (q, k) pairs of a causal layer,
// 137 GFLOP: 2.05 ms at the fp32 rate outside the tensor cores (67
// TFLOP/s), 0.90 ms for a window of 1024.  It runs those FMAs with
// operands from shared memory, well above that bound.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kKeys = 32;                      // keys per kv tile: one per lane
constexpr int kMaxChunks = 8;                  // hd <= 256
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int S, Hq, Hkv, hd, qt, causal, window;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

// the four values of one 16-byte chunk
__device__ __forceinline__ void unpack(const uint4& raw, float* f) {
  const float* p = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = p[e];
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 16-byte global -> shared copy; src_bytes = 0 zero-fills the destination
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

constexpr int kVec = 4;                        // floats per 16-byte chunk

// floats between key rows in shared memory: hd plus 16 bytes of padding
__host__ __device__ __forceinline__ int key_stride(int hd) { return hd + kVec; }

size_t smem_bytes(int hd) {
  return sizeof(float) * (2 * (size_t)kKeys * (key_stride(hd) + hd) + (size_t)kRows * hd);
}

// NC = ceil(hd / 32): accumulator registers per row and lane.
template <int NC>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = a.hd;
  const int ks = key_stride(hd);
  const int chunks = hd / kVec;             // 16-byte chunks per row
  float* Ks = reinterpret_cast<float*>(smem);               // 2 stages x kKeys x ks
  float* Vs = Ks + 2 * kKeys * ks;                          // 2 stages x kKeys x hd
  float* Qs = Vs + 2 * kKeys * hd;                          // kRows x hd, pre-scaled

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* out = static_cast<float*>(a.out);

  const int G = a.Hq / a.Hkv;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int q_lo = blockIdx.x * a.qt;
  const int q_hi = min(q_lo + a.qt, a.S) - 1;
  const int nrows = a.qt * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // live kv range of the block's positions [q_lo, q_hi]
  const int kv_lo = a.window > 0 ? max(0, q_lo - a.window + 1) : 0;
  const int kv_hi = a.causal ? q_hi : a.S - 1;
  const int t_lo = kv_lo / kKeys, t_hi = kv_hi / kKeys;

  // tile t (keys t * kKeys ..) into stage st, zero-filled past S
  auto copy_tile = [&](int t, int st) {
    float* kd = Ks + st * kKeys * ks;
    float* vd = Vs + st * kKeys * hd;
    for (int c = tid; c < kKeys * chunks; c += kThreads) {
      const int j = c / chunks, d = (c - j * chunks) * kVec;
      const int kp = t * kKeys + j;
      const long long row = kp < a.S ? kp : a.S - 1;
      const int bytes = kp < a.S ? 16 : 0;
      cp_async16(kd + j * ks + d, k + b * a.k_sb + row * a.k_ss + hk * a.k_sh + d, bytes);
      cp_async16(vd + j * hd + d, v + b * a.v_sb + row * a.v_ss + hk * a.v_sh + d, bytes);
    }
    cp_async_commit();
  };
  copy_tile(t_lo, 0);

  // row r of the block: query position q_lo + r / G, query head hk * G + r % G
  for (int c = tid; c < kRows * chunks; c += kThreads) {
    const int r = c / chunks, d = (c - r * chunks) * kVec;
    const int qp = q_lo + r / G;
    float x[kVec];
    if (r < nrows && qp < a.S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + b * a.q_sb + qp * a.q_ss + (long long)(hk * G + r % G) * a.q_sh + d);
      unpack(raw, x);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) Qs[r * hd + d + e] = x[e] * a.scale;
  }

  int qpos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    qpos[i] = q_lo + (warp * kRowsPerWarp + i) / G;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    if (t < t_hi) {                         // the next tile flies during this one
      copy_tile(t + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                        // tile t (and the query rows) landed

    // scores: lane = key t * kKeys + lane, against the warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* krow = Ks + st * kKeys * ks + lane * ks;
    const float4* qrow = reinterpret_cast<const float4*>(Qs + warp * kRowsPerWarp * hd);
    const int hd4 = hd / 4;
    for (int c = 0; c < chunks; ++c) {
      float kf[kVec];
      unpack(*reinterpret_cast<const uint4*>(krow + c * kVec), kf);
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        const int d4 = (c * kVec + e) / 4;
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const float4 qd = qrow[i * hd4 + d4];
          s[i] = fmaf(qd.x, kf[e], s[i]);
          s[i] = fmaf(qd.y, kf[e + 1], s[i]);
          s[i] = fmaf(qd.z, kf[e + 2], s[i]);
          s[i] = fmaf(qd.w, kf[e + 3], s[i]);
        }
      }
    }

    const int kp = t * kKeys + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      bool ok = kp < a.S;
      if (a.causal) ok = ok && kp <= qpos[i];
      if (a.window > 0) ok = ok && qpos[i] - kp < a.window;
      const float si = ok ? s[i] : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(si));
      p[i] = expf(si - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p[i]);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }

    // acc += p V: lane owns dims lane + 32 c
    const float* vt = Vs + st * kKeys * hd;
    for (int j = 0; j < kKeys; ++j) {
      float vj[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = lane + 32 * c;
        vj[c] = d < hd ? vt[j * hd + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pj, vj[c], acc[i][c]);
      }
    }
    __syncthreads();                        // stage st is free for tile t + 2
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    if (r >= nrows || qpos[i] >= a.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* o = out + (((long long)b * a.S + qpos[i]) * a.Hq + hk * G + r % G) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = lane + 32 * c;
      if (d < hd) o[d] = acc[i][c] / den;
    }
  }
}

template <int NC>
int launch(const Args& a, int B, cudaStream_t stream) {
  // above 48 KB a block gets dynamic shared memory only when asked for
  const size_t bytes = smem_bytes(a.hd);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.S + a.qt - 1) / a.qt, a.Hkv, B);
  flash_kernel<NC><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, int B, cudaStream_t stream) {
  switch ((a.hd + 31) / 32) {
    case 1: return launch<1>(a, B, stream);
    case 2: return launch<2>(a, B, stream);
    case 3: return launch<3>(a, B, stream);
    case 4: return launch<4>(a, B, stream);
    case 5: return launch<5>(a, B, stream);
    case 6: return launch<6>(a, B, stream);
    case 7: return launch<7>(a, B, stream);
    case 8: return launch<8>(a, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, Hq, hd), k and v (B, S, Hkv, hd) float32, each with unit stride
// over hd, the given element strides over (b, s, h), and every row starting
// on 16 bytes (hd, the strides times 4 and the pointers multiples of 16);
// out (B, S, Hq, hd) contiguous float32.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int S, int Hq, int Hkv,
    int hd, long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, int causal, int window,
    float scale, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > kRows || hd <= 0 ||
      hd % 4 != 0 || hd > 32 * kMaxChunks || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.S = S;
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
  return dispatch(a, B, static_cast<cudaStream_t>(stream));
}
