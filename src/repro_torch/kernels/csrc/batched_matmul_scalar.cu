// The first design of the fixed-order batched product (csrc/batched_matmul.cu
// replaced it), kept as a yardstick and on no path: chip_smoke.py times the
// current kernel beside it in the same run, and kernel_ablation.py (part
// `bmm`) times it with its staging, its k loop or its store removed.  Same
// arithmetic (each output one thread's running sum over k in order by
// __fmul_rn / __fadd_rn), same C entry point and arguments, so a caller
// swaps one library for the other.
//
// Design.  A block of 256 threads owns a tile of 16 output rows and TN
// columns of one batch entry (TN = 64, 32 or 16, the least that holds N).
// Thread (tx, ty) owns column tx and rows ty, ty + RT, ...: 16 / RT of them,
// RT = 256 / TN.  K is walked in chunks of 32: the block stages the chunk's
// 16 x 32 slice of a and 32 x TN slice of b in shared memory (strided scalar
// loads, any layout), then each thread adds the chunk's products to its
// sums in order: five shared loads for four multiply-adds a k step.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 16;
constexpr int kChunkK = 32;

template <int TN>
__global__ void __launch_bounds__(kThreads)
batched_matmul_kernel(const float* __restrict__ a, long long sab, long long sam,
                      long long sak, const float* __restrict__ b, long long sbb,
                      long long sbk, long long sbn, float* __restrict__ c, int M,
                      int K, int N) {
  constexpr int RT = kThreads / TN;      // thread rows
  constexpr int RPT = kTileM / RT;       // output rows a thread
  __shared__ float a_s[kTileM][kChunkK + 1];
  __shared__ float b_s[kChunkK][TN];

  const int tx = threadIdx.x % TN, ty = threadIdx.x / TN;
  const long long batch = blockIdx.z;
  const int row0 = blockIdx.y * kTileM, col0 = blockIdx.x * TN;
  const float* ab = a + batch * sab;
  const float* bb = b + batch * sbb;

  float acc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunkK) {
    const int kc = min(kChunkK, K - k0);
    for (int e = threadIdx.x; e < kTileM * kChunkK; e += kThreads) {
      const int i = e / kChunkK, k = e % kChunkK;
      a_s[i][k] = (row0 + i < M && k < kc)
                     ? ab[(long long)(row0 + i) * sam + (long long)(k0 + k) * sak]
                     : 0.f;
    }
    for (int e = threadIdx.x; e < kChunkK * TN; e += kThreads) {
      const int k = e / TN, j = e % TN;
      b_s[k][j] = (col0 + j < N && k < kc)
                     ? bb[(long long)(k0 + k) * sbk + (long long)(col0 + j) * sbn]
                     : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {      // only the chunk's real terms, in order
      const float bv = b_s[k][tx];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        acc[r] = __fadd_rn(acc[r], __fmul_rn(a_s[ty + r * RT][k], bv));
    }
    __syncthreads();
  }

  const int col = col0 + tx;
  if (col >= N) return;
  float* cb = c + batch * (long long)M * N;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + ty + r * RT;
    if (row < M) cb[(long long)row * N + col] = acc[r];
  }
}

template <int TN>
cudaError_t launch(const float* a, long long sab, long long sam, long long sak,
                   const float* b, long long sbb, long long sbk, long long sbn, float* c,
                   int batch, int M, int K, int N, cudaStream_t stream) {
  const dim3 grid((N + TN - 1) / TN, (M + kTileM - 1) / kTileM, batch);
  batched_matmul_kernel<TN><<<grid, kThreads, 0, stream>>>(a, sab, sam, sak, b, sbb, sbk,
                                                           sbn, c, M, K, N);
  return cudaGetLastError();
}

}  // namespace

// c (batch, M, N) contiguous = a @ b, a[b, i, k] at a + b*sab + i*sam + k*sak
// (sab = 0: one a for every batch entry), b[b, k, j] at b + b*sbb + k*sbk +
// j*sbn.  The wrapper checks the shapes (batch, M / 16 <= 65535) and that
// M, N, batch > 0.  Returns the launch's CUDA error (0 on success).
extern "C" int batched_matmul_launch(const float* a, long long sab, long long sam,
                                     long long sak, const float* b, long long sbb,
                                     long long sbk, long long sbn, float* c, int batch,
                                     int M, int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (N > 32)
    err = launch<64>(a, sab, sam, sak, b, sbb, sbk, sbn, c, batch, M, K, N, s);
  else if (N > 16)
    err = launch<32>(a, sab, sam, sak, b, sbb, sbk, sbn, c, batch, M, K, N, s);
  else
    err = launch<16>(a, sab, sam, sak, b, sbb, sbk, sbn, c, batch, M, K, N, s);
  return static_cast<int>(err);
}
