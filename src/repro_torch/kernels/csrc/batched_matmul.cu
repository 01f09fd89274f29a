// A batched float32 matrix product in one fixed summation order, on Hopper
// (sm_90a): c[b, i, j] = sum_k a[b, i, k] * b[b, k, j], k = 0, 1, ..., K-1.
//
// No Pallas counterpart.  The reference leaves the client-stacked products
// of local training, prototypes and evaluation (src/repro/models/
// classifier.py, vmapped over the cohort) to XLA.  On the card cuBLAS picks
// its kernel by the batch count, so a client trained in a call of 25 got
// other low bits than in a call of 100, and a cohort sharded over S devices
// could not replay the one-device run bit for bit.  Here every output element
// is one thread's running sum over k in order, each product and each sum an
// explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn: nvcc never
// contracts them into an FMA; no TF32, no split over K).  An element's bits
// then depend on its own row of a and column of b alone: not on the batch
// count, the grid, the tile or the shape class.  The plain PyTorch version
// (kernels/batched_matmul.py::batched_matmul_plain) adds the same products in
// the same order and equals it bit for bit.
//
// Operands come with any strides, so the backward's dY @ B^T and A^T @ dY
// read transposed views in place, and a may be one matrix shared by every
// batch entry (batch stride 0: the shared eval or probe batch).
//
// Design.  A block of 256 threads owns a tile of 16 output rows and TN
// columns of one batch entry (TN = 64, 32 or 16, the least that holds N, so
// that a head of 10 classes does not idle three quarters of a 64-wide tile).
// Thread (tx, ty) owns column tx and rows ty, ty + RT, ...: 16 / RT of them,
// RT = 256 / TN.  K is walked in chunks of 32: the block stages the chunk's
// 16 x 32 slice of a and 32 x TN slice of b in shared memory (strided
// loads, any layout), then each thread adds the chunk's products to its
// sums in order.  A warp's threads read one element of the a slice
// (broadcast) and neighbouring elements of the b slice.
//
// Bound on the H100: at the training shapes (16 x 64 @ 64 x 64 a client,
// 100 clients) the work is 13 MFLOP and 2.5 MB, about 0.7 us of bytes at
// 3.35 TB/s: a launch (about 5 us) exceeds it.  At the shared eval batch
// (100 models, 1024 x 64 @ 64 x 64) it is 0.84 GFLOP, 12.5 us at 67 TFLOP/s
// (no FMA: each multiply-add is two instructions, so the kernel cannot pass
// half that rate).  Its times beside cuBLAS's are in PERF.md (chip_smoke.py).

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
