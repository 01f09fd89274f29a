// A batched float32 matrix product in one fixed summation order, on Hopper
// (sm_90a): c[b, i, j] = sum_k a[b, i, k] * b[b, k, j], k = 0, 1, ..., K-1.
//
// No Pallas counterpart.  The reference leaves the client-stacked products
// of local training, prototypes and evaluation (src/repro/models/
// classifier.py, vmapped over the cohort) to XLA.  On the card cuBLAS picks
// its kernel by the batch count, so a client trained in a call of 25 got
// other low bits than in a call of 100, and a cohort sharded over S devices
// could not replay the one-device run bit for bit.  Here every output element
// is one thread's running sum over k in order, from +0.0, each product and
// each sum an explicit round-to-nearest intrinsic (__fmul_rn, __fadd_rn:
// nvcc never contracts them into an FMA; no TF32, no split over K).  An
// element's bits then depend on its own row of a and column of b alone: not
// on the batch count, the grid, the tile or the shape class.  The plain
// PyTorch version (kernels/batched_matmul.py::batched_matmul_plain) adds the
// same products in the same order and equals it bit for bit.
//
// Operands come with any strides, so the backward's dY @ B^T and A^T @ dY
// read transposed views in place, and a may be one matrix shared by every
// batch entry (batch stride 0: the shared eval or probe batch).
//
// Bound on the H100.  No tensor core gives these bits (TF32, 3xTF32 and
// wgmma sum inside the instruction in their own order) and no FMA does (it
// rounds once), so each multiply-add is two instructions on the CUDA cores:
// half of 67 TFLOP/s.  At the shared eval batch, (1024, 64) @ (100, 64, 64),
// that is 25.04 us (12.52 at the FMA rate).  The training shapes (16 rows a
// client, 100 clients, K 16-64) are bound by bytes, under 1 us, and in fact
// by a launch and one cold read of the operands.
//
// Design.  One template, two shape classes, the same per-element order:
// - A thread owns TM rows x TN columns of outputs in registers, each its own
//   running sum.  The block stages a (BM rows x up to 64 k, row-major) and b
//   (up to 64 k x BN columns) in shared memory; each step of four k values
//   reads a thread's TM rows as one 16-byte load each (the lanes of a warp
//   share their rows: a broadcast, conflict-free across row groups) and TN / 4
//   16-byte loads of b a k, then does its TM x TN multiply-adds a k: at the
//   eval batch 12 shared loads to 256 FP32 instructions.  A thread's columns
//   are TN / 4 groups of four, 4 * TX apart, so that each 16-byte load of b
//   by a warp's row of TX lanes reads 16 * TX contiguous bytes.
// - Work comes in units (row tile, column tile, batch entry), the batch entry
//   fastest.  A grid of at most (SMs x resident blocks an SM) blocks takes
//   contiguous runs of units, so a block walks several batch entries of one
//   row tile.  Each (unit, 64-deep chunk of k) is a stage; stage s + 1 is
//   staged into the other of two buffers while stage s computes.  Where a is
//   shared (batch stride 0) and K <= 64, the block's a tile stays in shared
//   memory across the entries it walks: a is read once a block, not once an
//   entry.
// - Staging (Staging below): 16-byte cp.async pieces where the inner stride
//   is 1 and the rows are 16-byte aligned; 16-byte register loads along the
//   rows of an aligned transposed view (the backward's B^T and A^T), issued
//   after the other operand's copies so that both are in flight; 4-byte
//   cp.async copies otherwise.  Zero-filled past the matrix: k past K is
//   zero in both operands, so the padded terms add +0.0 * +0.0 to a sum that
//   is never -0.0, and the bits do not change.
// - Outputs are stored from registers as 16-byte stores where N % 4 == 0,
//   a warp's lanes on neighbouring columns.
// - Rows class (M >= 128: the eval round's three products, FP32-bound at N =
//   64): 64-row tiles, TM = 4; 64 columns at TN = 8 (128 threads), 32 or 16
//   at TN = 4.  64-row units split the eval batch's 6.06 units an SM of
//   128-row ones into 12.12, so the busiest SM waits less.  Small class (M <
//   128: training, its backward forms, prototypes, a launch and one cold
//   read): 16-row tiles, TM = 2 (BN = 32) or 1 (BN = 16), 64 threads, one
//   unit a block, so 100 clients make 100-800 blocks for 132 SMs; K <= 64 is
//   one staging round and one barrier.  The launch bound lets a thread take
//   up to 255 registers (256 threads an SM at the least).
// Its times beside cuBLAS's and beside the first design
// (csrc/batched_matmul_scalar.cu), and where its time goes
// (kernel_ablation.py bmm), are in PERF.md.

#include <cuda_runtime.h>

namespace {

constexpr int kChunkK = 64;          // k values staged a stage
constexpr int kLdA = kChunkK + 4;    // a tile row pitch (floats): 16-byte rows
constexpr int kRowLoadsInFlight = 8; // 16-byte register loads a thread at once
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// How a tile is staged: 16-byte cp.async pieces along its columns (unit
// column stride, every row 16-byte aligned), 16-byte register loads along
// its rows (unit row stride, every column 16-byte aligned: a transposed
// view), or 4-byte cp.async copies (anything else).
enum Staging : int { kPieces = 0, kRowLoads = 1, kWords = 2 };

// Rows [r0, r0 + R) x columns [c0, c0 + C) of one batch entry's (nr x nc)
// matrix (element (r, c) at src + r * sr + c * sc) into dst[r * ld + c],
// zeros outside the matrix (C, c0, R and r0 multiples of 4).  kPieces and
// kWords only issue copies (the caller's wait_group waits); kRowLoads waits
// for its loads, all of a thread's in flight at once (neighbouring threads
// on neighbouring columns, so a piece's four shared stores do not
// conflict), then stores them.
template <int NT>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, long long sr,
                                      long long sc, int r0, int nr, int c0, int nc, int R,
                                      int C, int how) {
  if (how == kPieces) {
    const int C4 = C / 4;
    for (int e = threadIdx.x; e < R * C4; e += NT) {
      const int r = e / C4, c = (e % C4) * 4;
      const int gr = r0 + r, gc = c0 + c;
      const int n = gr < nr ? max(0, min(4, nc - gc)) : 0;
      cp_async16(dst + r * ld + c, n ? src + gr * sr + gc : src, 4 * n);
    }
  } else if (how == kRowLoads) {
    const int pieces = (R / 4) * C;
    for (int e0 = threadIdx.x; e0 < pieces; e0 += kRowLoadsInFlight * NT) {
      float4 v[kRowLoadsInFlight];
#pragma unroll
      for (int u = 0; u < kRowLoadsInFlight; ++u) {
        const int e = e0 + u * NT, c = e % C, r = (e / C) * 4;
        const int gr = r0 + r, gc = c0 + c;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < pieces && gc < nc) {
          const float* g = src + gr + gc * sc;
          if (gr + 4 <= nr) {
            v[u] = *reinterpret_cast<const float4*>(g);
          } else {
            if (gr < nr) v[u].x = g[0];
            if (gr + 1 < nr) v[u].y = g[1];
            if (gr + 2 < nr) v[u].z = g[2];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kRowLoadsInFlight; ++u) {
        const int e = e0 + u * NT, c = e % C, r = (e / C) * 4;
        if (e < pieces) {
          dst[r * ld + c] = v[u].x;
          dst[(r + 1) * ld + c] = v[u].y;
          dst[(r + 2) * ld + c] = v[u].z;
          dst[(r + 3) * ld + c] = v[u].w;
        }
      }
    }
  } else {
    // the unit-stride axis (rows where sr == 1) across neighbouring threads
    const bool rows_fast = sr == 1 && sc != 1;
    for (int e = threadIdx.x; e < R * C; e += NT) {
      const int r = rows_fast ? e % R : e / C, c = rows_fast ? e / R : e % C;
      const int gr = r0 + r, gc = c0 + c;
      const bool in = gr < nr && gc < nc;
      cp_async4(dst + r * ld + c, in ? src + gr * sr + gc * sc : src, in ? 4 : 0);
    }
  }
}

// Where a stage stands: batch entry z of column tile ct of row tile rt, k
// chunk ch; advanced in unit order (the chunk, then the batch entry, then
// the column tile, then the row tile fastest to slowest) without dividing.
struct Pos {
  int ch, z, ct, rt;
  __device__ void advance(int nch, int batch, int col_tiles) {
    if (++ch < nch) return;
    ch = 0;
    if (++z < batch) return;
    z = 0;
    if (++ct < col_tiles) return;
    ct = 0;
    ++rt;
  }
};

template <int BM, int BN, int TM, int TN>
constexpr int threads() {
  return (BM / TM) * (BN / TN);
}

template <int BM, int BN>
constexpr int smem_floats() {
  return 2 * BM * kLdA + 2 * kChunkK * (BN + 4);
}

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(threads<BM, BN, TM, TN>(), 256 / threads<BM, BN, TM, TN>())
batched_matmul_kernel(const float* __restrict__ a, long long sab, long long sam,
                      long long sak, const float* __restrict__ b, long long sbb,
                      long long sbk, long long sbn, float* __restrict__ c, int batch, int M,
                      int K, int N, long long units, int how_a, int how_b) {
  static_assert(TN % 4 == 0, "a thread's columns are 16-byte pieces");
  constexpr int TX = BN / TN, TY = BM / TM, NT = TX * TY, kLdB = BN + 4;
  extern __shared__ __align__(16) float smem[];
  float* const a_s = smem;                          // [2][BM][kLdA]
  float* const b_s = smem + 2 * BM * kLdA;          // [2][kChunkK][kLdB]

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int nch = (K + kChunkK - 1) / kChunkK;
  const int col_tiles = (N + BN - 1) / BN;
  // this block's units: one where the grid holds them all (no 64-bit
  // division on the short path), else a contiguous run
  long long u0 = blockIdx.x, n_stages = nch;
  if (units > gridDim.x) {
    u0 = units * blockIdx.x / gridDim.x;
    n_stages = (units * (blockIdx.x + 1) / gridDim.x - u0) * nch;
  }
  Pos cur = {0, 0, 0, 0};
  if (u0 <= 0xffffffffLL) {           // 32-bit divisions where the index fits
    const unsigned u = static_cast<unsigned>(u0), t = u / batch;
    cur = {0, static_cast<int>(u - t * batch), static_cast<int>(t % col_tiles),
           static_cast<int>(t / col_tiles)};
  } else {
    const long long t = u0 / batch;
    cur = {0, static_cast<int>(u0 - t * batch), static_cast<int>(t % col_tiles),
           static_cast<int>(t / col_tiles)};
  }
  Pos nxt = cur;

  // the (row tile, chunk) of a shared a (batch stride 0) each a buffer
  // holds, -1 for none (two scalars, not an array indexed at run time)
  long long holds0 = -1, holds1 = -1;

  // Stage nxt into b buffer bb and, unless the a tile it needs is resident
  // in buffer a_cur, into a buffer a_cur ^ 1; returns the a buffer it reads.
  auto issue = [&](int bb, int a_cur) -> int {
    const int k0 = nxt.ch * kChunkK, kc4 = (min(kChunkK, K - k0) + 3) / 4 * 4;
    const long long key = sab == 0 ? static_cast<long long>(nxt.rt) * nch + nxt.ch : -1;
    const bool load_a = key < 0 || (a_cur ? holds1 : holds0) != key;
    const int ab = load_a ? a_cur ^ 1 : a_cur;
    // the copies first, so that register loads wait behind them, not before
    const auto stage_a = [&] {
      stage<NT>(a_s + ab * BM * kLdA, kLdA, a + nxt.z * sab, sam, sak, nxt.rt * BM, M, k0,
                K, BM, kc4, how_a);
    };
    if (load_a && how_a != kRowLoads) stage_a();
    stage<NT>(b_s + bb * kChunkK * kLdB, kLdB, b + nxt.z * sbb, sbk, sbn, k0, K,
              nxt.ct * BN, N, kc4, BN, how_b);
    if (load_a && how_a == kRowLoads) stage_a();
    if (load_a) (ab ? holds1 : holds0) = key;
    cp_async_commit();
    nxt.advance(nch, batch, col_tiles);
    return ab;
  };

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[r][q] = 0.f;

  int a_cur = n_stages > 0 ? issue(0, 1) : 0;
  for (long long s = 0; s < n_stages; ++s) {
    int a_next = a_cur;
    if (s + 1 < n_stages) {
      a_next = issue(static_cast<int>((s + 1) & 1), a_cur);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int kc4 = (min(kChunkK, K - cur.ch * kChunkK) + 3) / 4 * 4;
    const float* as = a_s + a_cur * BM * kLdA + ty * kLdA;
    const float* bs = b_s + (s & 1) * kChunkK * kLdB + tx * 4;
    for (int k = 0; k < kc4; k += 4) {
      float4 av[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r)
        av[r] = *reinterpret_cast<const float4*>(as + r * TY * kLdA + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float4 bv[TN / 4];
#pragma unroll
        for (int j = 0; j < TN / 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(bs + (k + q) * kLdB + j * 4 * TX);
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float x = q == 0 ? av[r].x : q == 1 ? av[r].y : q == 2 ? av[r].z : av[r].w;
#pragma unroll
          for (int j = 0; j < TN / 4; ++j) {
            acc[r][4 * j] = __fadd_rn(acc[r][4 * j], __fmul_rn(x, bv[j].x));
            acc[r][4 * j + 1] = __fadd_rn(acc[r][4 * j + 1], __fmul_rn(x, bv[j].y));
            acc[r][4 * j + 2] = __fadd_rn(acc[r][4 * j + 2], __fmul_rn(x, bv[j].z));
            acc[r][4 * j + 3] = __fadd_rn(acc[r][4 * j + 3], __fmul_rn(x, bv[j].w));
          }
        }
      }
    }

    if (cur.ch == nch - 1) {          // the unit's last chunk: store, restart
      float* cz = c + cur.z * static_cast<long long>(M) * N;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int row = cur.rt * BM + ty + r * TY;
#pragma unroll
        for (int j = 0; j < TN / 4; ++j) {
          const int col = cur.ct * BN + j * 4 * TX + tx * 4;
          if (row >= M || col >= N) continue;
          float* out = cz + static_cast<long long>(row) * N + col;
          if (N % 4 == 0) {
            *reinterpret_cast<float4*>(out) = make_float4(
                acc[r][4 * j], acc[r][4 * j + 1], acc[r][4 * j + 2], acc[r][4 * j + 3]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (col + q < N) out[q] = acc[r][4 * j + q];
          }
        }
#pragma unroll
        for (int q = 0; q < TN; ++q) acc[r][q] = 0.f;
      }
    }
    cur.advance(nch, batch, col_tiles);
    if (s + 1 < n_stages) __syncthreads();   // before stage s + 2 overwrites
    a_cur = a_next;
  }
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch(const float* a, long long sab, long long sam, long long sak,
                   const float* b, long long sbb, long long sbk, long long sbn, float* c,
                   int batch, int M, int K, int N, cudaStream_t stream) {
  constexpr int NT = threads<BM, BN, TM, TN>();
  constexpr int smem = smem_floats<BM, BN>() * static_cast<int>(sizeof(float));
  const auto kernel = batched_matmul_kernel<BM, BN, TM, TN>;
  // the most blocks resident at once on each device, read once a device
  static long long resident[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!resident[dev]) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
    if (err) return err;
    resident[dev] = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  }
  // 16-byte pieces along the unit-stride axis where every piece is aligned
  const auto how = [](const float* p, long long s_batch, long long s_row, long long s_col) {
    const bool base = reinterpret_cast<unsigned long long>(p) % 16 == 0 && s_batch % 4 == 0;
    if (s_col == 1 && base && s_row % 4 == 0) return int{kPieces};
    if (s_row == 1 && base && s_col % 4 == 0) return int{kRowLoads};
    return int{kWords};
  };
  const int how_a = how(a, sab, sam, sak), how_b = how(b, sbb, sbk, sbn);
  const long long units =
      static_cast<long long>(batch) * ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const unsigned grid = static_cast<unsigned>(units < resident[dev] ? units : resident[dev]);
  kernel<<<grid, NT, smem, stream>>>(a, sab, sam, sak, b, sbb, sbk, sbn, c, batch, M, K, N,
                                     units, how_a, how_b);
  return cudaGetLastError();
}

}  // namespace

// c (batch, M, N) contiguous = a @ b, a[b, i, k] at a + b*sab + i*sam + k*sak
// (sab = 0: one a for every batch entry), b[b, k, j] at b + b*sbb + k*sbk +
// j*sbn.  The wrapper checks the shapes and that M, N, K, batch > 0.  Picks
// the shape class (the note above).  Returns the launch's CUDA error (0
// on success).
extern "C" int batched_matmul_launch(const float* a, long long sab, long long sam,
                                     long long sak, const float* b, long long sbb,
                                     long long sbk, long long sbn, float* c, int batch,
                                     int M, int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M >= 128) {
    if (N > 32)
      err = launch<64, 64, 4, 8>(a, sab, sam, sak, b, sbb, sbk, sbn, c, batch, M, K, N, s);
    else if (N > 16)
      err = launch<64, 32, 4, 4>(a, sab, sam, sak, b, sbb, sbk, sbn, c, batch, M, K, N, s);
    else
      err = launch<64, 16, 4, 4>(a, sab, sam, sak, b, sbb, sbk, sbn, c, batch, M, K, N, s);
  } else if (N > 16) {
    err = launch<16, 32, 2, 4>(a, sab, sam, sak, b, sbb, sbk, sbn, c, batch, M, K, N, s);
  } else {
    err = launch<16, 16, 1, 4>(a, sab, sam, sak, b, sbb, sbk, sbn, c, batch, M, K, N, s);
  }
  return static_cast<int>(err);
}
