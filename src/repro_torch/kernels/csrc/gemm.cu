// y = x @ W for the model's projections, for Hopper (sm_90a), with a
// reduction order that does not depend on the row count.
//
// No TPU kernel stands behind this one: the JAX package leaves its
// projections (q/k/v/o, the FFN, the LM head) to XLA's dot. On the card
// the library GEMM picks its tile shape and split-K by the row count
// M = B * Sq, so the order in which one output's products are summed, and
// with it the output's last bits, change with how many other rows share
// the batch. The decoder's exactness contract (a row decodes to the same
// bits whatever gang it sits in: compaction, merges, the prefix cache's
// in-batch recompute) needs a sum whose order depends on (N, K) alone:
//   - no split-K, no stream-K: one thread sums each output over all of K;
//   - K is walked in one fixed order: BLOCK_K tiles ascending, then the
//     tile's 16-wide mma k-steps ascending (bf16), or k ascending with one
//     fma each (float32);
//   - the tile configuration is a constant of the dtype (and so of
//     (N, K, dtype): kernels/gemm.py:launch_plan takes no M);
//   - rows past M are zeros in shared memory, never another variant;
//     columns past N and the K tail likewise (a zero product adds +0).
//
// x: (M, K) row-major; W: (K, N) row-major (the JAX layout the port
// keeps); y: (M, N) row-major in x's dtype; accumulation in float32.
//
// What bounds it on the H100, at the main path's shapes (llada-8b, B
// requests of Sq = 129): the weight bytes at B <= 2, the bf16 tensor-core
// rate above (a gate/up product at B = 4 is 51.9 GFLOP, 0.052 ms at
// 989 TFLOP/s, against 100.7 MB of weights, 0.030 ms at 3.35 TB/s). The
// design is the plain multistage one, kept simple:
//   - bf16: a 128 x 128 output tile per CTA of 8 warps (2 x 4, each
//     64 x 32: 4 x 4 mma.sync.m16n8k16 tiles, float32 accumulators);
//     a 4-stage cp.async ring of 128 x 32 x-tiles and 32 x 128 W-tiles in
//     shared memory, rows padded by 16 bytes so ldmatrix (x4 for x, x4.trans
//     for W) is free of bank conflicts; the grid runs the row tiles of one
//     column tile next to each other, so a W tile is read from device
//     memory once and the small x is re-read from L2;
//   - float32 (the `tiny` config): a plain 64 x 64 FFMA tile loop, 4 x 4
//     outputs per thread, no TF32 (it would change the numbers).
// mma.sync reaches only part of the card's bf16 rate, and the M tail of a
// 129-row request is computed on zeros up to the next 128: wgmma with a
// TMA ring is the next step (ROADMAP B 3).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// must match kernels/gemm.py
constexpr int kBM = 128, kBN = 128, kBK = 32, kStages = 4, kThreads = 256;
constexpr int kWM = kBM / 2, kMI = kWM / 16;  // warp rows, m16 tiles a warp
constexpr int kAPitch = kBK + 8;             // bf16 per x-tile row (80 bytes)
constexpr int kBPitch = kBN + 8;             // bf16 per W-tile row (272 bytes)
constexpr int kAStage = kBM * kAPitch;       // bf16 per stage
constexpr int kBStage = kBK * kBPitch;
constexpr int kSmemBytes = kStages * (kAStage + kBStage) * 2;

constexpr int kFBM = 64, kFBN = 64, kFBK = 16, kFThreads = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage: the x tile rows [m0, m0+BM) x cols [k0, k0+BK) and the W
// tile rows [k0, k0+BK) x cols [n0, n0+128), in 16-byte chunks spread
// over the threads. Out-of-range chunks are zero-filled (K % 8 == 0 and
// N % 8 == 0, so a chunk is wholly in or out).
__device__ __forceinline__ void load_stage(
    __nv_bfloat16* as, __nv_bfloat16* bs, const __nv_bfloat16* x,
    const __nv_bfloat16* w, int M, int N, int K, int m0, int n0, int k0) {
  constexpr int kAChunks = kBM * kBK / 8 / kThreads;
  constexpr int kBChunks = kBK * kBN / 8 / kThreads;
#pragma unroll
  for (int i = 0; i < kAChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
    const bool in = (m0 + r < M) && (k0 + col < K);
    const __nv_bfloat16* src =
        in ? x + static_cast<long long>(m0 + r) * K + k0 + col : x;
    cp_async16(as + r * kAPitch + col, src, in ? 16 : 0);
  }
#pragma unroll
  for (int i = 0; i < kBChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c >> 4, col = (c & 15) * 8;
    const bool in = (k0 + r < K) && (n0 + col < N);
    const __nv_bfloat16* src =
        in ? w + static_cast<long long>(k0 + r) * N + n0 + col : w;
    cp_async16(bs + r * kBPitch + col, src, in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
gemm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ y, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* as_base = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bs_base = as_base + kStages * kAStage;

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * kWM, wn = (warp >> 1) * 32;
  const int ktiles = (K + kBK - 1) / kBK;

  float acc[kMI][4][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles)
      load_stage(as_base + s * kAStage, bs_base + s * kBStage, x, w, M, N, K,
                 m0, n0, s * kBK);
    cp_async_commit();
  }

  // ldmatrix row addresses inside a stage: x rows (lane % 16) at k-column
  // 8 * (lane / 16); W rows (k) lane % 8 + 8 * ((lane / 8) % 2) at
  // n-column 8 * (lane / 16)
  const int a_row = wm + (lane & 15), a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = wn + (lane >> 4) * 8;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile kt landed; stage (kt - 1) % kStages is free
    const int nk = kt + kStages - 1;
    if (nk < ktiles)
      load_stage(as_base + (nk % kStages) * kAStage,
                 bs_base + (nk % kStages) * kBStage, x, w, M, N, K, m0, n0,
                 nk * kBK);
    cp_async_commit();

    const __nv_bfloat16* as = as_base + (kt % kStages) * kAStage;
    const __nv_bfloat16* bs = bs_base + (kt % kStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[kMI][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
        ldmatrix_x4(a[mi], as + (a_row + mi * 16) * kAPitch + kk + a_col);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk + b_row) * kBPitch + b_col + nj * 16);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

  // accumulator layout: c0, c1 at (row g, cols 2t, 2t + 1), c2, c3 at
  // row g + 8 (g = lane / 4, t = lane % 4)
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + 2 * t;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + h * 8;
        if (row < M)
          *reinterpret_cast<__nv_bfloat162*>(
              y + static_cast<long long>(row) * N + col) =
              __floats2bfloat162_rn(acc[mi][ni][2 * h],
                                    acc[mi][ni][2 * h + 1]);
      }
    }
  }
}

// float32: 64 x 64 outputs per CTA of 256 threads, 4 x 4 per thread; each
// output is one fma chain over k = 0 .. K-1.
__global__ void __launch_bounds__(kFThreads)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ y, int M, int N, int K) {
  __shared__ float as[kFBK][kFBM];            // x tile, transposed
  __shared__ float bs[kFBK][kFBN];
  const int m0 = blockIdx.x * kFBM, n0 = blockIdx.y * kFBN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = threadIdx.x + i * kFThreads;
      const int r = c >> 4, kc = c & 15;       // x: 64 rows x 16 k
      as[kc][r] = (m0 + r < M && k0 + kc < K)
                      ? x[static_cast<long long>(m0 + r) * K + k0 + kc] : 0.f;
      const int kr = c >> 6, nc = c & 63;      // W: 16 k x 64 cols
      bs[kr][nc] = (k0 + kr < K && n0 + nc < N)
                       ? w[static_cast<long long>(k0 + kr) * N + n0 + nc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) y[static_cast<long long>(row) * N + col] = acc[i][j];
    }
  }
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (or an error for arguments the kernels do not take).
extern "C" int gemm_launch(const void* x, const void* w, void* y, int M,
                           int N, int K, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (K % 8 != 0 || N % 8 != 0) return cudaErrorInvalidValue;
    static bool smem_set = false;
    if (!smem_set) {
      cudaError_t e = cudaFuncSetAttribute(
          gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kSmemBytes);
      if (e != cudaSuccess) return e;
      smem_set = true;
    }
    dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
    gemm_bf16_kernel<<<grid, kThreads, kSmemBytes, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
        M, N, K);
    return cudaGetLastError();
  }
  if (dtype == 0) {
    dim3 grid((M + kFBM - 1) / kFBM, (N + kFBN - 1) / kFBN);
    gemm_f32_kernel<<<grid, kFThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(y), M, N, K);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
