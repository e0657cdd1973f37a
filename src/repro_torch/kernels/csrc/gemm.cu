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
//   - no split-K, no stream-K: one accumulator holds each output over all
//     of K;
//   - K is walked in one fixed order: BLOCK_K tiles ascending, then the
//     tile's k16 wgmma steps ascending, all into the same registers
//     (bf16), or BLOCK_K tiles ascending, then the tile's k8 mma.sync
//     steps ascending, three products each in a fixed order (float32);
//   - the tile configuration is a function of (N, K, dtype) only
//     (kernels/gemm.py:launch_plan takes no M);
//   - rows past M are zeros (TMA's out-of-bounds fill), never another
//     variant; columns past N and the K tail likewise (a zero product
//     adds +0). Which CTA computes a tile, and whether a warpgroup whose
//     rows all lie past M skips its wgmmas, changes no sum.
//
// x: (M, K) row-major; W: (K, N) row-major (the JAX layout the port
// keeps); y: (M, N) row-major in x's dtype; accumulation in float32.
//
// What bounds it on the H100, at the main path's shapes (llada-8b, B
// requests of Sq = 129 rows, the head on 32 rows a request): the weight
// bytes at B <= 2 and in the LM head, the bf16 tensor-core rate above (a
// gate/up product at B = 4 is 51.9 GFLOP, 0.052 ms at 989 TFLOP/s,
// against 100.7 MB of weights, 0.030 ms at 3.35 TB/s). Only wgmma reaches
// that rate, and only if shared memory stays full without the math warps
// spending issue slots on copies. The bf16 design:
//   - TMA moves the tiles: x through a 2-D tensor map (K, M) in boxes of
//     64 k x 128 rows, W through one (N, K) in boxes of 64 n x 64 k, both
//     with the 128-byte swizzle wgmma reads (64 bf16 = 128 bytes); rows
//     past M and columns past N are the hardware's zero fill. The maps are
//     kernel parameters (__grid_constant__), so a CUDA graph records them
//     with the launch; the host encodes them at each launch (a pure
//     function of pointer, shape and box, cheap beside the launch);
//   - a ring in shared memory of 128 x 64 x-boxes and 64 x 256 W-tiles,
//     each stage with a "full" mbarrier (the producer's expect_tx; TMA
//     completes it) and an "empty" one (each consumer warp arrives once
//     its wgmmas on the stage have retired);
//   - warp roles: one producer thread issues every copy; two consumer
//     warpgroups own 64 rows x 256 columns each and issue, per stage, four
//     wgmma.mma_async m64n256k16 in ascending k (A K-major, B N-major
//     through the transpose-B bit), commit them, and retire the previous
//     stage's group (wait_group 1), so the tensor cores hold one stage's
//     work while the next is issued. setmaxnreg moves the producer
//     warpgroup's registers to the consumers (128 accumulators each);
//   - one tile for every product: 128 x 256, 4 stages of 48 KB, the
//     widest wgmma, which moves the fewest bytes per operation from L2.
//     Without split-K a product has only ceil(M / 128) * ceil(N / 256)
//     tiles to spread over 132 SMs, and which width fills the SMs best
//     depends on M (a 192-wide tile won at B <= 4 requests on N = 4096
//     and lost at B = 6), which the tile may not see.
//     One CTA per tile, the row tiles of one column tile next to each
//     other (a W tile comes from device memory once, then from L2); the
//     card hands out tiles as SMs free up, which kept the SMs at least as
//     busy as persistent CTAs walking the tiles in a fixed order did;
//   - the M tail: a request's 129 rows leave one live row in a second
//     row tile. A consumer warpgroup whose 64 rows all lie past M waits
//     and releases each stage without issuing its wgmmas, so the tail
//     costs a warpgroup's 64 rows, not a tile's 128;
//   - the epilogue rounds to bf16 (nearest even) and stores rows < M and
//     columns < N straight from the accumulators; with out_f32 it stores
//     the float32 sums, and with acc_in too it starts them from y's
//     float32 values: a tensor-parallel rank continues the previous
//     rank's partial sum over its rows of K, so the ranks' chain sums
//     in the one order a single rank's kernel does (bit-equal to it).
// The float32 route (the MoE routers, RG-LRU's u @ [w_a | w_x], the
// `tiny` config) runs on the tensor cores as three TF32 products per
// float32 product (3xTF32). Each operand value v is split once, as its
// fragment is loaded from shared memory, into big = tf32(v) and small =
// tf32(v - big) (cvt.rna's rounding), and each k8 step issues small.big,
// big.small and big.big, in that order, into a fragment of the step's
// own, which one float32 add (round to nearest) then adds to the
// output's accumulator. The dropped small.small term is below 2^-22 of
// each product, so the result keeps float32's accuracy (2e-5 of max
// |ref| at K = 7168), which one TF32 product (a 10-bit mantissa) would
// not. The step's own fragment is not a choice of speed: the tensor
// cores truncate where they add into their accumulator, and with every
// step's products added there the error grew with K to 2.1e-4 at the
// kimi-k2 router (K 7168; 2.4x the tolerance; H100, chip_smoke.py's
// check_gemm). Each output is still one accumulator over all of K, k8
// steps ascending, and an acc chain cut at a multiple of 8 is the same
// sequence of adds.
//   - mma.sync.m16n8k8.tf32, not wgmma: wgmma's .tf32 form reads both
//     operands K-major only (its transpose bits exist for 16-bit types
//     alone), and W is (K, N) row-major, N-major. mma.sync's B fragment
//     is loaded by hand from a K x N tile (b0 = W[k = lane % 4][n =
//     lane / 4]), so W lands in shared memory as it is, with no
//     transpose pass, and the split runs in registers;
//   - tiles of 64 rows x BN columns x 32 k, 4 warps, a cp.async ring of
//     4 stages (rows past M, columns past N and the K tail zero-filled).
//     BN is the widest of 64, 32, 16, 8 that gives N at least 32 column
//     tiles (kernels/gemm.py:f32_block_n): a router (N 64 or 384), bound
//     by latency, spreads over more CTAs without splitting K, and a wide
//     product runs two 64 x 64 CTAs an SM, 8 warps to hide the latency
//     of mma.sync (on the H100 both beat one 64 x 128 CTA of 4 warps an
//     SM). BN 64: 2 x 2 warps of 32 x 32; BN <= 32: 4 x 1 warps of 16 x
//     BN;
//   - per output the serial chain is K / 8 float32 adds; each step's
//     three mma.sync are a chain of their own, independent of the other
//     steps', so a router (its bytes take 0.0005 ms) is bound by issue
//     and latency, while RG-LRU's product (M 128, K 4096, N 8192) is
//     bound by the tensor cores: 3 x 2 M K N operations at 495 TFLOP/s
//     (kernels/cost.py counts 2 M K N at a third of that rate);
//   - shared-memory rows padded (x rows 36 floats, W rows 8 mod 32), so
//     each fragment load hits 32 distinct banks.
// Where the bf16 kernel's time goes: chip_smoke.py times it beside cuBLAS and
// its bound at every product of a step at B = 1..8, and its probe build
// below against it. On the H100 the load path alone (probe 1)
// takes most of the kernel's time from B = 4 on: the feed of x and W
// boxes from L2 into shared memory, not the tensor cores, bounds it
// there (each row tile reads all of its W column again), so a tile that
// loads fewer bytes per operation is the next lever (PERF.md).
#include <cuda.h>            // CUtensorMap and its enums; no -lcuda
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// GEMM_PROBE=1 (chip_smoke.py only): the load path alone (the consumers
// release each stage without their wgmmas; the output is garbage).
#ifndef GEMM_PROBE
#define GEMM_PROBE 0
#endif

namespace {

// must match kernels/gemm.py:_TILES and launch_plan
constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4, kThreads = 384;
constexpr int kFBM = 64, kFBK = 32, kFStages = 4, kFThreads = 128;
constexpr int kFBNMax = 64, kFBNMin = 8, kFColTiles = 32;
constexpr int kFAStride = kFBK + 4;              // floats a row of x's tile

constexpr int kBox = 64;              // bf16 in a 128-byte swizzled row
constexpr int kConsumers = 2;         // warpgroups of 64 rows each
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kABytes = kBM * kBK * 2;           // one x box
constexpr int kBoxBytes = kBK * kBox * 2;        // one W box
constexpr int kStageBytes = kABytes + kBN / kBox * kBoxBytes;
// the ring, 1024 bytes to align it, and 2 mbarriers a stage
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;
static_assert(kBN % kBox == 0 && kStageBytes % 1024 == 0,
              "stages must hold whole 1024-byte swizzle atoms");
static_assert(kSmemBytes <= 232448, "dynamic shared memory");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One 2-D box of the tensor map at (c0 inner, c1 outer) into shared
// memory; its bytes complete the barrier's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1) : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, LBO
// and SBO in bytes (stored in 16-byte units).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>(lbo >> 4) << 16
         | static_cast<uint64_t>(sbo >> 4) << 32
         | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads across a wgmma wait.
template <int R>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256 f32, 128 a thread) += A (64 x 16, K-major) * B (16 x 256,
// N-major: the transpose-B bit), both read from shared memory.
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

// The bf16 kernel: one CTA per 128 x 256 tile, of two consumer
// warpgroups (warps 0-7) and a producer warpgroup (warps 8-11, of which
// one thread works). CTA t computes row tile t % row_tiles of column tile
// t / row_tiles.
__global__ void __launch_bounds__(kThreads, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap tmap_x,
                 const __grid_constant__ CUtensorMap tmap_w,
                 void* __restrict__ y, int M, int N, int K, int out_f32,
                 int acc_in) {
  constexpr int S = kStages;
  extern __shared__ __align__(1024) unsigned char smem[];
  // stage s: the x box at ring + s * kStageBytes, then the W boxes; the
  // full barriers, then the empty ones, after the last stage
  const uint32_t ring = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t full = ring + S * kStageBytes;
  const uint32_t empty = full + 8 * S;

  const int row_tiles = (M + kBM - 1) / kBM;
  const int m0 = (blockIdx.x % row_tiles) * kBM;
  const int n0 = (blockIdx.x / row_tiles) * kBN;
  const int ktiles = (K + kBK - 1) / kBK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);                     // the producer's
      mbar_init(empty + 8 * s, kConsumers * 4);       // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     kProducerRegs));
    if (threadIdx.x != kConsumers * 128) return;
    tma_prefetch(&tmap_x);
    tma_prefetch(&tmap_w);
    // W boxes with a live column (a box wholly past N is not loaded; the
    // columns it would hold are never stored)
    const int boxes = min(kBN / kBox, (N - n0 + kBox - 1) / kBox);
    const int bytes = kABytes + boxes * kBoxBytes;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % S;
      mbar_wait(empty + 8 * s, ((kt / S) & 1) ^ 1);
      const uint32_t bar = full + 8 * s;
      const uint32_t dst = ring + s * kStageBytes;
      mbar_expect_tx(bar, bytes);
      tma_load(dst, &tmap_x, bar, kt * kBK, m0);
      for (int j = 0; j < boxes; ++j)
        tma_load(dst + kABytes + j * kBoxBytes, &tmap_w, bar,
                 n0 + j * kBox, kt * kBK);
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     kConsumerRegs));
    const int wg = warp >> 2;
    const int r0 = m0 + wg * 64;
    if (r0 >= M || GEMM_PROBE == 1) {
      // every row of this warpgroup lies past M (or the load-path probe):
      // release the stages as they land
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % S;
        mbar_wait(full + 8 * s, (kt / S) & 1);
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
      return;
    }
    // accumulator layout (m64nNk16, f32): warp w of the group holds rows
    // 16 w + lane / 4 (acc[4 i], acc[4 i + 1]) and 8 below (acc[4 i + 2],
    // acc[4 i + 3]), columns 8 i + 2 (lane % 4) and the next
    const int ra = r0 + (warp & 3) * 16 + (lane >> 2), rb = ra + 8;
    const int c0 = n0 + 2 * (lane & 3);
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
    if (acc_in) {
      // start from y's float32 sums (each thread reads the outputs it
      // will write, so y is read and written in place)
      const float* yf = static_cast<const float*>(y);
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        const int col = c0 + 8 * i;
        if (col >= N) continue;
        if (ra < M) {
          const float2 v = *reinterpret_cast<const float2*>(
              yf + static_cast<long long>(ra) * N + col);
          acc[4 * i] = v.x;
          acc[4 * i + 1] = v.y;
        }
        if (rb < M) {
          const float2 v = *reinterpret_cast<const float2*>(
              yf + static_cast<long long>(rb) * N + col);
          acc[4 * i + 2] = v.x;
          acc[4 * i + 3] = v.y;
        }
      }
    }
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % S;
      mbar_wait(full + 8 * s, (kt / S) & 1);
      // A: this warpgroup's 64 rows of the x box (K-major, 128-byte rows,
      // 8-row atoms 1024 bytes apart), a k16 step 32 bytes on. B: the W
      // boxes (N-major: 64-column atoms kBoxBytes apart, 8-k groups 1024
      // bytes apart), a k16 step 16 rows = 2048 bytes on.
      const uint32_t a = ring + s * kStageBytes + wg * 64 * 128;
      const uint32_t b = ring + s * kStageBytes + kABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_n256(acc, smem_desc(a + kk * 32, 16, 1024),
                   smem_desc(b + kk * 2048, kBoxBytes, 1024));
      wgmma_commit();
      wgmma_wait<1>();        // the previous stage's wgmmas have retired
      if (kt > 0 && lane == 0) mbar_arrive(empty + 8 * ((kt - 1) % S));
    }
    wgmma_wait<0>();
    fence_acc<kBN / 2>(acc);

    // out_f32: the float32 sums as they are (a tensor-parallel partial
    // sum, completed over the ranks before it is rounded once)
    if (out_f32) {
      float* yf = static_cast<float*>(y);
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        const int col = c0 + 8 * i;
        if (col >= N) continue;
        if (ra < M)
          *reinterpret_cast<float2*>(yf + static_cast<long long>(ra) * N
                                     + col) =
              make_float2(acc[4 * i], acc[4 * i + 1]);
        if (rb < M)
          *reinterpret_cast<float2*>(yf + static_cast<long long>(rb) * N
                                     + col) =
              make_float2(acc[4 * i + 2], acc[4 * i + 3]);
      }
      return;
    }
    __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      const int col = c0 + 8 * i;
      if (col >= N) continue;
      if (ra < M)
        *reinterpret_cast<__nv_bfloat162*>(
            yb + static_cast<long long>(ra) * N + col) =
            __floats2bfloat162_rn(acc[4 * i], acc[4 * i + 1]);
      if (rb < M)
        *reinterpret_cast<__nv_bfloat162*>(
            yb + static_cast<long long>(rb) * N + col) =
            __floats2bfloat162_rn(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
}

// ------------------------------------------------------------- float32

// A row of W's tile in floats: 8 mod 32, so the fragment loads (k = lane
// % 4, n = lane / 4) hit 32 distinct banks.
__host__ __device__ constexpr int f32_b_stride(int bn) {
  return (bn + 31) / 32 * 32 + 8;
}
// One stage of the ring in floats: x's 64 x 32 tile, then W's 32 x BN.
__host__ __device__ constexpr int f32_stage_floats(int bn) {
  return kFBM * kFAStride + kFBK * f32_b_stride(bn);
}

// v rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; finite v): an integer add of half the dropped ulp to the
// magnitude, then the 13 low mantissa bits cleared. ptxas expands
// cvt.rna.tf32.f32 into a compare-and-select sequence per value; this is
// two integer ops.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = big + small, both TF32 (v - big is exact in float32).
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(v);
  small = to_tf32(v - __uint_as_float(big));
}

// d (16 x 8, f32) += a (16 x 8, row-major) * b (8 x 8, column-major),
// TF32 operands.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (16 x 8, f32) = a * b, from zero.
__device__ __forceinline__ void mma_tf32_zero(float* d, const uint32_t* a,
                                              const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// VEC floats from global to shared memory, or zeros where !valid.
template <int VEC>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src,
                                         bool valid) {
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// float32 (3xTF32): one CTA per 64 x BN tile, CTA (i, j) computing row
// tile i of column tile j, on WM x (4 / WM) warps of MI x NI m16n8
// fragments each. Each output is one accumulator, from 0 or (acc_in) from
// its value in y, over the k8 steps in ascending order. VEC: floats per
// cp.async (4 where K, N and the bases allow 16-byte copies, else 1).
template <int WM, int MI, int NI, int VEC>
__global__ void __launch_bounds__(kFThreads)
gemm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ y, int M, int N, int K, int acc_in) {
  constexpr int WN = kFThreads / 32 / WM;
  constexpr int BN = WN * NI * 8;
  constexpr int BS = f32_b_stride(BN);
  constexpr int kStage = f32_stage_floats(BN);
  static_assert(WM * MI * 16 == kFBM, "the warps cover the tile's rows");
  extern __shared__ __align__(16) float fsm[];
  const int m0 = blockIdx.x * kFBM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp / WN) * MI * 16;     // the warp's rows in the tile
  const int wc = (warp % WN) * NI * 8;      // and its columns
  const int ktiles = (K + kFBK - 1) / kFBK;

  // k tile kt of x (64 x 32) and of W (32 x BN) into stage s; rows past
  // M, columns past N and k past K are zeros
  auto load = [&](int kt, int s) {
    float* as = fsm + s * kStage;
    float* bs = as + kFBM * kFAStride;
    const int k0 = kt * kFBK;
    constexpr int AC = kFBM * kFBK / VEC, BC = kFBK * BN / VEC;
#pragma unroll
    for (int i = 0; i < (AC + kFThreads - 1) / kFThreads; ++i) {
      const int c = threadIdx.x + i * kFThreads;
      if (AC % kFThreads != 0 && c >= AC) break;
      const int r = c / (kFBK / VEC), kc = c % (kFBK / VEC) * VEC;
      const bool ok = m0 + r < M && k0 + kc < K;
      cp_async<VEC>(smem_u32(as + r * kFAStride + kc),
                    ok ? x + static_cast<long long>(m0 + r) * K + k0 + kc
                       : x, ok);
    }
#pragma unroll
    for (int i = 0; i < (BC + kFThreads - 1) / kFThreads; ++i) {
      const int c = threadIdx.x + i * kFThreads;
      if (BC % kFThreads != 0 && c >= BC) break;
      const int kr = c / (BN / VEC), nc = c % (BN / VEC) * VEC;
      const bool ok = k0 + kr < K && n0 + nc < N;
      cp_async<VEC>(smem_u32(bs + kr * BS + nc),
                    ok ? w + static_cast<long long>(k0 + kr) * N + n0 + nc
                       : w, ok);
    }
  };

  // fragment layout (m16n8, f32): acc[mi][ni][q] is row wr + 16 mi + g
  // (+ 8 for q >= 2), column wc + 8 ni + 2 t (+ 1 for odd q)
  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + wr + mi * 16 + g + (q >> 1) * 8;
        const int col = n0 + wc + ni * 8 + 2 * t + (q & 1);
        acc[mi][ni][q] = (acc_in && row < M && col < N)
                             ? y[static_cast<long long>(row) * N + col]
                             : 0.f;
      }
  // a warp whose rows all lie past M skips its mma.sync (no other sum
  // changes)
  const bool live = m0 + wr < M;

#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kFStages - 2>();     // tile kt has landed
    __syncthreads();                   // and every warp is done with kt - 1
    if (kt + kFStages - 1 < ktiles)
      load(kt + kFStages - 1, (kt + kFStages - 1) % kFStages);
    cp_async_commit();
    if (!live) continue;
    const float* as = fsm + (kt % kFStages) * kStage;
    const float* bs = as + kFBM * kFAStride;
#pragma unroll
    for (int kk = 0; kk < kFBK; kk += 8) {
      uint32_t a_big[MI][4], a_small[MI][4];
      uint32_t b_big[NI][2], b_small[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const float* a = as + (wr + mi * 16 + g) * kFAStride + kk + t;
        split_tf32(a[0], a_big[mi][0], a_small[mi][0]);
        split_tf32(a[8 * kFAStride], a_big[mi][1], a_small[mi][1]);
        split_tf32(a[4], a_big[mi][2], a_small[mi][2]);
        split_tf32(a[8 * kFAStride + 4], a_big[mi][3], a_small[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const float* b = bs + (kk + t) * BS + wc + ni * 8 + g;
        split_tf32(b[0], b_big[ni][0], b_small[ni][0]);
        split_tf32(b[4 * BS], b_big[ni][1], b_small[ni][1]);
      }
      // small.big, big.small, big.big, the fixed order of each k8 step,
      // into a fragment of the step's own, then one float32 add into the
      // output's accumulator
      float step[MI][NI][4];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_tf32_zero(step[mi][ni], a_small[mi], b_big[ni]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
          mma_tf32(step[mi][ni], a_big[mi], b_small[ni]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          mma_tf32(step[mi][ni], a_big[mi], b_big[ni]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][ni][q] += step[mi][ni][q];
        }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = m0 + wr + mi * 16 + g + (q >> 1) * 8;
        const int col = n0 + wc + ni * 8 + 2 * t + (q & 1);
        if (row < M && col < N)
          y[static_cast<long long>(row) * N + col] = acc[mi][ni][q];
      }
}

// cuTensorMapEncodeTiled is a driver call: reached through the runtime's
// entry-point query, so the library links no -lcuda.
typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiledFn encoder() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A 2-D bf16 tensor map over a row-major (outer, inner) array, boxes of
// (box_inner, box_outer), 128-byte swizzle, zeros out of bounds.
cudaError_t tensor_map(CUtensorMap* out, const void* ptr, uint64_t inner,
                       uint64_t outer, uint32_t box_inner,
                       uint32_t box_outer) {
  EncodeTiledFn encode = encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t unit[2] = {1, 1};
  return encode(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch_bf16(const void* x, const void* w, void* y, int M, int N,
                        int K, int out_f32, int acc_in, cudaStream_t s) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  CUtensorMap tx, tw;
  cudaError_t e = tensor_map(&tx, x, K, M, kBox, kBM);
  if (e == cudaSuccess) e = tensor_map(&tw, w, N, K, kBox, kBK);
  if (e != cudaSuccess) return e;
  const int grid = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  gemm_bf16_kernel<<<grid, kThreads, kSmemBytes, s>>>(tx, tw, y, M, N, K,
                                                     out_f32, acc_in);
  return cudaGetLastError();
}

// The float32 kernel's column tile: the widest of kFBNMax .. kFBNMin
// (halving) that gives N at least kFColTiles column tiles (a function of
// N alone, as kernels/gemm.py:f32_block_n).
int f32_block_n(int N) {
  int bn = kFBNMax;
  while (bn > kFBNMin && (N + bn - 1) / bn < kFColTiles) bn /= 2;
  return bn;
}

template <int WM, int MI, int NI, int VEC>
cudaError_t launch_f32_tile(const float* x, const float* w, float* y, int M,
                            int N, int K, int acc_in, cudaStream_t s) {
  constexpr int BN = kFThreads / 32 / WM * NI * 8;
  constexpr int smem = kFStages * f32_stage_floats(BN) * 4;
  static_assert(smem <= 232448, "dynamic shared memory");
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        gemm_f32_kernel<WM, MI, NI, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid((M + kFBM - 1) / kFBM, (N + BN - 1) / BN);
  gemm_f32_kernel<WM, MI, NI, VEC><<<grid, kFThreads, smem, s>>>(
      x, w, y, M, N, K, acc_in);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_f32(const float* x, const float* w, float* y, int M,
                       int N, int K, int acc_in, cudaStream_t s) {
  switch (f32_block_n(N)) {
    case 64: return launch_f32_tile<2, 2, 4, VEC>(x, w, y, M, N, K, acc_in,
                                                  s);
    case 32: return launch_f32_tile<4, 1, 4, VEC>(x, w, y, M, N, K, acc_in,
                                                  s);
    case 16: return launch_f32_tile<4, 1, 2, VEC>(x, w, y, M, N, K, acc_in,
                                                  s);
    default: return launch_f32_tile<4, 1, 1, VEC>(x, w, y, M, N, K, acc_in,
                                                  s);
  }
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16 (x and w); y is float32 where dtype is
// 0 or out_f32 is set, else bfloat16. acc_in (a float32 y only): the sums
// start from y's values. Returns cudaGetLastError() after the launch (or
// an error for arguments the kernels do not take).
extern "C" int gemm_launch(const void* x, const void* w, void* y, int M,
                           int N, int K, int dtype, int out_f32, int acc_in,
                           void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // TMA: 16-byte row strides and base addresses
    if (K % 8 != 0 || N % 8 != 0) return cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(x) % 16 != 0
        || reinterpret_cast<uintptr_t>(w) % 16 != 0)
      return cudaErrorMisalignedAddress;
    if (acc_in && !out_f32) return cudaErrorInvalidValue;
    return launch_bf16(x, w, y, M, N, K, out_f32, acc_in, s);
  }
  if (dtype == 0) {
    const bool vec = K % 4 == 0 && N % 4 == 0
                     && reinterpret_cast<uintptr_t>(x) % 16 == 0
                     && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    float* yf = static_cast<float*>(y);
    return vec ? launch_f32<4>(xf, wf, yf, M, N, K, acc_in, s)
               : launch_f32<1>(xf, wf, yf, M, N, K, acc_in, s);
  }
  return cudaErrorInvalidValue;
}
