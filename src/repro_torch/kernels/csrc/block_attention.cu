// Block attention for the diffusion decode query region, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_attention.py
// (_kernel / block_attention): flash-style online-softmax attention,
// bidirectional, GQA (kv head = h / (H / Hkv)), optional tanh softcap,
// optional window |q_pos - kv_pos| <= window, per-key (B, Skv) validity
// mask. Masked scores are -1e30, the running max is clamped at -1e4 and
// the softmax sum floored at 1e-20, so a query row with no valid key comes
// out as exact zeros. Output is float32, or bfloat16 rounded to nearest
// even from the float32 result when the caller asks for it.
//
// Two kernels live here.
//
// attn_bf16_kernel<D> (bf16 inputs, D = 64, 128 or 256: the main path).
//   What bounds it on the H100: at the decode shapes (llada-8b step:
//   B=4, Sq=129 over Skv=513 keys, 32 heads, D=128) the work is about
//   3.3 us of bf16 tensor-core time and the bytes (one read of q and of
//   the attended K/V rows, one write of the output) about 11 us at
//   3.35 TB/s, so the kernel is byte-bound. The design therefore:
//   - reads K/V once per (b, kv head): one CTA owns one (b, kv head)
//     and every query row that attends it (the g = H / Hkv heads of a
//     GQA group are packed into the row dimension, row r = (query r / g,
//     head r % g)). Where the rows exceed what one CTA holds, or too few
//     CTAs would fill the card, the rows are split over a few CTAs and
//     the re-reads come from L2 (launch_plan in block_attention.py);
//   - keeps the loads in flight: a producer warp streams 32-key K/V
//     tiles into a 4-stage shared-memory ring. K/V rows of one head are
//     strided by Hkv * D elements, so it copies row by row with 16-byte
//     cp.async, D/8 lanes per row (coalesced), and signals the stage's
//     mbarrier with cp.async.mbarrier.arrive.noinc when they land; it
//     reads each tile's mask and positions one tile ahead. Consumers
//     wait on the stage and release it after their PV. One
//     cp.async.bulk per 256-byte row was tried first and was slower on
//     the H100 (PERF.md). No tensor map is
//     needed, so a launch costs the host nothing beyond the launch
//     itself (the host sets the decode's pace), and nothing is set per
//     call, so the launch stays graph-capturable;
//   - skips tiles in the producer: it reads the (B, Skv) mask for its
//     tile before any copy, and a tile with no valid key (or, with a
//     window, none inside any row's window) is neither loaded nor
//     multiplied. Masked keys inside a loaded tile are not copied
//     either; their rows are zero-filled;
//   - does both products on tensor cores, bf16 operands accumulating in
//     f32: each consumer warp owns 16 query rows and runs
//     mma.sync.m16n8k16 fed by ldmatrix from shared memory (rows padded
//     by 16 bytes, so ldmatrix is free of bank conflicts). mma.sync,
//     not wgmma: its synchronous fragments were the shorter way to a
//     kernel that is right (wgmma is the next step, below). `scale`
//     multiplies the f32 scores, not bf16 q (1/sqrt(128) is not a power
//     of two).
//     P is split into P_hi + P_lo, both bf16, and both go through PV
//     into the same f32 accumulator: rounding P once to bf16 would add
//     ~1e-3 error that the plain version does not have.
//   The online softmax runs per row in registers, in mma's accumulator
//   layout, on scores scaled by log2(e) so that p = ex2(s - m); max and
//   sum reduce over the 4 lanes that share a row.
//   Where the time goes now: chip_smoke.py's probe phase times the load
//   path alone and the math alone (ATTN_PROBE below); on the H100 the
//   math, mma.sync doubled in PV by P_lo plus the softmax, is the larger
//   (PERF.md). wgmma (asynchronous, from shared memory) is the
//   next step.
//   ptxas -v (sm_90a, both output types): D=128 157 registers, D=64
//   118, no stack, no spills (__launch_bounds__(384, 1) allows 168).
//   Dynamic shared memory at D=128: 4 stages x 2 x 32 rows x 272 bytes
//   + 4352 bytes per consumer warp (109,440 bytes at the step's 9
//   warps, 118,144 at the most, 11).
//   D = 256 (recurrentgemma's local layers) is its own instantiation
//   with its own warp cap: a consumer warp's f32 output accumulator alone
//   is 16 x 256 / 32 = 128 registers a thread, which 168 cannot hold
//   beside the scores and fragments. Its cap is 7 consumer warps (256
//   threads with the producer), so __launch_bounds__(256, 1) lets ptxas
//   give 255 registers; Q stays in shared memory (ldmatrix per use).
//   Shared memory at D=256: 4 x 2 x 32 x 528 + 8448 per warp (194,304
//   bytes at 7 warps).
//
// attn_simple_kernel<T, D> (float32 inputs, D = 32/64/128; also built
//   for bf16 so that chip_smoke.py can time it beside the new kernel).
//   The first port: each block owns one (b, h, 16-row query tile) and
//   walks the keys in 32-key tiles staged in shared memory as float32;
//   CUDA-core f32 dots, one key per lane, K/V re-read per query tile,
//   key tiles with no valid key skipped. It serves the f32 reference
//   path, off the bf16 main path. ptxas -v: 96 registers and 41,728
//   bytes of static shared memory at D=128, no spills.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kMClamp = -1e4f;

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store_out2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_out2(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// ===================================================== bf16 tensor-core kernel

// Probe builds (chip_smoke.py's probe phase), never the library the port
// loads: 1 = consumers skip the math (the load path alone), 2 = the
// producer skips the copies (the math alone). Results are then garbage.
#ifndef ATTN_PROBE
#define ATTN_PROBE 0
#endif

constexpr int kTileK = 32;          // keys per ring stage: one per producer lane
constexpr int kStages = 4;
constexpr int kRowsPerWarp = 16;    // mma.sync m16
constexpr int kMaxWarps = 11;       // consumer warps per CTA (176 query rows):
                                    // 384 threads, so ptxas may give 168 registers
constexpr int kMaxWarps256 = 7;     // D = 256: 256 threads, 255 registers

template <int D>
constexpr int max_warps() { return D == 256 ? kMaxWarps256 : kMaxWarps; }
constexpr float kLog2e = 1.4426950408889634f;

struct alignas(16) StageMeta {
  int kpos[kTileK];   // kv_pos of the tile's keys
  uint32_t valid;     // bit j: key j in range and unmasked (and so loaded)
  int end;            // 1: no more tiles
  int pad[2];
};

template <int D>
struct Smem {
  static constexpr int kPitch = 2 * D + 16;        // bytes per padded row
  static constexpr int kStageBytes = 2 * kTileK * kPitch;   // K then V
  static constexpr int kQWarpBytes = kRowsPerWarp * kPitch;
  static __host__ __device__ int bytes(int warps) {
    return kStages * kStageBytes + warps * kQWarpBytes +
           kStages * int(sizeof(StageMeta)) + 2 * kStages * 8;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// 16 bytes, global -> shared, asynchronously.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src) : "memory");
}

// One arrival on `bar` once this thread's cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(smem_u32(bar)) : "memory");
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

// 2^x in one MUFU instruction (relative error ~2^-22); 2^(-huge) = +0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// The bf16 residual x - bf16(x), packed like pack_bf16.
__device__ __forceinline__ uint32_t pack_bf16_residual(float lo, float hi) {
  const float rlo = lo - __bfloat162float(__float2bfloat16_rn(lo));
  const float rhi = hi - __bfloat162float(__float2bfloat16_rn(hi));
  return pack_bf16(rlo, rhi);
}

// Grid (ctas_per_head, Hkv, B); block (warps + 1) * 32 threads: consumer
// warps 0 .. warps-1, the producer warp last. CTA x of (b, kv head) owns
// the 16-row tiles [x*T/c, (x+1)*T/c) of the g*Sq packed rows.
template <int D, typename OutT>
__global__ void __launch_bounds__((max_warps<D>() + 1) * 32, 1)
attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ q_pos,
                 const int* __restrict__ kv_pos,
                 const uint8_t* __restrict__ kv_mask,
                 OutT* __restrict__ out, int Sq, int Skv, int H, int Hkv,
                 float scale, float softcap, int window) {
  using S = Smem<D>;
  constexpr int P = S::kPitch;
  constexpr int kRowBytes = 2 * D;
  extern __shared__ __align__(128) uint8_t smem[];
  const int warps = blockDim.x / 32 - 1;
  uint8_t* stage_base = smem;
  uint8_t* q_base = smem + kStages * S::kStageBytes;
  StageMeta* meta =
      reinterpret_cast<StageMeta*>(q_base + warps * S::kQWarpBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(meta + kStages);
  uint64_t* empty = full + kStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / Hkv;
  const int rows = g * Sq;
  const int tiles = (rows + kRowsPerWarp - 1) / kRowsPerWarp;
  const int c = gridDim.x;
  const int tile_begin = int(int64_t(blockIdx.x) * tiles / c);
  const int tile_end = int(int64_t(blockIdx.x + 1) * tiles / c);
  const int n_active = tile_end - tile_begin;   // consumer warps with rows

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // each producer lane arrives twice: once after writing the stage's
      // metadata, once (cp.async ...arrive.noinc) when its copies land
      mbar_init(&full[s], 64);
      mbar_init(&empty[s], n_active);   // lane 0 of each working consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == warps) {
    // ------------------------------------------------------------ producer
    int qmin = 0x7fffffff, qmax = -0x7fffffff;
    if (window > 0) {
      const int r0 = tile_begin * kRowsPerWarp;
      const int r1 = min(tile_end * kRowsPerWarp, rows);
      for (int qi = r0 / g + lane; qi <= (r1 - 1) / g; qi += 32) {
        const int p = q_pos[int64_t(b) * Sq + qi];
        qmin = min(qmin, p);
        qmax = max(qmax, p);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
        qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
      }
    }
    const uint8_t* mask_b = kv_mask + int64_t(b) * Skv;
    const int* kpos_b = kv_pos + int64_t(b) * Skv;
    // this lane's key of the next tile, loaded one tile ahead so that its
    // latency overlaps the current tile's wait and copies
    bool ok_n = lane < Skv && mask_b[lane] != 0;
    int kp_n = lane < Skv ? kpos_b[lane] : 0;
    constexpr int kChunksRow = kRowBytes / 16;   // lanes per row copy
    const int ch = lane % kChunksRow;
    int stage = 0;
    uint32_t parity = 1;   // the ring starts empty: the first waits pass
    for (int k0 = 0; k0 < Skv; k0 += kTileK) {
      const bool ok = ok_n;
      const int kp = kp_n;
      const int kj = k0 + kTileK + lane;
      ok_n = kj < Skv && mask_b[kj] != 0;
      kp_n = kj < Skv ? kpos_b[kj] : 0;
      const bool live = ok && (window <= 0 || (kp >= qmin - window &&
                                               kp <= qmax + window));
      // A tile that no row may attend leaves every row's softmax state
      // exactly as it was (p = 0, correction 1): neither load nor send it.
      if (!__any_sync(0xffffffffu, live)) continue;
      const uint32_t valid = __ballot_sync(0xffffffffu, ok);
      mbar_wait(&empty[stage], parity);
      StageMeta& m = meta[stage];
      uint8_t* ks = stage_base + stage * S::kStageBytes;
      m.kpos[lane] = kp;
      if (!ok) {   // zeros, so that p = 0 never meets a stale NaN
#pragma unroll
        for (int e = 0; e < kRowBytes; e += 16) {
          *reinterpret_cast<uint4*>(ks + lane * P + e) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(ks + (kTileK + lane) * P + e) =
              make_uint4(0, 0, 0, 0);
        }
      }
      if (lane == 0) {
        m.valid = valid;
        m.end = 0;
      }
      mbar_arrive(&full[stage]);   // metadata and zero rows written
      // valid keys' K and V rows, coalesced: kChunksRow lanes per row,
      // 16 bytes each
#pragma unroll 4
      for (int j0 = 0; j0 < kTileK * (ATTN_PROBE != 2);
           j0 += 32 / kChunksRow) {
        const int j = j0 + lane / kChunksRow;
        if ((valid >> j) & 1u) {
          const int64_t off =
              ((int64_t(b) * Skv + k0 + j) * Hkv + kvh) * D + ch * 8;
          cp_async16(ks + j * P + ch * 16, k + off);
          cp_async16(ks + (kTileK + j) * P + ch * 16, v + off);
        }
      }
      cp_async_arrive(&full[stage]);
      if (++stage == kStages) { stage = 0; parity ^= 1; }
    }
    mbar_wait(&empty[stage], parity);
    if (lane == 0) meta[stage].end = 1;
    mbar_arrive(&full[stage]);
    mbar_arrive(&full[stage]);
  } else if (warp < n_active) {
    // ------------------------------------------------------------ consumer
    const int row0 = (tile_begin + warp) * kRowsPerWarp;
    uint8_t* qs = q_base + warp * S::kQWarpBytes;
    constexpr int kChunks = kRowBytes / 16;      // 16-byte chunks per row
    constexpr int kPerLane = kRowsPerWarp * kChunks / 32;
    {
      uint4 x[kPerLane];   // all loads in flight before the first store
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        const int i = lane + 32 * t;
        const int pr = row0 + i / kChunks, ch = i % kChunks;
        x[t] = make_uint4(0, 0, 0, 0);
        if (pr < rows)
          x[t] = *reinterpret_cast<const uint4*>(
              q + ((int64_t(b) * Sq + pr / g) * H + kvh * g + pr % g) * D +
              ch * 8);
      }
#pragma unroll
      for (int t = 0; t < kPerLane; ++t) {
        const int i = lane + 32 * t;
        *reinterpret_cast<uint4*>(qs + (i / kChunks) * P +
                                  (i % kChunks) * 16) = x[t];
      }
    }
    __syncwarp();

    // this lane's two rows of every 16-row fragment: lane/4 and lane/4+8
    const int ra = row0 + lane / 4, rb = ra + 8;
    const int qpa = ra < rows ? q_pos[int64_t(b) * Sq + ra / g] : 0;
    const int qpb = rb < rows ? q_pos[int64_t(b) * Sq + rb / g] : 0;
    const int col = (lane % 4) * 2;              // first key column owned
    // scores are kept in the log2 domain: x * log2(e), so p = 2^(x - m)
    const float scale2 = scale * kLog2e;
    const float clamp2 = kMClamp * kLog2e;
    float ma = clamp2, mb = clamp2, la = 0.f, lb = 0.f;
    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    // ldmatrix lane addresses (byte offsets inside a tile)
    const int q_off = (lane % 16) * P + (lane / 16) * 16;
    const int k_off = (lane % 8) * P + (lane / 8) * 16;
    const int v_off = ((lane % 8) + ((lane / 8) % 2) * 8) * P +
                      (lane / 16) * 16;

    int stage = 0;
    uint32_t parity = 0;
    for (;;) {
      mbar_wait(&full[stage], parity);
      const StageMeta& m = meta[stage];
      if (m.end) break;
      const uint8_t* ks = stage_base + stage * S::kStageBytes;
      const uint8_t* vs = ks + kTileK * P;
#if ATTN_PROBE != 1

      // S = Q K^T over the tile's keys: kTileK/8 n-tiles of 8 keys
      constexpr int kN = kTileK / 8;
      float s[kN][4];
#pragma unroll
      for (int n = 0; n < kN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int d2 = 0; d2 < D / 32; ++d2) {
        uint32_t qa[4], qb[4];
        ldmatrix_x4(qa, qs + q_off + d2 * 64);
        ldmatrix_x4(qb, qs + q_off + d2 * 64 + 32);
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          uint32_t kb[4];
          ldmatrix_x4(kb, ks + n * 8 * P + k_off + d2 * 64);
          mma_bf16(s[n], qa, kb[0], kb[1]);
          mma_bf16(s[n], qb, kb[2], kb[3]);
        }
      }

      // mask, softcap, online softmax (rows a: s[n][0..1], b: s[n][2..3])
      float cur_a = kNegInf, cur_b = kNegInf;
      const uint32_t valid = m.valid;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = n * 8 + col + (e & 1);
          float x = s[n][e] * scale;
          if (softcap != 0.f) x = softcap * tanhf(x / softcap);
          bool ok = (valid >> kc) & 1u;
          if (window > 0) ok = ok && abs((e < 2 ? qpa : qpb) - m.kpos[kc])
                                     <= window;
          x = ok ? x * kLog2e : kNegInf;
          s[n][e] = x;
          if (e < 2) cur_a = fmaxf(cur_a, x); else cur_b = fmaxf(cur_b, x);
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        cur_a = fmaxf(cur_a, __shfl_xor_sync(0xffffffffu, cur_a, o));
        cur_b = fmaxf(cur_b, __shfl_xor_sync(0xffffffffu, cur_b, o));
      }
      const float na = fmaxf(ma, fmaxf(cur_a, clamp2));
      const float nb = fmaxf(mb, fmaxf(cur_b, clamp2));
      const float corr_a = exp2_approx(ma - na);
      const float corr_b = exp2_approx(mb - nb);
      ma = na;
      mb = nb;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        s[n][0] = exp2_approx(s[n][0] - na);
        s[n][1] = exp2_approx(s[n][1] - na);
        s[n][2] = exp2_approx(s[n][2] - nb);
        s[n][3] = exp2_approx(s[n][3] - nb);
        sum_a += s[n][0] + s[n][1];
        sum_b += s[n][2] + s[n][3];
      }
      la = la * corr_a + sum_a;       // this lane's share of the row sum
      lb = lb * corr_b + sum_b;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][0] *= corr_a;
        acc[j][1] *= corr_a;
        acc[j][2] *= corr_b;
        acc[j][3] *= corr_b;
      }

      // O += P V, P = P_hi + P_lo: 16-key chunks, D/8 n-tiles of 8
#pragma unroll
      for (int kc = 0; kc < kTileK / 16; ++kc) {
        const float* p0 = s[2 * kc];
        const float* p1 = s[2 * kc + 1];
        const uint32_t hi[4] = {pack_bf16(p0[0], p0[1]),
                                pack_bf16(p0[2], p0[3]),
                                pack_bf16(p1[0], p1[1]),
                                pack_bf16(p1[2], p1[3])};
        const uint32_t lo[4] = {pack_bf16_residual(p0[0], p0[1]),
                                pack_bf16_residual(p0[2], p0[3]),
                                pack_bf16_residual(p1[0], p1[1]),
                                pack_bf16_residual(p1[2], p1[3])};
#pragma unroll
        for (int d2 = 0; d2 < D / 16; ++d2) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vs + kc * 16 * P + v_off + d2 * 32);
          mma_bf16(acc[2 * d2], hi, vb[0], vb[1]);
          mma_bf16(acc[2 * d2 + 1], hi, vb[2], vb[3]);
          mma_bf16(acc[2 * d2], lo, vb[0], vb[1]);
          mma_bf16(acc[2 * d2 + 1], lo, vb[2], vb[3]);
        }
      }
#endif
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kStages) { stage = 0; parity ^= 1; }
    }

#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      la += __shfl_xor_sync(0xffffffffu, la, o);
      lb += __shfl_xor_sync(0xffffffffu, lb, o);
    }
    const float inv_a = 1.f / fmaxf(la, 1e-20f);
    const float inv_b = 1.f / fmaxf(lb, 1e-20f);
    OutT* oa = ra < rows ? out + ((int64_t(b) * Sq + ra / g) * H + kvh * g +
                                  ra % g) * D : nullptr;
    OutT* ob = rb < rows ? out + ((int64_t(b) * Sq + rb / g) * H + kvh * g +
                                  rb % g) * D : nullptr;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (oa) store_out2(oa + j * 8 + col, acc[j][0] * inv_a,
                         acc[j][1] * inv_a);
      if (ob) store_out2(ob + j * 8 + col, acc[j][2] * inv_b,
                         acc[j][3] * inv_b);
    }
  }
}

template <int D, typename OutT>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int* q_pos, const int* kv_pos,
                        const uint8_t* kv_mask, void* out, int B, int Sq,
                        int Skv, int H, int Hkv, int ctas_per_head,
                        int warps, float scale, float softcap, int window,
                        cudaStream_t stream) {
  const int smem = Smem<D>::bytes(warps);
  // Once per instantiation, before its first launch: more than 48 KB of
  // dynamic shared memory must be asked for (not a stream operation).
  static const cudaError_t attr = cudaFuncSetAttribute(
      attn_bf16_kernel<D, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<D>::bytes(max_warps<D>()));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(ctas_per_head, Hkv, B);
  attn_bf16_kernel<D, OutT><<<grid, (warps + 1) * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_pos, kv_pos, kv_mask,
      static_cast<OutT*>(out), Sq, Skv, H, Hkv, scale, softcap, window);
  return cudaGetLastError();
}

// ===================================================== simple kernel (first port)

constexpr int kSimpleRowsPerWarp = 4;
constexpr int kSimpleWarps = 4;
constexpr int kSimpleThreads = kSimpleWarps * 32;
constexpr int kSimpleTileQ = kSimpleWarps * kSimpleRowsPerWarp;   // 16 rows
constexpr int kSimpleTileK = 32;                                  // 1 key/lane

// Loads 16 bytes (4 float32 or 8 bfloat16 values) as float32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Stores n (a multiple of 4) float32 values to 16-byte-aligned shared memory.
template <int n>
__device__ __forceinline__ void store_f32(float* dst, const float* x) {
#pragma unroll
  for (int e = 0; e < n; e += 4)
    *reinterpret_cast<float4*>(dst + e) = make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D, typename OutT>
__global__ void __launch_bounds__(kSimpleThreads)
attn_simple_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ q_pos,
                   const int* __restrict__ kv_pos,
                   const uint8_t* __restrict__ kv_mask,
                   OutT* __restrict__ out, int Sq, int Skv, int H,
                   int Hkv, float scale, float softcap, int window) {
  constexpr int kCols = D / 32;              // output columns per lane
  constexpr int kStride = D + 4;             // K row pitch: float4-aligned,
                                             // lanes spread over all banks
  constexpr int R = kSimpleRowsPerWarp;
  constexpr int kVec = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int kChunks = D / kVec;          // 16-byte loads per row
  __shared__ __align__(16) float qs[kSimpleTileQ][D];
  __shared__ __align__(16) float ks[kSimpleTileK * kStride];
  __shared__ __align__(16) float vs[kSimpleTileK][D];
  __shared__ int kpos_s[kSimpleTileK];
  __shared__ uint8_t kok_s[kSimpleTileK];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * kSimpleTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);

  // stage the query tile, scaled in f32 before any dot
  for (int c = tid; c < kSimpleTileQ * kChunks; c += kSimpleThreads) {
    const int r = c / kChunks, d0 = (c % kChunks) * kVec;
    const int qi = q0 + r;
    float x[kVec] = {};
    if (qi < Sq) {
      load16(q + ((int64_t(b) * Sq + qi) * H + h) * D + d0, x);
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] *= scale;
    }
    store_f32<kVec>(&qs[r][d0], x);
  }

  float m[R], l[R], acc[R][kCols];
  int qp[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kMClamp;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
    const int qi = q0 + warp * R + r;
    qp[r] = qi < Sq ? q_pos[int64_t(b) * Sq + qi] : 0;
  }

  for (int k0 = 0; k0 < Skv; k0 += kSimpleTileK) {
    __syncthreads();   // previous tile fully consumed (and qs staged)
    bool key_valid = false;
    if (tid < kSimpleTileK) {
      const int kj = k0 + tid;
      key_valid = kj < Skv && kv_mask[int64_t(b) * Skv + kj] != 0;
      kok_s[tid] = key_valid;
      kpos_s[tid] = kj < Skv ? kv_pos[int64_t(b) * Skv + kj] : 0;
    }
    // A tile with no valid key leaves the softmax state exactly as it was
    // (p = 0, and m stays >= the clamp so the correction is 1): skip it.
    if (!__syncthreads_or(key_valid)) continue;
    for (int c = tid; c < kSimpleTileK * kChunks; c += kSimpleThreads) {
      const int j = c / kChunks, d0 = (c % kChunks) * kVec;
      const int kj = k0 + j;
      float kx[kVec] = {}, vx[kVec] = {};
      if (kj < Skv) {
        const int64_t off = ((int64_t(b) * Skv + kj) * Hkv + hk) * D + d0;
        load16(k + off, kx);
        load16(v + off, vx);
      }
      store_f32<kVec>(ks + j * kStride + d0, kx);
      store_f32<kVec>(&vs[j][d0], vx);
    }
    __syncthreads();

    // scores: lane j owns key j; each K element read once for the warp's
    // R rows, q read as float4 broadcasts
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(ks + lane * kStride);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qq = reinterpret_cast<const float4*>(qs[warp * R + r])[d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    const bool key_ok = kok_s[lane] != 0;
    const int kp = kpos_s[lane];
    float p[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float x = s[r];
      if (softcap != 0.f) x = softcap * tanhf(x / softcap);
      bool ok = key_ok;
      if (window > 0) ok = ok && abs(qp[r] - kp) <= window;
      x = ok ? x : kNegInf;
      const float m_prev = m[r];
      const float m_cur = fmaxf(warp_max(x), kMClamp);
      const float m_new = fmaxf(m_prev, m_cur);
      p[r] = expf(x - m_new);
      const float corr = expf(m_prev - m_new);
      l[r] = l[r] * corr + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
    }

    // P V: each V element read once for the warp's R rows
#pragma unroll 4
    for (int j = 0; j < kSimpleTileK; ++j) {
      float vj[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vj[c] = vs[j][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + warp * R + r;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-20f);
    OutT* o = out + ((int64_t(b) * Sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store_out(o + lane + 32 * c, acc[r][c] * inv);
  }
}

template <typename T, typename OutT>
cudaError_t launch_simple(const void* q, const void* k, const void* v,
                          const int* q_pos, const int* kv_pos,
                          const uint8_t* kv_mask, void* out, int B, int Sq,
                          int Skv, int H, int Hkv, int D, float scale,
                          float softcap, int window, cudaStream_t stream) {
  const dim3 grid((Sq + kSimpleTileQ - 1) / kSimpleTileQ, H, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  OutT* o = static_cast<OutT*>(out);
  switch (D) {
    case 32:
      attn_simple_kernel<T, 32, OutT><<<grid, kSimpleThreads, 0, stream>>>(
          qt, kt, vt, q_pos, kv_pos, kv_mask, o, Sq, Skv, H, Hkv, scale,
          softcap, window);
      break;
    case 64:
      attn_simple_kernel<T, 64, OutT><<<grid, kSimpleThreads, 0, stream>>>(
          qt, kt, vt, q_pos, kv_pos, kv_mask, o, Sq, Skv, H, Hkv, scale,
          softcap, window);
      break;
    case 128:
      attn_simple_kernel<T, 128, OutT><<<grid, kSimpleThreads, 0, stream>>>(
          qt, kt, vt, q_pos, kv_pos, kv_mask, o, Sq, Skv, H, Hkv, scale,
          softcap, window);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simple_out(const void* q, const void* k, const void* v,
                              const int* qp, const int* kp,
                              const uint8_t* km, void* out, int B, int Sq,
                              int Skv, int H, int Hkv, int D, int out_bf16,
                              float scale, float softcap, int window,
                              cudaStream_t s) {
  if (out_bf16)
    return launch_simple<T, __nv_bfloat16>(q, k, v, qp, kp, km, out, B, Sq,
                                           Skv, H, Hkv, D, scale, softcap,
                                           window, s);
  return launch_simple<T, float>(q, k, v, qp, kp, km, out, B, Sq, Skv, H,
                                 Hkv, D, scale, softcap, window, s);
}

}  // namespace

// The bf16 tensor-core kernel. `ctas_per_head` and `warps` come from
// launch_plan (block_attention.py); `smem_bytes` is the plan's dynamic
// shared memory, checked here against the kernel's own layout.
// Returns the launch's cudaError_t.
extern "C" int block_attention_bf16_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, const void* kv_mask, void* out, int B, int Sq,
    int Skv, int H, int Hkv, int D, int out_bf16, int ctas_per_head,
    int warps, int smem_bytes, float scale, float softcap, int window,
    void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  const int tiles = (H / Hkv * Sq + kRowsPerWarp - 1) / kRowsPerWarp;
  const int cap = D == 256 ? kMaxWarps256 : kMaxWarps;
  if (warps < 1 || warps > cap || ctas_per_head < 1 ||
      ctas_per_head > tiles ||
      int64_t(warps) * ctas_per_head < tiles)
    return cudaErrorInvalidValue;   // some CTA would get more than `warps`
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  const uint8_t* km = static_cast<const uint8_t*>(kv_mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 256) {
    if (smem_bytes != Smem<256>::bytes(warps)) return cudaErrorInvalidValue;
    return out_bf16
        ? launch_bf16<256, __nv_bfloat16>(q, k, v, qp, kp, km, out, B, Sq,
                                          Skv, H, Hkv, ctas_per_head, warps,
                                          scale, softcap, window, s)
        : launch_bf16<256, float>(q, k, v, qp, kp, km, out, B, Sq, Skv, H,
                                  Hkv, ctas_per_head, warps, scale, softcap,
                                  window, s);
  }
  if (D == 128) {
    if (smem_bytes != Smem<128>::bytes(warps)) return cudaErrorInvalidValue;
    return out_bf16
        ? launch_bf16<128, __nv_bfloat16>(q, k, v, qp, kp, km, out, B, Sq,
                                          Skv, H, Hkv, ctas_per_head, warps,
                                          scale, softcap, window, s)
        : launch_bf16<128, float>(q, k, v, qp, kp, km, out, B, Sq, Skv, H,
                                  Hkv, ctas_per_head, warps, scale, softcap,
                                  window, s);
  }
  if (D == 64) {
    if (smem_bytes != Smem<64>::bytes(warps)) return cudaErrorInvalidValue;
    return out_bf16
        ? launch_bf16<64, __nv_bfloat16>(q, k, v, qp, kp, km, out, B, Sq,
                                         Skv, H, Hkv, ctas_per_head, warps,
                                         scale, softcap, window, s)
        : launch_bf16<64, float>(q, k, v, qp, kp, km, out, B, Sq, Skv, H,
                                 Hkv, ctas_per_head, warps, scale, softcap,
                                 window, s);
  }
  return cudaErrorInvalidValue;
}

// The simple kernel. dtype: 0 = float32, 1 = bfloat16.
extern "C" int block_attention_simple_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, const void* kv_mask, void* out, int B, int Sq,
    int Skv, int H, int Hkv, int D, int dtype, int out_bf16, float scale,
    float softcap, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  const uint8_t* km = static_cast<const uint8_t*>(kv_mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_simple_out<float>(q, k, v, qp, kp, km, out, B, Sq, Skv, H,
                                    Hkv, D, out_bf16, scale, softcap, window,
                                    s);
  if (dtype == 1)
    return launch_simple_out<__nv_bfloat16>(q, k, v, qp, kp, km, out, B, Sq,
                                            Skv, H, Hkv, D, out_bf16, scale,
                                            softcap, window, s);
  return cudaErrorInvalidValue;
}
