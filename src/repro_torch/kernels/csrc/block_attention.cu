// Block attention for the diffusion decode query region, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/block_attention.py
// (_kernel / block_attention): flash-style online-softmax attention,
// bidirectional, GQA (kv head = h / (H / Hkv)), optional tanh softcap,
// optional window |q_pos - kv_pos| <= window, per-key (B, Skv) validity
// mask. Masked scores are -1e30, the running max is clamped at -1e4 and
// the softmax sum floored at 1e-20, so a query row with no valid key comes
// out as exact zeros. Output is float32.
//
// What bounds it on the H100: at the decode shapes (Sq = 129 query rows
// over Skv = a few hundred to a few thousand keys, D = 128) the work is
// small and the bytes are one read of K and V, so one pass over K/V at
// 3.35 TB/s is the bound; the scores never leave the chip.
//
// Design: the TPU kernel's sequential nK grid axis becomes a loop inside
// the block. Each block owns one (b, h, 16-row query tile) and walks the
// keys in 32-key tiles staged in shared memory as float32 (bf16 -> f32 is
// exact). Each warp owns 4 query rows; lane j scores key j of the tile,
// so the running max / sum are warp reductions and the online-softmax
// state lives in registers (each lane keeps D/32 output columns of each
// of its warp's rows). Instruction issue is the limit of this layout, so
// tiles arrive by 16-byte loads, each K and V element is read from shared
// memory once per warp for all 4 rows, and key tiles with no valid key
// are skipped. Ragged Sq/Skv edges are masked in
// the kernel; no padded copies are made. This is the simple version:
// CUDA-core f32 dots, K/V re-read once per query tile. wgmma, TMA and
// pipelining come later.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerWarp = 4;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileQ = kWarps * kRowsPerWarp;   // 16 query rows per block
constexpr int kTileK = 32;                      // one key per lane
constexpr float kNegInf = -1e30f;
constexpr float kMClamp = -1e4f;

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
block_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ q_pos,
                       const int* __restrict__ kv_pos,
                       const uint8_t* __restrict__ kv_mask,
                       float* __restrict__ out, int Sq, int Skv, int H,
                       int Hkv, float scale, float softcap, int window) {
  constexpr int kCols = D / 32;              // output columns per lane
  constexpr int kStride = D + 4;             // K row pitch: float4-aligned,
                                             // lanes spread over all banks
  constexpr int R = kRowsPerWarp;
  constexpr int kVec = 16 / sizeof(T);       // elements per 16-byte load
  constexpr int kChunks = D / kVec;          // 16-byte loads per row
  __shared__ __align__(16) float qs[kTileQ][D];
  __shared__ __align__(16) float ks[kTileK * kStride];
  __shared__ __align__(16) float vs[kTileK][D];
  __shared__ int kpos_s[kTileK];
  __shared__ uint8_t kok_s[kTileK];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);

  // stage the query tile, scaled in f32 before any dot
  for (int c = tid; c < kTileQ * kChunks; c += kThreads) {
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

  for (int k0 = 0; k0 < Skv; k0 += kTileK) {
    __syncthreads();   // previous tile fully consumed (and qs staged)
    bool key_valid = false;
    if (tid < kTileK) {
      const int kj = k0 + tid;
      key_valid = kj < Skv && kv_mask[int64_t(b) * Skv + kj] != 0;
      kok_s[tid] = key_valid;
      kpos_s[tid] = kj < Skv ? kv_pos[int64_t(b) * Skv + kj] : 0;
    }
    // A tile with no valid key leaves the softmax state exactly as it was
    // (p = 0, and m stays >= the clamp so the correction is 1): skip it.
    // Decode steps attend the whole cache buffer, much of it not yet valid.
    if (!__syncthreads_or(key_valid)) continue;
    for (int c = tid; c < kTileK * kChunks; c += kThreads) {
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
    for (int j = 0; j < kTileK; ++j) {
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
    float* o = out + ((int64_t(b) * Sq + qi) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[lane + 32 * c] = acc[r][c] * inv;
  }
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         const int* q_pos, const int* kv_pos,
                         const uint8_t* kv_mask, float* out, int B, int Sq,
                         int Skv, int H, int Hkv, int D, float scale,
                         float softcap, int window, cudaStream_t stream) {
  const dim3 grid((Sq + kTileQ - 1) / kTileQ, H, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  switch (D) {
    case 32:
      block_attention_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, q_pos, kv_pos, kv_mask, out, Sq, Skv, H, Hkv, scale,
          softcap, window);
      break;
    case 64:
      block_attention_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, q_pos, kv_pos, kv_mask, out, Sq, Skv, H, Hkv, scale,
          softcap, window);
      break;
    case 128:
      block_attention_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
          qt, kt, vt, q_pos, kv_pos, kv_mask, out, Sq, Skv, H, Hkv, scale,
          softcap, window);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int block_attention_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* kv_pos, const void* kv_mask, void* out, int B, int Sq,
    int Skv, int H, int Hkv, int D, int dtype, float scale, float softcap,
    int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || H % Hkv != 0)
    return cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(kv_pos);
  const uint8_t* km = static_cast<const uint8_t*>(kv_mask);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(q, k, v, qp, kp, km, o, B, Sq, Skv, H, Hkv, D,
                               scale, softcap, window, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, qp, kp, km, o, B, Sq, Skv, H,
                                       Hkv, D, scale, softcap, window, s);
  return cudaErrorInvalidValue;
}
