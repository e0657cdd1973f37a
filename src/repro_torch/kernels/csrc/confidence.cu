// Confidence + argmax over the vocabulary (Eq. 4), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/confidence.py
// (_kernel / confidence_argmax). Per row of logits: idx is the first index
// of the row's float32 maximum, and conf = 1 / max(sum exp(x - max), 1e-30),
// the largest softmax probability. The row's values are read once.
//
// The kernel also takes the two steps that used to run as passes in front
// of it, so that the decode's head path reads the LM head's logits exactly
// once:
//   - bf16 input: the head GEMM writes bf16; the kernel widens each value
//     to float32 in registers (exact), so the argmax is the one the float32
//     reference picks from the same bf16 logits. float32 input works too;
//   - the [MASK] ban: column mask_id (-1: none) counts as -1e30 after the
//     widening, as `logits[:, mask_id] = -1e30` does in the plain version.
//
// What bounds it on the H100: bytes. The main path's call (N = 128 rows,
// V = 126464, bf16) reads 32.4 MB, 9.7 us at 3.35 TB/s; one ex2 per element
// on the SFUs is about 4 us at that size, under it. The design:
//   - splits each row's vector body across CTAs: grid (N, splits), so the
//     card holds several CTAs per SM (kernels/confidence.py:launch_plan
//     picks the split count; 4 at N = 128, 512 CTAs). Split cuts fall on
//     16-byte boundaries of the row;
//   - keeps bytes in flight: each thread holds two groups of kUnroll = 2
//     independent 16-byte loads (8 bf16 or 4 float32 values each), through
//     the read-only path without L1 allocation, and issues the next
//     group's loads before it folds the group it holds. At 4 CTAs of 256
//     threads per SM that is 64 KB in flight on each SM. Deeper groups (4,
//     8), and groups folded as they land, were no faster on the H100
//     (PERF.md). A cp.async.bulk ring in shared memory would also do;
//     plain vector loads need no barriers and no shared memory for a pure
//     stream, so they came first;
//   - a row whose start is not 16-byte aligned (V = 50257, any odd stride)
//     takes its first a0 < 8 values as scalars in split 0 and its last
//     few after the vector body in the last split;
//   - per 16-byte vector: its max, then the running (m, s) is updated once,
//     with ex2.approx on (x - m) * log2(e); the running argmax
//     moves only on a strict `>`, and each thread visits its columns in
//     increasing order, so it keeps the first index of its maximum;
//   - partials merge by shuffles and shared memory; on equal maxima the
//     lower index wins, so the order of the merge cannot change idx;
//   - the CTA's partial (m, s, idx) goes to a scratch buffer (allocated by
//     the wrapper); the last CTA of a row to arrive (a __threadfence and a
//     per-row atomic counter, which it resets to 0, so the buffer stays
//     valid across CUDA-graph replays) merges the row's partials in a fixed
//     order and writes conf and idx. The fixed order makes the result the
//     same run to run. One launch; a row with one split writes directly.
// Where the time goes: chip_smoke.py times the loads alone and the
// arithmetic alone (CONF_PROBE below) and the call as the rows grow. On the
// H100 the bytes stream at about the peak rate once the kernel runs; a
// fixed cost of a few microseconds per launch (start, ramp-up, the rows'
// last-CTA merges) keeps the main path's short call well short of its
// bound (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <limits.h>

namespace {

// Probe builds (chip_smoke.py), never the library the port loads: 1 =
// the loads alone (each vector's words are only XORed together), 2 = the
// arithmetic alone (vectors are made from their index, nothing is read).
// Their results are garbage.
#ifndef CONF_PROBE
#define CONF_PROBE 0
#endif

// must match kernels/confidence.py
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;          // 16-byte loads in a thread's group
constexpr int kMaxSplits = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kBan = -1e30f;
constexpr int kNone = INT_MAX;      // no index seen yet

// 2^x in one MUFU instruction (relative error ~2^-22); 2^(-inf) = +0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes through the non-coherent read-only path, not kept in L1.
__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void widen(const uint4& v, float* x) {
    x[0] = __uint_as_float(v.x);
    x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z);
    x[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ float scalar(const float* p) {
    return __ldg(p);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  // bf16 -> float32 is a 16-bit shift: the lower address is the low half.
  static __device__ __forceinline__ void widen(const uint4& v, float* x) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float scalar(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

// Running state: max m, sum s of 2^((x - m) log2 e), first index a of m.
// It starts as the TPU kernel's does, at m = -1e30, s = 0, and a value
// moves m only if it is larger, so a banned value (or -inf) never does.
struct State {
  float m;
  float s;
  int a;
};

// Folds n values at columns col0 .. col0 + n - 1 (in order) into st.
template <int n>
__device__ __forceinline__ void fold(State& st, float* x, int col0,
                                     int mask_id) {
  const unsigned ban = unsigned(mask_id - col0);   // >= n unless banned here
  if (ban < unsigned(n)) {
#pragma unroll
    for (int i = 0; i < n; ++i) x[i] = (unsigned(i) == ban) ? kBan : x[i];
  }
  float vm = x[0];
#pragma unroll
  for (int i = 1; i < n; ++i) vm = fmaxf(vm, x[i]);
  if (vm > st.m) {
    int first = n - 1;
#pragma unroll
    for (int i = n - 1; i >= 0; --i) first = (x[i] == vm) ? i : first;
    st.s *= exp2_approx((st.m - vm) * kLog2e);
    st.m = vm;
    st.a = col0 + first;
  }
  // x - m first: it is exact near m, where x * log2e - m * log2e is not
  // (at m = -1e30 that difference of two roundings is some 1e23).
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < n; ++i) t += exp2_approx((x[i] - st.m) * kLog2e);
  st.s += t;
}

// A thread's group: vectors v, v + kThreads, .. (kUnroll of them, those
// below v_hi) of a row's body. load_group issues their loads, fold_group
// folds them.
__device__ __forceinline__ void load_group(uint4 (&r)[kUnroll],
                                           const uint4* body, int v,
                                           int v_hi) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (v + u * kThreads < v_hi) {
#if CONF_PROBE == 2
      // finite values: bit 30 (and 14) cleared, so |x| < 2
      const uint32_t w = (uint32_t(v + u * kThreads) * 2654435761u) &
                         0xbfffbfffu;
      r[u] = make_uint4(w, w ^ 0x00010001u, w ^ 0x80008000u,
                        w ^ 0x00200020u);
#else
      r[u] = load_stream(body + v + u * kThreads);
#endif
    }
  }
}

template <typename T>
__device__ __forceinline__ void fold_group(State& st,
                                           const uint4 (&r)[kUnroll], int v,
                                           int v_hi, int a0, int mask_id) {
  constexpr int kVec = Elem<T>::kVec;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (v + u * kThreads < v_hi) {
#if CONF_PROBE == 1
      st.a ^= r[u].x ^ r[u].y ^ r[u].z ^ r[u].w;
#else
      float f[kVec];
      Elem<T>::widen(r[u], f);
      fold<kVec>(st, f, a0 + (v + u * kThreads) * kVec, mask_id);
#endif
    }
  }
}

// st <- st merged with (m, s, a). The result does not depend on which side
// is which: equal maxima keep the lower index, and a side that saw nothing
// (m = -1e30, s = 0) adds nothing.
__device__ __forceinline__ void merge(State& st, float m, float s, int a) {
  const float M = fmaxf(st.m, m);
  const float s1 = (st.m == M) ? st.s : st.s * exp2_approx((st.m - M) * kLog2e);
  const float s2 = (m == M) ? s : s * exp2_approx((m - M) * kLog2e);
  if (m > st.m || (m == st.m && a < st.a)) st.a = a;
  st.m = M;
  st.s = s1 + s2;
}

__device__ __forceinline__ void warp_merge(State& st) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m = __shfl_xor_sync(0xffffffffu, st.m, o);
    const float s = __shfl_xor_sync(0xffffffffu, st.s, o);
    const int a = __shfl_xor_sync(0xffffffffu, st.a, o);
    merge(st, m, s, a);
  }
}

__device__ __forceinline__ void write_row(float* conf, int* idx, int row,
                                          const State& st) {
  conf[row] = 1.f / fmaxf(st.s, 1e-30f);
  idx[row] = (st.a == kNone) ? 0 : st.a;
}

// Grid (N, splits), kThreads threads. Split y of a row takes vectors
// [y * chunk, (y + 1) * chunk) of the row's 16-byte-aligned body, which
// starts at column a0; split 0 also takes columns [0, a0), the last split
// the columns after the body (kernels/confidence.py:LaunchPlan.columns).
template <typename T>
__global__ void __launch_bounds__(kThreads, 4)
conf_argmax_kernel(const T* __restrict__ logits, float* __restrict__ conf,
                   int* __restrict__ idx, float4* __restrict__ partials,
                   unsigned* __restrict__ counters, int V, long long stride,
                   int mask_id, int splits, int chunk) {
  constexpr int kVec = Elem<T>::kVec;
  const int row = blockIdx.x;
  const int split = blockIdx.y;
  const int tid = threadIdx.x;
  const T* x = logits + row * stride;
  const int a0 = min(V, int(((16u - (reinterpret_cast<uintptr_t>(x) & 15u))
                             & 15u) / sizeof(T)));
  const int nvec = (V - a0) / kVec;
  const int v_lo = min(split * chunk, nvec);
  const int v_hi = min(v_lo + chunk, nvec);

  State st{kBan, 0.f, kNone};
  if (split == 0 && tid < a0) {
    float xv = Elem<T>::scalar(x + tid);
    fold<1>(st, &xv, tid, mask_id);
  }
  const uint4* body = reinterpret_cast<const uint4*>(x + a0);
  // the next group's loads go out before this group's arithmetic
  constexpr int kStep = kThreads * kUnroll;
  uint4 cur[kUnroll], nxt[kUnroll];
  int v = v_lo + tid;
  load_group(cur, body, v, v_hi);
  for (; v < v_hi; v += kStep) {
    load_group(nxt, body, v + kStep, v_hi);
    fold_group<T>(st, cur, v, v_hi, a0, mask_id);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
  }
  const int tail = a0 + nvec * kVec;
  if (split == splits - 1 && tail + tid < V) {
    float xv = Elem<T>::scalar(x + tail + tid);
    fold<1>(st, &xv, tail + tid, mask_id);
  }

  // the CTA's partial: warps, then warp 0 over the warps
  __shared__ State warp_st[kWarps];
  __shared__ bool last;
  const int warp = tid / 32, lane = tid % 32;
  warp_merge(st);
  if (lane == 0) warp_st[warp] = st;
  __syncthreads();
  if (warp != 0) return;
  st = (lane < kWarps) ? warp_st[lane] : State{kBan, 0.f, kNone};
  warp_merge(st);
  if (splits == 1) {
    if (lane == 0) write_row(conf, idx, row, st);
    return;
  }
  if (lane == 0) {
    partials[row * splits + split] =
        make_float4(st.m, st.s, __int_as_float(st.a), 0.f);
    __threadfence();                      // the partial before the count
    last = atomicAdd(counters + row, 1u) == unsigned(splits - 1);
  }
  __syncwarp();
  if (!last) return;
  // the last CTA of the row: merge its partials, lane p taking p, p + 32, ..
  __threadfence();
  st = State{kBan, 0.f, kNone};
  for (int p = lane; p < splits; p += 32) {
    const float4 q = __ldcg(partials + row * splits + p);   // L2, not L1
    merge(st, q.x, q.y, __float_as_int(q.z));
  }
  warp_merge(st);
  if (lane == 0) {
    write_row(conf, idx, row, st);
    counters[row] = 0;                    // ready for the next launch
  }
}

template <typename T>
int launch(const void* logits, float* conf, int* idx, void* partials,
           void* counters, int N, int V, long long stride, int mask_id,
           int splits, int chunk, cudaStream_t s) {
  // every vector of a row's body (at most V / kVec of them) has a split
  if (int64_t(splits) * chunk < V / Elem<T>::kVec) return cudaErrorInvalidValue;
  conf_argmax_kernel<T><<<dim3(N, splits), kThreads, 0, s>>>(
      static_cast<const T*>(logits), conf, idx,
      static_cast<float4*>(partials), static_cast<unsigned*>(counters), V,
      stride, mask_id, splits, chunk);
  return cudaGetLastError();
}

}  // namespace

// logits (N, V) with rows `stride` elements apart, unit column stride;
// dtype 0 = float32, 1 = bfloat16. conf (N,) float32, idx (N,) int32.
// partials: N * splits float4 scratch; counters: N unsigned, all 0 (the
// kernel leaves them 0). Both may be null when splits == 1. Returns the
// launch's cudaError_t.
extern "C" int confidence_argmax_launch(const void* logits, void* conf,
                                        void* idx, void* partials,
                                        void* counters, int N, int V,
                                        long long stride, int dtype,
                                        int mask_id, int splits, int chunk,
                                        void* stream) {
  if (N <= 0 || V <= 0 || stride < V || mask_id < -1 || mask_id >= V ||
      splits < 1 || splits > kMaxSplits || chunk < 1 ||
      (splits > 1 && (partials == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  float* c = static_cast<float*>(conf);
  int* i = static_cast<int*>(idx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(logits, c, i, partials, counters, N, V, stride,
                         mask_id, splits, chunk, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(logits, c, i, partials, counters, N, V,
                                 stride, mask_id, splits, chunk, s);
  return cudaErrorInvalidValue;
}
