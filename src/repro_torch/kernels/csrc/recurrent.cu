// Time scans of the recurrent mixers, for Hopper (sm_90a).
//
// No TPU kernel stands behind these: the JAX package runs its scans with
// lax.scan (src/repro/models/recurrent.py: _rglru_scan, the mLSTM and
// sLSTM step functions). On the card a scan written in PyTorch is S steps
// of ~15 launches each; inside a captured block graph, whose step body is
// copied into every IF node, that is tens of thousands of nodes. Each
// scan here is one launch that walks the time axis on chip.
//
// Contract shared by the three kernels:
// - activations come in T (float32 or bfloat16) and are widened to
//   float32; weights read inside a scan (RG-LRU's lam, the sLSTM's R)
//   come in float32; state and gate arithmetic is float32, as in the
//   reference;
//   the per-step output is written in OutT (float32, or T rounded to
//   nearest even from the float32 value);
// - a CTA (or thread) owns one batch row and walks t = 0 .. S-1 in order;
//   every sum runs in a fixed order and no atomics are used, so a run is
//   deterministic and a row's bits do not depend on its batch or its
//   place in it;
// - the final state is written to separate buffers (the caller copies it
//   into the cache where the reference keeps it).
//
// rglru_scan_kernel<T, OutT>: one thread per (row, channel). Per step it
//   reads the two float32 gate pre-activations (u @ [w_a | w_x]) and u,
//   computes r, i, a = exp(-8 softplus(lam) r), b = sqrt(max(1 - a^2,
//   1e-12)) (i u) and h = a h + b. Memory-bound: each input is read once.
// mlstm_scan_kernel<KPT, T, OutT>: one CTA of 256 threads per (row, head,
//   32 value columns). The CTA keeps its dk x 32 slice of C in registers
//   across time (KPT = dk / 8 rows a thread: 32 at xlstm-350m's dk = 256).
//   Per step: the stabiliser m, i' = exp(i - m'), f' = exp(logsig(f) + m
//   - m'); C = f' C + i' (k v^T); n = f' n + i' k; h = (C^T q) /
//   max(|n . q|, 1). The step's q, k, v, i, f are loaded one step ahead.
// slstm_scan_kernel<T, OutT>: one CTA of hd threads per (row, head);
//   thread j owns channel j. Per step it computes the four gates' rows of
//   the block-diagonal recurrent products h_{t-1} R_g (k ascending), then
//   the stabilised c, n, m, h. R_g (4 x hd x hd per head) is re-read from
//   L2 every step; h lives in shared memory, double-buffered.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}
// PyTorch's softplus (beta 1, threshold 20)
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// ================================================================ RG-LRU

constexpr int kRglruThreads = 256;

template <typename T, typename OutT>
__global__ void __launch_bounds__(kRglruThreads)
rglru_scan_kernel(const float* __restrict__ gx, const T* __restrict__ u,
                  const float* __restrict__ lam, const float* __restrict__ h0,
                  OutT* __restrict__ hs, float* __restrict__ hT, int S,
                  int w) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= w) return;
  const float neg_c = -8.f * softplus(lam[c]);
  const float* g = gx + int64_t(b) * S * 2 * w + c;
  const T* ub = u + int64_t(b) * S * w + c;
  OutT* ob = hs + int64_t(b) * S * w + c;
  float h = h0[int64_t(b) * w + c];
#pragma unroll 4
  for (int t = 0; t < S; ++t) {
    const float r = sigmoid(g[int64_t(t) * 2 * w]);
    const float i = sigmoid(g[int64_t(t) * 2 * w + w]);
    const float a = expf(neg_c * r);
    const float bt = sqrtf(fmaxf(1.f - a * a, 1e-12f)) *
                     (i * to_f32(ub[int64_t(t) * w]));
    h = a * h + bt;
    store(ob + int64_t(t) * w, h);
  }
  hT[int64_t(b) * w + c] = h;
}

// ================================================================ mLSTM

constexpr int kMlstmThreads = 256;            // 8 warps
constexpr int kMlstmWarps = kMlstmThreads / 32;
constexpr int kMlstmCols = 32;                // value columns per CTA

// proj: (B, S, N) rows [q (H dk) | k (H dk) | v (H dv) | i (H) | f (H) |
// pad]; grid (dv / 32, H, B); C0/C1 (B, H, dk, dv), n (B, H, dk), m (B, H).
template <int KPT, typename T, typename OutT>
__global__ void __launch_bounds__(kMlstmThreads)
mlstm_scan_kernel(const T* __restrict__ proj, const float* __restrict__ C0,
                  const float* __restrict__ n0, const float* __restrict__ m0,
                  OutT* __restrict__ hs, float* __restrict__ C1,
                  float* __restrict__ n1, float* __restrict__ m1, int S,
                  int N, int H, int dv, float k_div) {
  constexpr int dk = KPT * kMlstmWarps;
  __shared__ float qs[dk], ks[dk], vs[kMlstmCols];
  __shared__ float gates[2];
  __shared__ float num_part[kMlstmWarps][kMlstmCols];
  __shared__ float den_part[kMlstmWarps];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * kMlstmCols;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t bh = int64_t(b) * H + hh;

  // this thread's C rows k = warp + 8 i, column col0 + lane
  float C[KPT];
  const float* Cb = C0 + bh * dk * dv + col0 + lane;
#pragma unroll
  for (int i = 0; i < KPT; ++i) C[i] = Cb[int64_t(warp + kMlstmWarps * i) * dv];
  float nk = tid < dk ? n0[bh * dk + tid] : 0.f;   // n[tid]
  float m = m0[bh];

  // the loaders of step t + 1, one step ahead: q[tid], k[tid] (tid < dk),
  // v[col0 + tid] (tid < 32), i and f (tid 32, 33)
  const int q_off = hh * dk + tid;
  const int k_off = H * dk + hh * dk + tid;
  const int v_off = 2 * H * dk + hh * dv + col0 + tid;
  const int g_off = 2 * H * dk + H * dv + (tid - 32) * H + hh;
  const T* pb = proj + int64_t(b) * S * N;
  float nq = 0.f, nk_in = 0.f, nv = 0.f, ng = 0.f;
  auto load = [&](int t) {
    const T* row = pb + int64_t(t) * N;
    if (tid < dk) {
      nq = to_f32(row[q_off]);
      nk_in = to_f32(row[k_off]) / k_div;
    }
    if (tid < kMlstmCols) nv = to_f32(row[v_off]);
    if (tid >= 32 && tid < 34) ng = to_f32(row[g_off]);
  };
  if (S > 0) load(0);

  for (int t = 0; t < S; ++t) {
    __syncthreads();                    // step t-1 done with the buffers
    if (tid < dk) { qs[tid] = nq; ks[tid] = nk_in; }
    if (tid < kMlstmCols) vs[tid] = nv;
    if (tid >= 32 && tid < 34) gates[tid - 32] = ng;
    __syncthreads();
    if (t + 1 < S) load(t + 1);

    const float it = gates[0];
    const float f_log = log_sigmoid(gates[1]);
    const float m_new = fmaxf(f_log + m, it);
    const float i_p = expf(it - m_new);
    const float f_p = expf(f_log + m - m_new);
    m = m_new;

    const float vj = vs[lane];
    float num = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int k = warp + kMlstmWarps * i;
      C[i] = f_p * C[i] + i_p * (ks[k] * vj);
      num += C[i] * qs[k];
    }
    num_part[warp][lane] = num;
    // n . q over dk: each warp sums its 32 entries in a fixed butterfly
    float dq = 0.f;
    if (tid < dk) {
      nk = f_p * nk + i_p * ks[tid];
      dq = nk * qs[tid];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) dq += __shfl_xor_sync(0xffffffffu, dq, o);
    if (lane == 0) den_part[warp] = dq;
    __syncthreads();
    if (warp == 0) {
      float s = 0.f, den = 0.f;
#pragma unroll
      for (int w = 0; w < kMlstmWarps; ++w) {
        s += num_part[w][lane];
        den += den_part[w];
      }
      store(hs + (int64_t(b) * S + t) * H * dv + hh * dv + col0 + lane,
            s / fmaxf(fabsf(den), 1.f));
    }
  }

  float* Co = C1 + bh * dk * dv + col0 + lane;
#pragma unroll
  for (int i = 0; i < KPT; ++i) Co[int64_t(warp + kMlstmWarps * i) * dv] = C[i];
  if (blockIdx.x == 0) {
    if (tid < dk) n1[bh * dk + tid] = nk;
    if (tid == 0) m1[bh] = m;
  }
}

// ================================================================ sLSTM

// pre: (B, S, 4 d) rows [z | i | f | o]; r: (4, H, hd, hd); state (B, d);
// grid (H, B), block hd threads.
template <typename T, typename OutT>
__global__ void __launch_bounds__(1024)
slstm_scan_kernel(const T* __restrict__ pre, const float* __restrict__ r,
                  const float* __restrict__ h0, const float* __restrict__ c0,
                  const float* __restrict__ n0, const float* __restrict__ m0,
                  OutT* __restrict__ hs, float* __restrict__ h1,
                  float* __restrict__ c1, float* __restrict__ n1,
                  float* __restrict__ m1, int S, int H) {
  extern __shared__ float hbuf[];               // 2 x hd
  const int hd = blockDim.x;
  const int j = threadIdx.x;
  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int d = H * hd;
  const int ch = hh * hd + j;                    // this thread's channel
  const int64_t st = int64_t(b) * d + ch;
  float c = c0[st], n = n0[st], m = m0[st];
  hbuf[j] = h0[st];
  const int64_t gate = int64_t(H) * hd * hd;     // between R_z, R_i, ...
  const float* rj = r + int64_t(hh) * hd * hd + j;   // R_g[hh][k][j]
  const T* pb = pre + int64_t(b) * S * 4 * d + ch;
  float pz = 0.f, pi = 0.f, pf = 0.f, po = 0.f;
  if (S > 0) {
    pz = to_f32(pb[0]); pi = to_f32(pb[d]);
    pf = to_f32(pb[2 * d]); po = to_f32(pb[3 * d]);
  }
  float h = hbuf[j];
  int cur = 0;
  for (int t = 0; t < S; ++t) {
    __syncthreads();                             // h_{t-1} complete in hbuf[cur]
    const float* hp = hbuf + cur * hd;
    float az = 0.f, ai = 0.f, af = 0.f, ao = 0.f;
#pragma unroll 8
    for (int k = 0; k < hd; ++k) {
      const float hk = hp[k];
      const float* rk = rj + int64_t(k) * hd;
      az += hk * rk[0];
      ai += hk * rk[gate];
      af += hk * rk[2 * gate];
      ao += hk * rk[3 * gate];
    }
    const float zt = tanhf(pz + az);
    const float it = pi + ai;
    const float ft = log_sigmoid(pf + af);
    const float ot = sigmoid(po + ao);
    if (t + 1 < S) {                             // the next step's inputs
      const T* row = pb + int64_t(t + 1) * 4 * d;
      pz = to_f32(row[0]); pi = to_f32(row[d]);
      pf = to_f32(row[2 * d]); po = to_f32(row[3 * d]);
    }
    const float m_new = fmaxf(ft + m, it);
    const float i_p = expf(it - m_new);
    const float f_p = expf(ft + m - m_new);
    c = f_p * c + i_p * zt;
    n = f_p * n + i_p;
    h = ot * (c / fmaxf(n, 1.f));
    m = m_new;
    cur ^= 1;
    hbuf[cur * hd + j] = h;
    store(hs + (int64_t(b) * S + t) * d + ch, h);
  }
  h1[st] = h;
  c1[st] = c;
  n1[st] = n;
  m1[st] = m;
}

// dtype codes: 0 = float32, 1 = bfloat16
template <template <typename, typename> class Launch, typename... Args>
cudaError_t by_dtype(int dtype, int out_dtype, Args... args) {
  if (dtype == 0 && out_dtype == 0) return Launch<float, float>::run(args...);
  if (dtype == 1 && out_dtype == 0)
    return Launch<__nv_bfloat16, float>::run(args...);
  if (dtype == 1 && out_dtype == 1)
    return Launch<__nv_bfloat16, __nv_bfloat16>::run(args...);
  return cudaErrorInvalidValue;
}

template <typename T, typename OutT>
struct RglruLaunch {
  static cudaError_t run(const void* gx, const void* u, const void* lam,
                         const void* h0, void* hs, void* hT, int B, int S,
                         int w, cudaStream_t s) {
    const dim3 grid((w + kRglruThreads - 1) / kRglruThreads, B);
    rglru_scan_kernel<T, OutT><<<grid, kRglruThreads, 0, s>>>(
        static_cast<const float*>(gx), static_cast<const T*>(u),
        static_cast<const float*>(lam), static_cast<const float*>(h0),
        static_cast<OutT*>(hs), static_cast<float*>(hT), S, w);
    return cudaGetLastError();
  }
};

template <int KPT, typename T, typename OutT>
cudaError_t mlstm_kpt(const void* proj, const void* C0, const void* n0,
                      const void* m0, void* hs, void* C1, void* n1, void* m1,
                      int B, int S, int N, int H, int dv, float k_div,
                      cudaStream_t s) {
  const dim3 grid(dv / kMlstmCols, H, B);
  mlstm_scan_kernel<KPT, T, OutT><<<grid, kMlstmThreads, 0, s>>>(
      static_cast<const T*>(proj), static_cast<const float*>(C0),
      static_cast<const float*>(n0), static_cast<const float*>(m0),
      static_cast<OutT*>(hs), static_cast<float*>(C1),
      static_cast<float*>(n1), static_cast<float*>(m1), S, N, H, dv, k_div);
  return cudaGetLastError();
}

template <typename T, typename OutT>
struct MlstmLaunch {
  static cudaError_t run(const void* proj, const void* C0, const void* n0,
                         const void* m0, void* hs, void* C1, void* n1,
                         void* m1, int B, int S, int N, int H, int dk,
                         int dv, float k_div, cudaStream_t s) {
    switch (dk) {
      case 64: return mlstm_kpt<8, T, OutT>(proj, C0, n0, m0, hs, C1, n1, m1,
                                            B, S, N, H, dv, k_div, s);
      case 128: return mlstm_kpt<16, T, OutT>(proj, C0, n0, m0, hs, C1, n1,
                                              m1, B, S, N, H, dv, k_div, s);
      case 256: return mlstm_kpt<32, T, OutT>(proj, C0, n0, m0, hs, C1, n1,
                                              m1, B, S, N, H, dv, k_div, s);
      default: return cudaErrorInvalidValue;
    }
  }
};

template <typename T, typename OutT>
struct SlstmLaunch {
  static cudaError_t run(const void* pre, const void* r, const void* h0,
                         const void* c0, const void* n0, const void* m0,
                         void* hs, void* h1, void* c1, void* n1, void* m1,
                         int B, int S, int H, int hd, cudaStream_t s) {
    slstm_scan_kernel<T, OutT>
        <<<dim3(H, B), hd, 2 * hd * sizeof(float), s>>>(
            static_cast<const T*>(pre), static_cast<const float*>(r),
            static_cast<const float*>(h0), static_cast<const float*>(c0),
            static_cast<const float*>(n0), static_cast<const float*>(m0),
            static_cast<OutT*>(hs), static_cast<float*>(h1),
            static_cast<float*>(c1), static_cast<float*>(n1),
            static_cast<float*>(m1), S, H);
    return cudaGetLastError();
  }
};

}  // namespace

// Each returns the launch's cudaError_t; shapes are checked by the Python
// wrappers (kernels/ops.py) and again here where a bad one would fault.
extern "C" int rglru_scan_launch(const void* gx, const void* u,
                                 const void* lam, const void* h0, void* hs,
                                 void* hT, int B, int S, int w, int dtype,
                                 int out_dtype, void* stream) {
  if (B <= 0 || S <= 0 || w <= 0) return cudaErrorInvalidValue;
  return by_dtype<RglruLaunch>(dtype, out_dtype, gx, u, lam, h0, hs, hT, B,
                               S, w, static_cast<cudaStream_t>(stream));
}

extern "C" int mlstm_scan_launch(const void* proj, const void* C0,
                                 const void* n0, const void* m0, void* hs,
                                 void* C1, void* n1, void* m1, int B, int S,
                                 int N, int H, int dk, int dv, float k_div,
                                 int dtype, int out_dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dv % kMlstmCols != 0 ||
      N < 2 * H * dk + H * dv + 2 * H)
    return cudaErrorInvalidValue;
  return by_dtype<MlstmLaunch>(dtype, out_dtype, proj, C0, n0, m0, hs, C1,
                               n1, m1, B, S, N, H, dk, dv, k_div,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int slstm_scan_launch(const void* pre, const void* r,
                                 const void* h0, const void* c0,
                                 const void* n0, const void* m0, void* hs,
                                 void* h1, void* c1, void* n1, void* m1,
                                 int B, int S, int H, int hd, int dtype,
                                 int out_dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd <= 0 || hd > 1024 || hd % 32 != 0)
    return cudaErrorInvalidValue;
  return by_dtype<SlstmLaunch>(dtype, out_dtype, pre, r, h0, c0, n0, m0, hs,
                               h1, c1, n1, m1, B, S, H, hd,
                               static_cast<cudaStream_t>(stream));
}
