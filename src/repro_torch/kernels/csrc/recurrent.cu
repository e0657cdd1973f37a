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
// - a CTA (or thread, or the sLSTM's cluster) walks t = 0 .. S-1 in
//   order for its rows; every sum runs in a fixed order and no atomics
//   are used, so a run is deterministic and a row's bits do not depend on
//   its batch or its place in it;
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
// slstm_scan_kernel<ROWS, T, OutT>: per step the four gates' rows of the
//   block-diagonal recurrent products h_{t-1} R_g (k ascending, one fma
//   chain each), then the stabilised c, n, m, h. The recurrence is serial
//   in t, so the kernel is bound by each step's latency, not by its
//   arithmetic (xlstm-350m: 8 x 256 x 1024 operations a row and step) or
//   its bytes. A head's R (4 x 256 x 256 float32 = 1 MiB at xlstm-350m)
//   does not fit one SM, and re-reading it from L2 every step made a step
//   cost ~45 us. So one thread-block cluster of C = hd / 32 CTAs (8 at
//   hd 256) holds a head: each CTA keeps the R columns of its 32
//   channels, all four gates (128 KiB at hd 256), in shared memory for
//   the whole launch and walks up to ROWS = 8 batch rows together,
//   reading each R value once per step for all of them. A thread owns
//   one (channel, gate) and its ROWS sums; the four gates of a channel
//   meet by warp shuffles, and each CTA sends its channels' h_t into
//   every CTA's next h buffer through distributed shared memory
//   (st.async, counted on the receiver's mbarrier; a cluster barrier a
//   step, whose release fenced all of device memory, cost more). No
//   step reads R from L2.
#include <cooperative_groups.h>
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// The address of shared-memory address a in cluster rank's CTA.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(a), "r"(rank));
  return out;
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}
// Arrive, adding `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
// Returns once the phase of the given parity has completed; the writes
// other CTAs completed on it are visible after.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1],"
        " %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// must match kernels/recurrent.py:slstm_plan
constexpr int kSlstmMaxCluster = 8;      // CTAs of a head (portable size)
constexpr int kSlstmChannels = 32;       // a CTA's channels
constexpr int kSlstmMaxRows = 8;         // batch rows a cluster walks
constexpr int kSlstmThreads = 4 * kSlstmChannels;   // a thread a gate
constexpr int kSlstmSmemLimit = 232448;  // dynamic shared memory a CTA

// pre: (B, S, 4 d) rows [z | i | f | o]; r: (4, H, hd, hd); state (B, d).
// grid (C H, ceil(B / ROWS)) in clusters of C CTAs along x: cluster hh is
// head hh, and its CTA of rank q owns the head's channels [q P, q P + P)
// (P = kSlstmChannels, C = hd / P) for rows [ROWS y, ROWS y + ROWS). 4 P
// threads, a row of rs (its stride a constant, so the k loop's loads
// take immediate offsets): thread tid
// is gate g = (tid / 4) % 4 of channel j = (tid / 16) * 4 + tid % 4, so a
// channel's four gates sit in one warp, 4 lanes apart.
// Shared memory: R's columns of this CTA's channels, all four gates (each
// thread's column, loaded once), then h of each row, double-buffered:
// hb[2][kSlstmMaxRows][hd], then a "full" mbarrier for each buffer.
template <int ROWS, typename T, typename OutT>
__global__ void __launch_bounds__(kSlstmThreads)
slstm_scan_kernel(const T* __restrict__ pre, const float* __restrict__ r,
                  const float* __restrict__ h0, const float* __restrict__ c0,
                  const float* __restrict__ n0, const float* __restrict__ m0,
                  OutT* __restrict__ hs, float* __restrict__ h1,
                  float* __restrict__ c1, float* __restrict__ n1,
                  float* __restrict__ m1, int B, int S, int H, int hd) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float slsm[];
  const int C = static_cast<int>(cluster.num_blocks());
  const int q = static_cast<int>(cluster.block_rank());
  constexpr int P = kSlstmChannels, W = kSlstmThreads;
  float* rs = slsm;
  float* hb = slsm + hd * W;
  // full[i]: h of every channel has landed in hb[i] (each CTA's
  // st.async of its channels completes bytes on it)
  uint64_t* full = reinterpret_cast<uint64_t*>(hb + 2 * kSlstmMaxRows * hd);
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = (tid >> 2) & 3;
  const int jl = (tid >> 4) * 4 + (tid & 3);     // channel in the CTA
  const int hh = blockIdx.x / C;
  const int d = H * hd;
  const int jh = q * P + jl;                     // channel in the head
  const int ch = hh * hd + jh;                   // channel in d
  const int row0 = blockIdx.y * ROWS;

  // this thread's column of R_g[hh] (its gate and channel), every k, as
  // rs4[k / 4][tid]: four consecutive k in one 16-byte word, so the k
  // loop reads R with one 16-byte load per 4 k
  float4* rs4 = reinterpret_cast<float4*>(rs);
  {
    const float* src = r + (static_cast<int64_t>(g) * H + hh) * hd * hd
                       + jh;
#pragma unroll 16
    for (int k4 = 0; k4 < hd / 4; ++k4) {
      const float* sk = src + static_cast<int64_t>(4 * k4) * hd;
      rs4[k4 * W + tid] = make_float4(sk[0], sk[hd], sk[2 * hd], sk[3 * hd]);
    }
  }
  // h_0 of every channel of the head, for this cluster's rows
  for (int i = tid; i < ROWS * hd; i += W) {
    const int b = i / hd, k = i % hd;
    hb[b * hd + k] = row0 + b < B
        ? h0[static_cast<int64_t>(row0 + b) * d + hh * hd + k] : 0.f;
  }
  float c[ROWS], n[ROWS], m[ROWS], pv[ROWS], h[ROWS];
#pragma unroll
  for (int b = 0; b < ROWS; ++b) {
    const bool live = row0 + b < B;
    const int64_t st = static_cast<int64_t>(row0 + b) * d + ch;
    c[b] = live ? c0[st] : 0.f;
    n[b] = live ? n0[st] : 1.f;
    m[b] = live ? m0[st] : 0.f;
    h[b] = 0.f;
    // this thread's gate of step 0
    pv[b] = live ? to_f32(pre[static_cast<int64_t>(row0 + b) * S * 4 * d
                              + g * d + ch]) : 0.f;
  }
  if (tid == 0) {
    mbar_init(smem_addr(&full[0]), 1);
    mbar_init(smem_addr(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA of the cluster has started and set up its buffers and
  // barriers before any writes into another's
  cluster.sync();

  const float4* rj = rs4 + tid;
  const int quad = lane & ~12;                   // gate 0's lane
  int cur = 0;
  uint32_t parity = 0;                           // bit i: full[i]'s phase
  for (int t = 0; t < S; ++t) {
    if (t > 0) {                                 // h_{t-1} from every CTA
      mbar_wait(smem_addr(&full[cur]), (parity >> cur) & 1);
      parity ^= 1u << cur;
    }
    // this gate's row of h_{t-1} R_g for each row, k ascending
    const float* hp = hb + cur * kSlstmMaxRows * hd;
    float a[ROWS];
#pragma unroll
    for (int b = 0; b < ROWS; ++b) a[b] = 0.f;
    // in whole chunks of KC k (hd is a multiple of 32), each unrolled so
    // its loads run ahead of the fma chains; fewer rows, longer chunks
    constexpr int KC = ROWS <= 2 ? 32 : (ROWS <= 4 ? 16 : 8);
    for (int k0 = 0; k0 < hd; k0 += KC) {
#pragma unroll
      for (int k = k0; k < k0 + KC; k += 4) {
        const float4 rv = rj[(k >> 2) * W];
#pragma unroll
        for (int b = 0; b < ROWS; ++b) {
          const float4 hv =
              *reinterpret_cast<const float4*>(hp + b * hd + k);
          a[b] = fmaf(hv.x, rv.x, a[b]);
          a[b] = fmaf(hv.y, rv.y, a[b]);
          a[b] = fmaf(hv.z, rv.z, a[b]);
          a[b] = fmaf(hv.w, rv.w, a[b]);
        }
      }
    }
    float x[ROWS];
#pragma unroll
    for (int b = 0; b < ROWS; ++b) {
      x[b] = pv[b] + a[b];
      if (t + 1 < S && row0 + b < B)             // the next step's input
        pv[b] = to_f32(pre[(static_cast<int64_t>(row0 + b) * S + t + 1)
                           * 4 * d + g * d + ch]);
    }
    cur ^= 1;
    float* hn = hb + cur * kSlstmMaxRows * hd;
#pragma unroll
    for (int b = 0; b < ROWS; ++b) {
      const float zt = tanhf(__shfl_sync(0xffffffffu, x[b], quad));
      const float it = __shfl_sync(0xffffffffu, x[b], quad | 4);
      const float ft = log_sigmoid(__shfl_sync(0xffffffffu, x[b], quad | 8));
      const float ot = sigmoid(__shfl_sync(0xffffffffu, x[b], quad | 12));
      const float m_new = fmaxf(ft + m[b], it);
      const float i_p = expf(it - m_new);
      const float f_p = expf(ft + m[b] - m_new);
      c[b] = f_p * c[b] + i_p * zt;
      n[b] = f_p * n[b] + i_p;
      h[b] = ot * (c[b] / fmaxf(n[b], 1.f));
      m[b] = m_new;
    }
    if (t + 1 < S) {
      // h_t of this channel into every CTA's next buffer (distributed
      // shared memory; gate lane g feeds ranks g, g + 4), each 4-byte
      // st.async completing 4 bytes on that CTA's full barrier, which
      // its own thread 0 armed for all ROWS x hd values. No CTA writes
      // a buffer before every CTA has sent h_{t-1} (the wait above),
      // which each sends after its last read of that buffer.
      const uint32_t nbar = smem_addr(&full[cur]);
      if (tid == 0) mbar_expect_tx(nbar, ROWS * hd * 4);
      const uint32_t dst = smem_addr(hn + jh);
      for (int rk = g; rk < C; rk += 4) {
        const uint32_t rdst = cluster_addr(dst, rk);
        const uint32_t rbar = cluster_addr(nbar, rk);
#pragma unroll
        for (int b = 0; b < ROWS; ++b)
          asm volatile(
              "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32"
              " [%0], %1, [%2];\n"
              ::"r"(rdst + 4 * b * hd), "r"(__float_as_uint(h[b])),
              "r"(rbar) : "memory");
      }
    }
#pragma unroll
    for (int b = 0; b < ROWS; ++b)
      if (row0 + b < B && (b & 3) == g)
        store(hs + (static_cast<int64_t>(row0 + b) * S + t) * d + ch, h[b]);
  }
  if (g == 0) {
#pragma unroll
    for (int b = 0; b < ROWS; ++b) {
      if (row0 + b >= B) continue;
      const int64_t st = static_cast<int64_t>(row0 + b) * d + ch;
      h1[st] = h[b];
      c1[st] = c[b];
      n1[st] = n[b];
      m1[st] = m[b];
    }
  }
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

// The sLSTM kernel's shared memory: R's columns, the h buffers, the two
// full barriers.
int slstm_smem_bytes(int hd) {
  return (4 * hd * kSlstmChannels + 2 * kSlstmMaxRows * hd) * 4 + 16;
}

// The sLSTM kernel's cluster for head dim hd (0: no kernel takes it), as
// kernels/recurrent.py:slstm_plan: C = hd / 32 CTAs of 32 channels each.
int slstm_cluster(int hd) {
  if (hd <= 0 || hd % kSlstmChannels != 0
      || hd / kSlstmChannels > kSlstmMaxCluster)
    return 0;
  if (slstm_smem_bytes(hd) > kSlstmSmemLimit)
    return 0;
  return hd / kSlstmChannels;
}

template <int ROWS, typename T, typename OutT>
cudaError_t slstm_rows(const void* pre, const void* r, const void* h0,
                       const void* c0, const void* n0, const void* m0,
                       void* hs, void* h1, void* c1, void* n1, void* m1,
                       int B, int S, int H, int hd, int C, cudaStream_t s) {
  auto kernel = slstm_scan_kernel<ROWS, T, OutT>;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSlstmSmemLimit);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * H, (B + ROWS - 1) / ROWS);
  cfg.blockDim = dim3(kSlstmThreads);
  cfg.dynamicSmemBytes = slstm_smem_bytes(hd);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(pre), static_cast<const float*>(r),
      static_cast<const float*>(h0), static_cast<const float*>(c0),
      static_cast<const float*>(n0), static_cast<const float*>(m0),
      static_cast<OutT*>(hs), static_cast<float*>(h1),
      static_cast<float*>(c1), static_cast<float*>(n1),
      static_cast<float*>(m1), B, S, H, hd);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, typename OutT>
struct SlstmLaunch {
  static cudaError_t run(const void* pre, const void* r, const void* h0,
                         const void* c0, const void* n0, const void* m0,
                         void* hs, void* h1, void* c1, void* n1, void* m1,
                         int B, int S, int H, int hd, cudaStream_t s) {
    const int C = slstm_cluster(hd);
    if (C == 0) return cudaErrorInvalidValue;
    // rows a cluster walks together: B rounded up to a power of two, at
    // most kSlstmMaxRows (a row's sums are the same at every ROWS)
    if (B >= 8)
      return slstm_rows<8, T, OutT>(pre, r, h0, c0, n0, m0, hs, h1, c1, n1,
                                    m1, B, S, H, hd, C, s);
    if (B > 2)
      return slstm_rows<4, T, OutT>(pre, r, h0, c0, n0, m0, hs, h1, c1, n1,
                                    m1, B, S, H, hd, C, s);
    if (B == 2)
      return slstm_rows<2, T, OutT>(pre, r, h0, c0, n0, m0, hs, h1, c1, n1,
                                    m1, B, S, H, hd, C, s);
    return slstm_rows<1, T, OutT>(pre, r, h0, c0, n0, m0, hs, h1, c1, n1,
                                  m1, B, S, H, hd, C, s);
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
  if (B <= 0 || S <= 0 || H <= 0 || slstm_cluster(hd) == 0)
    return cudaErrorInvalidValue;
  return by_dtype<SlstmLaunch>(dtype, out_dtype, pre, r, h0, c0, n0, m0, hs,
                               h1, c1, n1, m1, B, S, H, hd,
                               static_cast<cudaStream_t>(stream));
}
