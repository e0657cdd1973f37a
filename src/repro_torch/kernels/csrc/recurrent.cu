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
// rglru_scan_kernel<T, OutT>: h_t = a_t h_{t-1} + b_t per (row, channel),
//   with a = exp(-8 softplus(lam) r), b = sqrt(max(1 - a^2, 1e-12)) (i u),
//   r and i sigmoids of the two float32 gate pre-activations (u @ [w_a |
//   w_x]). Bound by bytes (each input read once: 6.3 MB at
//   recurrentgemma-9b's step) and by the gate arithmetic, not by the walk
//   (h = a h + b is one dependent fma a step). A first kernel of one
//   thread a (row, channel) on 32 CTAs paid a memory round trip a step.
//   Here a CTA of 512 threads owns a row's slice of kRglruChannels
//   channels (B ceil(w / 32) CTAs: 256 at recurrentgemma-9b) and walks
//   time in chunks of kRglruChunk steps through a ring of kRglruStages
//   chunks in dynamic shared memory, which 16-byte cp.async copies fill
//   two chunks ahead (a warp a step's rows: both gate halves and u,
//   coalesced). Warps 1..15 compute a and b of a whole chunk at once over
//   (t, c), the first kernel's expressions, while warp 0, a lane a
//   channel, walks the chunk before from shared memory in t order and
//   stores h; one barrier a chunk hands a chunk from the gate warps to the
//   walker. The walk is the first kernel's fma, so the bits are its bits,
//   and a scan resumed from its returned state equals one scan.
// mlstm_scan_kernel<KPT, T, OutT>: one CTA of 256 threads per (row, head,
//   32 value columns). The CTA keeps its dk x 32 slice of C in registers
//   across time (KPT = dk / 8 rows a thread, k = warp + 8 i: 32 at
//   xlstm-350m's dk = 256). A step: the stabiliser m, i' = exp(i - m'),
//   f' = exp(logsig(f) + m - m'); C = f' C + i' (k v^T); n = f' n + i' k;
//   h = (C^T q) / max(|n . q|, 1). Bound by the steps' latency and issue,
//   not by bytes: 32 C updates and a chain of 32 dependent fma into num a
//   thread, with two warps a scheduler (about 510 cycles a step on the
//   H100, some 70 % of the kernel). A first kernel paid three block
//   barriers a step, loaded each step's inputs one step ahead and left a
//   step's final sums to warp 0 alone. Here time runs in chunks of
//   kMlstmChunk steps, two block barriers a chunk and none inside it.
//   Between them: warps 1..7 widen the chunk's q, k, v (copied by 16-byte
//   cp.async, a warp a row, during the chunk before; i, f by lanes of
//   warp 0) to float32, q and k permuted so that each warp's rows are
//   contiguous (one 16-byte broadcast read serves four rows; k / sqrt(dk)
//   a product where sqrt(dk) is a power of two), while warp 0 walks m
//   through the chunk (i', f' of step t in lane t), and threads 0..127 sum
//   the chunk before's n[k] q[k], each warp's 32 in the pairs of the first
//   kernel's butterfly, as one thread's tree. After the second barrier
//   each warp sums two steps' num partials in warp order, stores them
//   coalesced and issues its rows of the next chunk's copies; then the
//   steps, each writing its num partials (by chunk parity) and n[k] q[k]
//   into slots of that step. The sums keep the first kernel's order (rows
//   ascending in a thread, then warps ascending; n . q by the same
//   butterfly pairs, then warps) and each step's arithmetic is its
//   expression for expression, so the outputs are its bits. kMlstm* and
//   kRglru* are mirrored by kernels/recurrent.py.
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from device memory into shared memory, past L1; it completes
// with the thread's next commit group
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Returns once at most N of this thread's newest commit groups are
// pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The E = 16 / sizeof(T) values of T at 16-byte aligned src, widened to
// float32 (a bfloat16 is the high half of its float32).
template <typename T>
__device__ __forceinline__ void widen16(const T* src, float* x) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (sizeof(T) == 4) {
      x[j] = __uint_as_float(u[j]);
    } else {
      x[2 * j] = __uint_as_float(u[j] << 16);
      x[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
}

// ================================================================ RG-LRU

// must match kernels/recurrent.py:rglru_plan
constexpr int kRglruThreads = 512;     // warp 0 walks, warps 1..15 gate
constexpr int kRglruChannels = 32;     // a CTA's channels, a walker lane each
constexpr int kRglruChunk = 32;        // steps a chunk
constexpr int kRglruStages = 3;        // chunks in the copy ring

// One chunk's inputs as copied: the two gate pre-activations and u of the
// CTA's channels, kRglruChunk rows each.
template <typename T>
struct RglruStage {
  float g[2][kRglruChunk][kRglruChannels];   // r, i halves
  T u[kRglruChunk][kRglruChannels];
};

// Chunk rows [t0, t0 + Lc) of row b into st: 16-byte cp.async pieces
// where vec (every row's slice 16-byte aligned, the tile whole), else
// plain loads of the n < kRglruChannels (or unaligned) channels.
template <typename T>
__device__ void rglru_copy(RglruStage<T>& st, const float* __restrict__ gx,
                           const T* __restrict__ u, int b, int t0, int Lc,
                           int S, int w, int c0, int n, bool vec) {
  constexpr int P = kRglruChannels;
  if (vec) {
    // a warp a step's rows: lanes [0, 2 PG) the two gate rows, the next PU
    // lanes the u row
    constexpr int PG = P * 4 / 16;               // pieces of a gate row
    constexpr int PU = P * sizeof(T) / 16;       // pieces of a u row
    constexpr int EU = 16 / sizeof(T);
    static_assert(2 * PG + PU <= 32, "a step's pieces fit a warp");
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int t = warp; t < Lc; t += kRglruThreads / 32) {
      const int64_t row = int64_t(b) * S + t0 + t;
      if (lane < 2 * PG) {
        const int half = lane / PG, q = lane % PG;
        cp_async16(&st.g[half][t][4 * q],
                   gx + row * 2 * w + half * w + c0 + 4 * q);
      } else if (lane < 2 * PG + PU) {
        const int q = lane - 2 * PG;
        cp_async16(&st.u[t][EU * q], u + row * w + c0 + EU * q);
      }
    }
  } else {
    for (int p = threadIdx.x; p < Lc * P; p += kRglruThreads) {
      const int t = p / P, c = p % P;
      if (c >= n) continue;
      const int64_t row = int64_t(b) * S + t0 + t;
      st.g[0][t][c] = gx[row * 2 * w + c0 + c];
      st.g[1][t][c] = gx[row * 2 * w + w + c0 + c];
      st.u[t][c] = u[row * w + c0 + c];
    }
  }
}

// gx: (B, S, 2w) float32 [r half | i half]; u, hs: (B, S, w); lam: (w,);
// h0, hT: (B, w). Grid (ceil(w / 32), B): CTA (x, b) owns row b's
// channels [32 x, 32 x + 32). vec_ok: every row of gx and u starts on 16
// bytes (the launcher's check).
template <typename T, typename OutT>
__global__ void __launch_bounds__(kRglruThreads)
rglru_scan_kernel(const float* __restrict__ gx, const T* __restrict__ u,
                  const float* __restrict__ lam, const float* __restrict__ h0,
                  OutT* __restrict__ hs, float* __restrict__ hT, int S,
                  int w, int vec_ok) {
  constexpr int L = kRglruChunk, NS = kRglruStages, P = kRglruChannels;
  // dynamic shared memory (rglru_smem_bytes): the ring; a and b of a
  // chunk, double-buffered (the gate warps fill one while the walker reads
  // the other); each channel's -8 softplus(lam)
  extern __shared__ __align__(16) unsigned char rsm[];
  RglruStage<T>* ring = reinterpret_cast<RglruStage<T>*>(rsm);
  float(*as)[L][P] = reinterpret_cast<float(*)[L][P]>(ring + NS);
  float(*bs)[L][P] = as + 2;
  float* negc = reinterpret_cast<float*>(bs + 2);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c0 = blockIdx.x * P, b = blockIdx.y;
  const int n = min(P, w - c0);
  const bool vec = vec_ok && n == P;
  const int nch = (S + L - 1) / L;

  if (tid < n) negc[tid] = -8.f * softplus(lam[c0 + tid]);
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nch)
      rglru_copy(ring[s], gx, u, b, s * L, min(L, S - s * L), S, w, c0, n,
                 vec);
    cp_async_commit();
  }
  float h = warp == 0 && lane < n ? h0[int64_t(b) * w + c0 + lane] : 0.f;

  // iteration c: the gate warps compute chunk c, the walker walks c - 1
  for (int c = 0; c <= nch; ++c) {
    cp_async_wait<NS - 2>();             // this thread's copies of chunk c
    // chunk c is in shared memory; chunk c - 1's a, b are written, and
    // the walk of c - 2 and the gates of c - 1 are done
    __syncthreads();
    const int ahead = c + NS - 1;        // into the stage chunk c - 1 held
    if (ahead < nch)
      rglru_copy(ring[ahead % NS], gx, u, b, ahead * L,
                 min(L, S - ahead * L), S, w, c0, n, vec);
    cp_async_commit();
    if (warp == 0) {
      if (c > 0 && lane < n) {
        const int t0 = (c - 1) * L, Lc = min(L, S - t0);
        const float(*a)[P] = as[(c - 1) & 1];
        const float(*bt)[P] = bs[(c - 1) & 1];
        OutT* ob = hs + (int64_t(b) * S + t0) * w + c0 + lane;
#pragma unroll 4
        for (int t = 0; t < Lc; ++t) {
          h = a[t][lane] * h + bt[t][lane];
          store(ob + int64_t(t) * w, h);
        }
      }
    } else if (c < nch) {
      const RglruStage<T>& st = ring[c % NS];
      const int Lc = min(L, S - c * L);
      constexpr int GT = kRglruThreads - 32;     // gate threads
#pragma unroll
      for (int k = 0; k < (L * P + GT - 1) / GT; ++k) {
        const int p = tid - 32 + GT * k, t = p / P, j = p % P;
        if (p >= Lc * P || j >= n) continue;
        const float r = sigmoid(st.g[0][t][j]);
        const float i = sigmoid(st.g[1][t][j]);
        const float a = expf(negc[j] * r);
        as[c & 1][t][j] = a;
        bs[c & 1][t][j] = sqrtf(fmaxf(1.f - a * a, 1e-12f)) *
                          (i * to_f32(st.u[t][j]));
      }
    }
  }
  if (warp == 0 && lane < n) hT[int64_t(b) * w + c0 + lane] = h;
}

// ================================================================ mLSTM

// must match kernels/recurrent.py:mlstm_plan
constexpr int kMlstmThreads = 256;            // 8 warps
constexpr int kMlstmCols = 32;                // value columns per CTA
constexpr int kMlstmChunk = 16;               // steps a chunk
constexpr int kMlstmSmemLimit = 232448;       // dynamic shared memory a CTA
constexpr int kMlstmWarps = kMlstmThreads / 32;

// The mLSTM kernel's dynamic shared memory at head dim dk and input
// element bytes eb, in this order (every region a multiple of 16 bytes):
//   raw   [L][2 dk + 32] T   a chunk's q | k | v (the CTA's columns) as
//                            copied
//   qf,kf [L][dk + 32] fp32  q, k / sqrt(dk) with row k at (k % 8) (dk / 8
//                            + 4) + k / 8: a warp's rows contiguous, each
//                            group padded by 4 so that thread tid's reads
//                            of row tid hit 32 banks
//   vf    [L][32] fp32
//   gate  [L] float2         (i', f') of each step
//   num   [2][L][8][32] fp32 each warp's partial of each step's outputs,
//                            by chunk parity (a chunk's outputs are
//                            stored while the next chunk's steps run)
//   dq    [L][dk / 32][33]   n[k] q[k] of each step, by warp (padded: the
//                            chunk's n . q sums read it down a row)
//   den   [L] fp32           n . q of each step
int mlstm_smem_bytes(int dk, int eb) {
  const int L = kMlstmChunk, P = kMlstmCols, W = kMlstmWarps;
  return L * (2 * dk + P) * eb
         + 4 * L * (2 * (dk + 4 * W) + P + 2 + 2 * W * P + dk / 32 * 33 + 1);
}

// proj: (B, S, N) rows [q (H dk) | k (H dk) | v (H dv) | i (H) | f (H) |
// pad]; grid (dv / 32, H, B); C0/C1 (B, H, dk, dv), n (B, H, dk), m (B, H).
// vec_ok: every row of proj starts on 16 bytes (the launcher's check).
template <int KPT, typename T, typename OutT>
__global__ void __launch_bounds__(kMlstmThreads)
mlstm_scan_kernel(const T* __restrict__ proj, const float* __restrict__ C0,
                  const float* __restrict__ n0, const float* __restrict__ m0,
                  OutT* __restrict__ hs, float* __restrict__ C1,
                  float* __restrict__ n1, float* __restrict__ m1, int S,
                  int N, int H, int dv, float k_div, int vec_ok) {
  constexpr int W = kMlstmWarps, L = kMlstmChunk, P = kMlstmCols;
  constexpr int dk = KPT * W;
  constexpr int NT = dk / 32;           // warps that hold rows of n
  constexpr int RS = 2 * dk + P;        // a step's raw elements
  constexpr int G = KPT + 4;            // a warp's permuted rows + pad
  constexpr int KS = W * G;             // a step's permuted q or k
  extern __shared__ __align__(16) unsigned char msm[];
  T* raw = reinterpret_cast<T*>(msm);
  float* qf = reinterpret_cast<float*>(msm + L * RS * sizeof(T));
  float* kf = qf + L * KS;
  float* vf = kf + L * KS;
  float2* gate = reinterpret_cast<float2*>(vf + L * P);
  float* num_part = reinterpret_cast<float*>(gate + L);
  float* dqs = num_part + 2 * L * W * P;
  float* dens = dqs + L * NT * 33;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * P;
  const int hh = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t bh = int64_t(b) * H + hh;
  const T* pb = proj + int64_t(b) * S * N;
  const int q_off = hh * dk;
  const int k_off = H * dk + hh * dk;
  const int v_off = 2 * H * dk + hh * dv + col0;
  const int g_off = 2 * H * dk + H * dv + hh;   // i; f at g_off + H
  const int my = (tid % W) * G + tid / W;       // row tid, permuted
  const int nch = (S + L - 1) / L;
  // k / sqrt(dk) as a product where sqrt(dk) is a power of two (dk 64,
  // 256): the same rounding, without a division's slow-path check
  int k_exp;
  const bool k_pow2 = frexpf(k_div, &k_exp) == 0.5f;
  const float k_inv = 1.f / k_div;

  // Chunk ch's inputs into raw: where vec_ok, row item it of a chunk (the
  // q (it even) or k row of step it / 2) as one warp's 16-byte cp.async
  // pieces (its branches uniform), the v pieces by the first Lc PV
  // threads; else plain loads. Lane t of warp 0 loads step t's i, f into
  // gi, gf, as they are (widened where used, a chunk later, so that no
  // instruction waits on the load).
  constexpr int E = 16 / sizeof(T);             // elements a 16-byte piece
  constexpr int PQ = dk / E, PV = P / E;        // pieces of a q or k row, of v
  T gi = T(), gf = T();
  auto copy_row = [&](int ch, int it) {
    const int t = it >> 1, seg = it & 1;
    const T* src = pb + int64_t(ch * L + t) * N + (seg ? k_off : q_off);
    T* dst = raw + t * RS + seg * dk;
#pragma unroll
    for (int q = lane; q < PQ; q += 32) cp_async16(dst + q * E, src + q * E);
  };
  auto copy_v = [&](int ch, int Lc) {
    if (tid < Lc * PV) {
      const int t = tid / PV, q = tid % PV;
      cp_async16(raw + t * RS + 2 * dk + q * E,
                 pb + int64_t(ch * L + t) * N + v_off + q * E);
    }
  };
  auto copy_plain = [&](int ch, int Lc) {
    for (int p = tid; p < Lc * RS; p += kMlstmThreads) {
      const int t = p / RS, e = p % RS;
      const T* row = pb + int64_t(ch * L + t) * N;
      raw[p] = e < dk ? row[q_off + e]
          : e < 2 * dk ? row[k_off + e - dk] : row[v_off + e - 2 * dk];
    }
  };
  auto load_gates = [&](int ch, int Lc) {
    if (warp == 0) {
      const T* row = pb + int64_t(ch * L + min(lane, Lc - 1)) * N + g_off;
      gi = row[0];
      gf = row[H];
    }
  };
  auto copy = [&](int ch) {
    const int Lc = min(L, S - ch * L);
    if (vec_ok) {
#pragma unroll
      for (int r = 0; r < 2 * L / W; ++r)
        if (warp + W * r < 2 * Lc) copy_row(ch, warp + W * r);
      copy_v(ch, Lc);
    } else {
      copy_plain(ch, Lc);
    }
    load_gates(ch, Lc);
    cp_async_commit();
  };
  copy(0);

  // this thread's C rows k = warp + 8 i, column col0 + lane
  float C[KPT];
  const float* Cb = C0 + bh * dk * dv + col0 + lane;
#pragma unroll
  for (int i = 0; i < KPT; ++i) C[i] = Cb[int64_t(warp + W * i) * dv];
  float nk = tid < dk ? n0[bh * dk + tid] : 0.f;   // n[tid]
  float m = m0[bh];                    // walked by warp 0

  // a chunk: [B1] n . q of the chunk before; widen this chunk's inputs
  // (warps 1..7) while warp 0 walks its gates; [B2] the chunk before's
  // outputs; copy the next chunk; this chunk's steps
  for (int ch = 0; ch <= nch; ++ch) {
    cp_async_wait<0>();
    __syncthreads();                   // chunk ch landed, ch - 1's steps done
    const int t_prev = (ch - 1) * L, L_prev = min(L, S - t_prev);
    if (ch > 0) {
      // n . q of each step before: each warp's 32 products summed in the
      // pairs of a butterfly over lanes (offsets 16, 8, 4, 2, 1), as one
      // thread's tree, then the warps in order (warps past dk / 32 held no
      // row of n and added zeros)
      float e = 0.f;
      if (tid < L_prev * NT) {
        const float* v = dqs + tid * 33;
        float a[16];
#pragma unroll
        for (int l = 0; l < 16; ++l) a[l] = v[l] + v[l + 16];
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) {
#pragma unroll
          for (int l = 0; l < o; ++l) a[l] = a[l] + a[l + o];
        }
        e = a[0];
      }
      float den = 0.f;
#pragma unroll
      for (int w = 0; w < NT; ++w)
        den += __shfl_sync(0xffffffffu, e, (lane & ~(NT - 1)) + w);
      if (tid < L_prev * NT && tid % NT == 0) dens[tid / NT] = den;
    }
    const int Lc = min(L, S - ch * L);
    if (ch < nch && warp > 0) {
      // widen to float32, a warp a q or k row (rows permuted; k /
      // sqrt(dk)), v by the first Lc PV threads past warp 0
#pragma unroll
      for (int r = 0; r < (2 * L + W - 2) / (W - 1); ++r) {
        const int it = warp - 1 + (W - 1) * r, t = it >> 1, seg = it & 1;
        if (it >= 2 * Lc) break;
        const T* src = raw + t * RS + seg * dk;
        float* dst = (seg ? kf : qf) + t * KS;
#pragma unroll
        for (int q = lane; q < PQ; q += 32) {
          float x[E];
          widen16(src + q * E, x);
#pragma unroll
          for (int j = 0; j < E; ++j) {
            const int e = q * E + j;
            dst[(e % W) * G + e / W] =
                !seg ? x[j] : k_pow2 ? x[j] * k_inv : x[j] / k_div;
          }
        }
      }
      if (tid - 32 < Lc * PV) {
        const int t = (tid - 32) / PV, q = (tid - 32) % PV;
        float x[E];
        widen16(raw + t * RS + 2 * dk + q * E, x);
#pragma unroll
        for (int j = 0; j < E; ++j) vf[t * P + q * E + j] = x[j];
      }
    } else if (ch < nch) {
      // the stabiliser through the chunk, in step order; lane t keeps
      // step t's m before and after
      const float it_l = to_f32(gi);
      const float f_log = log_sigmoid(to_f32(gf));
      float m_prev = m, m_new = m;
#pragma unroll
      for (int t = 0; t < L; ++t) {
        const float ft = __shfl_sync(0xffffffffu, f_log, t);
        const float it = __shfl_sync(0xffffffffu, it_l, t);
        if (t < Lc) {
          const float mt = fmaxf(ft + m, it);
          if (lane == t) {
            m_prev = m;
            m_new = mt;
          }
          m = mt;
        }
      }
      if (lane < Lc)
        gate[lane] = make_float2(expf(it_l - m_new),
                                 expf(f_log + m_prev - m_new));
    }
    __syncthreads();                   // raw free, the chunk's inputs ready
    if (ch > 0) {
      // the chunk before's outputs: each warp's partials summed in warp
      // order
      const float* np = num_part + ((ch - 1) & 1) * L * W * P;
#pragma unroll
      for (int r = 0; r < L / W; ++r) {
        const int t = warp + W * r;
        if (t >= L_prev) break;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) s += np[(t * W + w) * P + lane];
        store(hs + (int64_t(b) * S + t_prev + t) * H * dv + hh * dv + col0
              + lane, s / fmaxf(fabsf(dens[t]), 1.f));
      }
    }
    if (ch == nch) break;
    if (ch + 1 < nch) copy(ch + 1);

    // the chunk's steps, with no block barrier between them
    float* np = num_part + (ch & 1) * L * W * P;
#pragma unroll 2
    for (int t = 0; t < Lc; ++t) {
      const float2 g = gate[t];
      const float i_p = g.x, f_p = g.y;
      const float vj = vf[t * P + lane];
      const float4* kr = reinterpret_cast<const float4*>(kf + t * KS
                                                         + warp * G);
      const float4* qr = reinterpret_cast<const float4*>(qf + t * KS
                                                         + warp * G);
      float num = 0.f;
#pragma unroll
      for (int i4 = 0; i4 < KPT / 4; ++i4) {
        const float4 kk = kr[i4], qq = qr[i4];
        const float k4[4] = {kk.x, kk.y, kk.z, kk.w};
        const float q4[4] = {qq.x, qq.y, qq.z, qq.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 4 * i4 + j;
          C[i] = f_p * C[i] + i_p * (k4[j] * vj);
          num += C[i] * q4[j];
        }
      }
      np[(t * W + warp) * P + lane] = num;
      if (tid < dk) {
        nk = f_p * nk + i_p * kf[t * KS + my];
        dqs[(t * NT + warp) * 33 + lane] = nk * qf[t * KS + my];
      }
    }
  }

  float* Co = C1 + bh * dk * dv + col0 + lane;
#pragma unroll
  for (int i = 0; i < KPT; ++i) Co[int64_t(warp + W * i) * dv] = C[i];
  if (blockIdx.x == 0) {
    if (tid < dk) n1[bh * dk + tid] = nk;
    if (tid == 0) m1[bh] = m;
  }
}

// ================================================================ sLSTM

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

// Whether p is 16-byte aligned and rows of `row` elements of T keep it so.
template <typename T>
bool rows_aligned(const void* p, int64_t row) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0
         && row * int64_t(sizeof(T)) % 16 == 0;
}

// The RG-LRU kernel's shared memory: the ring, a and b, -8 softplus(lam).
int rglru_smem_bytes(int eb) {
  const int L = kRglruChunk, P = kRglruChannels;
  return kRglruStages * L * P * (8 + eb) + 2 * 2 * L * P * 4 + 4 * P;
}

template <typename T, typename OutT>
struct RglruLaunch {
  static cudaError_t run(const void* gx, const void* u, const void* lam,
                         const void* h0, void* hs, void* hT, int B, int S,
                         int w, cudaStream_t s) {
    auto kernel = rglru_scan_kernel<T, OutT>;
    const int smem = rglru_smem_bytes(sizeof(T));
    // set before the first launch, so that one inside a graph capture
    // works
    static bool smem_set = false;
    if (!smem_set) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
      smem_set = true;
    }
    const dim3 grid((w + kRglruChannels - 1) / kRglruChannels, B);
    // the i half starts w floats into a row of gx
    const int vec_ok = rows_aligned<float>(gx, w) && rows_aligned<T>(u, w);
    kernel<<<grid, kRglruThreads, smem, s>>>(
        static_cast<const float*>(gx), static_cast<const T*>(u),
        static_cast<const float*>(lam), static_cast<const float*>(h0),
        static_cast<OutT*>(hs), static_cast<float*>(hT), S, w, vec_ok);
    return cudaGetLastError();
  }
};

template <int KPT, typename T, typename OutT>
cudaError_t mlstm_kpt(const void* proj, const void* C0, const void* n0,
                      const void* m0, void* hs, void* C1, void* n1, void* m1,
                      int B, int S, int N, int H, int dv, float k_div,
                      cudaStream_t s) {
  auto kernel = mlstm_scan_kernel<KPT, T, OutT>;
  const int smem = mlstm_smem_bytes(KPT * kMlstmWarps, sizeof(T));
  if (smem > kMlstmSmemLimit) return cudaErrorInvalidValue;
  // the launch's own bytes (static and dynamic shared memory together
  // may not pass the limit), set before the first launch so that one
  // inside a graph capture works
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  // q, k and v slices start at multiples of 32 elements of a row
  const int vec_ok = rows_aligned<T>(proj, N);
  const dim3 grid(dv / kMlstmCols, H, B);
  kernel<<<grid, kMlstmThreads, smem, s>>>(
      static_cast<const T*>(proj), static_cast<const float*>(C0),
      static_cast<const float*>(n0), static_cast<const float*>(m0),
      static_cast<OutT*>(hs), static_cast<float*>(C1),
      static_cast<float*>(n1), static_cast<float*>(m1), S, N, H, dv, k_div,
      vec_ok);
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
