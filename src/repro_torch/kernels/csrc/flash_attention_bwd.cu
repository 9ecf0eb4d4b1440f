// The gradient of the causal GQA flash attention kernel (flash_attention.cu)
// for Hopper (sm_90a), on the CUDA cores.
//
// The TPU kernel src/repro/kernels/flash_attention/flash_attention.py:72
// has no backward: the JAX package trains through XLA's autodiff of
// full_attention / chunked_attention (src/repro/models/attention.py:67-131).
// The port's forward on the card is the hand-written flash kernel, so its
// gradient is one too.  Given q [B, H, S, hd], k [B, KV, T, hd], v [B, KV,
// T, hd_v], the forward's output o and its gradient do [B, H, S, hd_v], it
// computes dq, dk and dv of what the forward computes, with the forward's
// mask (causal with the query positions offset by T - S, `window`, `prefix`
// including every key and S > T, visible() copied from the forward), its
// `scale` and its `softcap` (bf16 through hopper::softcap's exp2f form, f32
// through tanhf, as the forward caps).  Three launches a call, on the
// caller's stream, in this order:
//
//   prep: one CTA per (query block, head, batch) walks the KV blocks its
//     rows see, as the forward does, and keeps each row's running max and
//     sum (16 threads a row) to give lse = m + log(l); it also forms
//     D = sum(do * o) over the row.  Both land in f32 [B, H, S] scratch.
//     The forward is not touched, so a call without grad keeps its bits.
//   dq: one CTA per (query block, head, batch), the forward's walk over
//     the visible KV blocks.  Per block: V is staged and dP = dO V^T formed,
//     then K is staged where V was and S = Q K^T formed; P = exp(s_c -
//     lse) (0 where hidden), dS = P (dP - D), times the cap's derivative
//     1 - (s_c / c)^2 when capped; dS goes through shared memory and dQ +=
//     dS K accumulates in registers.  dQ * scale is rounded once.
//   dkdv: one CTA per (KV block, KV head, batch) keeps its K and V tile in
//     shared memory and walks the G query heads of its KV head and, for
//     each, the query blocks that can see the tile; per block it forms S^T
//     and dP^T (keys x queries), then P^T and dS^T through shared memory,
//     and accumulates dV += P^T dO and dK += dS^T Q in registers.  The sum
//     over the GQA group stays inside the CTA: no atomics, so two calls
//     give the same bits.  dK * scale and dV are rounded once to k's dtype.
//
// 256 threads as 16 x 16; thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j of each 64 x 64 tile (bq, bk <= 64, planned on the host under
// the 227 KB of shared memory a CTA may use), as the forward's CUDA-core
// route does; staged rows are padded by one 32-bit word.  Every product
// multiplies in f32 with FMAs.  What bounds it on this card: the
// operations, 10 hd flops (five products) a visible (query, key) pair at
// the widths the models train at, here on the CUDA cores; the tensor-core
// redesign (wgmma, TMA, the log-sum-exp from the forward) is later work.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlock = 64;  // largest bq and bk: 16 threads x 4 rows
constexpr int kPer = kMaxBlock / 16;
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;  // shared memory one CTA can use (227 KB)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;    // [B, H, S]
  float* delta;  // [B, H, S]
  // Element strides: q, k, v, o, do, dq, dk, dv, each (batch, head, position).
  int64_t st[24];
  int h, kv, s, t, bq, bk;
  float scale;
  int window;     // 0: causal only
  int prefix;     // keys below it are seen by every query; 0: causal only
  float softcap;  // 0: no cap
};

// The forward's visible(): the keys a query at position qpos sees, [lo, hi].
struct KeyRange {
  int lo, hi;
};
__device__ __forceinline__ KeyRange visible(int qpos, int t, int prefix, int window) {
  return {window ? qpos - window + 1 : -(1 << 30), min(max(qpos, prefix - 1), t - 1)};
}
__device__ __forceinline__ bool sees(const KeyRange& r, int key, int window) {
  return key <= r.hi && (!window || key >= r.lo);
}

// The forward's kv_blocks(): the KV blocks a query block whose largest
// position is q_last walks.
__device__ __forceinline__ int kv_blocks(int q_last, int t, int bk, int prefix) {
  const int n_t = (t + bk - 1) / bk;
  const int causal = q_last < 0 ? 0 : q_last / bk + 1;
  const int seen = (min(prefix, t) + bk - 1) / bk;
  return min(n_t, max(causal, seen));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float2 ld2(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Row stride of a staged tile of width W, in elements: W plus one 32-bit word.
template <typename T, int W>
__host__ __device__ constexpr int ld() { return W + int(4 / sizeof(T)); }

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// W columns of rows [r0, r0 + n) of src (position stride `ps`) into dst
// (row stride LD), zero past `limit`.
template <typename T, int W, int LD>
__device__ __forceinline__ void stage(T* dst, const T* src, int64_t ps, int r0, int n,
                                      int limit) {
  for (int i = threadIdx.x; i < n * W; i += kThreads) {
    const int r = i / W, d = i - r * W;
    const int row = r0 + r;
    dst[r * LD + d] = row < limit ? src[int64_t(row) * ps + d] : from_f32<T>(0.f);
  }
}

// out[i][c] = sum over the W columns of a[ra[i]] . b[rb[c]] (staged rows of
// strides LDA and LDB), in f32.
template <typename T, int W, int LDA, int LDB>
__device__ __forceinline__ void dots(const T* a, const T* b, const int (&ra)[kPer],
                                     const int (&rb)[kPer], float (&out)[kPer][kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < kPer; ++c) out[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < W; d += 2) {
    float2 av[kPer], bv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      av[i] = ld2(a + ra[i] * LDA + d);
      bv[i] = ld2(b + rb[i] * LDB + d);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int c = 0; c < kPer; ++c)
        out[i][c] = fmaf(av[i].y, bv[c].y, fmaf(av[i].x, bv[c].x, out[i][c]));
  }
}

// acc[i][e] += sum over c < n of w[rows[i]][c] * src[c][tx + 16 e]: a tile
// of f32 weights (row stride wld) times n staged rows of width W.
template <typename T, int W, int LD>
__device__ __forceinline__ void accumulate(const float* w, int wld, const int (&rows)[kPer],
                                           int n, const T* src, float (&acc)[kPer][W / 16]) {
  const int tx = threadIdx.x & 15;
  for (int c = 0; c < n; ++c) {
    float wv[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) wv[i] = w[rows[i] * wld + c];
    const T* row = src + c * LD + tx;
#pragma unroll
    for (int e = 0; e < W / 16; ++e) {
      const float x = to_f32(row[16 * e]);
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i][e] = fmaf(wv[i], x, acc[i][e]);
    }
  }
}

// A score scaled, then capped as the forward caps it.
template <typename T>
__device__ __forceinline__ float capped(float dot, const Params& p, float cap_k) {
  const float x = dot * p.scale;
  return p.softcap > 0.f ? hopper::softcap<sizeof(T) == 2>(x, p.softcap, cap_k) : x;
}

// dS from P, dP, D and the capped score: P (dP - D), times the cap's
// derivative 1 - (s_c / c)^2 when capped.
__device__ __forceinline__ float dscore(float pr, float dp, float d, float sc, float softcap) {
  float ds = pr * (dp - d);
  if (softcap > 0.f) {
    const float u = sc / softcap;
    ds *= 1.f - u * u;
  }
  return ds;
}

// -- prep: lse and D a query row ----------------------------------------------

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(kThreads) prep_kernel(Params p) {
  constexpr int LD = ld<T, HD>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);  // [bq][LD]
  T* k_s = q_s + p.bq * LD;             // [bk][LD]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest q blocks first
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (p.h / p.kv);
  const int offset = p.t - p.s;
  const int q0 = qb * p.bq;

  const T* qg = static_cast<const T*>(p.q) + b * p.st[0] + head * p.st[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.st[3] + kvh * p.st[4];
  const T* og = static_cast<const T*>(p.o) + b * p.st[9] + head * p.st[10];
  const T* dog = static_cast<const T*>(p.dout) + b * p.st[12] + head * p.st[13];
  stage<T, HD, LD>(q_s, qg, p.st[2], q0, p.bq, p.s);

  int rq[kPer], ck[kPer];
  float m[kPer], l[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    rq[i] = min(ty + 16 * i, p.bq - 1);
    ck[i] = min(tx + 16 * i, p.bk - 1);
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const int q_last = min(q0 + p.bq, p.s) - 1 + offset;
  const int n_kv = kv_blocks(q_last, p.t, p.bk, p.prefix);
  const int j0 = p.window ? max(0, q0 + offset - p.window + 1) / p.bk : 0;
  const float cap_k = p.softcap > 0.f ? hopper::softcap_k(p.softcap) : 0.f;

  for (int j = j0; j < n_kv; ++j) {
    const int k0 = j * p.bk;
    __syncthreads();  // q staged; the previous block no longer read
    stage<T, HD, LD>(k_s, kg, p.st[5], k0, p.bk, p.t);
    __syncthreads();
    float sc[kPer][kPer];
    dots<T, HD, LD, LD>(q_s, k_s, rq, ck, sc);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const KeyRange seen = visible(q0 + ty + 16 * i + offset, p.t, p.prefix, p.window);
      float rmax = kNegInf;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int col = tx + 16 * c;
        float x = capped<T>(sc[i][c], p, cap_k);
        if (col >= p.bk || !sees(seen, k0 + col, p.window)) x = kNegInf;
        sc[i][c] = x;
        rmax = fmaxf(rmax, x);
      }
      const float m_new = fmaxf(m[i], max16(rmax));
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < kPer; ++c) rsum += expf(sc[i][c] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + sum16(rsum);
      m[i] = m_new;
    }
  }

  float* lse = p.lse + (int64_t(b) * p.h + head) * p.s;
  float* delta = p.delta + (int64_t(b) * p.h + head) * p.s;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    const bool live = r < p.bq && row < p.s;
    float d = 0.f;
    if (live) {
      const T* orow = og + int64_t(row) * p.st[11] + tx;
      const T* dorow = dog + int64_t(row) * p.st[14] + tx;
#pragma unroll 4
      for (int e = 0; e < HDV / 16; ++e) d = fmaf(to_f32(dorow[16 * e]), to_f32(orow[16 * e]), d);
    }
    d = sum16(d);  // every lane of the warp takes part
    if (live && tx == 0) {
      lse[row] = m[i] + logf(l[i]);
      delta[row] = d;
    }
  }
}

// -- dq -------------------------------------------------------------------------

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(kThreads) dq_kernel(Params p) {
  constexpr int LD = ld<T, HD>();
  constexpr int LDV = ld<T, HDV>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);                      // [bq][LD]
  T* do_s = q_s + p.bq * LD;                                // [bq][LDV]
  T* kv_s = do_s + p.bq * LDV;                              // [bk][LD]: V, then K
  float* ds_s = reinterpret_cast<float*>(kv_s + p.bk * LD);  // [bq][bk + 1]
  const int dld = p.bk + 1;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (p.h / p.kv);
  const int offset = p.t - p.s;
  const int q0 = qb * p.bq;

  const T* qg = static_cast<const T*>(p.q) + b * p.st[0] + head * p.st[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.st[3] + kvh * p.st[4];
  const T* vg = static_cast<const T*>(p.v) + b * p.st[6] + kvh * p.st[7];
  const T* dog = static_cast<const T*>(p.dout) + b * p.st[12] + head * p.st[13];
  T* dqg = static_cast<T*>(p.dq) + b * p.st[15] + head * p.st[16];
  const float* lse_g = p.lse + (int64_t(b) * p.h + head) * p.s;
  const float* delta_g = p.delta + (int64_t(b) * p.h + head) * p.s;
  stage<T, HD, LD>(q_s, qg, p.st[2], q0, p.bq, p.s);
  stage<T, HDV, LDV>(do_s, dog, p.st[14], q0, p.bq, p.s);

  int rq[kPer], ck[kPer];
  float lse[kPer], dd[kPer];
  float acc[kPer][HD / 16];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    rq[i] = min(ty + 16 * i, p.bq - 1);
    ck[i] = min(tx + 16 * i, p.bk - 1);
    const int row = min(q0 + rq[i], p.s - 1);
    lse[i] = lse_g[row];
    dd[i] = delta_g[row];
#pragma unroll
    for (int e = 0; e < HD / 16; ++e) acc[i][e] = 0.f;
  }
  const int q_last = min(q0 + p.bq, p.s) - 1 + offset;
  const int n_kv = kv_blocks(q_last, p.t, p.bk, p.prefix);
  const int j0 = p.window ? max(0, q0 + offset - p.window + 1) / p.bk : 0;
  const float cap_k = p.softcap > 0.f ? hopper::softcap_k(p.softcap) : 0.f;

  for (int j = j0; j < n_kv; ++j) {
    const int k0 = j * p.bk;
    __syncthreads();  // q, dO staged; the previous block's K and dS no longer read
    stage<T, HDV, LD>(kv_s, vg, p.st[8], k0, p.bk, p.t);
    __syncthreads();
    float dp[kPer][kPer];
    dots<T, HDV, LDV, LD>(do_s, kv_s, rq, ck, dp);
    __syncthreads();  // V no longer read
    stage<T, HD, LD>(kv_s, kg, p.st[5], k0, p.bk, p.t);
    __syncthreads();
    float sc[kPer][kPer];
    dots<T, HD, LD, LD>(q_s, kv_s, rq, ck, sc);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + 16 * i;
      const KeyRange seen = visible(q0 + r + offset, p.t, p.prefix, p.window);
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int col = tx + 16 * c;
        const float x = capped<T>(sc[i][c], p, cap_k);
        const float pr = sees(seen, k0 + col, p.window) ? expf(x - lse[i]) : 0.f;
        if (r < p.bq && col < p.bk) ds_s[r * dld + col] = dscore(pr, dp[i][c], dd[i], x, p.softcap);
      }
    }
    __syncthreads();  // dS visible
    accumulate<T, HD, LD>(ds_s, dld, rq, min(p.bk, p.t - k0), kv_s, acc);
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    if (r < p.bq && row < p.s) {
      T* out = dqg + int64_t(row) * p.st[17] + tx;
#pragma unroll
      for (int e = 0; e < HD / 16; ++e) out[16 * e] = from_f32<T>(acc[i][e] * p.scale);
    }
  }
}

// -- dk, dv -----------------------------------------------------------------------

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(Params p) {
  constexpr int LD = ld<T, HD>();
  constexpr int LDV = ld<T, HDV>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                        // [bk][LD]
  T* v_s = k_s + p.bk * LD;                                   // [bk][LDV]
  T* q_s = v_s + p.bk * LDV;                                  // [bq][LD]
  T* do_s = q_s + p.bq * LD;                                  // [bq][LDV]
  float* pt_s = reinterpret_cast<float*>(do_s + p.bq * LDV);  // [bk][bq + 1]
  float* dst_s = pt_s + p.bk * (p.bq + 1);                    // [bk][bq + 1]
  float* lse_s = dst_s + p.bk * (p.bq + 1);                   // [bq]
  float* d_s = lse_s + p.bq;                                  // [bq]
  const int wld = p.bq + 1;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int kb = blockIdx.x;  // the first KV blocks are seen by the most queries
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int group = p.h / p.kv;
  const int offset = p.t - p.s;
  const int k0 = kb * p.bk;
  const int k_last = min(k0 + p.bk, p.t) - 1;

  const T* kg = static_cast<const T*>(p.k) + b * p.st[3] + kvh * p.st[4];
  const T* vg = static_cast<const T*>(p.v) + b * p.st[6] + kvh * p.st[7];
  stage<T, HD, LD>(k_s, kg, p.st[5], k0, p.bk, p.t);
  stage<T, HDV, LDV>(v_s, vg, p.st[8], k0, p.bk, p.t);

  // The query rows that see some key of this block: all of them when the
  // block starts inside the prefix, else those at or past its first key;
  // under a window, those whose window still reaches its last key.
  const int r_first = k0 < p.prefix ? 0 : max(0, k0 - offset);
  const int r_last = min(p.s - 1, p.window ? k_last + p.window - 1 - offset : p.s - 1);

  int rk[kPer], cq[kPer];
  float dk[kPer][HD / 16], dv[kPer][HDV / 16];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    rk[i] = min(ty + 16 * i, p.bk - 1);
    cq[i] = min(tx + 16 * i, p.bq - 1);
#pragma unroll
    for (int e = 0; e < HD / 16; ++e) dk[i][e] = 0.f;
#pragma unroll
    for (int e = 0; e < HDV / 16; ++e) dv[i][e] = 0.f;
  }
  const float cap_k = p.softcap > 0.f ? hopper::softcap_k(p.softcap) : 0.f;

  for (int g = 0; g < group && r_first <= r_last; ++g) {
    const int head = kvh * group + g;
    const T* qg = static_cast<const T*>(p.q) + b * p.st[0] + head * p.st[1];
    const T* dog = static_cast<const T*>(p.dout) + b * p.st[12] + head * p.st[13];
    const float* lse_g = p.lse + (int64_t(b) * p.h + head) * p.s;
    const float* delta_g = p.delta + (int64_t(b) * p.h + head) * p.s;
    for (int qb = r_first / p.bq; qb <= r_last / p.bq; ++qb) {
      const int q0 = qb * p.bq;
      __syncthreads();  // K, V staged; the previous block's tiles no longer read
      stage<T, HD, LD>(q_s, qg, p.st[2], q0, p.bq, p.s);
      stage<T, HDV, LDV>(do_s, dog, p.st[14], q0, p.bq, p.s);
      for (int r = tid; r < p.bq; r += kThreads) {
        const bool live = q0 + r < p.s;
        lse_s[r] = live ? lse_g[q0 + r] : 0.f;
        d_s[r] = live ? delta_g[q0 + r] : 0.f;
      }
      __syncthreads();
      float sc[kPer][kPer], dp[kPer][kPer];
      dots<T, HD, LD, LD>(k_s, q_s, rk, cq, sc);
      dots<T, HDV, LDV, LDV>(v_s, do_s, rk, cq, dp);
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int col = tx + 16 * c, row = q0 + col;
        const KeyRange seen = visible(row + offset, p.t, p.prefix, p.window);
        const bool live_q = col < p.bq && row < p.s;
        const float lq = lse_s[cq[c]], dq_ = d_s[cq[c]];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int r = ty + 16 * i, key = k0 + r;
          const float x = capped<T>(sc[i][c], p, cap_k);
          const float pr = live_q && sees(seen, key, p.window) ? expf(x - lq) : 0.f;
          if (r < p.bk && col < p.bq) {
            pt_s[r * wld + col] = pr;
            dst_s[r * wld + col] = dscore(pr, dp[i][c], dq_, x, p.softcap);
          }
        }
      }
      __syncthreads();  // P^T, dS^T visible
      accumulate<T, HDV, LDV>(pt_s, wld, rk, p.bq, do_s, dv);
      accumulate<T, HD, LD>(dst_s, wld, rk, p.bq, q_s, dk);
    }
  }

  T* dkg = static_cast<T*>(p.dk) + b * p.st[18] + kvh * p.st[19];
  T* dvg = static_cast<T*>(p.dv) + b * p.st[21] + kvh * p.st[22];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + 16 * i, key = k0 + r;
    if (r < p.bk && key < p.t) {
      T* krow = dkg + int64_t(key) * p.st[20] + tx;
      T* vrow = dvg + int64_t(key) * p.st[23] + tx;
#pragma unroll
      for (int e = 0; e < HD / 16; ++e) krow[16 * e] = from_f32<T>(dk[i][e] * p.scale);
#pragma unroll
      for (int e = 0; e < HDV / 16; ++e) vrow[16 * e] = from_f32<T>(dv[i][e]);
    }
  }
}

// -- host ------------------------------------------------------------------------

// Dynamic shared memory of each kernel (0 prep, 1 dq, 2 dkdv).
template <typename T, int HD, int HDV>
size_t smem_bytes(int kernel, int bq, int bk) {
  const size_t row = ld<T, HD>() * sizeof(T), row_v = ld<T, HDV>() * sizeof(T);
  if (kernel == 0) return size_t(bq + bk) * row;
  if (kernel == 1) return size_t(bq + bk) * row + size_t(bq) * row_v + size_t(bq) * (bk + 1) * 4;
  return size_t(bk + bq) * (row + row_v) + 2 * size_t(bk) * (bq + 1) * 4 + 2 * size_t(bq) * 4;
}

template <typename T, int HD, int HDV>
const void* kernel_of(int kernel) {
  if (kernel == 0) return reinterpret_cast<const void*>(prep_kernel<T, HD, HDV>);
  if (kernel == 1) return reinterpret_cast<const void*>(dq_kernel<T, HD, HDV>);
  return reinterpret_cast<const void*>(dkdv_kernel<T, HD, HDV>);
}

template <typename T, int HD, int HDV>
int launch(const Params& p, int batch, cudaStream_t stream) {
  for (int kernel = 0; kernel < 3; ++kernel) {
    const size_t smem = smem_bytes<T, HD, HDV>(kernel, p.bq, p.bk);
    if (smem > size_t(kMaxSmem)) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(kernel_of<T, HD, HDV>(kernel),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 q_grid((p.s + p.bq - 1) / p.bq, p.h, batch);
  const dim3 kv_grid((p.t + p.bk - 1) / p.bk, p.kv, batch);
  prep_kernel<T, HD, HDV><<<q_grid, kThreads, smem_bytes<T, HD, HDV>(0, p.bq, p.bk), stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, HD, HDV><<<q_grid, kThreads, smem_bytes<T, HD, HDV>(1, p.bq, p.bk), stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<T, HD, HDV><<<kv_grid, kThreads, smem_bytes<T, HD, HDV>(2, p.bq, p.bk), stream>>>(p);
  return cudaGetLastError();
}

// Registers, local (spilled) bytes a thread and the largest CTA of each of
// the three kernels, into out[9].
template <typename T, int HD, int HDV>
int attributes_of(int* out) {
  for (int kernel = 0; kernel < 3; ++kernel) {
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, kernel_of<T, HD, HDV>(kernel));
    if (err != cudaSuccess) return err;
    out[3 * kernel] = a.numRegs;
    out[3 * kernel + 1] = int(a.localSizeBytes);
    out[3 * kernel + 2] = a.maxThreadsPerBlock;
  }
  return cudaSuccess;
}

// The widths the repo's configs train at: (hd, hd_v) = (64, 64), (128,
// 128), (256, 256) and MLA's (192, 128); any other is refused.
template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o, const void* dout,
             void* dq, void* dk, void* dv, void* lse, void* delta, const long long* strides,
             int b, int h, int kv, int s, int t, int hd, int bq, int bk, float scale, int hd_v,
             int window, int prefix, float softcap, void* stream) {
  if (b <= 0 || s <= 0) return cudaSuccess;
  if (kv <= 0 || h % kv || t <= 0 || !(s <= t || prefix >= t) || window < 0 || prefix < 0 ||
      (window > 0 && prefix > 0) || !(softcap >= 0.f) || bq < 1 || bq > kMaxBlock || bk < 1 ||
      bk > kMaxBlock)
    return cudaErrorInvalidValue;
  Params p{q, k, v, o, dout, dq, dk, dv, static_cast<float*>(lse), static_cast<float*>(delta),
           {}, h, kv, s, t, bq, bk, scale, window, prefix, softcap};
  for (int i = 0; i < 24; ++i) p.st[i] = strides[i];
  auto st = static_cast<cudaStream_t>(stream);
  if (hd == 64 && hd_v == 64) return launch<T, 64, 64>(p, b, st);
  if (hd == 128 && hd_v == 128) return launch<T, 128, 128>(p, b, st);
  if (hd == 256 && hd_v == 256) return launch<T, 256, 256>(p, b, st);
  if (hd == 192 && hd_v == 128) return launch<T, 192, 128>(p, b, st);
  return cudaErrorInvalidValue;
}

template <typename T>
int attributes(int hd, int hd_v, int* out) {
  if (hd == 64 && hd_v == 64) return attributes_of<T, 64, 64>(out);
  if (hd == 128 && hd_v == 128) return attributes_of<T, 128, 128>(out);
  if (hd == 256 && hd_v == 256) return attributes_of<T, 256, 256>(out);
  if (hd == 192 && hd_v == 128) return attributes_of<T, 192, 128>(out);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v, o, do: the forward's inputs, output and the output's gradient;
// dq, dk, dv: the gradients (q's, k's and v's shapes and dtype); lse,
// delta: f32 [B, H, S] scratch; strides: 24 element strides, (batch, head,
// position) of q, k, v, o, do, dq, dk, dv.  The rest as the forward takes
// them (bq, bk <= 64, planned by the caller within the shared memory).
int remop_flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, void* lse,
                                   void* delta, const long long* strides, int b, int h, int kv,
                                   int s, int t, int hd, int bq, int bk, float scale, int hd_v,
                                   int window, int prefix, float softcap, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, lse, delta, strides, b, h, kv, s,
                                 t, hd, bq, bk, scale, hd_v, window, prefix, softcap, stream);
}

int remop_flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                                  const void* dout, void* dq, void* dk, void* dv, void* lse,
                                  void* delta, const long long* strides, int b, int h, int kv,
                                  int s, int t, int hd, int bq, int bk, float scale, int hd_v,
                                  int window, int prefix, float softcap, void* stream) {
  return dispatch<float>(q, k, v, o, dout, dq, dk, dv, lse, delta, strides, b, h, kv, s, t, hd,
                         bq, bk, scale, hd_v, window, prefix, softcap, stream);
}

// Registers, local bytes and the largest CTA of prep, dq and dkdv at these
// widths, into out[9].
int remop_flash_attention_bwd_attributes(int is_f32, int hd, int hd_v, int* out) {
  return is_f32 ? attributes<float>(hd, hd_v, out) : attributes<__nv_bfloat16>(hd, hd_v, out);
}

const char* remop_flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
