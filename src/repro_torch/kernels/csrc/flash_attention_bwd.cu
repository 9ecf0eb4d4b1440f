// The gradient of the causal GQA flash attention kernel (flash_attention.cu)
// for Hopper (sm_90a): a tensor-core route and a CUDA-core route.
//
// It replaces no Pallas kernel: the TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py:72 has no backward,
// and the JAX package trains through XLA's autodiff of full_attention /
// chunked_attention (src/repro/models/attention.py:67-131).  The port's
// forward on the card is the hand-written flash kernel, whose launch records
// nothing for autograd, so its gradient is hand-written too.  Given q [B, H,
// S, hd], k [B, KV, T, hd], v [B, KV, T, hd_v], the forward's output o and
// its gradient do [B, H, S, hd_v], it computes dq, dk and dv of what the
// forward computes, with the forward's mask (causal with the query positions
// offset by T - S, `window`, `prefix` including every key and S > T,
// visible() and the KV walk copied from the forward), its `scale` and its
// `softcap` (bf16 through hopper::softcap's exp2f form, f32 through tanhf,
// as the forward caps).  Per visible (query, key) pair: P = exp(s_c - lse),
// dV += P^T dO, dP = dO V^T, dS = P (dP - D) with D = sum(dO * O) (times 1
// - (s_c / c)^2 when capped), dQ += dS K, dK += dS^T Q; dQ and dK times
// `scale`, each gradient rounded once.  Neither route uses atomics: two
// calls give the same bits.
//
// What bounds it on this card: the operations.  Five products of 2 hd
// flops (at hd = hd_v) make 10 hd flops a visible pair (0.174 ms at
// qwen3-0.6b's [4, 16, 2048, 128] at 989 TFLOP/s), against a few bytes a
// pair.  Splitting dQ from dK/dV without atomics forms S and dP twice: 14 hd.
//
// Tensor-core route (dq_tc_kernel, then dkdv_tc_kernel or dkdv_wg_kernel):
// bf16 at (hd, hd_v) = (64, 64), (128, 128), (256, 256) or (192, 128),
// TMA-aligned q, k, v and do, two launches on the caller's stream (three with
// a split, below).  Each row's log-sum-exp comes from the forward
// (flash_attention.cu writes it into an f32 [B, H, S] buffer when asked), so
// nothing recomputes Q K^T for it.  The kernels take the forward's
// tensor-core shape: one producer warpgroup whose first thread issues TMA
// copies over rank-4 maps with each tensor's own strides (boxes of 64
// columns in the 128-byte swizzle, rows past S or T zero-filled; q and k
// hd / 64 such slabs, v and do hd_v / 64), consumer warpgroups on 64 rows
// each, a two-stage ring of streamed blocks on mbarriers, every product on
// wgmma with f32 accumulators in registers; at two consumer warpgroups the
// producer hands them its registers (setmaxnreg 40 / 232).
//   dq_tc: one CTA per (128 query rows, head, batch), 64 at hd 256 (128
//     rows of Q and dO with the ring would not fit shared memory), the
//     heaviest (last) first.  Q and dO land once; the prologue forms D of
//     its rows from O and dO (written to f32 scratch for dkdv).  Per KV
//     block of 64 (K and V on separate barriers): S = Q K^T and dP = dO V^T
//     (both operands K-major), then P and dS in registers, then dQ += dS K
//     with dS as the register A operand and K read MN-major (the transpose bit).
//   dkdv_tc (hd 64, 128): one CTA per (128 keys, KV head, batch), the
//     first KV blocks (seen by the most queries) first.  K and V land once;
//     for each step (a query head of the GQA group and a query block of 64
//     rows that sees the tile) Q and dO stream through the ring
//     and the producer's second warp stages the block's lse and D.  S^T = K
//     Q^T and dP^T = V dO^T, then P^T and dS^T in registers, then dV += P^T
//     dO and dK += dS^T Q (register A, dO and Q MN-major), both in each
//     consumer warpgroup's registers, dS^T in three bf16 terms (below).
//   dkdv_wg (256, (192, 128)): dK and dV of 64 keys no longer fit one
//     warpgroup's registers, so its two consumer warpgroups share the 64
//     keys, one gradient each, and pass P^T through shared memory (see
//     dkdv_wg_kernel).
// The split: the host asks for n_split CTAs a key block where B * KV * (key
// blocks) CTAs leave most SMs idle; each takes one run of its steps (heads
// first, then query blocks) and writes f32 partial dK and dV to scratch, and
// kv_reduce_kernel sums them in split order, applies the scale and rounds
// once.  No atomics: two calls give the same bits.
// The flush: wgmma's f32 sums lose more than the CUDA cores' over long
// walks (at G 8 on one KV head, 16,384 query rows into one accumulator, dK
// missed ATTN_TOL's elementwise bound against f64 by 3.4x at hd 128; with
// q 8 times the unit scale 4,096 rows still missed on some draws, 256 rows
// on none).  So where a key block's walk may pass 4,096 (head, query) rows,
// or the call has a prefix, the host hands the tc entry flush_steps (the
// steps of 256 rows, a power of two; flash_attention_bwd.py's
// plan_bwd_flush_steps, held to check_bwd_runs): every flush_steps steps of
// its walk (at the top of the next step, where the fewest registers are
// live: after the step the flush spilled at hd 128 and 256) each consumer
// thread adds its dK and dV accumulators into the CTA's f32 partial in
// scratch (the first flush stores them) on the CUDA cores, round to
// nearest, and restarts them from 0; the walk's last sums go in the same
// way, and at n_split 1 the CTA then rounds partial plus accumulators to dk
// and dv itself (no kv_reduce).  Each thread reads and writes only its own
// fragment's entries, so no barrier orders the flushes.  The flushing
// walks run the dkdv kernels' FLUSH instantiations; every other call
// (flush_steps 0) runs the others, which are the kernels it had.
// P and dS keep f32 precision into their products as the forward keeps P:
// x = hi + lo with hi = bf16(x), lo = bf16(x - hi), two products each; dK
// takes dS^T in three terms (x = hi + mid + lo, split3_frags) in both dkdv
// kernels: with two, dK's entries that cancel to near 0 missed ATTN_TOL's
// elementwise bound at G 8 on one KV head with q 8 times the unit scale.  So
// the design does 14 hd + 8 hd = 22 hd flops a pair on the tensor cores.
// The capped dkdv_tc at hd 128 streams 32 query rows a block (at 64 it spills).

// CUDA-core route (prep_kernel, dq_kernel, dkdv_kernel): every f32 call, and
// bf16 the tensor-core route does not take (the reduced configs' hd 16 and
// 32, reduced MLA's (24, 16) as (32, 16) on q and k zero-padded by the
// wrapper, strides TMA cannot load).  Three launches a call, in this order:
//
//   prep: one CTA per (query block, head, batch) walks the KV blocks its
//     rows see, as the forward does, and keeps each row's running max and
//     sum (16 threads a row) to give lse = m + log(l); it also forms
//     D = sum(do * o) over the row.  Both land in f32 [B, H, S] scratch.
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
//     over the GQA group stays inside the CTA.  dK * scale and dV are
//     rounded once to k's dtype.
//
// 256 threads as 16 x 16; thread (ty, tx) owns rows ty + 16 i and columns
// tx + 16 j of each 64 x 64 tile (bq, bk <= 64, planned on the host under
// the 227 KB of shared memory a CTA may use), as the forward's CUDA-core
// route does; staged rows are padded by one 32-bit word.  Every product
// multiplies in f32 with FMAs.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

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
// 128), (256, 256) and MLA's (192, 128); the reduced configs' (16, 16) and
// (32, 32), and (32, 16), which takes reduced MLA's (24, 16) with q and k
// zero-padded to 32 by the wrapper; any other is refused.
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
  if (hd == 16 && hd_v == 16) return launch<T, 16, 16>(p, b, st);
  if (hd == 32 && hd_v == 32) return launch<T, 32, 32>(p, b, st);
  if (hd == 32 && hd_v == 16) return launch<T, 32, 16>(p, b, st);
  return cudaErrorInvalidValue;
}

template <typename T>
int attributes(int hd, int hd_v, int* out) {
  if (hd == 64 && hd_v == 64) return attributes_of<T, 64, 64>(out);
  if (hd == 128 && hd_v == 128) return attributes_of<T, 128, 128>(out);
  if (hd == 256 && hd_v == 256) return attributes_of<T, 256, 256>(out);
  if (hd == 192 && hd_v == 128) return attributes_of<T, 192, 128>(out);
  if (hd == 16 && hd_v == 16) return attributes_of<T, 16, 16>(out);
  if (hd == 32 && hd_v == 32) return attributes_of<T, 32, 32>(out);
  if (hd == 32 && hd_v == 16) return attributes_of<T, 32, 16>(out);
  return cudaErrorInvalidValue;
}

// ----------------------------------------------------------------------------
// Tensor-core route: bf16 at (hd, hd_v) = (64, 64), (128, 128), (256, 256) or
// (192, 128)
// ----------------------------------------------------------------------------

constexpr int kProducerThreads = 128;  // one warpgroup, after the consumers
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSplit = 16;  // CTAs a key block at most (the partials' scratch)
struct TcParams {
  const void* o;     // the forward's output, for D
  const void* dout;  // its gradient, for D
  void* dq;
  void* dk;
  void* dv;
  const float* lse;  // [B, H, S], written by the forward
  float* delta;      // [B, H, S], written by dq_tc, read by dkdv
  // n_split > 1: [n_split, B, KV, T, hd + hd_v] f32, each CTA's dK (unscaled)
  // then dV, summed by kv_reduce_kernel; n_split = 1: dkdv writes dk, dv.
  float* part;
  // Element strides: q, k, v, o, do, dq, dk, dv, each (batch, head, position).
  int64_t st[24];
  int h, kv, s, t;
  float scale;
  int window, prefix;
  float softcap;
  int n_split;
  // The steps of the walk between flushes (see the flush above); 0: none.
  int flush_steps;
};

// Shared memory of dq_tc (byte offsets from a 1024-byte-aligned base): Q
// (hd / 64 slabs of BQ rows x 128 bytes) then dO (hd_v / 64 slabs); two
// stages of K (hd / 64 slabs of BK rows) and V (hd_v / 64); the mbarriers
// q_full, k_full[2], v_full[2], empty[2]; 1024 bytes of slack to align the base.
__host__ __device__ constexpr int dq_tc_smem(int hd, int hdv, int bq, int bk) {
  return 1024 + bq * (hd + hdv) * 2 + 2 * bk * (hd + hdv) * 2 + 7 * 8;
}
// dkdv: K then V of BKV keys; two stages of Q and dO of BQ rows; lse (times
// log2 e but in dkdv_tc's FLUSH walks) and D of each stage's BQ rows, f32; at
// BKV = 64 (dkdv_wg) the exchange, 64 x BQ f32; the mbarriers kv_full,
// q_full[2], do_full[2], empty[2]; 1024 bytes of slack.
__host__ __device__ constexpr int dkdv_tc_smem(int hd, int hdv, int bkv, int bq) {
  return 1024 + bkv * (hd + hdv) * 2 + 2 * bq * (hd + hdv) * 2 + 4 * bq * 4 +
         (bkv == 64 ? 64 * bq * 4 : 0) + 7 * 8;
}

template <int HD, int HDV, int BQ, int BK>
struct DqLayout {
  static constexpr int kQBytes = BQ * HD * 2;
  static constexpr int kDoBytes = BQ * HDV * 2;
  static constexpr int kKBytes = BK * HD * 2;  // one K block
  static constexpr int kVBytes = BK * HDV * 2;  // one V block
  static constexpr int kRing = kQBytes + kDoBytes;
  static constexpr int kStage = kKBytes + kVBytes;
  static constexpr int kBars = kRing + 2 * kStage;
  static constexpr int kSmem = dq_tc_smem(HD, HDV, BQ, BK);
};

template <int HD, int HDV, int BKV, int BQ>
struct KvLayout {
  static constexpr int kKBytes = BKV * HD * 2;
  static constexpr int kVBytes = BKV * HDV * 2;
  static constexpr int kQBytes = BQ * HD * 2;  // one Q block
  static constexpr int kDoBytes = BQ * HDV * 2;  // one dO block
  static constexpr int kRing = kKBytes + kVBytes;
  static constexpr int kStage = kQBytes + kDoBytes;
  static constexpr int kStats = kRing + 2 * kStage;  // lse[2][BQ], then D[2][BQ]
  static constexpr int kExchange = kStats + 4 * BQ * 4;  // dkdv_wg: [32][128] f32
  static constexpr int kBars = kExchange + (BKV == 64 ? 64 * BQ * 4 : 0);
  static constexpr int kSmem = dkdv_tc_smem(HD, HDV, BKV, BQ);
};

// The A fragments (hopper::wgmma_bf16_rs) of an f32 accumulator fragment
// of N columns, as hi = bf16(x) and lo = bf16(x - hi): the product with
// both keeps about 16 significant bits of x, as the forward keeps P.
template <int N>
__device__ __forceinline__ void split_frags(const float (&x)[N / 2], uint32_t (&hi)[N / 16][4],
                                            uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = x[8 * kk + 2 * e], c = x[8 * kk + 2 * e + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, c);
      const float2 back = __bfloat1622float2(h);
      const __nv_bfloat162 l = __floats2bfloat162_rn(a - back.x, c - back.y);
      hi[kk][e] = *reinterpret_cast<const uint32_t*>(&h);
      lo[kk][e] = *reinterpret_cast<const uint32_t*>(&l);
    }
  }
}

// The same with a third term, x = hi + mid + lo (about 24 significant bits,
// f32's): for dK (dkdv_tc and dkdv_wg), a sum of G S terms dS Q that cancel
// to near 0 in places while Q is large (the models' query gains).
template <int N>
__device__ __forceinline__ void split3_frags(const float (&x)[N / 2], uint32_t (&hi)[N / 16][4],
                                             uint32_t (&mid)[N / 16][4],
                                             uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = x[8 * kk + 2 * e], c = x[8 * kk + 2 * e + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, c);
      const float2 hb = __bfloat1622float2(h);
      const float ra = a - hb.x, rc = c - hb.y;
      const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rc);
      const float2 mb = __bfloat1622float2(m);
      const __nv_bfloat162 l = __floats2bfloat162_rn(ra - mb.x, rc - mb.y);
      hi[kk][e] = *reinterpret_cast<const uint32_t*>(&h);
      mid[kk][e] = *reinterpret_cast<const uint32_t*>(&m);
      lo[kk][e] = *reinterpret_cast<const uint32_t*>(&l);
    }
  }
}

// The exponent of P = exp(s_c - lse) in base 2, from the capped score and
// `lse`: without EXACT `lse` is lse * log2 e, rounded to f32 once a row, and
// the exponent fma(s_c, log2 e, -lse); with EXACT `lse` is the row's lse as
// the forward wrote it, and the exponent (s_c - lse) log2 e.  The rounding
// of lse * log2 e is an error shared by all of a row's P (at q 8 times the
// unit scale, lse near 26: up to 2^-19 of the exponent); dK sums it over a
// key block's whole walk, and at granite-20b's 48 heads on one KV head
// (98,304 rows) it carried dK past ATTN_TOL against f64 on 1 draw of 41,
// with the forward's own f32 lse (flash_probe.py --emulate).  dkdv_tc's
// flushing walks, the long ones, drop it (EXACT); dq_tc, dkdv_wg and every
// unflushed call keep their bits (dkdv_wg's flushing rows, at one KV head of
// 256, read 0 misses of 41 with the rounding, and the exact form costs them
// 5-7% on an H100).  Uncapped, the compiler contracts s_c = dot * scale into the fma.
template <bool EXACT>
__device__ __forceinline__ float p_exponent(float x, float lse) {
  return EXACT ? (x - lse) * kLog2e : fmaf(x, kLog2e, -lse);
}

// P = exp(s_c - lse) of a visible pair (0 where hidden) and dS = P (dP -
// D), times 1 - (s_c / c)^2 when capped; `dot` is the raw Q.K product,
// `lse` as p_exponent<EXACT> takes it.  P lands in `dot`'s place, dS in
// `dp`'s.
template <bool CAP, bool EXACT>
__device__ __forceinline__ void p_and_ds(float& dot, float& dp, bool seen, float lse, float d,
                                         const TcParams& p, float cap_k) {
  float x = dot * p.scale;
  if constexpr (CAP) x = hopper::softcap<true>(x, p.softcap, cap_k);
  const float pr = seen ? exp2f(p_exponent<EXACT>(x, lse)) : 0.f;
  float ds = pr * (dp - d);
  if constexpr (CAP) {
    const float u = x / p.softcap;
    ds *= 1.f - u * u;
  }
  dot = pr;
  dp = ds;
}

// Rows (r0, r0 + 8) of an accumulator fragment of W columns, times `mul`,
// to bf16 rows of `g` (position stride `ps`); rows at or past `limit` skipped.
template <int W>
__device__ __forceinline__ void store_rows(const float (&acc)[W / 2], __nv_bfloat16* g,
                                           int64_t ps, int r0, int limit, int lane, float mul) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= limit) continue;
    __nv_bfloat16* out = g + int64_t(row) * ps + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < W / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * c) =
          __floats2bfloat162_rn(acc[4 * c + 2 * half] * mul, acc[4 * c + 2 * half + 1] * mul);
  }
}

// The same rows, unscaled f32, into columns [col, col + W) of f32 rows of
// `width` values starting at `g` (row = key); keys at or past `limit` skipped.
template <int W>
__device__ __forceinline__ void store_part(const float (&acc)[W / 2], float* g, int width,
                                           int col, int r0, int limit, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= limit) continue;
    float* out = g + int64_t(row) * width + col + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < W / 8; ++c)
      *reinterpret_cast<float2*>(out + 8 * c) =
          make_float2(acc[4 * c + 2 * half], acc[4 * c + 2 * half + 1]);
  }
}

// The partial's rows plus the accumulator fragment: written back to the
// partial (WRITE: what the earlier flushes left there, plus this run) or into
// the fragment (the walk's last sums on top of its flushes).  The partial is
// read in batches of up to 16 float2 a row: a batch's loads issue back to
// back, then its adds; the compiler barrier keeps the next batch's loads
// behind them, so a flush holds at most 32 more registers.
template <int W, bool WRITE>
__device__ __forceinline__ void part_plus(float (&acc)[W / 2], float* g, int width, int col,
                                          int r0, int limit, int lane) {
  constexpr int kPairs = W / 8, kBatch = kPairs < 16 ? kPairs : 16;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= limit) continue;
    float* at = g + int64_t(row) * width + col + 2 * (lane & 3);
#pragma unroll
    for (int c0 = 0; c0 < kPairs; c0 += kBatch) {
      float2 y[kBatch];
#pragma unroll
      for (int c = 0; c < kBatch; ++c)
        y[c] = *reinterpret_cast<const float2*>(at + 8 * (c0 + c));
#pragma unroll
      for (int c = 0; c < kBatch; ++c) {
        float& lo = acc[4 * (c0 + c) + 2 * half];
        float& hi = acc[4 * (c0 + c) + 2 * half + 1];
        if constexpr (WRITE) {
          *reinterpret_cast<float2*>(at + 8 * (c0 + c)) = make_float2(y[c].x + lo, y[c].y + hi);
        } else {
          lo = y[c].x + lo;
          hi = y[c].y + hi;
        }
      }
      asm volatile("" ::: "memory");
    }
  }
}

// The flush after step i of a walk [lo, hi) (run at the top of step i + 1,
// where the fewest registers are live): every flush_steps steps (a power of
// two) but the last, the accumulator fragment into the partial's rows
// (stored at the first flush, added after), then restarted from 0.
template <int W>
__device__ __forceinline__ void flush_part(float (&acc)[W / 2], const TcParams& p, float* g,
                                           int width, int col, int r0, int lane, int i, int lo,
                                           int hi) {
  if (((i - lo + 1) & (p.flush_steps - 1)) || i + 1 >= hi) return;
  if (i - lo + 1 > p.flush_steps)
    part_plus<W, true>(acc, g, width, col, r0, p.t, lane);
  else
    store_part<W>(acc, g, width, col, r0, p.t, lane);
#pragma unroll
  for (int r = 0; r < W / 2; ++r) acc[r] = 0.f;
}

// The end of one consumer's walk [lo, hi): its W columns at `col` of the
// CTA's f32 partial (rows of `width`), or at n_split 1 rounded to bf16 rows
// of `g` (position stride `ps`) times `mul`; where FLUSH left sums of this
// walk in the partial (the walk passed flush_steps steps), on top of them.
template <int W, bool FLUSH>
__device__ __forceinline__ void finish_walk(float (&acc)[W / 2], const TcParams& p, float* part,
                                            int width, int col, __nv_bfloat16* g, int64_t ps,
                                            float mul, int r0, int lane, int lo, int hi) {
  const bool flushed = FLUSH && hi - lo > p.flush_steps;
  if (p.n_split == 1) {
    if (flushed) part_plus<W, false>(acc, part, width, col, r0, p.t, lane);
    store_rows<W>(acc, g, ps, r0, p.t, lane, mul);
  } else if (flushed) {
    part_plus<W, true>(acc, part, width, col, r0, p.t, lane);
  } else {
    store_part<W>(acc, part, width, col, r0, p.t, lane);
  }
}

// -- dq_tc ------------------------------------------------------------------------

// One consumer warpgroup w: query rows [q0 + 64w, q0 + 64w + 64); this
// thread holds rows r0 and r0 + 8 of the fragments.  KV blocks j0 .. n_kv -
// 1; the i-th (i = j - j0) sits in ring stage i % 2 at parity (i / 2) % 2.
template <int HD, int HDV, int BQ, int BK, bool CAP>
__device__ __forceinline__ void dq_consume(unsigned char* smem, uint64_t* q_full,
                                           uint64_t* k_full, uint64_t* v_full, uint64_t* empty,
                                           const TcParams& p, int w, int warp, int lane, int q0,
                                           int head, int b, int offset, int j0, int n_kv) {
  using L = DqLayout<HD, HDV, BQ, BK>;
  const int r0 = q0 + 64 * w + 16 * (warp % 4) + (lane >> 2);
  const KeyRange seen0 = visible(r0 + offset, p.t, p.prefix, p.window);
  const KeyRange seen1 = visible(r0 + 8 + offset, p.t, p.prefix, p.window);
  const uint32_t q_addr = hopper::smem_u32(smem) + w * 64 * 128;
  const uint32_t do_addr = q_addr + L::kQBytes;
  const int64_t bh = int64_t(b) * p.h + head;

  // D = sum(dO * O) of rows r0 and r0 + 8 (the 4 lanes of a row split its
  // columns), written for dkdv; lse of the same rows, times log2 e.
  float dd[2], lse2[2];
  const __nv_bfloat16* og = static_cast<const __nv_bfloat16*>(p.o) + b * p.st[9] + head * p.st[10];
  const __nv_bfloat16* dog =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.st[12] + head * p.st[13];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    float d = 0.f;
    if (row < p.s) {
      const __nv_bfloat16* orow = og + int64_t(row) * p.st[11] + 2 * (lane & 3);
      const __nv_bfloat16* drow = dog + int64_t(row) * p.st[14] + 2 * (lane & 3);
#pragma unroll 4
      for (int c = 0; c < HDV / 8; ++c) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + 8 * c));
        const float2 e = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + 8 * c));
        d = fmaf(a.y, e.y, fmaf(a.x, e.x, d));
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    dd[half] = d;
    lse2[half] = row < p.s ? p.lse[bh * p.s + row] * kLog2e : 0.f;
    if (row < p.s && (lane & 3) == 0) p.delta[bh * p.s + row] = d;
  }

  float acc[HD / 2];
#pragma unroll
  for (int r = 0; r < HD / 2; ++r) acc[r] = 0.f;
  const float cap_k = CAP ? hopper::softcap_k(p.softcap) : 0.f;

  hopper::mbar_wait(q_full, 0);
  for (int j = j0; j < n_kv; ++j) {
    const int s = (j - j0) & 1;
    const uint32_t parity = ((j - j0) >> 1) & 1;
    const uint32_t k_addr = hopper::smem_u32(smem + L::kRing + s * L::kStage);
    const uint32_t v_addr = k_addr + L::kKBytes;

    // S = Q K^T and dP = dO V^T: column c of both fragments is key j * BK + c.
    float sc[BK / 2], dp[BK / 2];
#pragma unroll
    for (int r = 0; r < BK / 2; ++r) sc[r] = dp[r] = 0.f;
    hopper::mbar_wait(&k_full[s], parity);
    hopper::wgmma_fence();
    hopper::fence_operands(sc);
    hopper::fence_operands(dp);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::wgmma_bf16<0, 0>(
          sc, hopper::desc_sw128(q_addr + (kk >> 2) * BQ * 128 + (kk & 3) * 32, 16, 1024),
          hopper::desc_sw128(k_addr + (kk >> 2) * BK * 128 + (kk & 3) * 32, 16, 1024));
    hopper::wgmma_commit();
    hopper::mbar_wait(&v_full[s], parity);
#pragma unroll
    for (int kk = 0; kk < HDV / 16; ++kk)
      hopper::wgmma_bf16<0, 0>(
          dp, hopper::desc_sw128(do_addr + (kk >> 2) * BQ * 128 + (kk & 3) * 32, 16, 1024),
          hopper::desc_sw128(v_addr + (kk >> 2) * BK * 128 + (kk & 3) * 32, 16, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(sc);
    hopper::fence_operands(dp);

    const int k0 = j * BK;
#pragma unroll
    for (int r = 0; r < BK / 2; ++r) {
      const int col = k0 + 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
      const int lower = (r >> 1) & 1;  // row r0 + 8
      const KeyRange& seen = lower ? seen1 : seen0;
      p_and_ds<CAP, false>(sc[r], dp[r], sees(seen, col, p.window), lse2[lower], dd[lower], p,
                           cap_k);
    }

    // dQ += dS K: dS from registers, K MN-major through the transpose bit.
    uint32_t dh[BK / 16][4], dl[BK / 16][4];
    split_frags<BK>(dp, dh, dl);
    hopper::wgmma_fence();
    hopper::fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = hopper::desc_sw128(k_addr + kk * 2048, BK * 128, 1024);
      hopper::wgmma_bf16_rs<1>(acc, dh[kk], db);
      hopper::wgmma_bf16_rs<1>(acc, dl[kk], db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      hopper::fence_operands(dh[kk]);
      hopper::fence_operands(dl[kk]);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // this warp is done with the stage
  }

  __nv_bfloat16* dqg = static_cast<__nv_bfloat16*>(p.dq) + b * p.st[15] + head * p.st[16];
  store_rows<HD>(acc, dqg, p.st[17], r0, p.s, lane, p.scale);
}

// One CTA per (BQ query rows, head, batch), heaviest (last) blocks first:
// BQ / 64 consumer warpgroups and one producer warpgroup (setmaxnreg 40 /
// 232 at two consumers, as the forward's tensor-core kernel).
template <int HD, int HDV, int BQ, int BK, bool CAP>
__global__ void __launch_bounds__(BQ / 64 * 128 + kProducerThreads, 1)
    dq_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_do, TcParams p) {
  using L = DqLayout<HD, HDV, BQ, BK>;
  constexpr int kWarpgroups = BQ / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = q_full + 3;
  uint64_t* empty = q_full + 5;

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (p.h / p.kv);
  const int offset = p.t - p.s;
  const int q0 = qb * BQ;
  const int q_last = min(q0 + BQ, p.s) - 1 + offset;
  const int n_kv = kv_blocks(q_last, p.t, BK, p.prefix);
  const int j0 = p.window ? max(0, q0 + offset - p.window + 1) / BK : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 4 * kWarpgroups);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 4 * kWarpgroups) {
    if constexpr (kWarpgroups == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 4 * kWarpgroups && lane == 0) {
      hopper::mbar_arrive_expect_tx(q_full, L::kQBytes + L::kDoBytes);
      for (int i = 0; i < HD / 64; ++i)
        hopper::tma_load_4d(smem + i * BQ * 128, &map_q, q_full, 64 * i, q0, head, b);
      for (int i = 0; i < HDV / 64; ++i)
        hopper::tma_load_4d(smem + L::kQBytes + i * BQ * 128, &map_do, q_full, 64 * i, q0, head,
                            b);
      for (int j = j0; j < n_kv; ++j) {
        const int s = (j - j0) & 1;
        hopper::mbar_wait(&empty[s], (((j - j0) >> 1) & 1) ^ 1);
        unsigned char* ks = smem + L::kRing + s * L::kStage;
        hopper::mbar_arrive_expect_tx(&k_full[s], L::kKBytes);
        for (int i = 0; i < HD / 64; ++i)
          hopper::tma_load_4d(ks + i * BK * 128, &map_k, &k_full[s], 64 * i, j * BK, kvh, b);
        hopper::mbar_arrive_expect_tx(&v_full[s], L::kVBytes);
        for (int i = 0; i < HDV / 64; ++i)
          hopper::tma_load_4d(ks + L::kKBytes + i * BK * 128, &map_v, &v_full[s], 64 * i, j * BK,
                              kvh, b);
      }
    }
  } else {
    if constexpr (kWarpgroups == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    dq_consume<HD, HDV, BQ, BK, CAP>(smem, q_full, k_full, v_full, empty, p, warp / 4, warp, lane,
                                     q0, head, b, offset, j0, n_kv);
  }
}

// -- dkdv: dkdv_tc (hd = hd_v = 64, 128) and dkdv_wg (256, (192, 128)) ------------------

// The query rows that see some key of [k0, k_last]: all of them when the
// tile starts inside the prefix, else those at or past its first key;
// under a window, those whose window still reaches its last key.
struct RowRange {
  int first, last;
};
__device__ __forceinline__ RowRange seeing_rows(int k0, int k_last, const TcParams& p) {
  const int offset = p.t - p.s;
  return {k0 < p.prefix ? 0 : max(0, k0 - offset),
          min(p.s - 1, p.window ? k_last + p.window - 1 - offset : p.s - 1)};
}

// The walk of one dkdv CTA: blockIdx.x = key block * n_split + z.  The key
// block's steps (head i / n_q of the group, query block first_qb + i % n_q,
// i < group * n_q) are cut into n_split runs of consecutive steps, heads
// first; the CTA takes run z, steps [lo, hi).  Its j-th step (i = lo + j)
// sits in ring stage j % 2 at parity (j / 2) % 2.
struct Walk {
  int k0, z, first_qb, n_q, lo, hi;
};
template <int BKV, int BQ>
__device__ __forceinline__ Walk walk_of(const TcParams& p) {
  const int kb = blockIdx.x / p.n_split, z = blockIdx.x % p.n_split;
  const int k0 = kb * BKV;
  const RowRange rows = seeing_rows(k0, min(k0 + BKV, p.t) - 1, p);
  const int first_qb = rows.first / BQ;
  const int n_q = rows.first <= rows.last ? rows.last / BQ - first_qb + 1 : 0;
  const int steps = (p.h / p.kv) * n_q;
  return {k0, z, first_qb, n_q, int(int64_t(steps) * z / p.n_split),
          int(int64_t(steps) * (z + 1) / p.n_split)};
}

// This CTA's f32 partial rows of [n_split, B, KV, T, hd + hd_v], from key 0
// (none without a split or a flush).
__device__ __forceinline__ float* part_rows(const TcParams& p, int z, int kvh, int b, int width) {
  if (p.part == nullptr) return nullptr;
  return p.part + ((int64_t(z) * gridDim.z + b) * p.kv + kvh) * int64_t(p.t) * width;
}

// An opaque 0: addresses built on it are formed where they are used, not
// hoisted out of the walk's loop (where they would stay live).
__device__ __forceinline__ int opaque_zero() {
  int zero;
  asm volatile("mov.u32 %0, 0;\n" : "=r"(zero));
  return zero;
}

// The producer warpgroup of either dkdv kernel: its first warp issues the
// copies (K and V once, then Q and dO of each step), its second loads each
// step's lse (times log2 e without EXACT: p_exponent) and D.
template <int HD, int HDV, int BKV, int BQ, bool EXACT>
__device__ __forceinline__ void dkdv_produce(unsigned char* smem, uint64_t* kv_full,
                                             uint64_t* q_full, uint64_t* do_full,
                                             uint64_t* empty, const CUtensorMap* map_q,
                                             const CUtensorMap* map_k, const CUtensorMap* map_v,
                                             const CUtensorMap* map_do, const TcParams& p,
                                             const Walk& w, int warp_in_group, int lane,
                                             int kvh, int b) {
  using L = KvLayout<HD, HDV, BKV, BQ>;
  const int group = p.h / p.kv;
  if (warp_in_group == 0 && lane == 0 && w.hi > w.lo) {
    hopper::mbar_arrive_expect_tx(kv_full, L::kKBytes + L::kVBytes);
    for (int i = 0; i < HD / 64; ++i)
      hopper::tma_load_4d(smem + i * BKV * 128, map_k, kv_full, 64 * i, w.k0, kvh, b);
    for (int i = 0; i < HDV / 64; ++i)
      hopper::tma_load_4d(smem + L::kKBytes + i * BKV * 128, map_v, kv_full, 64 * i, w.k0, kvh,
                          b);
    for (int i = w.lo; i < w.hi; ++i) {
      const int j = i - w.lo, s = j & 1;
      const int head = kvh * group + i / w.n_q, q0 = (w.first_qb + i % w.n_q) * BQ;
      hopper::mbar_wait(&empty[s], ((j >> 1) & 1) ^ 1);
      unsigned char* qs = smem + L::kRing + s * L::kStage;
      hopper::mbar_arrive_expect_tx(&q_full[s], L::kQBytes);
      for (int c = 0; c < HD / 64; ++c)
        hopper::tma_load_4d(qs + c * BQ * 128, map_q, &q_full[s], 64 * c, q0, head, b);
      hopper::mbar_arrive_expect_tx(&do_full[s], L::kDoBytes);
      for (int c = 0; c < HDV / 64; ++c)
        hopper::tma_load_4d(qs + L::kQBytes + c * BQ * 128, map_do, &do_full[s], 64 * c, q0,
                            head, b);
    }
  } else if (warp_in_group == 1) {
    for (int i = w.lo; i < w.hi; ++i) {
      const int j = i - w.lo, s = j & 1;
      const int head = kvh * group + i / w.n_q, q0 = (w.first_qb + i % w.n_q) * BQ;
      const int64_t base = (int64_t(b) * p.h + head) * p.s;
      hopper::mbar_wait(&empty[s], ((j >> 1) & 1) ^ 1);
      float* lse_s = reinterpret_cast<float*>(smem + L::kStats) + s * BQ;
      float* d_s = lse_s + 2 * BQ;
      for (int r = lane; r < BQ; r += 32) {
        const bool live = q0 + r < p.s;
        const float lse = live ? p.lse[base + q0 + r] : 0.f;
        lse_s[r] = EXACT ? lse : lse * kLog2e;
        d_s[r] = live ? p.delta[base + q0 + r] : 0.f;
      }
      hopper::mbar_arrive(&do_full[s]);
    }
  }
}

// Whether key `key` is seen by query row `row` (its position row + T - S).
__device__ __forceinline__ bool pair_seen(int key, int row, const TcParams& p) {
  const int qpos = row + p.t - p.s;
  return row < p.s && key < p.t && (key <= qpos || key < p.prefix) &&
         (!p.window || key > qpos - p.window);
}

// One consumer warpgroup w of dkdv_tc: keys [k0 + 64w, k0 + 64w + 64);
// this thread holds keys kr0 and kr0 + 8.
template <int HD, int BKV, int BQ, bool CAP, bool FLUSH>
__device__ __forceinline__ void dkdv_consume(unsigned char* smem, uint64_t* kv_full,
                                             uint64_t* q_full, uint64_t* do_full,
                                             uint64_t* empty, const TcParams& p, int w, int warp,
                                             int lane, const Walk& walk, int kvh, int b) {
  using L = KvLayout<HD, HD, BKV, BQ>;
  const int kr0 = walk.k0 + 64 * w + 16 * (warp % 4) + (lane >> 2);
  const uint32_t k_addr = hopper::smem_u32(smem) + w * 64 * 128;
  const uint32_t v_addr = k_addr + L::kKBytes;
  const float cap_k = CAP ? hopper::softcap_k(p.softcap) : 0.f;

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int r = 0; r < HD / 2; ++r) dk[r] = dv[r] = 0.f;

  if (walk.hi > walk.lo) hopper::mbar_wait(kv_full, 0);
  for (int i = walk.lo; i < walk.hi; ++i) {
    if constexpr (FLUSH) {
      if (i > walk.lo) {
        float* part = part_rows(p, walk.z, kvh, b, 2 * HD) + opaque_zero();
        flush_part<HD>(dk, p, part, 2 * HD, 0, kr0, lane, i - 1, walk.lo, walk.hi);
        flush_part<HD>(dv, p, part, 2 * HD, HD, kr0, lane, i - 1, walk.lo, walk.hi);
      }
    }
    const int s = (i - walk.lo) & 1;
    const uint32_t parity = ((i - walk.lo) >> 1) & 1;
    const int q0 = (walk.first_qb + i % walk.n_q) * BQ;
    const uint32_t q_addr = hopper::smem_u32(smem + L::kRing + s * L::kStage);
    const uint32_t do_addr = q_addr + L::kQBytes;
    const float* lse_s = reinterpret_cast<const float*>(smem + L::kStats) + s * BQ;
    const float* d_s = lse_s + 2 * BQ;

    // S^T = K Q^T and dP^T = V dO^T: column c of both is query q0 + c.
    float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
    for (int r = 0; r < BQ / 2; ++r) st[r] = dpt[r] = 0.f;
    hopper::mbar_wait(&q_full[s], parity);
    hopper::wgmma_fence();
    hopper::fence_operands(st);
    hopper::fence_operands(dpt);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::wgmma_bf16<0, 0>(
          st, hopper::desc_sw128(k_addr + (kk >> 2) * BKV * 128 + (kk & 3) * 32, 16, 1024),
          hopper::desc_sw128(q_addr + (kk >> 2) * BQ * 128 + (kk & 3) * 32, 16, 1024));
    hopper::wgmma_commit();
    hopper::mbar_wait(&do_full[s], parity);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::wgmma_bf16<0, 0>(
          dpt, hopper::desc_sw128(v_addr + (kk >> 2) * BKV * 128 + (kk & 3) * 32, 16, 1024),
          hopper::desc_sw128(do_addr + (kk >> 2) * BQ * 128 + (kk & 3) * 32, 16, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(st);
    hopper::fence_operands(dpt);

#pragma unroll
    for (int r = 0; r < BQ / 2; ++r) {
      const int c = 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
      const bool seen = pair_seen(kr0 + 8 * ((r >> 1) & 1), q0 + c, p);
      p_and_ds<CAP, FLUSH>(st[r], dpt[r], seen, lse_s[c], d_s[c], p, cap_k);
    }

    // dV += P^T dO and dK += dS^T Q: P^T and dS^T from registers, dO and Q
    // MN-major through the transpose bit.
    uint32_t ph[BQ / 16][4], pl[BQ / 16][4], dh[BQ / 16][4], dm[BQ / 16][4], dl[BQ / 16][4];
    split_frags<BQ>(st, ph, pl);
    split3_frags<BQ>(dpt, dh, dm, dl);
    hopper::wgmma_fence();
    hopper::fence_operands(dv);
    hopper::fence_operands(dk);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint64_t ddo = hopper::desc_sw128(do_addr + kk * 2048, BQ * 128, 1024);
      hopper::wgmma_bf16_rs<1>(dv, ph[kk], ddo);
      hopper::wgmma_bf16_rs<1>(dv, pl[kk], ddo);
    }
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint64_t dqd = hopper::desc_sw128(q_addr + kk * 2048, BQ * 128, 1024);
      hopper::wgmma_bf16_rs<1>(dk, dh[kk], dqd);
      hopper::wgmma_bf16_rs<1>(dk, dm[kk], dqd);
      hopper::wgmma_bf16_rs<1>(dk, dl[kk], dqd);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(dv);
    hopper::fence_operands(dk);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      hopper::fence_operands(ph[kk]);
      hopper::fence_operands(pl[kk]);
      hopper::fence_operands(dh[kk]);
      hopper::fence_operands(dm[kk]);
      hopper::fence_operands(dl[kk]);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  float* part = part_rows(p, walk.z, kvh, b, 2 * HD);
  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + b * p.st[18] + kvh * p.st[19];
  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + b * p.st[21] + kvh * p.st[22];
  finish_walk<HD, FLUSH>(dk, p, part, 2 * HD, 0, dkg, p.st[20], p.scale, kr0, lane, walk.lo,
                         walk.hi);
  finish_walk<HD, FLUSH>(dv, p, part, 2 * HD, HD, dvg, p.st[23], 1.f, kr0, lane, walk.lo,
                         walk.hi);
}

// One CTA per (BKV keys, KV head, batch, run of the key block's steps), the
// first KV blocks (seen by the most queries) first: BKV / 64 consumer
// warpgroups and the producer warpgroup (setmaxnreg 40 / 232; the FLUSH
// instantiations 24 / 240: at hd 128 their consumers spilled 16-20 bytes
// at 232).  Split (n_split > 1) where KV heads are few (see the split
// above): the runs write f32 partials, summed by kv_reduce_kernel.
template <int HD, int BKV, int BQ, bool CAP, bool FLUSH>
__global__ void __launch_bounds__(BKV / 64 * 128 + kProducerThreads, 1)
    dkdv_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do, TcParams p) {
  using L = KvLayout<HD, HD, BKV, BQ>;
  constexpr int kWarpgroups = BKV / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = kv_full + 1;
  uint64_t* do_full = kv_full + 3;
  uint64_t* empty = kv_full + 5;

  const int kvh = blockIdx.y, b = blockIdx.z;
  const Walk walk = walk_of<BKV, BQ>(p);

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&q_full[s], 1);
      hopper::mbar_init(&do_full[s], 1 + 32);  // the copies, and each lane of the stats warp
      hopper::mbar_init(&empty[s], 4 * kWarpgroups);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 4 * kWarpgroups) {
    if constexpr (kWarpgroups == 2 && FLUSH)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    else if constexpr (kWarpgroups == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    dkdv_produce<HD, HD, BKV, BQ, FLUSH>(smem, kv_full, q_full, do_full, empty, &map_q, &map_k,
                                         &map_v, &map_do, p, walk, warp - 4 * kWarpgroups, lane,
                                         kvh, b);
  } else {
    if constexpr (kWarpgroups == 2 && FLUSH)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    else if constexpr (kWarpgroups == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    dkdv_consume<HD, BKV, BQ, CAP, FLUSH>(smem, kv_full, q_full, do_full, empty, p, warp / 4,
                                          warp, lane, walk, kvh, b);
  }
}

// -- dkdv_wg: dK and dV of 64 keys split across two warpgroups ---------------------------
//
// At hd 256 one warpgroup cannot hold dK and dV of its 64 keys (256 f32 a
// thread before S^T, dP^T and the hi/lo fragments; (192, 128): 160 plus 128).
// So both consumer warpgroups work on the same 64 keys, each holding one
// gradient: A forms S^T = K Q^T, P^T from lse, and dV += P^T dO; B forms
// dP^T = V dO^T and, once A has put P^T (times the cap's derivative when
// capped) in the exchange, dS^T = P^T (dP^T - D) and dK += dS^T Q.  The
// exchange is 64 x 64 f32 in shared memory, element r of consumer thread t at
// [r][t] (both warpgroups hold the same fragment, so B's thread t reads what
// A's thread t wrote; consecutive threads, consecutive words), passed on
// named barriers: A arrives on kBarFull once it has written, B syncs on it;
// B arrives on kBarEmpty once it has read, A syncs on it before writing the
// next step.  Each product is formed once, as in dkdv_tc, dK's with dS^T in
// three terms (split3_frags): 22 hd flops a pair, as there.

constexpr int kBarFull = 1, kBarEmpty = 2;  // named barriers; 0 is __syncthreads
constexpr int kPairThreads = 256;           // the two consumer warpgroups

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kPairThreads) : "memory");
}
// Arrives after this thread's shared-memory reads and writes so far are
// ordered before the other warpgroup's accesses past its named_sync.
__device__ __forceinline__ void named_arrive(int id) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(kPairThreads) : "memory");
}

// Warpgroup A: P^T into the exchange, dV += P^T dO.
template <int HD, int HDV, bool CAP, bool FLUSH>
__device__ __forceinline__ void dkdv_wg_p(unsigned char* smem, uint64_t* kv_full,
                                          uint64_t* q_full, uint64_t* do_full, uint64_t* empty,
                                          const TcParams& p, int warp, int lane,
                                          const Walk& walk, int kvh, int b) {
  using L = KvLayout<HD, HDV, 64, 64>;
  constexpr int BQ = 64;
  const int tid = threadIdx.x & 127;
  const int kr0 = walk.k0 + 16 * (warp % 4) + (lane >> 2);
  const uint32_t k_addr = hopper::smem_u32(smem);
  float* xs = reinterpret_cast<float*>(smem + L::kExchange);
  const float cap_k = CAP ? hopper::softcap_k(p.softcap) : 0.f;

  float dv[HDV / 2];
#pragma unroll
  for (int r = 0; r < HDV / 2; ++r) dv[r] = 0.f;

  if (walk.hi > walk.lo) hopper::mbar_wait(kv_full, 0);
  for (int i = walk.lo; i < walk.hi; ++i) {
    if constexpr (FLUSH) {
      if (i > walk.lo)
        flush_part<HDV>(dv, p, part_rows(p, walk.z, kvh, b, HD + HDV), HD + HDV, HD, kr0, lane,
                        i - 1, walk.lo, walk.hi);
    }
    const int j = i - walk.lo, s = j & 1;
    const uint32_t parity = (j >> 1) & 1;
    const int q0 = (walk.first_qb + i % walk.n_q) * BQ;
    const uint32_t q_addr = hopper::smem_u32(smem + L::kRing + s * L::kStage);
    const uint32_t do_addr = q_addr + L::kQBytes;
    const float* lse_s = reinterpret_cast<const float*>(smem + L::kStats) + s * BQ;

    float st[BQ / 2];
#pragma unroll
    for (int r = 0; r < BQ / 2; ++r) st[r] = 0.f;
    hopper::mbar_wait(&q_full[s], parity);
    hopper::wgmma_fence();
    hopper::fence_operands(st);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::wgmma_bf16<0, 0>(
          st, hopper::desc_sw128(k_addr + (kk >> 2) * 64 * 128 + (kk & 3) * 32, 16, 1024),
          hopper::desc_sw128(q_addr + (kk >> 2) * BQ * 128 + (kk & 3) * 32, 16, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(st);
    hopper::mbar_wait(&do_full[s], parity);  // the stats, and dO

    if (j > 0) named_sync(kBarEmpty);  // B has read the previous step's P^T
#pragma unroll
    for (int r = 0; r < BQ / 2; ++r) {
      const int c = 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
      float x = st[r] * p.scale;
      if constexpr (CAP) x = hopper::softcap<true>(x, p.softcap, cap_k);
      const bool seen = pair_seen(kr0 + 8 * ((r >> 1) & 1), q0 + c, p);
      const float pr = seen ? exp2f(fmaf(x, kLog2e, -lse_s[c])) : 0.f;
      float xv = pr;
      if constexpr (CAP) {
        const float u = x / p.softcap;
        xv *= 1.f - u * u;
      }
      xs[r * 128 + tid] = xv;
      st[r] = pr;
    }
    named_arrive(kBarFull);

    uint32_t ph[BQ / 16][4], pl[BQ / 16][4];
    split_frags<BQ>(st, ph, pl);
    hopper::wgmma_fence();
    hopper::fence_operands(dv);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint64_t ddo = hopper::desc_sw128(do_addr + kk * 2048, BQ * 128, 1024);
      hopper::wgmma_bf16_rs<1>(dv, ph[kk], ddo);
      hopper::wgmma_bf16_rs<1>(dv, pl[kk], ddo);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(dv);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      hopper::fence_operands(ph[kk]);
      hopper::fence_operands(pl[kk]);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* dvg = static_cast<__nv_bfloat16*>(p.dv) + b * p.st[21] + kvh * p.st[22];
  finish_walk<HDV, FLUSH>(dv, p, part_rows(p, walk.z, kvh, b, HD + HDV), HD + HDV, HD, dvg,
                          p.st[23], 1.f, kr0, lane, walk.lo, walk.hi);
}

// Warpgroup B: dP^T, dS^T from the exchange, dK += dS^T Q with dS^T in three
// bf16 terms (split3_frags: with two, dK's entries near 0 missed the check's
// 1e-4 at gemma-2b's shape with q 8 times the unit scale).
template <int HD, int HDV, bool FLUSH>
__device__ __forceinline__ void dkdv_wg_ds(unsigned char* smem, uint64_t* kv_full,
                                           uint64_t* q_full, uint64_t* do_full, uint64_t* empty,
                                           const TcParams& p, int warp, int lane,
                                           const Walk& walk, int kvh, int b) {
  using L = KvLayout<HD, HDV, 64, 64>;
  constexpr int BQ = 64;
  const int tid = threadIdx.x & 127;
  const int kr0 = walk.k0 + 16 * (warp % 4) + (lane >> 2);
  const uint32_t v_addr = hopper::smem_u32(smem) + L::kKBytes;
  const float* xs = reinterpret_cast<const float*>(smem + L::kExchange);

  float dk[HD / 2];
#pragma unroll
  for (int r = 0; r < HD / 2; ++r) dk[r] = 0.f;

  if (walk.hi > walk.lo) hopper::mbar_wait(kv_full, 0);
  for (int i = walk.lo; i < walk.hi; ++i) {
    if constexpr (FLUSH) {
      if (i > walk.lo)
        flush_part<HD>(dk, p, part_rows(p, walk.z, kvh, b, HD + HDV), HD + HDV, 0, kr0, lane,
                       i - 1, walk.lo, walk.hi);
    }
    const int j = i - walk.lo, s = j & 1;
    const uint32_t parity = (j >> 1) & 1;
    const uint32_t q_addr = hopper::smem_u32(smem + L::kRing + s * L::kStage);
    const uint32_t do_addr = q_addr + L::kQBytes;
    const float* d_s = reinterpret_cast<const float*>(smem + L::kStats) + 2 * BQ + s * BQ;

    float dpt[BQ / 2];
#pragma unroll
    for (int r = 0; r < BQ / 2; ++r) dpt[r] = 0.f;
    hopper::mbar_wait(&do_full[s], parity);
    hopper::wgmma_fence();
    hopper::fence_operands(dpt);
#pragma unroll
    for (int kk = 0; kk < HDV / 16; ++kk)
      hopper::wgmma_bf16<0, 0>(
          dpt, hopper::desc_sw128(v_addr + (kk >> 2) * 64 * 128 + (kk & 3) * 32, 16, 1024),
          hopper::desc_sw128(do_addr + (kk >> 2) * BQ * 128 + (kk & 3) * 32, 16, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(dpt);

    named_sync(kBarFull);  // A has written this step's P^T
#pragma unroll
    for (int r = 0; r < BQ / 2; ++r) {
      const int c = 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
      dpt[r] = xs[r * 128 + tid] * (dpt[r] - d_s[c]);
    }
    if (i + 1 < walk.hi) named_arrive(kBarEmpty);

    uint32_t dh[BQ / 16][4], dm[BQ / 16][4], dl[BQ / 16][4];
    split3_frags<BQ>(dpt, dh, dm, dl);
    hopper::mbar_wait(&q_full[s], parity);
    hopper::wgmma_fence();
    hopper::fence_operands(dk);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint64_t dqd = hopper::desc_sw128(q_addr + kk * 2048, BQ * 128, 1024);
      hopper::wgmma_bf16_rs<1>(dk, dh[kk], dqd);
      hopper::wgmma_bf16_rs<1>(dk, dm[kk], dqd);
      hopper::wgmma_bf16_rs<1>(dk, dl[kk], dqd);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(dk);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      hopper::fence_operands(dh[kk]);
      hopper::fence_operands(dm[kk]);
      hopper::fence_operands(dl[kk]);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* dkg = static_cast<__nv_bfloat16*>(p.dk) + b * p.st[18] + kvh * p.st[19];
  finish_walk<HD, FLUSH>(dk, p, part_rows(p, walk.z, kvh, b, HD + HDV), HD + HDV, 0, dkg,
                         p.st[20], p.scale, kr0, lane, walk.lo, walk.hi);
}

// One CTA per (64 keys, KV head, batch, run of steps): warpgroups A and B,
// then the producer warpgroup (setmaxnreg 232 / 232 / 40).
template <int HD, int HDV, bool CAP, bool FLUSH>
__global__ void __launch_bounds__(2 * 128 + kProducerThreads, 1)
    dkdv_wg_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do, TcParams p) {
  using L = KvLayout<HD, HDV, 64, 64>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = kv_full + 1;
  uint64_t* do_full = kv_full + 3;
  uint64_t* empty = kv_full + 5;

  const int kvh = blockIdx.y, b = blockIdx.z;
  const Walk walk = walk_of<64, 64>(p);

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&q_full[s], 1);
      hopper::mbar_init(&do_full[s], 1 + 32);  // the copies, and each lane of the stats warp
      hopper::mbar_init(&empty[s], 8);         // each warp of A and B
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    dkdv_produce<HD, HDV, 64, 64, false>(smem, kv_full, q_full, do_full, empty, &map_q, &map_k,
                                         &map_v, &map_do, p, walk, warp - 8, lane, kvh, b);
  } else if (warp < 4) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    dkdv_wg_p<HD, HDV, CAP, FLUSH>(smem, kv_full, q_full, do_full, empty, p, warp, lane, walk,
                                   kvh, b);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    dkdv_wg_ds<HD, HDV, FLUSH>(smem, kv_full, q_full, do_full, empty, p, warp, lane, walk, kvh,
                               b);
  }
}

// -- the split's sum ------------------------------------------------------------------

// dK = scale * (part[0] + part[1] + ...) and dV = part[0] + part[1] + ...,
// summed in that order (no atomics: the same bits every call), rounded once
// to bf16 rows of dk and dv (strides st[18..23]).  Four columns a thread.
__global__ void __launch_bounds__(256) kv_reduce_kernel(const float* part, __nv_bfloat16* dk,
                                                        __nv_bfloat16* dv, TcParams p, int hd,
                                                        int hdv, int batch) {
  const int width = hd + hdv, quads = width / 4;
  const int64_t rows = int64_t(batch) * p.kv * p.t, plane = rows * width;
  for (int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; i < rows * quads;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int64_t row = i / quads;
    const int c = int(i - row * quads) * 4;
    const float* src = part + row * width + c;
    float4 acc = *reinterpret_cast<const float4*>(src);
    for (int z = 1; z < p.n_split; ++z) {
      const float4 x = *reinterpret_cast<const float4*>(src + z * plane);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const int key = int(row % p.t);
    const int64_t bk = row / p.t;
    const int kvh = int(bk % p.kv), b = int(bk / p.kv);
    const bool is_k = c < hd;
    const int64_t st_b = is_k ? p.st[18] : p.st[21], st_h = is_k ? p.st[19] : p.st[22];
    const int64_t st_t = is_k ? p.st[20] : p.st[23];
    const float mul = is_k ? p.scale : 1.f;
    __nv_bfloat16* out = (is_k ? dk : dv) + b * st_b + kvh * st_h + key * st_t + (is_k ? c : c - hd);
    reinterpret_cast<__nv_bfloat162*>(out)[0] = __floats2bfloat162_rn(acc.x * mul, acc.y * mul);
    reinterpret_cast<__nv_bfloat162*>(out)[1] = __floats2bfloat162_rn(acc.z * mul, acc.w * mul);
  }
}

// -- host (tensor-core route) --------------------------------------------------------

// The blocks the route takes: at hd = hd_v = 64 or 128, dq_tc at (bq, bk) =
// (128, 64) and dkdv_tc at (bkv, bq) = (128, 64) or (128, 32); at (256,
// 256), dq_tc at (64, 64) and dkdv_wg at (64, 64); at (192, 128), dq_tc at
// (128, 64) and dkdv_wg at (64, 64).  f(integral_constant<HD>, <HDV>,
// <DQ_BQ>, <DQ_BK>, <KV_BK>, <KV_BQ>, bool_constant<CAP>).
template <typename F>
int tc_dispatch(int hd, int hdv, int dq_bq, int dq_bk, int kv_bk, int kv_bq, bool cap, F&& f) {
#define REMOP_BWD_TC_CALL(HD, HDV, DQ_BQ, KV_BK, KV_BQ, CAP)                                  \
  f(std::integral_constant<int, HD>{}, std::integral_constant<int, HDV>{},                   \
    std::integral_constant<int, DQ_BQ>{}, std::integral_constant<int, 64>{},                 \
    std::integral_constant<int, KV_BK>{}, std::integral_constant<int, KV_BQ>{},              \
    std::bool_constant<CAP>{})
#define REMOP_BWD_TC(HD, HDV, DQ_BQ, KV_BK, KV_BQ)                                            \
  if (hd == HD && hdv == HDV && dq_bq == DQ_BQ && kv_bk == KV_BK && kv_bq == KV_BQ)          \
    return cap ? REMOP_BWD_TC_CALL(HD, HDV, DQ_BQ, KV_BK, KV_BQ, true)                        \
               : REMOP_BWD_TC_CALL(HD, HDV, DQ_BQ, KV_BK, KV_BQ, false);
  if (dq_bk != 64) return cudaErrorInvalidValue;
  REMOP_BWD_TC(64, 64, 128, 128, 64)
  REMOP_BWD_TC(64, 64, 128, 128, 32)
  REMOP_BWD_TC(128, 128, 128, 128, 64)
  REMOP_BWD_TC(128, 128, 128, 128, 32)
  REMOP_BWD_TC(256, 256, 64, 64, 64)
  REMOP_BWD_TC(192, 128, 128, 64, 64)
#undef REMOP_BWD_TC
#undef REMOP_BWD_TC_CALL
  return cudaErrorInvalidValue;
}

// TMA byte strides of dims 1..3 of a tensor with extents dims[0..3]
// (innermost first) and element strides st[0..2] of dims 1..3 (the
// forward's tma_strides: a dim of extent 1 is never stepped).
void tma_strides(const uint64_t (&dims)[4], const long long* st, uint64_t (&out)[3]) {
  uint64_t extent = dims[0] * 2;
  for (int i = 0; i < 3; ++i) {
    out[i] = dims[i + 1] == 1 ? extent : uint64_t(st[i]) * 2;
    extent = out[i] * dims[i + 1] > extent ? out[i] * dims[i + 1] : extent;
  }
}

bool tma_aligned(const void* base, const uint64_t (&dims)[4], const long long* st) {
  if (reinterpret_cast<uintptr_t>(base) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] > 1 && (st[i] <= 0 || st[i] % 8)) return false;
  return true;
}

// A rank-4 map over (hd, position, head, batch) of a tensor whose (batch,
// head, position) element strides are strides[3 * idx .. 3 * idx + 2],
// read in boxes of `rows` positions; false if TMA cannot take it.
bool encode(CUtensorMap* map, const void* base, const long long* strides, int idx, int hd,
            int positions, int heads, int b, int rows) {
  const uint64_t dims[4] = {uint64_t(hd), uint64_t(positions), uint64_t(heads), uint64_t(b)};
  const long long st[3] = {strides[3 * idx + 2], strides[3 * idx + 1], strides[3 * idx]};
  uint64_t bst[3];
  if (!tma_aligned(base, dims, st)) return false;
  tma_strides(dims, st, bst);
  return hopper::encode_bf16_4d(map, base, dims, bst, rows);
}

template <int HD, int HDV, int DQ_BQ, int DQ_BK, int KV_BK, int KV_BQ, bool CAP, bool FLUSH>
cudaError_t tc_kernels(const void** dq_kernel, const void** kv_kernel) {
  auto dq = dq_tc_kernel<HD, HDV, DQ_BQ, DQ_BK, CAP>;
  const void* kv;
  if constexpr (KV_BK == 64)
    kv = reinterpret_cast<const void*>(dkdv_wg_kernel<HD, HDV, CAP, FLUSH>);
  else
    kv = reinterpret_cast<const void*>(dkdv_tc_kernel<HD, KV_BK, KV_BQ, CAP, FLUSH>);
  cudaError_t err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DqLayout<HD, HDV, DQ_BQ, DQ_BK>::kSmem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             KvLayout<HD, HDV, KV_BK, KV_BQ>::kSmem);
  *dq_kernel = reinterpret_cast<const void*>(dq);
  *kv_kernel = kv;
  return err;
}

// Threads of either dkdv kernel: two consumer warpgroups (dkdv_tc's one a 64
// of its 128 keys, dkdv_wg's A and B) and the producer.
constexpr int kKvThreads = 2 * 128 + kProducerThreads;

int launch_tc(const void* q, const void* k, const void* v, const void* o, const void* dout,
              void* dq, void* dk, void* dv, const void* lse, void* delta, void* part,
              const long long* strides, int b, int h, int kv, int s, int t, int hd, int hd_v,
              int dq_bq, int dq_bk, int kv_bk, int kv_bq, int n_split, float scale, int window,
              int prefix, float softcap, int flush_steps, void* stream) {
  if (b <= 0 || s <= 0) return cudaSuccess;
  if (kv <= 0 || h % kv || t <= 0 || !(s <= t || prefix >= t) || window < 0 || prefix < 0 ||
      (window > 0 && prefix > 0) || !(softcap >= 0.f) || lse == nullptr || delta == nullptr ||
      n_split < 1 || n_split > kMaxSplit || flush_steps < 0 ||
      (flush_steps & (flush_steps - 1)) ||
      ((n_split > 1 || flush_steps > 0) && part == nullptr) ||
      reinterpret_cast<uintptr_t>(part) % 16)
    return cudaErrorInvalidValue;
  // The outputs and O are read and written as bf16 pairs.
  for (int i : {3, 5, 6, 7})
    if (strides[3 * i] % 2 || strides[3 * i + 1] % 2 || strides[3 * i + 2] % 2)
      return cudaErrorInvalidValue;
  for (const void* x : {o, static_cast<const void*>(dq), static_cast<const void*>(dk),
                        static_cast<const void*>(dv)})
    if (reinterpret_cast<uintptr_t>(x) % 4) return cudaErrorInvalidValue;
  CUtensorMap dq_q{}, dq_k{}, dq_v{}, dq_do{}, kv_q{}, kv_k{}, kv_v{}, kv_do{};
  if (!encode(&dq_q, q, strides, 0, hd, s, h, b, dq_bq) ||
      !encode(&dq_k, k, strides, 1, hd, t, kv, b, dq_bk) ||
      !encode(&dq_v, v, strides, 2, hd_v, t, kv, b, dq_bk) ||
      !encode(&dq_do, dout, strides, 4, hd_v, s, h, b, dq_bq) ||
      !encode(&kv_q, q, strides, 0, hd, s, h, b, kv_bq) ||
      !encode(&kv_k, k, strides, 1, hd, t, kv, b, kv_bk) ||
      !encode(&kv_v, v, strides, 2, hd_v, t, kv, b, kv_bk) ||
      !encode(&kv_do, dout, strides, 4, hd_v, s, h, b, kv_bq))
    return cudaErrorNotSupported;
  TcParams p{o, dout, dq, dk, dv, static_cast<const float*>(lse), static_cast<float*>(delta),
             static_cast<float*>(part), {}, h, kv, s, t, scale, window, prefix, softcap, n_split,
             flush_steps};
  for (int i = 0; i < 24; ++i) p.st[i] = strides[i];
  auto st = static_cast<cudaStream_t>(stream);
  return tc_dispatch(hd, hd_v, dq_bq, dq_bk, kv_bk, kv_bq, softcap > 0.f,
                     [&](auto hd_c, auto hdv_c, auto dq_bq_c, auto dq_bk_c, auto kv_bk_c,
                         auto kv_bq_c, auto cap_c) -> int {
    constexpr int HD = decltype(hd_c)::value, HDV = decltype(hdv_c)::value;
    constexpr int DQ_BQ = decltype(dq_bq_c)::value, DQ_BK = decltype(dq_bk_c)::value;
    constexpr int KV_BK = decltype(kv_bk_c)::value, KV_BQ = decltype(kv_bq_c)::value;
    constexpr bool CAP = decltype(cap_c)::value;
    auto run = [&](auto flush_c) -> int {
      constexpr bool FLUSH = decltype(flush_c)::value;
      const void *dq_kernel, *kv_kernel;
      cudaError_t err = tc_kernels<HD, HDV, DQ_BQ, DQ_BK, KV_BK, KV_BQ, CAP, FLUSH>(
          &dq_kernel, &kv_kernel);
      if (err != cudaSuccess) return err;
      dq_tc_kernel<HD, HDV, DQ_BQ, DQ_BK, CAP>
          <<<dim3((s + DQ_BQ - 1) / DQ_BQ, h, b), DQ_BQ / 64 * 128 + kProducerThreads,
             DqLayout<HD, HDV, DQ_BQ, DQ_BK>::kSmem, st>>>(dq_q, dq_k, dq_v, dq_do, p);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      // After dq_tc on the same stream: it wrote D.
      const dim3 kv_grid((t + KV_BK - 1) / KV_BK * n_split, kv, b);
      const int kv_smem = KvLayout<HD, HDV, KV_BK, KV_BQ>::kSmem;
      if constexpr (KV_BK == 64)
        dkdv_wg_kernel<HD, HDV, CAP, FLUSH><<<kv_grid, kKvThreads, kv_smem, st>>>(
            kv_q, kv_k, kv_v, kv_do, p);
      else
        dkdv_tc_kernel<HD, KV_BK, KV_BQ, CAP, FLUSH>
            <<<kv_grid, kKvThreads, kv_smem, st>>>(kv_q, kv_k, kv_v, kv_do, p);
      return cudaGetLastError();
    };
    return flush_steps > 0 ? run(std::true_type{}) : run(std::false_type{});
  });
}

// Sums the split's partials (kv_reduce_kernel) into dk and dv.
int launch_kv_reduce(const void* part, void* dk, void* dv, const long long* strides, int b,
                     int kv, int t, int hd, int hd_v, int n_split, float scale, void* stream) {
  if (b <= 0 || t <= 0) return cudaSuccess;
  if (kv <= 0 || n_split < 1 || n_split > kMaxSplit || part == nullptr || (hd + hd_v) % 4 ||
      reinterpret_cast<uintptr_t>(part) % 16 || reinterpret_cast<uintptr_t>(dk) % 4 ||
      reinterpret_cast<uintptr_t>(dv) % 4)
    return cudaErrorInvalidValue;
  for (int i = 18; i < 24; ++i)
    if (strides[i] % 2) return cudaErrorInvalidValue;
  TcParams p{};
  for (int i = 0; i < 24; ++i) p.st[i] = strides[i];
  p.kv = kv;
  p.t = t;
  p.scale = scale;
  p.n_split = n_split;
  const int64_t quads = int64_t(b) * kv * t * (hd + hd_v) / 4;
  const int blocks = int(quads / 256 + 1 < 132 * 8 ? quads / 256 + 1 : 132 * 8);
  kv_reduce_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), p, hd, hd_v, b);
  return cudaGetLastError();
}

// out[10]: for dq_tc then dkdv (dkdv_tc or dkdv_wg; flush != 0: its FLUSH
// instantiation), CTAs resident on one SM, registers a thread, local
// (spilled) bytes a thread, dynamic shared memory, threads.
int attributes_tc(int hd, int hd_v, int dq_bq, int dq_bk, int kv_bk, int kv_bq, int cap,
                  int flush, int* out) {
  return tc_dispatch(hd, hd_v, dq_bq, dq_bk, kv_bk, kv_bq, cap != 0,
                     [&](auto hd_c, auto hdv_c, auto dq_bq_c, auto dq_bk_c, auto kv_bk_c,
                         auto kv_bq_c, auto cap_c) -> int {
    constexpr int HD = decltype(hd_c)::value, HDV = decltype(hdv_c)::value;
    constexpr int DQ_BQ = decltype(dq_bq_c)::value, DQ_BK = decltype(dq_bk_c)::value;
    constexpr int KV_BK = decltype(kv_bk_c)::value, KV_BQ = decltype(kv_bq_c)::value;
    constexpr bool CAP = decltype(cap_c)::value;
    const void* kernels[2];
    cudaError_t err =
        flush ? tc_kernels<HD, HDV, DQ_BQ, DQ_BK, KV_BK, KV_BQ, CAP, true>(&kernels[0],
                                                                           &kernels[1])
              : tc_kernels<HD, HDV, DQ_BQ, DQ_BK, KV_BK, KV_BQ, CAP, false>(&kernels[0],
                                                                            &kernels[1]);
    if (err != cudaSuccess) return err;
    const int threads[2] = {DQ_BQ / 64 * 128 + kProducerThreads, kKvThreads};
    const int smem[2] = {DqLayout<HD, HDV, DQ_BQ, DQ_BK>::kSmem,
                         KvLayout<HD, HDV, KV_BK, KV_BQ>::kSmem};
    for (int i = 0; i < 2; ++i) {
      cudaFuncAttributes a;
      err = cudaFuncGetAttributes(&a, kernels[i]);
      if (err != cudaSuccess) return err;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[5 * i], kernels[i], threads[i],
                                                          smem[i]);
      if (err != cudaSuccess) return err;
      out[5 * i + 1] = a.numRegs;
      out[5 * i + 2] = int(a.localSizeBytes);
      out[5 * i + 3] = smem[i];
      out[5 * i + 4] = threads[i];
    }
    return cudaSuccess;
  });
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

// The tensor-core route: bf16 at (hd, hd_v) = (64, 64), (128, 128), (256,
// 256) or (192, 128), TMA-aligned q, k, v and do; lse: the forward's f32 [B,
// H, S] log-sum-exp (contiguous); delta: f32 [B, H, S] scratch.  Blocks (see
// tc_dispatch): dq_tc's (dq_bq, dq_bk), dkdv's (kv_bk, kv_bq).  kv_split:
// dkdv's CTAs a key block (1 .. 16); above 1, part is f32 scratch of
// [kv_split, B, KV, T, hd + hd_v] that dkdv fills instead of dk and dv, and
// the caller sums it with remop_flash_attention_bwd_kv_reduce.  flush_steps:
// 0, or the query blocks of each dkdv accumulator's runs between flushes
// into the f32 partial (then part is that scratch at kv_split 1 too, and
// dkdv writes dk and dv from it there).  Two launches.
int remop_flash_attention_bwd_tc(const void* q, const void* k, const void* v, const void* o,
                                 const void* dout, void* dq, void* dk, void* dv, const void* lse,
                                 void* delta, void* part, const long long* strides, int b, int h,
                                 int kv, int s, int t, int hd, int hd_v, int dq_bq, int dq_bk,
                                 int kv_bk, int kv_bq, int kv_split, float scale, int window,
                                 int prefix, float softcap, int flush_steps, void* stream) {
  return launch_tc(q, k, v, o, dout, dq, dk, dv, lse, delta, part, strides, b, h, kv, s, t, hd,
                   hd_v, dq_bq, dq_bk, kv_bk, kv_bq, kv_split, scale, window, prefix, softcap,
                   flush_steps, stream);
}

// dk = scale * (part[0] + part[1] + ... + part[kv_split - 1]) and dv the same
// sum unscaled, in that order (part: the tc entry's scratch, its dK columns
// first); strides: the tc entry's 24 (dk's at 18..20, dv's at 21..23).
int remop_flash_attention_bwd_kv_reduce(const void* part, void* dk, void* dv,
                                        const long long* strides, int b, int kv, int t, int hd,
                                        int hd_v, int kv_split, float scale, void* stream) {
  return launch_kv_reduce(part, dk, dv, strides, b, kv, t, hd, hd_v, kv_split, scale, stream);
}

// Occupancy, registers, local bytes, shared memory and threads of dq_tc
// and dkdv at these blocks (cap != 0: the capped instantiations; flush !=
// 0: dkdv's flushing one), into out[10].
int remop_flash_attention_bwd_tc_attributes(int hd, int hd_v, int dq_bq, int dq_bk, int kv_bk,
                                            int kv_bq, int cap, int flush, int* out) {
  return attributes_tc(hd, hd_v, dq_bq, dq_bk, kv_bk, kv_bq, cap, flush, out);
}

const char* remop_flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
