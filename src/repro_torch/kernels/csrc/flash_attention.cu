// Causal GQA flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py:72
// (flash_attention): q [B, H, S, hd], k [B, KV, T, hd], v [B, KV, T, hd_v],
// query head h reads KV head h / (H / KV), causal with the query positions
// offset by T - S, an online softmax in f32 of the scores times `scale`,
// fully masked KV blocks skipped, output [B, H, S, hd_v] in q's dtype.
// With window = W > 0 (local attention, which the TPU kernel does not
// compute) a query at position q sees only the keys q - W + 1 .. q.  With
// prefix = P > 0 it sees every key below P beside the causal ones (k < P or
// k <= q): the prefix-LM mask over an image prefix (P its length), and with
// P >= T every key (a bidirectional encoder, or cross-attention, where S may
// exceed T).  A window and a prefix are never given together.
// With softcap = c > 0 each scaled score is capped before the mask, s =
// c tanh(s / c) (repro's attention logit softcap,
// src/repro/models/attention.py:72-73, which the TPU kernel does not
// compute).  The cap is a template argument of both routes (CAP), so a launch
// without one runs the code it ran before, bit for bit and at its time.  bf16
// calls cap through hopper::softcap's exp2f form (within about 5e-7 of the
// cap), f32 calls through tanhf; neither uses tanh.approx, whose 2^-11
// relative error times a cap of 50 would move a score by 0.025.
// hd_v = hd, or (hd, hd_v) = (192, 128): MLA's prefill, whose q and k are
// 128 nope and 64 rope columns and whose values are 128 wide.
// Any S <= T (any S when P >= T) works without padding (rows past S and
// keys past T are masked), and every tensor is passed with its own strides
// (the last dimension contiguous), so the model's [B, S, H, hd] activations
// are read and written in place.  Both routes launch one CTA per (q block, head, batch),
// the heaviest (last) q blocks first to shorten the tail, and walk the KV
// blocks j0 .. the last one a row of the block can see (the TPU kernel's
// `q_base + bq - 1 >= k_base` skip), j0 = 0 without a window and else the
// first block the block's first row can see, so the work follows the
// visible pairs; with a prefix the walk also runs to the block that holds
// key min(P, T) - 1.  A later row whose window starts past block j0 sees only
// masked scores there: its m stays kNegInf (finite), each p is exp(0) = 1,
// and the correction exp(kNegInf - m) at its first live key, which the
// diagonal block always holds, wipes them exactly.  What bounds both on this
// card, at the model's widths (hd 128 or 256, S in the thousands): the
// operations, about 2 S T hd H flops under the causal mask (2 S min(T, W) hd
// H under a window), against a few bytes per key.
//
// Tensor-core route (flash_attention_kernel_tc): bf16 at hd 64, 128 or 256
// (hd_v = hd) or at (192, 128), with TMA-aligned bases and strides (16
// bytes).  Both products run on
// wgmma, bf16 in, f32 accumulate.  bq = 64 or 128: one consumer warpgroup
// per 64 query rows, plus one producer warpgroup, of which one thread
// issues the copies (a whole warpgroup, so that at bq = 128 it can hand its
// registers to the consumers: ptxas budgets 384 threads at 168 registers,
// and O, S and P of hd 256 need about 200).  The producer loads Q once and
// K and V in a ring of two stages with TMA (rank-4 maps over (hd, position,
// head, batch) with each tensor's own strides, boxes of [bk positions, 64 of
// hd] in the 128-byte swizzle, positions past S or T zero-filled; q and k
// of hd 192 are three such 64-column slabs, v of 128 two), so block
// j + 1's copies are in flight while block j's products run; completion is
// counted on mbarriers (K and V apart, so Q K^T starts before V lands), and
// a stage is refilled once every consumer warp has released it.  A
// warpgroup forms S = Q K^T (M 64, N bk, K hd; both operands K-major) into
// registers (hd / 16 k-steps of 16), masks it by position and runs the
// online softmax on the accumulator fragment (row max over the 4 lanes that share a row; the row
// sum kept per lane and reduced once at the end), rescales O by `corr`,
// then O += P V (M 64, N hd_v, K bk; V MN-major through the transpose bit)
// with P taken from registers: the S fragment is wgmma's A fragment, so P
// never goes through shared memory.  P is kept at f32 precision, as the
// TPU kernel keeps it: P = P_hi + P_lo with P_hi = bf16(P), P_lo = bf16(P -
// P_hi) (about 16 significant bits), two products into the same O, 1.5x
// the tensor work of a bf16 P.  SPLIT = false (a probe off the main path)
// rounds P to bf16 once.  Given an f32 [B, H, S] buffer `lse` (the entry
// remop_flash_attention_tc_lse, at every width of the route) the epilogue also
// writes each row's log-sum-exp, m + log(l), in the scaled and capped score
// domain P was formed in: the backward's tc route reads it instead of
// recomputing Q K^T for it.  The write is a template argument (LSE), as the
// cap is: a runtime pointer tested in the epilogue cost the calls without
// one 1-3% of their device time (parent/change A/B on the card).
//
// CUDA-core route (flash_attention_kernel): every f32 call (f32 on a tensor
// core would be TF32, which does not compute what the TPU kernel computes
// in f32) and bf16 at hd 16 or 32, or with strides TMA cannot take.  It
// stages its bq <= 64 query rows and each KV block in shared memory (rows
// padded by one 32-bit word, so the 16 rows a half-warp reads fall in 16
// banks), forms the bq x bk scores with f32 FMAs in registers (256 threads
// as 16 x 16, thread (ty, tx) owning rows ty + 16 i and head columns tx +
// 16 j), updates (m, l, acc) exactly as the TPU kernel does, puts P in
// shared memory, stages V into the buffer K used, and adds P V.  Its widths
// are multiples of 16 (each thread holds hd / 16 columns); reduced MLA's
// q/k width 24 over values of 16 runs the (32, 16) instantiation on q and k
// the wrapper zero-pads to 32 (the zero columns add exact zeros to every
// score; the wrapper passes the scale of 24).

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlock = 64;  // largest bq and bk: 16 threads x 4 rows
constexpr int kPer = kMaxBlock / 16;
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // Element strides: q, k, v, o, each (batch, head, position).
  int64_t st[12];
  int h, kv, s, t, bq, bk;
  float scale;
  int window;  // 0: causal only
  int prefix;  // keys below it are seen by every query; 0: causal only
  float softcap;  // 0: no cap
};

// The keys a query at position qpos sees, as one range [lo, hi]: hi the
// last key below T that lies at or before qpos or inside the prefix, lo the
// window's first key (none without a window).  Computed once a row, so a
// score is masked by one compare, two with a window (keys past T, which the
// tiles hold as zeros, included: with a prefix a row may see keys past its
// position).
struct KeyRange {
  int lo, hi;
};
__device__ __forceinline__ KeyRange visible(int qpos, int t, int prefix, int window) {
  return {window ? qpos - window + 1 : -(1 << 30), min(max(qpos, prefix - 1), t - 1)};
}

// The KV blocks of bk positions a query block whose largest position is
// q_last walks: up to the last one a row of it sees, at least the blocks of
// keys below min(prefix, T), never past T.
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

// Two neighbouring elements (d even) of a staged row, as floats.
__device__ __forceinline__ float2 ld2(const float* p) { return make_float2(p[0], p[1]); }
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Row stride of a staged tile, in elements: hd plus one 32-bit word.
template <typename T, int HD>
__host__ __device__ constexpr int ld() { return HD + int(4 / sizeof(T)); }

// Reductions over the 16 threads that share a row (one half of a warp).
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
__device__ __forceinline__ void stage(T* dst, const T* src, int64_t ps, int r0,
                                      int n, int limit) {
  for (int i = threadIdx.x; i < n * W; i += kThreads) {
    const int r = i / W, d = i - r * W;
    const int row = r0 + r;
    dst[r * LD + d] = row < limit ? src[int64_t(row) * ps + d] : from_f32<T>(0.f);
  }
}

// HD: the width of q and k; HDV: of v and the output (V is staged into
// the rows K used).
template <typename T, int HD, int HDV, bool CAP>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Params p) {
  constexpr int LD = ld<T, HD>();
  constexpr int CD = HDV / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);                            // [bq][LD]
  T* kv_s = q_s + p.bq * LD;                                      // [bk][LD]
  float* p_s = reinterpret_cast<float*>(kv_s + p.bk * LD);        // [bq][bk + 1]
  const int pld = p.bk + 1;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest q blocks first
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (p.h / p.kv);
  const int offset = p.t - p.s;
  const int q0 = qb * p.bq;

  const T* qg = static_cast<const T*>(p.q) + b * p.st[0] + head * p.st[1];
  const T* kg = static_cast<const T*>(p.k) + b * p.st[3] + kvh * p.st[4];
  const T* vg = static_cast<const T*>(p.v) + b * p.st[6] + kvh * p.st[7];
  T* og = static_cast<T*>(p.o) + b * p.st[9] + head * p.st[10];

  stage<T, HD, LD>(q_s, qg, p.st[2], q0, p.bq, p.s);

  // Rows and columns past bq / bk read a valid row (clamped) and are
  // discarded, which keeps the inner loops free of branches.
  int rq[kPer], ck[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    rq[i] = min(ty + 16 * i, p.bq - 1);
    ck[i] = min(tx + 16 * i, p.bk - 1);
  }

  float acc[kPer][CD];
  float m[kPer], l[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + p.bq, p.s) - 1 + offset;  // largest q position here
  const int n_kv = kv_blocks(q_last, p.t, p.bk, p.prefix);
  const int j0 = p.window ? max(0, q0 + offset - p.window + 1) / p.bk : 0;
  const float cap_k = CAP ? hopper::softcap_k(p.softcap) : 0.f;

  for (int j = j0; j < n_kv; ++j) {
    const int k0 = j * p.bk;
    __syncthreads();  // q staged; the previous block's V no longer read
    stage<T, HD, LD>(kv_s, kg, p.st[5], k0, p.bk, p.t);
    __syncthreads();

    float sc[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int c = 0; c < kPer; ++c) sc[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 2) {
      float2 qv[kPer], kv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        qv[i] = ld2(q_s + rq[i] * LD + d);
        kv[i] = ld2(kv_s + ck[i] * LD + d);
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < kPer; ++c)
          sc[i][c] = fmaf(qv[i].y, kv[c].y, fmaf(qv[i].x, kv[c].x, sc[i][c]));
    }

    // Columns past bk and the keys a row does not see (visible()), then the
    // online softmax update of the TPU kernel.
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const KeyRange seen = visible(q0 + ty + 16 * i + offset, p.t, p.prefix, p.window);
      float rmax = kNegInf;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int col = tx + 16 * c, key = k0 + col;
        float x = sc[i][c] * p.scale;
        if constexpr (CAP) x = hopper::softcap<sizeof(T) == 2>(x, p.softcap, cap_k);
        if (col >= p.bk || key > seen.hi || (p.window && key < seen.lo)) x = kNegInf;
        sc[i][c] = x;
        rmax = fmaxf(rmax, x);
      }
      const float m_new = fmaxf(m[i], max16(rmax));
      float rsum = 0.f;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        sc[i][c] = expf(sc[i][c] - m_new);
        rsum += sc[i][c];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum16(rsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
      if (ty + 16 * i < p.bq) {
#pragma unroll
        for (int c = 0; c < kPer; ++c)
          if (tx + 16 * c < p.bk) p_s[(ty + 16 * i) * pld + tx + 16 * c] = sc[i][c];
      }
    }
    __syncthreads();  // K no longer read; P visible
    stage<T, HDV, LD>(kv_s, vg, p.st[8], k0, p.bk, p.t);
    __syncthreads();

    for (int c = 0; c < p.bk; ++c) {
      float pv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) pv[i] = p_s[rq[i] * pld + c];
      const T* vrow = kv_s + c * LD + tx;
#pragma unroll
      for (int e = 0; e < CD; ++e) {
        const float vv = to_f32(vrow[16 * e]);
#pragma unroll
        for (int i = 0; i < kPer; ++i) acc[i][e] = fmaf(pv[i], vv, acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    if (r < p.bq && row < p.s) {
      const float den = fmaxf(l[i], 1e-30f);
      T* orow = og + int64_t(row) * p.st[11] + tx;
#pragma unroll
      for (int e = 0; e < CD; ++e) orow[16 * e] = from_f32<T>(acc[i][e] / den);
    }
  }
}

template <typename T, int HD, int HDV>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = size_t(p.bq + p.bk) * ld<T, HD>() * sizeof(T) +
                      size_t(p.bq) * (p.bk + 1) * sizeof(float);
  auto kernel = p.softcap > 0.f ? flash_attention_kernel<T, HD, HDV, true>
                                : flash_attention_kernel<T, HD, HDV, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + p.bq - 1) / p.bq, p.h, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// What both routes take: KV heads dividing the query heads, S <= T unless
// every key is seen (prefix >= T, T > 0), a window or a prefix, not both, a
// cap of 0 or above.
bool shape_ok(int h, int kv, int s, int t, int window, int prefix, float softcap) {
  return kv > 0 && h % kv == 0 && t > 0 && (s <= t || prefix >= t) && window >= 0 &&
         prefix >= 0 && !(window > 0 && prefix > 0) && softcap >= 0.f;
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const long long* strides, int b, int h, int kv, int s, int t,
             int hd, int bq, int bk, float scale, int hd_v, int window, int prefix,
             float softcap, void* stream) {
  if (b <= 0 || s <= 0) return cudaSuccess;
  if (!shape_ok(h, kv, s, t, window, prefix, softcap) || bq < 1 || bq > kMaxBlock || bk < 1 ||
      bk > kMaxBlock)
    return cudaErrorInvalidValue;
  Params p{q, k, v, o, {}, h, kv, s, t, bq, bk, scale, window, prefix, softcap};
  for (int i = 0; i < 12; ++i) p.st[i] = strides[i];
  auto st = static_cast<cudaStream_t>(stream);
  if (hd_v != hd) {
    if (hd == 192 && hd_v == 128) return launch<T, 192, 128>(p, b, st);
    if (hd == 32 && hd_v == 16) return launch<T, 32, 16>(p, b, st);
    return cudaErrorInvalidValue;
  }
  switch (hd) {
    case 16: return launch<T, 16, 16>(p, b, st);
    case 32: return launch<T, 32, 32>(p, b, st);
    case 64: return launch<T, 64, 64>(p, b, st);
    case 128: return launch<T, 128, 128>(p, b, st);
    case 256: return launch<T, 256, 256>(p, b, st);
    default: return cudaErrorInvalidValue;
  }
}

// ----------------------------------------------------------------------------
// Tensor-core route
// ----------------------------------------------------------------------------

constexpr int kProducerThreads = 128;  // one warpgroup, after the consumers
constexpr int kMaxSmem = 232448;      // shared memory one CTA can use (227 KB)
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one CTA (byte offsets from a 1024-byte-aligned base):
// Q as hd / 64 slabs of bq rows x 128 bytes; then two stages, each K as hd /
// 64 and V as hd_v / 64 slabs of bk rows x 128 bytes; then the mbarriers
// q_full, k_full[2], v_full[2], empty[2]; 1024 bytes of slack to align the
// base.  Every slab starts on 1024 bytes, as the swizzle wants.
__host__ __device__ constexpr int tc_smem(int hd, int hdv, int bq, int bk) {
  return 1024 + bq * hd * 2 + 2 * bk * (hd + hdv) * 2 + 7 * 8;
}

template <int HD, int HDV, int BQ, int BK>
struct TcLayout {
  static constexpr int kQBytes = BQ * HD * 2;
  static constexpr int kKBytes = BK * HD * 2;   // one K block
  static constexpr int kVBytes = BK * HDV * 2;  // one V block
  static constexpr int kStage = kKBytes + kVBytes;
  static constexpr int kBars = kQBytes + 2 * kStage;
  static constexpr int kSmem = tc_smem(HD, HDV, BQ, BK);
};

struct TcParams {
  void* o;
  int64_t ost[3];  // o's element strides (batch, head, position)
  int h, kv, s, t;
  float scale;
  int window;  // 0: causal only
  int prefix;  // 0: causal only
  float softcap;  // 0: no cap
};

// One consumer warpgroup w of the CTA: query rows [q0 + 64w, q0 + 64w +
// 64); this thread holds rows r0 and r0 + 8 of the accumulator fragments.
// KV blocks j0 .. n_kv - 1; the i-th of them (i = j - j0) sits in ring stage
// i % 2 at mbarrier parity (i / 2) % 2, as the producer counts it.  LSE:
// also write each row's log-sum-exp to lse [B, H, S].
template <int HD, int HDV, int BQ, int BK, bool SPLIT, bool CAP, bool LSE>
__device__ __forceinline__ void consume(unsigned char* smem, uint64_t* q_full, uint64_t* k_full,
                                        uint64_t* v_full, uint64_t* empty, const TcParams& p,
                                        int w, int warp, int lane, int q0, int head, int b,
                                        int offset, int j0, int n_kv, float* lse) {
  using L = TcLayout<HD, HDV, BQ, BK>;
  const int r0 = q0 + 64 * w + 16 * (warp % 4) + (lane >> 2);
  const KeyRange seen0 = visible(r0 + offset, p.t, p.prefix, p.window);
  const KeyRange seen1 = visible(r0 + 8 + offset, p.t, p.prefix, p.window);
  const uint32_t q_addr = hopper::smem_u32(smem) + w * 64 * 128;

  float o[HDV / 2];
#pragma unroll
  for (int r = 0; r < HDV / 2; ++r) o[r] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: this lane's share
  const float cap_k = CAP ? hopper::softcap_k(p.softcap) : 0.f;

  hopper::mbar_wait(q_full, 0);
  for (int j = j0; j < n_kv; ++j) {
    const int s = (j - j0) & 1;
    const uint32_t parity = ((j - j0) >> 1) & 1;
    const uint32_t k_addr = hopper::smem_u32(smem + L::kQBytes + s * L::kStage);
    const uint32_t v_addr = k_addr + L::kKBytes;

    // S = Q K^T: column c of the fragment is key j * BK + c.
    float sc[BK / 2];
#pragma unroll
    for (int r = 0; r < BK / 2; ++r) sc[r] = 0.f;
    hopper::mbar_wait(&k_full[s], parity);
    hopper::wgmma_fence();
    hopper::fence_operands(sc);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint64_t da =
          hopper::desc_sw128(q_addr + (kk >> 2) * BQ * 128 + (kk & 3) * 32, 16, 1024);
      const uint64_t db =
          hopper::desc_sw128(k_addr + (kk >> 2) * BK * 128 + (kk & 3) * 32, 16, 1024);
      hopper::wgmma_bf16<0, 0>(sc, da, db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(sc);

    // The keys a row does not see (visible(); TMA fills rows past T with
    // zeros, which would score 0), then the online softmax update of the TPU
    // kernel.
    const int k0 = j * BK;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int r = 0; r < BK / 2; ++r) {
      const int col = k0 + 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
      const bool lower = (r >> 1) & 1;  // row r0 + 8
      const KeyRange& seen = lower ? seen1 : seen0;
      float x = sc[r] * p.scale;
      if constexpr (CAP) x = hopper::softcap<true>(x, p.softcap, cap_k);
      if (col > seen.hi || (p.window && col < seen.lo)) x = kNegInf;
      sc[r] = x;
      if (lower) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f((m0 - mn0) * kLog2e), c1 = exp2f((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int r = 0; r < BK / 2; ++r) {
      const bool lower = (r >> 1) & 1;
      sc[r] = exp2f((sc[r] - (lower ? mn1 : mn0)) * kLog2e);
      if (lower) s1 += sc[r]; else s0 += sc[r];
    }
    l0 = l0 * c0 + s0;
    l1 = l1 * c1 + s1;
#pragma unroll
    for (int r = 0; r < HDV / 2; ++r) o[r] *= ((r >> 1) & 1) ? c1 : c0;

    // P as wgmma A fragments: columns [16kk, 16kk + 16) are sc[8kk .. 8kk + 7].
    uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[8 * kk + 2 * e], y = sc[8 * kk + 2 * e + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
        ph[kk][e] = *reinterpret_cast<const uint32_t*>(&hi);
        if constexpr (SPLIT) {
          const float2 back = __bfloat1622float2(hi);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(x - back.x, y - back.y);
          pl[kk][e] = *reinterpret_cast<const uint32_t*>(&lo);
        }
      }
    }

    // O += P V.
    hopper::mbar_wait(&v_full[s], parity);
    hopper::wgmma_fence();
    hopper::fence_operands(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = hopper::desc_sw128(v_addr + kk * 2048, BK * 128, 1024);
      hopper::wgmma_bf16_rs<1>(o, ph[kk], dv);
      if constexpr (SPLIT) hopper::wgmma_bf16_rs<1>(o, pl[kk], dv);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operands(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      hopper::fence_operands(ph[kk]);
      if constexpr (SPLIT) hopper::fence_operands(pl[kk]);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);  // this warp is done with the stage
  }

#pragma unroll
  for (int d = 1; d <= 2; d <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, d);
    l1 += __shfl_xor_sync(0xffffffffu, l1, d);
  }
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  if constexpr (LSE) {
    if ((lane & 3) == 0) {
      float* lg = lse + (int64_t(b) * p.h + head) * p.s;
      if (r0 < p.s) lg[r0] = m0 + logf(den0);
      if (r0 + 8 < p.s) lg[r0 + 8] = m1 + logf(den1);
    }
  }
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.ost[0] + head * p.ost[1];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= p.s) continue;
    const float den = half ? den1 : den0;
    __nv_bfloat16* orow = og + int64_t(row) * p.ost[2] + 2 * (lane & 3);
#pragma unroll
    for (int c = 0; c < HDV / 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
          __floats2bfloat162_rn(o[4 * c + 2 * half] / den, o[4 * c + 2 * half + 1] / den);
  }
}

// With two consumer warpgroups (384 threads) ptxas gives a thread at most
// 168 registers at entry; the producer warpgroup then hands its registers
// to the consumers (setmaxnreg: 40 and 232, 64,512 of the SM's 65,536).
template <int HD, int HDV, int BQ, int BK, bool SPLIT, bool CAP, bool LSE>
__global__ void __launch_bounds__(BQ / 64 * 128 + kProducerThreads, 1)
    flash_attention_kernel_tc(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v, TcParams p,
                              float* lse) {
  using L = TcLayout<HD, HDV, BQ, BK>;
  constexpr int kWarpgroups = BQ / 64;
  constexpr int kSlabs = HD / 64;    // of Q and K
  constexpr int kVSlabs = HDV / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = q_full + 3;
  uint64_t* empty = q_full + 5;

  const int qb = gridDim.x - 1 - blockIdx.x;  // heaviest q blocks first
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (p.h / p.kv);
  const int offset = p.t - p.s;
  const int q0 = qb * BQ;
  const int q_last = min(q0 + BQ, p.s) - 1 + offset;  // largest q position here
  const int n_kv = kv_blocks(q_last, p.t, BK, p.prefix);
  const int j0 = p.window ? max(0, q0 + offset - p.window + 1) / BK : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 4 * kWarpgroups);  // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= 4 * kWarpgroups) {
    // -- producer: Q once, then block j's K and V into stage (j - j0) % 2
    // once the stage's last use (block j - 2) is released --
    if constexpr (kWarpgroups == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 4 * kWarpgroups && lane == 0) {
      hopper::mbar_arrive_expect_tx(q_full, L::kQBytes);
      for (int i = 0; i < kSlabs; ++i)
        hopper::tma_load_4d(smem + i * BQ * 128, &map_q, q_full, 64 * i, q0, head, b);
      for (int j = j0; j < n_kv; ++j) {
        const int s = (j - j0) & 1;
        hopper::mbar_wait(&empty[s], (((j - j0) >> 1) & 1) ^ 1);
        unsigned char* ks = smem + L::kQBytes + s * L::kStage;
        unsigned char* vs = ks + L::kKBytes;
        hopper::mbar_arrive_expect_tx(&k_full[s], L::kKBytes);
        for (int i = 0; i < kSlabs; ++i)
          hopper::tma_load_4d(ks + i * BK * 128, &map_k, &k_full[s], 64 * i, j * BK, kvh, b);
        hopper::mbar_arrive_expect_tx(&v_full[s], L::kVBytes);
        for (int i = 0; i < kVSlabs; ++i)
          hopper::tma_load_4d(vs + i * BK * 128, &map_v, &v_full[s], 64 * i, j * BK, kvh, b);
      }
    }
  } else {
    // -- consumers --
    if constexpr (kWarpgroups == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume<HD, HDV, BQ, BK, SPLIT, CAP, LSE>(smem, q_full, k_full, v_full, empty, p, warp / 4,
                                              warp, lane, q0, head, b, offset, j0, n_kv, lse);
  }
}

// The blocks the tensor-core route takes: bq, bk in {64, 128}, (hd, hd_v)
// in {(64, 64), (128, 128), (256, 256), (192, 128)}, within one CTA's
// shared memory (which leaves hd 256 at bk 64).
bool tc_ok(int hd, int hdv, int bq, int bk) {
  const bool pair = (hd == hdv && (hd == 64 || hd == 128 || hd == 256)) ||
                    (hd == 192 && hdv == 128);
  return pair && (bq == 64 || bq == 128) && (bk == 64 || bk == 128) &&
         tc_smem(hd, hdv, bq, bk) <= kMaxSmem;
}

// f(integral_constant<HD>, <HDV>, <BQ>, <BK>, bool_constant<SPLIT>,
// bool_constant<CAP>, bool_constant<LSE>) for a tc_ok shape.  A cap and an
// lse come with the split P only (split = 0 is a probe off the main path);
// an lse at every tc_ok shape, the widths the backward's tc route takes.
template <typename F>
int tc_dispatch(int hd, int hdv, int bq, int bk, int split, bool cap, bool lse, F&& f) {
#define REMOP_FLASH_TC_CALL(HD, HDV, BQ, BK, SPLIT, CAP, LSE)                                \
  f(std::integral_constant<int, HD>{}, std::integral_constant<int, HDV>{},                   \
    std::integral_constant<int, BQ>{}, std::integral_constant<int, BK>{},                    \
    std::bool_constant<SPLIT>{}, std::bool_constant<CAP>{}, std::bool_constant<LSE>{})
#define REMOP_FLASH_TC_WITH_LSE(HD, HDV, BQ, BK)                                             \
  if (hd == HD && hdv == HDV && bq == BQ && bk == BK) {                                      \
    if (lse) {                                                                               \
      if (!split) return cudaErrorInvalidValue;                                              \
      return cap ? REMOP_FLASH_TC_CALL(HD, HDV, BQ, BK, true, true, true)                    \
                 : REMOP_FLASH_TC_CALL(HD, HDV, BQ, BK, true, false, true);                  \
    }                                                                                        \
    if (cap)                                                                                 \
      return split ? REMOP_FLASH_TC_CALL(HD, HDV, BQ, BK, true, true, false)                 \
                   : cudaErrorInvalidValue;                                                  \
    return split ? REMOP_FLASH_TC_CALL(HD, HDV, BQ, BK, true, false, false)                  \
                 : REMOP_FLASH_TC_CALL(HD, HDV, BQ, BK, false, false, false);                \
  }
  REMOP_FLASH_TC_WITH_LSE(64, 64, 64, 64)
  REMOP_FLASH_TC_WITH_LSE(64, 64, 64, 128)
  REMOP_FLASH_TC_WITH_LSE(64, 64, 128, 64)
  REMOP_FLASH_TC_WITH_LSE(64, 64, 128, 128)
  REMOP_FLASH_TC_WITH_LSE(128, 128, 64, 64)
  REMOP_FLASH_TC_WITH_LSE(128, 128, 64, 128)
  REMOP_FLASH_TC_WITH_LSE(128, 128, 128, 64)
  REMOP_FLASH_TC_WITH_LSE(128, 128, 128, 128)
  REMOP_FLASH_TC_WITH_LSE(256, 256, 64, 64)
  REMOP_FLASH_TC_WITH_LSE(256, 256, 128, 64)
  REMOP_FLASH_TC_WITH_LSE(192, 128, 64, 64)
  REMOP_FLASH_TC_WITH_LSE(192, 128, 64, 128)
  REMOP_FLASH_TC_WITH_LSE(192, 128, 128, 64)
  REMOP_FLASH_TC_WITH_LSE(192, 128, 128, 128)
#undef REMOP_FLASH_TC_WITH_LSE
#undef REMOP_FLASH_TC_CALL
  return cudaErrorInvalidValue;
}

template <int HD, int HDV, int BQ, int BK, bool SPLIT, bool CAP, bool LSE>
auto tc_kernel_for(cudaError_t* err) {
  auto kernel = flash_attention_kernel_tc<HD, HDV, BQ, BK, SPLIT, CAP, LSE>;
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              TcLayout<HD, HDV, BQ, BK>::kSmem);
  return kernel;
}

// TMA byte strides of dims 1..3 of a tensor with extents dims[0..3]
// (innermost first) and element strides st[0..2] of dims 1..3.  A dim of
// extent 1 is never stepped: its stride becomes the extent of the dims
// inside it, which TMA takes whatever the tensor's own stride was.
void tma_strides(const uint64_t (&dims)[4], const long long* st, uint64_t (&out)[3]) {
  uint64_t extent = dims[0] * 2;
  for (int i = 0; i < 3; ++i) {
    out[i] = dims[i + 1] == 1 ? extent : uint64_t(st[i]) * 2;
    extent = out[i] * dims[i + 1] > extent ? out[i] * dims[i + 1] : extent;
  }
}

// What TMA takes: a 16-byte-aligned base and, for every dim of extent > 1,
// a positive stride that is a multiple of 16 bytes (8 elements).
bool tma_aligned(const void* base, const uint64_t (&dims)[4], const long long* st) {
  if (reinterpret_cast<uintptr_t>(base) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (dims[i + 1] > 1 && (st[i] <= 0 || st[i] % 8)) return false;
  return true;
}

// strides: q, k, v, o, each (batch, head, position), in elements.
int launch_tc(const void* q, const void* k, const void* v, void* o, const long long* strides,
              int b, int h, int kv, int s, int t, int hd, int bq, int bk, float scale, int split,
              int hd_v, int window, int prefix, float softcap, float* lse, void* stream) {
  if (b <= 0 || s <= 0) return cudaSuccess;
  if (!shape_ok(h, kv, s, t, window, prefix, softcap) || !tc_ok(hd, hd_v, bq, bk) ||
      reinterpret_cast<uintptr_t>(lse) % 4)
    return cudaErrorInvalidValue;
  const uint64_t dq[4] = {uint64_t(hd), uint64_t(s), uint64_t(h), uint64_t(b)};
  const uint64_t dkv[4] = {uint64_t(hd), uint64_t(t), uint64_t(kv), uint64_t(b)};
  const uint64_t dv[4] = {uint64_t(hd_v), uint64_t(t), uint64_t(kv), uint64_t(b)};
  // Each tensor's strides, innermost (position) first.
  long long sq[3], sk[3], sv[3];
  for (int i = 0; i < 3; ++i) {
    sq[i] = strides[2 - i];
    sk[i] = strides[5 - i];
    sv[i] = strides[8 - i];
  }
  if (!tma_aligned(q, dq, sq) || !tma_aligned(k, dkv, sk) || !tma_aligned(v, dv, sv) ||
      reinterpret_cast<uintptr_t>(o) % 4 || strides[9] % 2 || strides[10] % 2 || strides[11] % 2)
    return cudaErrorInvalidValue;
  uint64_t bq_st[3], bk_st[3], bv_st[3];
  tma_strides(dq, sq, bq_st);
  tma_strides(dkv, sk, bk_st);
  tma_strides(dv, sv, bv_st);
  CUtensorMap map_q{}, map_k{}, map_v{};
  if (!hopper::encode_bf16_4d(&map_q, q, dq, bq_st, bq) ||
      !hopper::encode_bf16_4d(&map_k, k, dkv, bk_st, bk) ||
      !hopper::encode_bf16_4d(&map_v, v, dv, bv_st, bk))
    return cudaErrorNotSupported;
  TcParams p{o, {strides[9], strides[10], strides[11]}, h, kv, s, t, scale, window, prefix,
             softcap};
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid((s + bq - 1) / bq, h, b);
  return tc_dispatch(hd, hd_v, bq, bk, split, softcap > 0.f, lse != nullptr,
                     [&](auto hd_c, auto hdv_c, auto bq_c, auto bk_c, auto split_c,
                         auto cap_c, auto lse_c) -> int {
    constexpr int HD = decltype(hd_c)::value, HDV = decltype(hdv_c)::value;
    constexpr int BQ = decltype(bq_c)::value, BK = decltype(bk_c)::value;
    cudaError_t err;
    auto kernel = tc_kernel_for<HD, HDV, BQ, BK, decltype(split_c)::value,
                                decltype(cap_c)::value, decltype(lse_c)::value>(&err);
    if (err != cudaSuccess) return err;
    kernel<<<grid, BQ / 64 * 128 + kProducerThreads, TcLayout<HD, HDV, BQ, BK>::kSmem, st>>>(
        map_q, map_k, map_v, p, lse);
    return cudaGetLastError();
  });
}

// out: CTAs resident on one SM (the occupancy calculator), registers a
// thread, local (spilled) bytes a thread, dynamic shared memory, threads.
int occupancy_tc(int hd, int hd_v, int bq, int bk, int split, int cap, int* out) {
  if (!tc_ok(hd, hd_v, bq, bk)) return cudaErrorInvalidValue;
  return tc_dispatch(hd, hd_v, bq, bk, split, cap != 0, false,
                     [&](auto hd_c, auto hdv_c, auto bq_c, auto bk_c, auto split_c,
                         auto cap_c, auto lse_c) -> int {
    constexpr int HD = decltype(hd_c)::value, HDV = decltype(hdv_c)::value;
    constexpr int BQ = decltype(bq_c)::value, BK = decltype(bk_c)::value;
    cudaError_t err;
    auto kernel = tc_kernel_for<HD, HDV, BQ, BK, decltype(split_c)::value,
                                decltype(cap_c)::value, decltype(lse_c)::value>(&err);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    const int threads = BQ / 64 * 128 + kProducerThreads;
    const int smem = TcLayout<HD, HDV, BQ, BK>::kSmem;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, threads, smem);
    out[1] = attr.numRegs;
    out[2] = int(attr.localSizeBytes);
    out[3] = smem;
    out[4] = threads;
    return err;
  });
}

}  // namespace

extern "C" {

// hd: the width of q and k; hd_v: of v and o (equal, or 192 and 128);
// window: the keys a query sees up to its own position, 0 for all of them;
// prefix: the keys every query sees (k < prefix), 0 for causal only;
// softcap: the cap of the scaled scores, 0 for none.
int remop_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                               const long long* strides, int b, int h, int kv, int s,
                               int t, int hd, int bq, int bk, float scale, int hd_v,
                               int window, int prefix, float softcap, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, strides, b, h, kv, s, t, hd, bq, bk,
                                 scale, hd_v, window, prefix, softcap, stream);
}

int remop_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                              const long long* strides, int b, int h, int kv, int s,
                              int t, int hd, int bq, int bk, float scale, int hd_v,
                              int window, int prefix, float softcap, void* stream) {
  return dispatch<float>(q, k, v, o, strides, b, h, kv, s, t, hd, bq, bk, scale, hd_v,
                         window, prefix, softcap, stream);
}

// bf16 on the tensor cores ((hd, hd_v) (64, 64), (128, 128), (256, 256) or
// (192, 128); bq, bk 64 or 128; TMA-aligned q, k, v); split = 0 rounds P to
// bf16 once (a probe, not the main path, which takes no cap).
int remop_flash_attention_tc(const void* q, const void* k, const void* v, void* o,
                             const long long* strides, int b, int h, int kv, int s, int t,
                             int hd, int bq, int bk, float scale, int split, int hd_v,
                             int window, int prefix, float softcap, void* stream) {
  return launch_tc(q, k, v, o, strides, b, h, kv, s, t, hd, bq, bk, scale, split, hd_v,
                   window, prefix, softcap, nullptr, stream);
}

// The same launch that also writes each row's log-sum-exp into lse, f32 [B,
// H, S], contiguous (every width and block of the route; the LSE
// instantiations).
int remop_flash_attention_tc_lse(const void* q, const void* k, const void* v, void* o,
                                 const long long* strides, int b, int h, int kv, int s, int t,
                                 int hd, int bq, int bk, float scale, int split, int hd_v,
                                 int window, int prefix, float softcap, float* lse,
                                 void* stream) {
  return launch_tc(q, k, v, o, strides, b, h, kv, s, t, hd, bq, bk, scale, split, hd_v,
                   window, prefix, softcap, lse, stream);
}

// Occupancy of the tensor-core instantiation these blocks launch (cap != 0:
// the capped one), into out[5] (see occupancy_tc above).
int remop_flash_attention_tc_occupancy(int hd, int hd_v, int bq, int bk, int split, int cap,
                                       int* out) {
  return occupancy_tc(hd, hd_v, bq, bk, split, cap, out);
}

const char* remop_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
