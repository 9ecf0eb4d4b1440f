// Paged decode attention for Hopper (sm_90a), split over the positions
// ("flash-decoding").
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/paged_attention.py:65
// (paged_attention): q [B, KV, G, hd], k/v cache [B, S, KV, hd], lengths [B];
// scores q.k^T / sqrt(hd) in f32 with positions >= lengths[b] masked, an f32
// softmax, p @ v in f32, output in q's dtype.
//
// What bounds it on this card: the bytes, the K and V rows up to lengths[b]
// (2 MiB at gemma-2b's decode, 0.6 us at 3.35 TB/s).  Decode reads each K/V
// byte for G query rows only (8-48 flop a byte), far below the tensor cores'
// balance point, so the kernel runs on the CUDA cores and its design is about
// parallelism and loads in flight:
//
// 1. Split.  The grid is (splits, KV * ceil(G / gc), B).  The host plans
//    `splits` from the shape so that the CTAs fill the card's 132 SMs; each
//    CTA derives its chunk of positions on the device from lengths[b]:
//        c = round_up(ceil(max(len, 1) / splits), 16),
//        chunk i = [min(i c, len), min((i + 1) c, len)),
//    so the host never reads lengths.  A CTA whose chunk is empty returns at
//    once; the combine skips it by the same rule.  gc, the query heads one
//    CTA holds, is min(G, kMaxGroup): all G heads of a KV head share the
//    CTA's K/V rows, so each row is read once (granite-20b's 48 heads: one
//    group).
// 2. Loads in flight.  A CTA first copies its q rows (cp.async, before it
//    reads lengths[b]), then walks its chunk in tiles of kTile = 32
//    positions through a two-stage ring in shared memory: every row of a
//    tile is one group of 16-byte cp.async copies issued before the CTA
//    computes on the tile before it.  At the serving shapes a chunk is one
//    tile (16 or 32 positions), so the CTA's whole chunk is in flight at
//    once.  Rows are padded by 16 bytes, which keeps the reads below free of
//    bank conflicts.
// 3. Fewer reductions, short chains.  At these sizes a CTA's time is the
//    latency of its dependent steps, not its bytes or flops, so each phase
//    is cut to short independent chains without branches:
//    - scores: eight lanes share a position, each holding an eighth of its
//      K row in registers; a lane takes its partial dot products with all
//      the CTA's heads (independent FMA chains), and one 3-step shuffle per
//      head sums the eight (not 5 shuffles over 32 lanes);
//    - softmax: one warp max and one warp sum per (head, tile) update the
//      head's running (m, l) in shared memory;
//    - p @ v: thread (16-byte word of the row, head slot) holds NH heads'
//      f32 accumulators for that word, NH a template argument chosen at
//      launch from gc, so the row loop has no branches.
// 4. Combine in a fixed order.  Each live CTA writes, per head, its partial
//    (acc[hd], m, l) to an f32 scratch buffer the wrapper allocates; the
//    second kernel merges the partials of one (batch, KV head, query head)
//    and 64 columns per CTA: m = max m_i, w_i = exp(m_i - m), l = sum l_i w_i,
//    o = sum acc_i w_i / max(l, 1e-30), every sum in an order fixed by the
//    thread layout, so the result does not depend on timing.
//
// The latent route (remop_latent_decode_*) is MLA's absorbed-weight decode
// (src/repro/models/attention.py:316-347, mla_decode): q [B, H, 576] is
// (q_nope W_uk^T) | q_rope, the cache [B, S, 576] holds each position's
// latent row c_kv (512) | k_rope (64), and the values are the first 512
// columns of the same rows, with the scale 1 / sqrt(nope + rope) the caller
// gives.  It is the same split kernel with HD = 576, HDV = 512 and one KV
// head whose G = H query heads (16 for deepseek-v2-lite) share every row:
// a row is copied to shared memory once and read there for the scores and
// for the context, so the step reads L * 1152 bytes of cache (0.7 us at L
// 2048 and 3.35 TB/s).  576 = 9 x 64 columns: a position's eight lanes hold
// nine 16-byte words each.  Its split plan keeps chunks of at least
// `min_chunk` positions (128 from the host), so the f32 partials, 16 x 514
// values a chunk (32.9 KB), stay at most 22% of the chunk's cache bytes
// (147 KB): at L 2048, 16 live chunks and 0.53 MB of partials, not the 4.2
// MB that 128 chunks of 16 positions would write.
//
// Softcap.  With softcap = c > 0 each scaled score is capped before the
// mask, s = c tanh(s / c) (repro's attention logit softcap,
// src/repro/models/attention.py:72-73, which the TPU kernel does not
// compute), through hopper::softcap: its exp2f form for bf16 q, tanhf for
// f32; the cap is a template argument (CAP), so a launch without one runs
// the code it ran before, bit for bit.  The latent route has none.
//
// The int8 route (remop_paged_attention_int8_bf16) reads repro's int8 KV
// cache (src/repro/models/attention.py:32-52): int8 k_q, v_q [B, S, KV, hd]
// and bf16 scales [B, S, KV, 1], q and the output bf16.  Its ring holds the
// int8 rows (hd + 16 bytes a row, the 16 bytes of padding kept against bank
// conflicts), so a tile costs half the bf16 route's bytes plus two bytes a
// row of scale.  The scales are not 16-byte runs (they sit KV * 2 bytes
// apart), so the first two warps load a tile's K and V scales with plain
// loads into registers when they issue its copies, and store them to shared
// memory only when the tile comes up, a tile later.  Once a tile has landed
// its rows are widened in shared memory to the bf16 tile the bf16 route
// reads, each value bf16(float(q) * float(scale)) as repro's dequantize_kv
// rounds it; from there on the code is the bf16 route's, so the int8 route
// on (k_q, k_scale, ...) equals the bf16 route on the dequantized caches bit
// for bit.
//
// Every __global__ here keeps "paged_attention_kernel" in its name: the
// serving breakdown finds the attention kernels' device time by that name.
// lengths[b] is read as min(lengths[b], S); it must lie in [1, S].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;       // positions per tile: one per lane
constexpr int kStages = 2;      // tiles of the ring
constexpr int kMaxGroup = 64;   // query heads one CTA holds
constexpr int kLatentMaxGroup = 16;  // on the latent route (q rows of 576 f32)
constexpr int kMinChunk = 16;   // chunks are multiples of 16 positions
constexpr int kLatentHd = 576;  // the latent route's key width (lora 512 + rope 64)
constexpr int kLatentHdv = 512;  // and its value width
constexpr int kMaxSplits = 1024;
constexpr int kPStride = kTile + 1;  // p_s row stride, padded against bank conflicts
constexpr int kCombineThreads = 256;
constexpr int kCombineCols = 64;  // output columns a combine CTA merges
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The chunk length for a row of `len` valid positions over `splits` CTAs:
// ceil(len / splits) rounded up to 16, and at least `min_chunk` (a multiple
// of 16: 16 on the GQA route, where it changes nothing).
__host__ __device__ __forceinline__ int chunk_len(int len, int splits, int min_chunk) {
  const int c = ((len > 1 ? len : 1) + splits - 1) / splits;
  const int r = (c + kMinChunk - 1) / kMinChunk * kMinChunk;
  return r > min_chunk ? r : min_chunk;
}

// The 16 int8 values at src times `scale`, rounded to bf16 (32 bytes at dst).
__device__ __forceinline__ void widen_int8(unsigned char* dst, const unsigned char* src,
                                           float scale) {
  const int4 raw = *reinterpret_cast<const int4*>(src);
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const __nv_bfloat162 pair =
        __floats2bfloat162_rn(float(e[2 * i]) * scale, float(e[2 * i + 1]) * scale);
    w[i] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// One 16-byte word of a row, as floats.
template <typename T>
struct Word {
  static constexpr int kVec = 16 / int(sizeof(T));
  float x[kVec];
  __device__ __forceinline__ explicit Word(const void* p) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) x[i] = to_f32(e[i]);
  }
};

// T: q's type and the type the scores and p @ v read; C: the cache's (T,
// or int8_t on the int8 route, whose tiles are widened to T in shared
// memory).  HD: the key width; HDV: the value width.  HDV < HD is the latent
// route, whose values are the first HDV columns of the key rows: its ring
// holds the rows once.
template <typename T, typename C, int HD, int HDV>
struct Layout {
  static constexpr bool kShared = HDV != HD;
  static constexpr bool kInt8 = std::is_same<C, int8_t>::value;
  static constexpr int kVec = 16 / int(sizeof(T));   // elements per 16-byte word
  static constexpr int kWords = HD / kVec;           // 16-byte words per key row
  static constexpr int kVWords = HDV / kVec;         // and per value row
  static constexpr int kRowBytes = HD * int(sizeof(T)) + 16;  // padded row
  static constexpr int kTileBytes = kTile * kRowBytes;
  // The ring holds the cache's own rows, padded by 16 bytes.
  static constexpr int kLoadVec = 16 / int(sizeof(C));
  static constexpr int kLoadWords = HD / kLoadVec;
  static constexpr int kLoadRowBytes = HD * int(sizeof(C)) + 16;
  static constexpr int kLoadTileBytes = kTile * kLoadRowBytes;
  static constexpr int kStageTiles = kShared ? 1 : 2;  // K and V, or the shared rows
  static constexpr int kRingBytes = kStages * kStageTiles * kLoadTileBytes;
  // int8: the widened K and V tiles, then a tile's K and V scales.
  static constexpr int kWideBytes = kInt8 ? 2 * kTileBytes : 0;
  static constexpr int kScaleBytes = kInt8 ? 2 * kTile * int(sizeof(float)) : 0;
  static constexpr int kQOffset = kRingBytes + kWideBytes + kScaleBytes;
  // p @ v: thread (word, head slot); slot ps holds heads ps, ps + kSlots, ...
  // (NH of them, a template argument chosen at launch, at most kMaxNh).
  static constexpr int kSlots = kThreads / kVWords;
  static constexpr int kMaxNh =
      ((kShared ? kLatentMaxGroup : kMaxGroup) + kSlots - 1) / kSlots;
  // Scores: kSlices lanes share a position, lane slice r holding row words
  // r, r + kSlices, ...: kSliceWords words, kSliceWords * kVec elements.
  static constexpr int kSlices = kWords < 8 ? kWords : 8;
  static constexpr int kSliceWords = kWords / kSlices;
  static constexpr int kSlicePos = 32 / kSlices;  // positions a warp holds
  // bf16 q is staged as loaded, then widened; f32 q is copied in place.
  __host__ __device__ static size_t q_raw_bytes(int gc) {
    return sizeof(T) == 2 ? size_t(gc) * HD * 2 : 0;
  }
  static size_t smem(int gc) {
    return size_t(kQOffset) + q_raw_bytes(gc) +
           sizeof(float) * (size_t(gc) * HD + size_t(gc) * kPStride + 3 * size_t(gc));
  }
};

template <typename T, typename C, int HD, int HDV, int NH, bool CAP>
__global__ void __launch_bounds__(kThreads, 1)
    paged_attention_kernel_split(const T* __restrict__ q, const C* __restrict__ kc,
                                 const C* __restrict__ vc,
                                 const __nv_bfloat16* __restrict__ k_scale,
                                 const __nv_bfloat16* __restrict__ v_scale,
                                 const int32_t* __restrict__ lengths,
                                 float* __restrict__ part_acc, float* __restrict__ part_ml,
                                 int kv, int g, int s, int splits, int gc, int min_chunk,
                                 float scale, float softcap) {
  using L = Layout<T, C, HD, HDV>;
  const int split = blockIdx.x, b = blockIdx.z;
  const int groups = (g + gc - 1) / gc;
  const int h = blockIdx.y / groups, g0 = (blockIdx.y % groups) * gc;
  const int gn = min(gc, g - g0);  // query heads of this CTA
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;  // [stage][K, V or the shared rows][kTile][kLoadRowBytes]
  unsigned char* wide = smem + L::kRingBytes;  // int8: [K, V][kTile][kRowBytes]
  float* sc_s = reinterpret_cast<float*>(wide + L::kWideBytes);  // int8: [K, V][kTile]
  // q as f32, each head's float4s ordered so that the kSlices lanes of a
  // position read consecutive float4s: word w = r + kSlices * i of a row
  // goes to float4s (i * kVec / 4 + half) * kSlices + r (in order for f32).
  float* q_s = reinterpret_cast<float*>(smem + L::kQOffset);  // [gc][HD]
  unsigned char* q_raw = reinterpret_cast<unsigned char*>(q_s + gc * HD);
  float* p_s = reinterpret_cast<float*>(q_raw + L::q_raw_bytes(gc));  // [gc][kPStride]
  float* c_s = p_s + gc * kPStride;  // [gc] this tile's correction factors
  float* m_s = c_s + gc;             // [gc] running max
  float* l_s = m_s + gc;             // [gc] running sum

  // q first: it does not wait for lengths[b].
  const int64_t head0 = ((int64_t(b) * kv + h) * g + g0) * HD;
  for (int word = tid; word < gn * L::kWords; word += kThreads)
    cp_async_16(sizeof(T) == 4 ? static_cast<void*>(q_s + word * L::kVec)
                               : static_cast<void*>(q_raw + word * 16),
                q + head0 + int64_t(word) * L::kVec);
  cp_async_commit();

  const int len = min(lengths[b], s);
  const int c = chunk_len(len, splits, min_chunk);
  const int lo = min(split * c, len), hi = min(lo + c, len);
  if (lo >= hi) {  // empty chunk: the combine skips it
    cp_async_wait<0>();
    return;
  }

  const int64_t pos_stride = int64_t(kv) * HD;
  const int64_t row0 = int64_t(b) * s * kv + h;  // (b, position 0, h)
  const C* kb = kc + row0 * HD;
  const C* vb = vc + row0 * HD;
  float scale_reg = 0.f;  // int8: the scale this thread loads for the tile in flight
  auto issue = [&](int t0, int stage) {
    const int rows = min(kTile, hi - t0);
    unsigned char* kd = ring + stage * L::kStageTiles * L::kLoadTileBytes;
    unsigned char* vd = kd + L::kLoadTileBytes;
    for (int i = tid; i < rows * L::kLoadWords; i += kThreads) {
      const int r = i / L::kLoadWords, w = i % L::kLoadWords;
      const int64_t off = int64_t(t0 + r) * pos_stride + w * L::kLoadVec;
      cp_async_16(kd + r * L::kLoadRowBytes + w * 16, kb + off);
      if constexpr (!L::kShared) cp_async_16(vd + r * L::kLoadRowBytes + w * 16, vb + off);
    }
    if constexpr (L::kInt8) {
      if (tid < 2 * kTile) {  // warp 0 the K scales, warp 1 the V scales
        const int r = tid % kTile;
        const __nv_bfloat16* sb = tid < kTile ? k_scale : v_scale;
        scale_reg = r < rows ? __bfloat162float(sb[row0 + int64_t(t0 + r) * kv]) : 0.f;
      }
    }
    cp_async_commit();
  };
  issue(lo, 0);

  for (int i = tid; i < gn; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  if constexpr (sizeof(T) == 2) {  // widen q once its group is in
    cp_async_wait<1>();
    __syncthreads();
    for (int word = tid; word < gn * L::kWords; word += kThreads) {
      const int hh = word / L::kWords, w = word % L::kWords;
      const int r = w % L::kSlices, i = w / L::kSlices;
      const Word<T> qw(q_raw + word * 16);
      float4* dst = reinterpret_cast<float4*>(q_s + hh * HD);
#pragma unroll
      for (int half = 0; half < L::kVec / 4; ++half)
        dst[(i * (L::kVec / 4) + half) * L::kSlices + r] =
            make_float4(qw.x[4 * half], qw.x[4 * half + 1], qw.x[4 * half + 2],
                        qw.x[4 * half + 3]);
    }
  }

  // p @ v accumulators: thread (word pw, slot ps) holds heads ps + kSlots * j;
  // a head past gn reads head gn - 1's p and is never stored.
  const int pw = tid % L::kVWords, ps = tid / L::kVWords;
  int p_row[NH];
  float acc[NH][L::kVec];
#pragma unroll
  for (int j = 0; j < NH; ++j) {
    p_row[j] = min(ps + L::kSlots * j, gn - 1) * kPStride;
#pragma unroll
    for (int e = 0; e < L::kVec; ++e) acc[j][e] = 0.f;
  }
  const float cap_k = CAP ? hopper::softcap_k(softcap) : 0.f;
  // Scores: position sp of the tile, lane slice sr.
  const int sp = warp * L::kSlicePos + lane / L::kSlices, sr = lane % L::kSlices;
  const int sp_row = min(sp, kTile - 1);

  const int n_tiles = (hi - lo + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = lo + tile * kTile, stage = tile % kStages;
    if constexpr (L::kInt8) {
      if (tid < 2 * kTile) sc_s[tid] = scale_reg;  // this tile's, before the next load
    }
    if (tile + 1 < n_tiles) {
      issue(t0 + kTile, (tile + 1) % kStages);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's rows (and, at the first, q_s, m_s, l_s) are in
    const int tn = min(kTile, hi - t0);
    const unsigned char* kt = ring + stage * L::kStageTiles * L::kLoadTileBytes;
    const unsigned char* vt = L::kShared ? kt : kt + L::kLoadTileBytes;
    if constexpr (L::kInt8) {
      // Widen the landed int8 rows to bf16 tiles; rows past tn are left stale,
      // as in the ring.
      constexpr int kHalf = kTile * L::kLoadWords;
      for (int i = tid; i < 2 * kHalf; i += kThreads) {
        const int kv_sel = i / kHalf, r = (i % kHalf) / L::kLoadWords, w = i % L::kLoadWords;
        if (r < tn)
          widen_int8(wide + kv_sel * L::kTileBytes + r * L::kRowBytes + w * 32,
                     kt + kv_sel * L::kLoadTileBytes + r * L::kLoadRowBytes + w * 16,
                     sc_s[kv_sel * kTile + r]);
      }
      __syncthreads();
      kt = wide;
      vt = wide + L::kTileBytes;
    }

    // Scores: the slice's K words in registers, eight heads at a time, one
    // 3-step reduction over the slices per head.  Rows past tn hold stale
    // bytes; their scores are replaced by the mask, never used.
    {
      float kf[L::kSliceWords][L::kVec];
#pragma unroll
      for (int i = 0; i < L::kSliceWords; ++i) {
        const Word<T> kw(kt + sp_row * L::kRowBytes + (sr + L::kSlices * i) * 16);
#pragma unroll
        for (int e = 0; e < L::kVec; ++e) kf[i][e] = kw.x[e];
      }
      const bool valid = sp < tn, writes = sr == 0 && sp < kTile;
      for (int h0 = 0; h0 < gn; h0 += 8) {
        float sc[8];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float4* qr =
              reinterpret_cast<const float4*>(q_s + min(h0 + jj, gn - 1) * HD) + sr;
          sc[jj] = 0.f;
#pragma unroll
          for (int i = 0; i < L::kSliceWords; ++i) {
#pragma unroll
            for (int half = 0; half < L::kVec / 4; ++half) {
              const float4 qv = qr[(i * (L::kVec / 4) + half) * L::kSlices];
              sc[jj] = fmaf(qv.x, kf[i][4 * half], sc[jj]);
              sc[jj] = fmaf(qv.y, kf[i][4 * half + 1], sc[jj]);
              sc[jj] = fmaf(qv.z, kf[i][4 * half + 2], sc[jj]);
              sc[jj] = fmaf(qv.w, kf[i][4 * half + 3], sc[jj]);
            }
          }
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
          for (int o = L::kSlices / 2; o > 0; o >>= 1)
            sc[jj] += __shfl_xor_sync(0xffffffffu, sc[jj], o);
          float x = sc[jj] * scale;
          if constexpr (CAP) x = hopper::softcap<sizeof(T) == 2>(x, softcap, cap_k);
          if (writes && h0 + jj < gn) p_s[(h0 + jj) * kPStride + sp] = valid ? x : kNegInf;
        }
      }
    }
    __syncthreads();

    // The online softmax: warp w takes heads w, w + kWarps, ...; lane = position.
#pragma unroll 2
    for (int hh = warp; hh < gn; hh += kWarps) {
      const float x = p_s[hh * kPStride + lane];
      const float m_prev = m_s[hh];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float p = lane < tn ? expf(x - m_new) : 0.f;
      const float corr = expf(m_prev - m_new);
      const float sum = warp_sum(p);
      p_s[hh * kPStride + lane] = p;
      if (lane == 0) {
        l_s[hh] = l_s[hh] * corr + sum;
        m_s[hh] = m_new;
        c_s[hh] = corr;
      }
    }
    __syncthreads();

    // p @ v over the tile's valid rows, no branches inside.
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const float corr = c_s[p_row[j] / kPStride];
#pragma unroll
      for (int e = 0; e < L::kVec; ++e) acc[j][e] *= corr;
    }
#pragma unroll 4
    for (int t = 0; t < tn; ++t) {
      const Word<T> vw(vt + t * L::kRowBytes + pw * 16);
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const float p = p_s[p_row[j] + t];
#pragma unroll
        for (int e = 0; e < L::kVec; ++e) acc[j][e] = fmaf(p, vw.x[e], acc[j][e]);
      }
    }
    __syncthreads();  // the stage, p_s and c_s are rewritten by later tiles
  }

  // Partials of row (b, h, g0 + hh), split `split`: acc [rows][splits][HDV],
  // (m, l) [rows][splits][2].
  const int64_t out0 = (int64_t(b) * kv + h) * g + g0;
#pragma unroll
  for (int j = 0; j < NH; ++j) {
    const int hh = ps + L::kSlots * j;
    if (hh < gn) {
      float4* dst = reinterpret_cast<float4*>(
          part_acc + ((out0 + hh) * splits + split) * HDV + pw * L::kVec);
#pragma unroll
      for (int e4 = 0; e4 < L::kVec / 4; ++e4)
        dst[e4] = make_float4(acc[j][4 * e4], acc[j][4 * e4 + 1], acc[j][4 * e4 + 2],
                              acc[j][4 * e4 + 3]);
    }
  }
  for (int hh = tid; hh < gn; hh += kThreads) {
    float* dst = part_ml + ((out0 + hh) * splits + split) * 2;
    dst[0] = m_s[hh];
    dst[1] = l_s[hh];
  }
}

// One CTA per (output row (b, KV head, query head), block of 64 columns):
// merges the live splits' partials in split order.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    paged_attention_kernel_combine(const float* __restrict__ part_acc,
                                   const float* __restrict__ part_ml,
                                   const int32_t* __restrict__ lengths, T* __restrict__ out,
                                   int kv, int g, int s, int hd, int splits, int min_chunk) {
  extern __shared__ __align__(16) float cs[];
  float* red = cs;                         // [kCombineThreads][4]
  float* w_s = cs + 4 * kCombineThreads;   // [splits]
  const int64_t row = blockIdx.x;
  const int col0 = blockIdx.y * kCombineCols;
  const int b = int(row / (int64_t(kv) * g));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kCombineWarps = kCombineThreads / 32;
  const int len = min(lengths[b], s);
  const int c = chunk_len(len, splits, min_chunk);
  const int live = len > 0 ? min((len + c - 1) / c, splits) : 0;
  const float* ml = part_ml + row * splits * 2;
  const float* pa = part_acc + row * splits * hd;

  float mx = kNegInf;
  for (int i = tid; i < live; i += kCombineThreads) mx = fmaxf(mx, ml[2 * i]);
  mx = warp_max(mx);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
  for (int w = 1; w < kCombineWarps; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();

  float ls = 0.f;
  for (int i = tid; i < live; i += kCombineThreads) {
    const float w = expf(ml[2 * i] - mx);
    w_s[i] = w;
    ls = fmaf(ml[2 * i + 1], w, ls);
  }
  ls = warp_sum(ls);
  if (lane == 0) red[warp] = ls;
  __syncthreads();
  float l = 0.f;
  for (int w = 0; w < kCombineWarps; ++w) l += red[w];
  __syncthreads();

  // Thread (4 columns, slice): slice sl sums splits sl, sl + slices, ...
  const int cols4 = min(hd, kCombineCols) / 4, slices = kCombineThreads / cols4;
  const int c4 = col0 / 4 + tid % cols4, sl = tid / cols4;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int i = sl; i < live; i += slices) {
    const float4 x = reinterpret_cast<const float4*>(pa + int64_t(i) * hd)[c4];
    const float w = w_s[i];
    a.x = fmaf(x.x, w, a.x);
    a.y = fmaf(x.y, w, a.y);
    a.z = fmaf(x.z, w, a.z);
    a.w = fmaf(x.w, w, a.w);
  }
  reinterpret_cast<float4*>(red)[tid] = a;
  __syncthreads();
  if (sl == 0) {
    for (int k = 1; k < slices; ++k) {
      const float4 x = reinterpret_cast<const float4*>(red)[k * cols4 + tid % cols4];
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    const float den = fmaxf(l, 1e-30f);
    T* o = out + row * hd + 4 * c4;
    o[0] = from_f32<T>(a.x / den);
    o[1] = from_f32<T>(a.y / den);
    o[2] = from_f32<T>(a.z / den);
    o[3] = from_f32<T>(a.w / den);
  }
}

// Calls f with the least NH in {1, 2, 4, 8, 16} (at most MaxNh) that holds
// `need` heads.
template <int MaxNh, typename F>
int with_nh(int need, F&& f) {
  if (need <= 1) return f(std::integral_constant<int, 1>{});
  if constexpr (MaxNh >= 2) if (need <= 2) return f(std::integral_constant<int, 2>{});
  if constexpr (MaxNh >= 4) if (need <= 4) return f(std::integral_constant<int, 4>{});
  if constexpr (MaxNh >= 8) if (need <= 8) return f(std::integral_constant<int, 8>{});
  if constexpr (MaxNh >= 16) if (need <= 16) return f(std::integral_constant<int, 16>{});
  return cudaErrorInvalidValue;
}

// Calls f with the split kernel for gc heads a CTA, with or without the cap,
// and its shared memory.
template <typename T, typename C, int HD, int HDV, bool CAP, typename F>
int with_split(int gc, F&& f) {
  using L = Layout<T, C, HD, HDV>;
  return with_nh<L::kMaxNh>((gc + L::kSlots - 1) / L::kSlots, [&](auto nh_c) -> int {
    auto kernel = paged_attention_kernel_split<T, C, HD, HDV, decltype(nh_c)::value, CAP>;
    const size_t smem = L::smem(gc);
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
    return f(kernel, smem);
  });
}

// The caches and, on the int8 route, their scales.
struct Cache {
  const void* k;
  const void* v;
  const void* k_scale;
  const void* v_scale;
};

template <typename T, typename C, int HD, int HDV>
int launch(const void* q, const Cache& cache, const void* lengths, void* o, void* scratch,
           int b, int kv, int g, int s, int splits, int gc, int min_chunk, float scale,
           float softcap, cudaStream_t stream) {
  float* part_acc = static_cast<float*>(scratch);
  float* part_ml = part_acc + int64_t(b) * kv * g * splits * HDV;
  const int groups = (g + gc - 1) / gc;
  auto run = [&](auto kernel, size_t smem) -> int {
    kernel<<<dim3(splits, kv * groups, b), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const C*>(cache.k), static_cast<const C*>(cache.v),
        static_cast<const __nv_bfloat16*>(cache.k_scale),
        static_cast<const __nv_bfloat16*>(cache.v_scale), static_cast<const int32_t*>(lengths),
        part_acc, part_ml, kv, g, s, splits, gc, min_chunk, scale, softcap);
    return cudaGetLastError();
  };
  const int err = softcap > 0.f ? with_split<T, C, HD, HDV, true>(gc, run)
                                : with_split<T, C, HD, HDV, false>(gc, run);
  if (err != cudaSuccess) return err;
  paged_attention_kernel_combine<T>
      <<<dim3(unsigned(int64_t(b) * kv * g), (HDV + kCombineCols - 1) / kCombineCols),
         kCombineThreads, sizeof(float) * (splits + 4 * kCombineThreads), stream>>>(
          part_acc, part_ml, static_cast<const int32_t*>(lengths), static_cast<T*>(o), kv,
          g, s, HDV, splits, min_chunk);
  return cudaGetLastError();
}

template <typename F>
int with_hd(int hd, F&& f) {
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

bool shape_ok(int b, int kv, int g, int s, int splits, int gc) {
  if (g < 1 || s < 1 || splits < 1 || splits > kMaxSplits) return false;
  if (gc < 1 || gc > kMaxGroup || gc > g) return false;
  const int64_t groups = (g + gc - 1) / gc;
  return b <= 65535 && int64_t(kv) * groups <= 65535 && int64_t(b) * kv * g < (int64_t(1) << 31);
}

// C = T: the bf16 and f32 routes; C = int8_t: the int8 route (T bf16).
template <typename T, typename C>
int dispatch(const void* q, const Cache& cache, const void* lengths, void* o, void* scratch,
             int b, int kv, int g, int s, int hd, int splits, int gc, float scale, float softcap,
             void* stream) {
  if (b <= 0 || kv <= 0) return cudaSuccess;
  if (!shape_ok(b, kv, g, s, splits, gc) || !(softcap >= 0.f)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return with_hd(hd, [&](auto hd_c) {
    constexpr int HD = decltype(hd_c)::value;
    return launch<T, C, HD, HD>(q, cache, lengths, o, scratch, b, kv, g, s, splits, gc,
                                kMinChunk, scale, softcap, st);
  });
}

// The latent route: one KV head (the latent rows), g = H query heads.
template <typename T>
int latent_dispatch(const void* q, const void* latent, const void* lengths, void* o,
                    void* scratch, int b, int h, int s, int splits, int gc, int min_chunk,
                    float scale, void* stream) {
  if (b <= 0) return cudaSuccess;
  if (!shape_ok(b, 1, h, s, splits, gc) || gc > kLatentMaxGroup || min_chunk < kMinChunk ||
      min_chunk % kMinChunk)
    return cudaErrorInvalidValue;
  return launch<T, T, kLatentHd, kLatentHdv>(q, Cache{latent, latent, nullptr, nullptr}, lengths,
                                             o, scratch, b, 1, h, s, splits, gc, min_chunk, scale,
                                             0.f, static_cast<cudaStream_t>(stream));
}

// out: split kernel's registers, local (spilled) bytes a thread, dynamic
// shared memory at gc heads, CTAs resident on one SM at gc heads; combine
// kernel's registers and local bytes.
template <typename T, typename C, int HD, int HDV>
int split_attributes(int gc, int* out) {
  return with_split<T, C, HD, HDV, false>(gc, [&](auto kernel, size_t smem) -> int {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    out[0] = attr.numRegs;
    out[1] = int(attr.localSizeBytes);
    out[2] = int(smem);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if ((err = cudaFuncGetAttributes(&attr, paged_attention_kernel_combine<T>)) != cudaSuccess)
      return err;
    out[4] = attr.numRegs;
    out[5] = int(attr.localSizeBytes);
    return cudaSuccess;
  });
}

template <typename T, typename C>
int attributes(int hd, int gc, int* out) {
  if (gc < 1 || gc > kMaxGroup) return cudaErrorInvalidValue;
  return with_hd(hd, [&](auto hd_c) -> int {
    constexpr int HD = decltype(hd_c)::value;
    return split_attributes<T, C, HD, HD>(gc, out);
  });
}

}  // namespace

extern "C" {

// softcap: 0 for none, else the cap of the scaled scores.
int remop_paged_attention_bf16(const void* q, const void* k, const void* v,
                               const void* lengths, void* o, void* scratch, int b, int kv,
                               int g, int s, int hd, int splits, int gc, float scale,
                               float softcap, void* stream) {
  return dispatch<__nv_bfloat16, __nv_bfloat16>(q, Cache{k, v, nullptr, nullptr}, lengths, o,
                                                scratch, b, kv, g, s, hd, splits, gc, scale,
                                                softcap, stream);
}

int remop_paged_attention_f32(const void* q, const void* k, const void* v,
                              const void* lengths, void* o, void* scratch, int b, int kv,
                              int g, int s, int hd, int splits, int gc, float scale,
                              float softcap, void* stream) {
  return dispatch<float, float>(q, Cache{k, v, nullptr, nullptr}, lengths, o, scratch, b, kv, g,
                                s, hd, splits, gc, scale, softcap, stream);
}

// The int8 route: q [B, KV, G, hd] bf16, k_q / v_q [B, S, KV, hd] int8,
// k_scale / v_scale [B, S, KV, 1] bf16, out bf16.
int remop_paged_attention_int8_bf16(const void* q, const void* k_q, const void* v_q,
                                    const void* k_scale, const void* v_scale,
                                    const void* lengths, void* o, void* scratch, int b, int kv,
                                    int g, int s, int hd, int splits, int gc, float scale,
                                    float softcap, void* stream) {
  return dispatch<__nv_bfloat16, int8_t>(q, Cache{k_q, v_q, k_scale, v_scale}, lengths, o,
                                         scratch, b, kv, g, s, hd, splits, gc, scale, softcap,
                                         stream);
}

// route (0 bf16, 1 f32, 2 int8), hd, gc, &out[6] (see split_attributes above;
// the instantiation without a cap).
int remop_paged_attention_attributes(int route, int hd, int gc, int* out) {
  switch (route) {
    case 0: return attributes<__nv_bfloat16, __nv_bfloat16>(hd, gc, out);
    case 1: return attributes<float, float>(hd, gc, out);
    case 2: return attributes<__nv_bfloat16, int8_t>(hd, gc, out);
    default: return cudaErrorInvalidValue;
  }
}

// MLA's absorbed decode: q [B, H, 576], latent [B, S, 576], lengths [B] int32,
// out [B, H, 512]; scratch holds B * H * splits * (512 + 2) floats; chunks
// of at least min_chunk positions.
int remop_latent_decode_bf16(const void* q, const void* latent, const void* lengths, void* o,
                             void* scratch, int b, int h, int s, int splits, int gc,
                             int min_chunk, float scale, void* stream) {
  return latent_dispatch<__nv_bfloat16>(q, latent, lengths, o, scratch, b, h, s, splits, gc,
                                        min_chunk, scale, stream);
}

int remop_latent_decode_f32(const void* q, const void* latent, const void* lengths, void* o,
                            void* scratch, int b, int h, int s, int splits, int gc,
                            int min_chunk, float scale, void* stream) {
  return latent_dispatch<float>(q, latent, lengths, o, scratch, b, h, s, splits, gc,
                                min_chunk, scale, stream);
}

// is_f32, gc, &out[6] (see split_attributes above).
int remop_latent_decode_attributes(int is_f32, int gc, int* out) {
  if (gc < 1 || gc > kLatentMaxGroup) return cudaErrorInvalidValue;
  return is_f32 ? split_attributes<float, float, kLatentHd, kLatentHdv>(gc, out)
                : split_attributes<__nv_bfloat16, __nv_bfloat16, kLatentHd, kLatentHdv>(gc, out);
}

const char* remop_paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
