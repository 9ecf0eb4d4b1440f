// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/paged_attention.py:65
// (paged_attention): q [B, KV, G, hd], k/v cache [B, S, KV, hd], lengths [B];
// the cache is walked one page of `page` positions at a time with an online
// f32 softmax, positions >= lengths[b] masked, output in q's dtype.
//
// One CTA per (KV head, batch, group of up to kMaxGroup query heads): the
// TPU kernel's grid step serves all G query heads of a KV head; here G is
// split over ceil(G / kMaxGroup) CTAs, each holding at most kMaxGroup heads
// in registers and walking the same pages.  Any G is taken (granite-20b:
// 48 heads on one KV head, 6 CTAs); the split keeps a thread's accumulators
// at kMaxGroup x hd / 32 and gives a wide group more SMs, at the price of
// reading the K and V rows once per CTA (from L2 after the first).  Pages past ceil(lengths[b] / page) are
// skipped: they are fully masked, so the result is the same.  Per page:
//   1. scores: warp w takes positions w, w + 8, ...; each lane holds hd / 32
//      elements of the K row (one 16-byte load at hd = 256 in bf16) and the
//      G dot products are reduced across the warp;
//   2. softmax: warp g updates (m, l) of query head g over the page and
//      leaves exp(s - m) and the correction factor in shared memory;
//   3. values: warp w rescales its partial accumulator (G x hd / 32 floats
//      in each lane's registers) and adds p * V for its positions.
// At the end the eight warps' partial sums are added in a fixed order, so
// the result does not depend on timing.  lengths[b] must lie in [1, S].
//
// What bounds it on this card: the bytes, the K and V rows up to lengths[b].
// This version reads them with one CTA per (batch, KV head, group of up to
// 8 query heads), which at gemma-2b's single KV head of 8 query heads is
// one SM of the 132; splitting the pages over CTAs (flash-decoding) is the
// next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;  // query heads one CTA holds
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

// N consecutive elements as floats, in 16-byte loads where N elements fill
// whole 16-byte words (the wrapper checks the base pointers' alignment).
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* src, float (&dst)[N]) {
  constexpr int kBytes = N * int(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPerWord = 16 / int(sizeof(T));
#pragma unroll
    for (int w = 0; w < kBytes / 16; ++w) {
      const uint4 word = reinterpret_cast<const uint4*>(src)[w];
      const T* e = reinterpret_cast<const T*>(&word);
#pragma unroll
      for (int i = 0; i < kPerWord; ++i) dst[w * kPerWord + i] = to_f32(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = to_f32(src[i]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                           const T* __restrict__ vc, const int32_t* __restrict__ lengths,
                           T* __restrict__ out, int kv, int g_all, int s, int page,
                           float scale) {
  constexpr int EPL = HD >= 32 ? HD / 32 : 1;  // row elements per lane
  constexpr int LANES = HD / EPL;              // lanes that hold a row
  // This CTA's query heads: [g0, g0 + g) of the G = g_all of KV head h.
  const int g0 = blockIdx.z * kMaxGroup;
  const int g = min(kMaxGroup, g_all - g0);
  extern __shared__ __align__(16) float sm[];
  float* q_s = sm;                 // [g][HD]
  float* acc_s = q_s + g * HD;     // [g][HD]
  float* p_s = acc_s + g * HD;     // [g][page]
  float* m_s = p_s + g * page;     // [g]
  float* l_s = m_s + g;            // [g]
  float* c_s = l_s + g;            // [g]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(lengths[b], s);
  const int n_pages = (len + page - 1) / page;
  const int64_t head0 = ((int64_t(b) * kv + h) * g_all + g0) * HD;  // q / out offset
  const int64_t pos_stride = int64_t(kv) * HD;
  const T* kb = kc + (int64_t(b) * s * kv + h) * HD + lane * EPL;
  const T* vb = vc + (int64_t(b) * s * kv + h) * HD + lane * EPL;
  const bool holds = lane < LANES;

  for (int i = tid; i < g * HD; i += kThreads) q_s[i] = to_f32(q[head0 + i]);
  if (tid < g) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxGroup][EPL];
#pragma unroll
  for (int gi = 0; gi < kMaxGroup; ++gi)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[gi][e] = 0.f;
  __syncthreads();

  for (int pg = 0; pg < n_pages; ++pg) {
    const int t0 = pg * page;
    const int tn = min(page, len - t0);  // unmasked positions of this page

    for (int tt = warp; tt < page; tt += kWarps) {
      float kr[EPL];
      if (holds && tt < tn) {
        load_row<T, EPL>(kb + int64_t(t0 + tt) * pos_stride, kr);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[e] = 0.f;
      }
#pragma unroll
      for (int gi = 0; gi < kMaxGroup; ++gi) {
        if (gi < g) {
          float part = 0.f;
          if (holds) {
            const float* qr = q_s + gi * HD + lane * EPL;
#pragma unroll
            for (int e = 0; e < EPL; ++e) part = fmaf(qr[e], kr[e], part);
          }
          part = warp_sum(part);
          if (lane == 0) p_s[gi * page + tt] = tt < tn ? part * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    for (int gi = warp; gi < g; gi += kWarps) {
      float* row = p_s + gi * page;
      float mx = kNegInf;
      for (int tt = lane; tt < page; tt += 32) mx = fmaxf(mx, row[tt]);
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int tt = lane; tt < page; tt += 32) {
        const float e = expf(row[tt] - m_new);
        row[tt] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[gi] = l_s[gi] * corr + sum;
        m_s[gi] = m_new;
        c_s[gi] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int gi = 0; gi < kMaxGroup; ++gi) {
      if (gi < g) {
        const float corr = c_s[gi];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[gi][e] *= corr;
      }
    }
    if (holds) {
      for (int tt = warp; tt < tn; tt += kWarps) {
        float vr[EPL];
        load_row<T, EPL>(vb + int64_t(t0 + tt) * pos_stride, vr);
#pragma unroll
        for (int gi = 0; gi < kMaxGroup; ++gi) {
          if (gi < g) {
            const float pv = p_s[gi * page + tt];
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[gi][e] = fmaf(pv, vr[e], acc[gi][e]);
          }
        }
      }
    }
    __syncthreads();  // p_s and c_s are rewritten by the next page
  }

  for (int w = 0; w < kWarps; ++w) {
    if (warp == w && holds) {
#pragma unroll
      for (int gi = 0; gi < kMaxGroup; ++gi) {
        if (gi < g) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            float* a = acc_s + gi * HD + lane * EPL + e;
            *a = (w == 0 ? 0.f : *a) + acc[gi][e];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < g * HD; i += kThreads) {
    const float den = fmaxf(l_s[i / HD], 1e-30f);
    out[head0 + i] = from_f32<T>(acc_s[i] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* o,
           int b, int kv, int g, int s, int page, float scale, cudaStream_t stream) {
  const int gc = g < kMaxGroup ? g : kMaxGroup;  // heads of the widest CTA
  const size_t smem = sizeof(float) * (size_t(2 * gc) * HD + size_t(gc) * page + 3 * gc);
  auto kernel = paged_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(kv, b, (g + kMaxGroup - 1) / kMaxGroup), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(lengths), static_cast<T*>(o), kv, g, s, page, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* lengths, void* o,
             int b, int kv, int g, int s, int hd, int page, float scale,
             void* stream) {
  if (b <= 0 || kv <= 0) return cudaSuccess;
  if (g < 1 || g > 65535 * kMaxGroup || s < 1 || page < 1) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, lengths, o, b, kv, g, s, page, scale, st);
    case 32: return launch<T, 32>(q, k, v, lengths, o, b, kv, g, s, page, scale, st);
    case 64: return launch<T, 64>(q, k, v, lengths, o, b, kv, g, s, page, scale, st);
    case 128: return launch<T, 128>(q, k, v, lengths, o, b, kv, g, s, page, scale, st);
    case 256: return launch<T, 256>(q, k, v, lengths, o, b, kv, g, s, page, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int remop_paged_attention_bf16(const void* q, const void* k, const void* v,
                               const void* lengths, void* o, int b, int kv, int g,
                               int s, int hd, int page, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, lengths, o, b, kv, g, s, hd, page, scale,
                                 stream);
}

int remop_paged_attention_f32(const void* q, const void* k, const void* v,
                              const void* lengths, void* o, int b, int kv, int g,
                              int s, int hd, int page, float scale, void* stream) {
  return dispatch<float>(q, k, v, lengths, o, b, kv, g, s, hd, page, scale, stream);
}

const char* remop_paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
