// Causal GQA flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py:72
// (flash_attention): q [B, H, S, hd], k/v [B, KV, T, hd], query head h reads
// KV head h / (H / KV), causal with the query positions offset by T - S, an
// online softmax in f32, fully masked KV blocks skipped, output in q's dtype.
//
// One CTA per (q block, head, batch).  It stages its bq query rows in shared
// memory, then walks the KV blocks 0 .. last one a row of the block can see
// (the TPU kernel's `q_base + bq - 1 >= k_base` skip): each block's K is
// staged, the bq x bk scores are formed in registers, the (m, l, acc) online
// softmax is updated exactly as the TPU kernel does it, P goes to shared
// memory, V is staged into the buffer K used, and acc += P V.  The
// accumulator lives in registers: 256 threads as 16 x 16, thread (ty, tx)
// owning rows ty + 16 i (i < 4) and head columns tx + 16 j.  So bq, bk <= 64;
// rows past S and columns past T are masked (zero-filled when staged), so
// any S <= T works without padding.  Strides are passed in elements for
// every tensor (the last dimension must be contiguous), so the model's
// [B, S, H, hd] activations are read and written in place.
//
// What bounds it on this card: at the model's widths (hd 128 or 256, S in
// the thousands) the operations, about 4 S T hd H / 2 flops.  This first
// version computes them with f32 FMAs on the CUDA cores, reading operands
// from shared memory (rows padded by one 32-bit word, so the 16 rows a
// half-warp reads fall in 16 banks), not on the tensor cores; the heaviest
// (last) q blocks are launched first to shorten the tail.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
};

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

// rows [r0, r0 + n) of src (position stride `ps`) into dst, zero past `limit`.
template <typename T, int HD>
__device__ __forceinline__ void stage(T* dst, const T* src, int64_t ps, int r0,
                                      int n, int limit) {
  constexpr int LD = ld<T, HD>();
  for (int i = threadIdx.x; i < n * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD;
    const int row = r0 + r;
    dst[r * LD + d] = row < limit ? src[int64_t(row) * ps + d] : from_f32<T>(0.f);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Params p) {
  constexpr int LD = ld<T, HD>();
  constexpr int CD = HD / 16;  // head columns per thread
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

  stage<T, HD>(q_s, qg, p.st[2], q0, p.bq, p.s);

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
  const int n_kv = min((p.t + p.bk - 1) / p.bk, q_last / p.bk + 1);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * p.bk;
    __syncthreads();  // q staged; the previous block's V no longer read
    stage<T, HD>(kv_s, kg, p.st[5], k0, p.bk, p.t);
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

    // Causal mask (it also masks k >= T, since every q position is < T),
    // then the online softmax update of the TPU kernel.
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int qpos = q0 + ty + 16 * i + offset;
      float rmax = kNegInf;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        const int col = tx + 16 * c;
        float x = sc[i][c] * p.scale;
        if (col >= p.bk || k0 + col > qpos) x = kNegInf;
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
    stage<T, HD>(kv_s, vg, p.st[8], k0, p.bk, p.t);
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

template <typename T, int HD>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = size_t(p.bq + p.bk) * ld<T, HD>() * sizeof(T) +
                      size_t(p.bq) * (p.bk + 1) * sizeof(float);
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.s + p.bq - 1) / p.bq, p.h, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             const long long* strides, int b, int h, int kv, int s, int t,
             int hd, int bq, int bk, float scale, void* stream) {
  if (b <= 0 || s <= 0) return cudaSuccess;
  if (kv <= 0 || h % kv || t < s || bq < 1 || bq > kMaxBlock || bk < 1 ||
      bk > kMaxBlock)
    return cudaErrorInvalidValue;
  Params p{q, k, v, o, {}, h, kv, s, t, bq, bk, scale};
  for (int i = 0; i < 12; ++i) p.st[i] = strides[i];
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<T, 16>(p, b, st);
    case 32: return launch<T, 32>(p, b, st);
    case 64: return launch<T, 64>(p, b, st);
    case 128: return launch<T, 128>(p, b, st);
    case 256: return launch<T, 256>(p, b, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int remop_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                               const long long* strides, int b, int h, int kv, int s,
                               int t, int hd, int bq, int bk, float scale,
                               void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, strides, b, h, kv, s, t, hd, bq, bk,
                                 scale, stream);
}

int remop_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                              const long long* strides, int b, int h, int kv, int s,
                              int t, int hd, int bq, int bk, float scale,
                              void* stream) {
  return dispatch<float>(q, k, v, o, strides, b, h, kv, s, t, hd, bq, bk, scale,
                         stream);
}

const char* remop_flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
