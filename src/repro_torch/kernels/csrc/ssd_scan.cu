// SSD inter-chunk state scan for Hopper (sm_90a), and its gradient.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/ssd_scan.py:50
// (ssd_scan): states [B, NC, H, P, N], decays [B, NC, H], one dtype (f32 or
// bf16); with an f32 carry starting at zero,
//     prev[:, c] = carry_c,   carry_{c+1} = carry_c * decays[:, c] + states[:, c],
//     final      = carry_NC,
// prev and final written in the states' dtype.
//
// The TPU kernel keeps the whole [H, P, N] carry resident in VMEM across a
// sequential chunk grid.  At mamba2-370m's widths that carry is 1 MiB, far
// above a CTA's 227 KB of shared memory, and nothing carries over between
// CTAs here.  But the recurrence is independent per element, so each thread
// owns VEC consecutive elements of one (b, h) row of P * N (16 bytes: 4 in
// f32, 8 in bf16), holds their carry in registers and loops over the chunks
// itself.  A CTA stays within one head, so every thread of it reads the same
// decays[b, c, h] (one broadcast load per chunk).  Chunk c + 1's state is
// loaded before chunk c's prev is stored, so two loads are in flight per
// thread.  The update is __fadd_rn(__fmul_rn(carry, decay), state): no FMA
// contraction, so the result equals the plain PyTorch version (multiply,
// round, add, round, in f32) bit for bit.
//
// What bounds it on this card: the bytes.  Every state is read once and every
// prev written once (2 * B * NC * H * P * N elements) plus one final row; the
// two operations per element are nothing beside them.  Rows whose P * N is
// not a multiple of VEC, or whose base is not 16-byte aligned, take
// element-wise loads.
//
// The gradient (ssd_scan_bwd_kernel, then ssd_scan_bwd_reduce_kernel)
// replaces no TPU kernel: the JAX package trains through XLA's autodiff of
// the jax.lax.scan in src/repro/models/ssm.py:116, and the port's forward is
// the kernel above, whose launch records nothing for autograd.  Given dprev
// [B, NC, H, P, N], dfinal [B, H, P, N], the forward's prev and the decays,
// with G_NC = dfinal and G_c = dprev[:, c] + G_{c+1} * decays[:, c] (f32),
//     dstates[:, c] = G_{c+1},   ddecays[:, c, h] = sum_{p, n} G_{c+1} * prev[:, c],
// both in the inputs' dtype.  The same layout as the forward: each thread
// owns VEC elements of one (b, h) row, holds their G in registers and walks
// the chunks backwards (chunk c - 1's prev and dprev in flight while chunk c
// is stored), with __fmul_rn / __fadd_rn so that dstates equals the plain
// version bit for bit.  ddecays is a sum over the P * N elements of a row,
// which several CTAs share: each warp sums its lanes' products (a fixed
// butterfly of shuffles) into one f32 partial of [B, NC, H, parts] scratch,
// and the reduce kernel sums a row's partials in order and rounds once.  No
// atomics, so two calls give the same bits.  Bound by the bytes as the
// forward: dprev and prev read once, dstates written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// The four 32-bit words of a 16-byte load as VEC elements, by bit operations
// (a reinterpret_cast of a local uint4 would put it in local memory).
__device__ __forceinline__ void unpack(const uint4& w, float (&dst)[4]) {
  dst[0] = __uint_as_float(w.x);
  dst[1] = __uint_as_float(w.y);
  dst[2] = __uint_as_float(w.z);
  dst[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, float (&dst)[8]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32
    dst[2 * i] = __uint_as_float(words[i] << 16);
    dst[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&src)[4]) {
  return make_uint4(__float_as_uint(src[0]), __float_as_uint(src[1]),
                    __float_as_uint(src[2]), __float_as_uint(src[3]));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}
__device__ __forceinline__ uint4 pack(const float (&src)[8]) {
  return make_uint4(pack2(src[0], src[1]), pack2(src[2], src[3]), pack2(src[4], src[5]),
                    pack2(src[6], src[7]));
}

// VEC elements starting at src[0] as floats; element i only where valid > i.
template <typename T, int VEC, bool WIDE>
__device__ __forceinline__ void load_vec(const T* __restrict__ src, int valid,
                                         float (&dst)[VEC]) {
  if constexpr (WIDE) {
    unpack(__ldg(reinterpret_cast<const uint4*>(src)), dst);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = i < valid ? to_f32(src[i]) : 0.f;
  }
}

template <typename T, int VEC, bool WIDE>
__device__ __forceinline__ void store_vec(T* __restrict__ dst, int valid,
                                          const float (&src)[VEC]) {
  if constexpr (WIDE) {
    *reinterpret_cast<uint4*>(dst) = pack(src);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (i < valid) dst[i] = from_f32<T>(src[i]);
  }
}

// grid (ceil(P*N / (VEC * kThreads)), H, B); thread -> VEC elements of one row.
template <typename T, bool WIDE>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ states, const T* __restrict__ decays,
                    T* __restrict__ prev, T* __restrict__ final_state, int nc, int h,
                    int64_t pn) {
  constexpr int VEC = 16 / int(sizeof(T));
  const int head = blockIdx.y, b = blockIdx.z;
  const int64_t i0 = (int64_t(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  if (i0 >= pn) return;
  const int valid = int(pn - i0 < VEC ? pn - i0 : VEC);
  const int64_t chunk_stride = int64_t(h) * pn;           // elements between chunks
  const int64_t row0 = (int64_t(b) * nc * h + head) * pn + i0;  // chunk 0 of (b, head)
  const T* dec = decays + int64_t(b) * nc * h + head;          // stride h per chunk

  float carry[VEC], cur[VEC], next[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) carry[i] = 0.f;
  load_vec<T, VEC, WIDE>(states + row0, valid, next);
  float d_next = to_f32(__ldg(dec));

  for (int c = 0; c < nc; ++c) {
    const float d = d_next;
#pragma unroll
    for (int i = 0; i < VEC; ++i) cur[i] = next[i];
    if (c + 1 < nc) {  // chunk c + 1 in flight while chunk c is stored
      load_vec<T, VEC, WIDE>(states + row0 + (c + 1) * chunk_stride, valid, next);
      d_next = to_f32(__ldg(dec + int64_t(c + 1) * h));
    }
    store_vec<T, VEC, WIDE>(prev + row0 + c * chunk_stride, valid, carry);
#pragma unroll
    for (int i = 0; i < VEC; ++i) carry[i] = __fadd_rn(__fmul_rn(carry[i], d), cur[i]);
  }
  store_vec<T, VEC, WIDE>(final_state + (int64_t(b) * h + head) * pn + i0, valid, carry);
}

// The valid elements of a row's VEC at src (none past the row's end).
template <typename T, int VEC, bool WIDE>
__device__ __forceinline__ void load_row(const T* __restrict__ src, int valid,
                                         float (&dst)[VEC]) {
  if (valid > 0) {
    load_vec<T, VEC, WIDE>(src, valid, dst);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = 0.f;
  }
}

constexpr int kWarps = kThreads / 32;

// grid (ceil(P*N / (VEC * kThreads)), H, B), as the forward; partial holds
// gridDim.x * kWarps f32 a (b, c, h) row, written by warp w of CTA x at
// x * kWarps + w.
template <typename T, bool WIDE>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_bwd_kernel(const T* __restrict__ dprev, const T* __restrict__ dfinal,
                        const T* __restrict__ prev, const T* __restrict__ decays,
                        T* __restrict__ dstates, float* __restrict__ partial, int nc, int h,
                        int64_t pn) {
  constexpr int VEC = 16 / int(sizeof(T));
  const int head = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t i0 = (int64_t(blockIdx.x) * kThreads + threadIdx.x) * VEC;
  // Threads past the row take part in the warp's sum with zeros.
  const int valid = i0 >= pn ? 0 : int(pn - i0 < VEC ? pn - i0 : VEC);
  const int64_t chunk_stride = int64_t(h) * pn;
  const int64_t row0 = (int64_t(b) * nc * h + head) * pn + i0;
  const T* dec = decays + int64_t(b) * nc * h + head;
  const int64_t parts = int64_t(gridDim.x) * kWarps;
  float* part = partial + (int64_t(b) * nc * h + head) * parts + blockIdx.x * kWarps + warp;

  float g[VEC], pv[VEC], dp[VEC], pv_next[VEC], dp_next[VEC];
  load_row<T, VEC, WIDE>(dfinal + (int64_t(b) * h + head) * pn + i0, valid, g);
  const int64_t last = row0 + int64_t(nc - 1) * chunk_stride;
  load_row<T, VEC, WIDE>(prev + last, valid, pv_next);
  load_row<T, VEC, WIDE>(dprev + last, nc > 1 ? valid : 0, dp_next);
  float d_next = to_f32(__ldg(dec + int64_t(nc - 1) * h));

  for (int c = nc - 1; c >= 0; --c) {
    const float d = d_next;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      pv[i] = pv_next[i];
      dp[i] = dp_next[i];
    }
    if (c > 0) {  // chunk c - 1 in flight while chunk c is stored
      const int64_t at = row0 + int64_t(c - 1) * chunk_stride;
      load_row<T, VEC, WIDE>(prev + at, valid, pv_next);
      load_row<T, VEC, WIDE>(dprev + at, c > 1 ? valid : 0, dp_next);  // dprev[:, 0] unused
      d_next = to_f32(__ldg(dec + int64_t(c - 1) * h));
    }
    if (valid > 0) store_vec<T, VEC, WIDE>(dstates + row0 + c * chunk_stride, valid, g);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) s = __fadd_rn(s, __fmul_rn(g[i], pv[i]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)  // every lane ends with the same sum
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    if (lane == 0) part[int64_t(c) * h * parts] = s;
    if (c > 0) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) g[i] = __fadd_rn(__fmul_rn(g[i], d), dp[i]);
    }
  }
}

// One thread per (b, c, h) row: its partials summed in order, rounded once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_bwd_reduce_kernel(const float* __restrict__ partial, T* __restrict__ ddecays,
                               int64_t rows, int parts) {
  const int64_t r = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  const float* p = partial + r * parts;
  float s = 0.f;
  for (int i = 0; i < parts; ++i) s = __fadd_rn(s, p[i]);
  ddecays[r] = from_f32<T>(s);
}

template <typename T>
int64_t bwd_blocks(int64_t pn) {
  constexpr int VEC = 16 / int(sizeof(T));
  return (pn + int64_t(VEC) * kThreads - 1) / (int64_t(VEC) * kThreads);
}

template <typename T>
int launch(const void* states, const void* decays, void* prev, void* final_state, int b,
           int nc, int h, int64_t pn, void* stream) {
  if (b <= 0 || h <= 0 || pn <= 0) return cudaSuccess;
  if (nc < 1) return cudaErrorInvalidValue;
  constexpr int VEC = 16 / int(sizeof(T));
  const int64_t blocks = (pn + int64_t(VEC) * kThreads - 1) / (int64_t(VEC) * kThreads);
  if (blocks > 0x7fffffff || h > 65535 || b > 65535) return cudaErrorInvalidValue;
  const bool aligned = pn % VEC == 0 &&
                       (reinterpret_cast<uintptr_t>(states) | reinterpret_cast<uintptr_t>(prev) |
                        reinterpret_cast<uintptr_t>(final_state)) % 16 == 0;
  const dim3 grid(unsigned(blocks), h, b);
  auto st = static_cast<cudaStream_t>(stream);
  const T* s = static_cast<const T*>(states);
  const T* d = static_cast<const T*>(decays);
  T* p = static_cast<T*>(prev);
  T* f = static_cast<T*>(final_state);
  if (aligned) {
    ssd_scan_kernel<T, true><<<grid, kThreads, 0, st>>>(s, d, p, f, nc, h, pn);
  } else {
    ssd_scan_kernel<T, false><<<grid, kThreads, 0, st>>>(s, d, p, f, nc, h, pn);
  }
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* dprev, const void* dfinal, const void* prev, const void* decays,
               void* dstates, void* ddecays, void* partial, int b, int nc, int h, int64_t pn,
               int parts, void* stream) {
  if (b <= 0 || h <= 0 || pn <= 0) return cudaSuccess;
  if (nc < 1) return cudaErrorInvalidValue;
  constexpr int VEC = 16 / int(sizeof(T));
  const int64_t blocks = bwd_blocks<T>(pn);
  const int64_t rows = int64_t(b) * nc * h;
  if (blocks > 0x7fffffff || h > 65535 || b > 65535 || parts != blocks * kWarps ||
      (rows + kThreads - 1) / kThreads > 0x7fffffff)
    return cudaErrorInvalidValue;
  const bool aligned =
      pn % VEC == 0 &&
      (reinterpret_cast<uintptr_t>(dprev) | reinterpret_cast<uintptr_t>(dfinal) |
       reinterpret_cast<uintptr_t>(prev) | reinterpret_cast<uintptr_t>(dstates)) % 16 == 0;
  const dim3 grid(unsigned(blocks), h, b);
  auto st = static_cast<cudaStream_t>(stream);
  const T* dp = static_cast<const T*>(dprev);
  const T* df = static_cast<const T*>(dfinal);
  const T* pv = static_cast<const T*>(prev);
  const T* d = static_cast<const T*>(decays);
  T* ds = static_cast<T*>(dstates);
  float* part = static_cast<float*>(partial);
  if (aligned) {
    ssd_scan_bwd_kernel<T, true><<<grid, kThreads, 0, st>>>(dp, df, pv, d, ds, part, nc, h, pn);
  } else {
    ssd_scan_bwd_kernel<T, false><<<grid, kThreads, 0, st>>>(dp, df, pv, d, ds, part, nc, h, pn);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_scan_bwd_reduce_kernel<T><<<unsigned((rows + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      part, static_cast<T*>(ddecays), rows, parts);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int remop_ssd_scan_f32(const void* states, const void* decays, void* prev, void* final_state,
                       int b, int nc, int h, long long pn, void* stream) {
  return launch<float>(states, decays, prev, final_state, b, nc, h, pn, stream);
}

int remop_ssd_scan_bf16(const void* states, const void* decays, void* prev, void* final_state,
                        int b, int nc, int h, long long pn, void* stream) {
  return launch<__nv_bfloat16>(states, decays, prev, final_state, b, nc, h, pn, stream);
}

// dprev, dfinal, prev, decays, dstates, ddecays, partial (f32 [B, NC, H, parts]),
// b, nc, h, p * n, parts (ceil(p * n / (VEC * 256)) * 8), stream.
int remop_ssd_scan_bwd_f32(const void* dprev, const void* dfinal, const void* prev,
                           const void* decays, void* dstates, void* ddecays, void* partial, int b,
                           int nc, int h, long long pn, int parts, void* stream) {
  return launch_bwd<float>(dprev, dfinal, prev, decays, dstates, ddecays, partial, b, nc, h, pn,
                           parts, stream);
}

int remop_ssd_scan_bwd_bf16(const void* dprev, const void* dfinal, const void* prev,
                            const void* decays, void* dstates, void* ddecays, void* partial, int b,
                            int nc, int h, long long pn, int parts, void* stream) {
  return launch_bwd<__nv_bfloat16>(dprev, dfinal, prev, decays, dstates, ddecays, partial, b, nc,
                                   h, pn, parts, stream);
}

const char* remop_ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
