// SSD inter-chunk state scan for Hopper (sm_90a).
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

const char* remop_ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
