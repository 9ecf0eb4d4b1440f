// Blocked matrix product for Hopper (sm_90a): the BNLJ analogue.
//
// Replaces the TPU kernel src/repro/kernels/matmul/matmul.py:47
// (matmul_pallas): C[M, N] = A[M, K] @ B[K, N] with tiles (bm, bn, bk),
// M % bm == N % bn == K % bk == 0 (the caller pads), an f32 accumulator
// over K and the product cast once to the output dtype (bf16 or f32).
// Inputs are both bf16 or both f32; rows of A and B may be strided
// (lda, ldb elements), their elements are contiguous.
//
// The kernel computes what the TPU kernel computes, in the same rounds.
// One CTA owns one (bm, bn) output tile and keeps its f32 accumulator in
// registers.  It sweeps K in steps of bk, and each step is one staging
// round: the (bm, bk) A tile and the (bk, bn) B tile are copied into
// dynamic shared memory in the input dtype (single-buffered), then a
// __syncthreads(), then f32 FMAs on the CUDA cores, then a __syncthreads()
// before the next round overwrites the tiles.  So the planner's c_rounds
// (core/planner.py: matmul_costs, two tile copies per step) counts this
// kernel's staging rounds, and its vmem_bytes without the double buffer,
// (bm*bk + bk*bn) * elem, is the shared memory it asks for.  The plan is
// never re-tiled inside the kernel.  CTAs are numbered with the column tile
// fastest, so neighbouring CTAs share an A row panel (the BNLJ outer block).
//
// Thread mapping: with 256 threads a thread owns one column of the tile
// and every (256 / bn)-th row of it, so bn <= 256 and a thread holds at
// most ceil(bm / (256 / bn)) accumulators; the launcher takes at most 32
// (64 x 128 is 32 a thread).  The kernel is instantiated for NR in
// {1, 2, 4, 8, 12, 16, 24, 32} accumulators and launched with the smallest
// NR that holds the tile.  Neighbouring threads read neighbouring B columns
// (no bank conflicts) and one broadcast A element.  When every tile row
// starts 16 bytes aligned (bk, bn, lda, ldb multiples of 16 bytes, aligned
// bases) tiles are staged with 16-byte loads and a thread reads A 16 bytes
// at a time along K; else both go element by element.
//
// What bounds it on this card: for the products it is run at (M >= 4096,
// K >= 1024), the operations: 2*M*N*K FLOP against 989 TFLOP/s of dense
// bf16 tensor-core work, with the bytes of A, B and C far below 295
// operations per byte.  This kernel does not reach the tensor cores: its
// FMAs run on the CUDA cores (67 TFLOP/s f32), each one paired with a bf16
// to f32 conversion and a share of a shared-memory load, with no overlap
// of a round's copy and its products beyond what other resident CTAs give.
// It is the simple, correct port; wgmma, TMA and a ring of stages are the
// redesign's work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAcc = 32;
constexpr int kMaxSmem = 232448;  // shared memory one CTA can use (227 KB)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The four 32-bit words of a 16-byte load as floats, by bit operations.
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

// Copy a rows x cols tile (row stride ld in global memory) into shared
// memory, packed at row stride cols.
template <typename T, bool WIDE>
__device__ __forceinline__ void stage(T* __restrict__ dst, const T* __restrict__ src, int rows,
                                      int cols, int64_t ld) {
  if constexpr (WIDE) {
    constexpr int V = 16 / int(sizeof(T));
    const int vcols = cols / V;
    const int total = rows * vcols;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int r = i / vcols, v = i - r * vcols;
      reinterpret_cast<uint4*>(dst)[i] =
          __ldg(reinterpret_cast<const uint4*>(src + r * ld) + v);
    }
  } else {
    const int total = rows * cols;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      dst[i] = src[r * ld + c];
    }
  }
}

// One round's products: acc[i] += sum_kk A[row0 + i*rs, kk] * B[kk, col],
// kk ascending.  WIDE reads A 16 bytes at a time (bk * elem % 16 == 0).
template <typename T, int NR, bool WIDE>
__device__ __forceinline__ void products(const T* __restrict__ as, const T* __restrict__ bs,
                                         int bm, int bn, int bk, int row0, int rs, int col,
                                         float (&acc)[NR]) {
  if constexpr (WIDE) {
    constexpr int V = 16 / int(sizeof(T));
    for (int kk = 0; kk < bk; kk += V) {
      float bv[V];
#pragma unroll
      for (int u = 0; u < V; ++u) bv[u] = to_f32(bs[(kk + u) * bn + col]);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = row0 + i * rs;
        if (r < bm) {
          float av[V];
          unpack(*reinterpret_cast<const uint4*>(as + r * bk + kk), av);
#pragma unroll
          for (int u = 0; u < V; ++u) acc[i] = fmaf(av[u], bv[u], acc[i]);
        }
      }
    }
  } else {
    for (int kk = 0; kk < bk; ++kk) {
      const float bval = to_f32(bs[kk * bn + col]);
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = row0 + i * rs;
        if (r < bm) acc[i] = fmaf(to_f32(as[r * bk + kk]), bval, acc[i]);
      }
    }
  }
}

// grid (M/bm * N/bn): one CTA per output tile, the column tile fastest.
template <typename T, int NR, bool WIDE>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const T* __restrict__ a, const T* __restrict__ b, void* __restrict__ c,
                  int out_f32, int64_t n, int64_t k, int64_t lda, int64_t ldb, int bm, int bn,
                  int bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* as = reinterpret_cast<T*>(smem);  // [bm][bk]
  T* bs = as + bm * bk;                // [bk][bn]
  const int64_t gn = n / bn;
  const int64_t ti = blockIdx.x / gn, tj = blockIdx.x % gn;
  const T* a_panel = a + ti * bm * lda;  // rows ti*bm .. of A
  const T* b_panel = b + tj * bn;        // columns tj*bn .. of B
  const int rs = kThreads / bn;          // rows between a thread's accumulators
  const bool active = int(threadIdx.x) < rs * bn;
  const int col = threadIdx.x % bn, row0 = threadIdx.x / bn;

  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;
  for (int64_t k0 = 0; k0 < k; k0 += bk) {  // one staging round per step
    stage<T, WIDE>(as, a_panel + k0, bm, bk, lda);
    stage<T, WIDE>(bs, b_panel + k0 * ldb, bk, bn, ldb);
    __syncthreads();
    if (active) products<T, NR, WIDE>(as, bs, bm, bn, bk, row0, rs, col, acc);
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = row0 + i * rs;
    if (r < bm) {
      const int64_t off = (ti * bm + r) * n + tj * bn + col;
      if (out_f32) {
        static_cast<float*>(c)[off] = acc[i];
      } else {  // round to nearest even, as torch's .to(bfloat16)
        static_cast<__nv_bfloat16*>(c)[off] = __float2bfloat16(acc[i]);
      }
    }
  }
}

// The instantiation for accumulators NR and WIDE, after raising its
// dynamic shared-memory limit when it needs more than the default 48 KB.
template <typename T, int NR, bool WIDE>
auto kernel_for(int smem, cudaError_t* err) {
  auto kernel = matmul_kernel<T, NR, WIDE>;
  *err = smem > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
             : cudaSuccess;
  return kernel;
}

// Checks the tiles; on success sets the accumulators a thread holds and the
// shared memory a CTA stages.  The Python wrapper checks the same first.
template <typename T>
bool tiles_ok(int bm, int bn, int bk, int* nr, int* smem) {
  if (bm < 1 || bn < 1 || bk < 1 || bn > kThreads) return false;
  const int rs = kThreads / bn;
  const int64_t bytes = (int64_t(bm) * bk + int64_t(bk) * bn) * int64_t(sizeof(T));
  if ((bm + rs - 1) / rs > kMaxAcc || bytes > kMaxSmem) return false;
  *nr = (bm + rs - 1) / rs;
  *smem = int(bytes);
  return true;
}

// f(integral_constant<NR>, bool_constant<WIDE>) for the smallest NR >= nr.
template <typename F>
int dispatch(int nr, bool wide, F&& f) {
#define REMOP_MATMUL_NR(N)                                                            \
  if (nr <= N)                                                                        \
    return wide ? f(std::integral_constant<int, N>{}, std::true_type{})               \
                : f(std::integral_constant<int, N>{}, std::false_type{});
  REMOP_MATMUL_NR(1)
  REMOP_MATMUL_NR(2)
  REMOP_MATMUL_NR(4)
  REMOP_MATMUL_NR(8)
  REMOP_MATMUL_NR(12)
  REMOP_MATMUL_NR(16)
  REMOP_MATMUL_NR(24)
  REMOP_MATMUL_NR(32)
#undef REMOP_MATMUL_NR
  return cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* a, const void* b, void* c, int64_t m, int64_t n, int64_t k, int64_t lda,
           int64_t ldb, int bm, int bn, int bk, int out_f32, int wide, void* stream) {
  int nr, smem;
  if (!tiles_ok<T>(bm, bn, bk, &nr, &smem)) return cudaErrorInvalidValue;
  if (m < 0 || n < 0 || k < 0 || m % bm || n % bn || k % bk) return cudaErrorInvalidValue;
  const int64_t tiles = (m / bm) * (n / bn);
  if (tiles == 0) return cudaSuccess;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  constexpr int V = 16 / int(sizeof(T));
  if (wide && !(bk % V == 0 && bn % V == 0 && lda % V == 0 && ldb % V == 0 &&
                (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0))
    return cudaErrorInvalidValue;
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  auto st = static_cast<cudaStream_t>(stream);
  return dispatch(nr, wide != 0, [&](auto nr_c, auto wide_c) -> int {
    cudaError_t err;
    auto kernel = kernel_for<T, decltype(nr_c)::value, decltype(wide_c)::value>(smem, &err);
    if (err != cudaSuccess) return err;
    kernel<<<unsigned(tiles), kThreads, smem, st>>>(pa, pb, c, out_f32, n, k, lda, ldb, bm, bn,
                                                    bk);
    return cudaGetLastError();
  });
}

// CTAs of these tiles that one SM holds at once (registers, shared memory,
// threads), as the occupancy calculator reports it.
template <typename T>
int resident(int bm, int bn, int bk, int wide, int* ctas) {
  int nr, smem;
  if (!tiles_ok<T>(bm, bn, bk, &nr, &smem)) return cudaErrorInvalidValue;
  return dispatch(nr, wide != 0, [&](auto nr_c, auto wide_c) -> int {
    cudaError_t err;
    auto kernel = kernel_for<T, decltype(nr_c)::value, decltype(wide_c)::value>(smem, &err);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, kThreads, smem);
  });
}

}  // namespace

extern "C" {

// a [m, k] (row stride lda), b [k, n] (row stride ldb), c [m, n] contiguous;
// out_f32 selects f32 over bf16 output; wide asks for 16-byte staging.
int remop_matmul_f32(const void* a, const void* b, void* c, long long m, long long n, long long k,
                     long long lda, long long ldb, int bm, int bn, int bk, int out_f32, int wide,
                     void* stream) {
  return launch<float>(a, b, c, m, n, k, lda, ldb, bm, bn, bk, out_f32, wide, stream);
}

int remop_matmul_bf16(const void* a, const void* b, void* c, long long m, long long n,
                      long long k, long long lda, long long ldb, int bm, int bn, int bk,
                      int out_f32, int wide, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, m, n, k, lda, ldb, bm, bn, bk, out_f32, wide, stream);
}

// CTAs of these tiles resident on one SM, into *ctas (bf16 or f32 inputs).
int remop_matmul_resident_ctas_f32(int bm, int bn, int bk, int wide, int* ctas) {
  return resident<float>(bm, bn, bk, wide, ctas);
}

int remop_matmul_resident_ctas_bf16(int bm, int bn, int bk, int wide, int* ctas) {
  return resident<__nv_bfloat16>(bm, bn, bk, wide, ctas);
}

const char* remop_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
