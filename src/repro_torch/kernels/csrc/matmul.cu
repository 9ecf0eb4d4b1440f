// Blocked matrix product for Hopper (sm_90a): the BNLJ analogue.
//
// Replaces the TPU kernel src/repro/kernels/matmul/matmul.py:47
// (matmul_pallas): C[M, N] = A[M, K] @ B[K, N] with tiles (bm, bn, bk), an
// f32 accumulator over K and the product cast once to the output dtype
// (bf16 or f32).  Inputs are both bf16 or both f32; rows of A and B may be
// strided (lda, ldb elements), their elements are contiguous.  M, N and K
// need not be multiples of the tiles: the last row, column and K tiles are
// masked (out-of-range elements read as zero, out-of-range outputs are not
// written), so the caller does not pad.
//
// Both kernels keep the planner's contract (core/planner.py: matmul_costs).
// One CTA owns one planned (bm, bn) output tile; the plan is never re-tiled.
// It sweeps K in steps of bk, and each step copies one (bm, bk) A tile and
// one (bk, bn) B tile into shared memory: one of the planner's rounds.  A
// step that does not fit a CTA's shared memory is copied in sub-steps of
// depth `sub` (sub divides the step), so the same tiles still cross in that
// round, just not all resident at once.  CTAs are numbered with the column
// tile fastest, so neighbouring CTAs share an A row panel (the BNLJ outer
// block).
//
// bf16: the tensor cores (wgmma_kernel).  wgmma's M is 64 and the planned
// bm is 8 or 24, so the kernel computes C^T = B^T A^T: bn becomes wgmma's M
// in 64-row slabs, one consumer warpgroup a slab (ceil(bn / 64) of them),
// and bm becomes its N, padded up to the next of kMmaN.  B^T is wgmma's A
// operand, read MN-major (the B tile as stored, N contiguous) through the
// instruction's transpose bit; A^T is its B operand, K-major (the A tile as
// stored).  Each K step's tiles go through a ring of two shared-memory
// slots, the planner's double-buffered working set (matmul_vmem with
// double_buffer=True, without the accumulator, which lives in registers).
// One producer warp fills a slot while the warpgroups run wgmma on the
// other: on the TMA route one thread issues cp.async.bulk.tensor boxes of
// the planned tile ([bm, 64] of A and [64, 64] of B, 128-byte swizzle;
// out-of-range boxes read as zero) and the slot's mbarrier counts their
// bytes; on the element route (a row stride or base not 16-byte aligned,
// or bk or bn not a multiple of 64) the warp copies element by element,
// masked, into the same swizzled layout.  The ring is zeroed once, so the
// rows between bm and the padded N stay zero.  A warpgroup holds N / 2 f32
// accumulators a thread; kMaxAccRegs bounds the warpgroups for a given N.
//
// f32: exact f32 FMAs on the CUDA cores (f32_kernel).  TF32 wgmma keeps 10
// mantissa bits and would not compute what matmul_pallas computes in f32.
// With 256 threads a thread owns one column of the tile and every (256 /
// bn)-th row of it (at most 32 accumulators); each sub-step is staged
// single-buffered, then a __syncthreads(), then the FMAs.
//
// What bounds it on this card: at the products it runs (M >= 4096, K >=
// 1024), the operations bound any tile of 64 or more rows (2*M*N*K FLOP at
// 989 TFLOP/s dense bf16); under the planned tiles the bytes each plan
// moves (the planner's D: every B panel read once for each row tile of A)
// are the larger bound: 31 GB under (24, 128, 128) at gemma-7b FFN up.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxSmem = 232448;  // shared memory one CTA can use (227 KB)

// ----------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ----------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32MaxAcc = 32;

__device__ __forceinline__ void unpack(const uint4& w, float (&dst)[4]) {
  dst[0] = __uint_as_float(w.x);
  dst[1] = __uint_as_float(w.y);
  dst[2] = __uint_as_float(w.z);
  dst[3] = __uint_as_float(w.w);
}

// Copy a rows x cols tile (row stride ld in global memory) into shared
// memory packed at row stride cols; elements at or past rows_valid /
// cols_valid are zero.  WIDE: cols and cols_valid are multiples of 4.
template <bool WIDE>
__device__ __forceinline__ void stage_f32(float* __restrict__ dst, const float* __restrict__ src,
                                          int rows, int cols, int64_t ld, int rows_valid,
                                          int cols_valid) {
  if constexpr (WIDE) {
    const int vcols = cols / 4;
    for (int i = threadIdx.x; i < rows * vcols; i += kF32Threads) {
      const int r = i / vcols, v = i - r * vcols;
      reinterpret_cast<uint4*>(dst)[i] =
          r < rows_valid && 4 * v < cols_valid
              ? __ldg(reinterpret_cast<const uint4*>(src + r * ld) + v)
              : make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += kF32Threads) {
      const int r = i / cols, c = i - r * cols;
      dst[i] = r < rows_valid && c < cols_valid ? src[r * ld + c] : 0.f;
    }
  }
}

// One sub-step's products: acc[i] += sum_kk A[row0 + i*rs, kk] * B[kk, col],
// kk ascending over len.  WIDE reads A 16 bytes at a time (len % 4 == 0).
template <int NR, bool WIDE>
__device__ __forceinline__ void products_f32(const float* __restrict__ as,
                                             const float* __restrict__ bs, int bm, int bn,
                                             int len, int row0, int rs, int col,
                                             float (&acc)[NR]) {
  if constexpr (WIDE) {
    for (int kk = 0; kk < len; kk += 4) {
      float bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) bv[u] = bs[(kk + u) * bn + col];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = row0 + i * rs;
        if (r < bm) {
          float av[4];
          unpack(*reinterpret_cast<const uint4*>(as + r * len + kk), av);
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[i] = fmaf(av[u], bv[u], acc[i]);
        }
      }
    }
  } else {
    for (int kk = 0; kk < len; ++kk) {
      const float bval = bs[kk * bn + col];
#pragma unroll
      for (int i = 0; i < NR; ++i) {
        const int r = row0 + i * rs;
        if (r < bm) acc[i] = fmaf(as[r * len + kk], bval, acc[i]);
      }
    }
  }
}

// grid (ceil(M/bm) * ceil(N/bn)): one CTA per output tile, the column tile
// fastest.
template <int NR, bool WIDE>
__global__ void __launch_bounds__(kF32Threads)
    f32_kernel(const float* __restrict__ a, const float* __restrict__ b, void* __restrict__ c,
               int out_f32, int64_t m, int64_t n, int64_t k, int64_t lda, int64_t ldb, int bm,
               int bn, int bk, int sub) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem);  // [bm][len]
  float* bs = as + bm * sub;                   // [len][bn]
  const int64_t gn = (n + bn - 1) / bn;
  const int64_t row0 = (blockIdx.x / gn) * bm, col0 = (blockIdx.x % gn) * bn;
  const int rows_valid = m - row0 < bm ? int(m - row0) : bm;
  const int cols_valid = n - col0 < bn ? int(n - col0) : bn;
  const int rs = kF32Threads / bn;  // rows between a thread's accumulators
  const bool active = int(threadIdx.x) < rs * bn;
  const int col = threadIdx.x % bn, trow = threadIdx.x / bn;

  float acc[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) acc[i] = 0.f;
  for (int64_t k0 = 0; k0 < k; k0 += bk) {             // one planner round per step
    for (int j0 = 0; j0 < bk && k0 + j0 < k; j0 += sub) {  // in sub-steps that fit
      const int len = min(sub, bk - j0);
      const int kv = k - k0 - j0 < len ? int(k - k0 - j0) : len;
      stage_f32<WIDE>(as, a + row0 * lda + k0 + j0, bm, len, lda, rows_valid, kv);
      stage_f32<WIDE>(bs, b + (k0 + j0) * ldb + col0, len, bn, ldb, kv, cols_valid);
      __syncthreads();
      if (active) products_f32<NR, WIDE>(as, bs, bm, bn, len, trow, rs, col, acc);
      __syncthreads();
    }
  }
  if (!active || col >= cols_valid) return;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = trow + i * rs;
    if (r < rows_valid) {
      const int64_t off = (row0 + r) * n + col0 + col;
      if (out_f32) {
        static_cast<float*>(c)[off] = acc[i];
      } else {  // round to nearest even, as torch's .to(bfloat16)
        static_cast<__nv_bfloat16*>(c)[off] = __float2bfloat16(acc[i]);
      }
    }
  }
}

template <int NR, bool WIDE>
auto f32_kernel_for(int smem, cudaError_t* err) {
  auto kernel = f32_kernel<NR, WIDE>;
  *err = smem > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
             : cudaSuccess;
  return kernel;
}

// Checks the tiles and sub-step; on success sets the accumulators a thread
// holds and the shared memory a CTA stages.
bool f32_ok(int bm, int bn, int bk, int sub, int* nr, int* smem) {
  if (bm < 1 || bn < 1 || bk < 1 || bn > kF32Threads || sub < 1 || sub > bk) return false;
  const int rs = kF32Threads / bn;
  const int64_t bytes = int64_t(bm + bn) * sub * int64_t(sizeof(float));
  if ((bm + rs - 1) / rs > kF32MaxAcc || bytes > kMaxSmem) return false;
  *nr = (bm + rs - 1) / rs;
  *smem = int(bytes);
  return true;
}

// f(integral_constant<NR>, bool_constant<WIDE>) for the smallest NR >= nr.
template <typename F>
int f32_dispatch(int nr, bool wide, F&& f) {
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

int launch_f32(const void* a, const void* b, void* c, int64_t m, int64_t n, int64_t k,
               int64_t lda, int64_t ldb, int bm, int bn, int bk, int sub, int out_f32, int wide,
               void* stream) {
  int nr, smem;
  if (!f32_ok(bm, bn, bk, sub, &nr, &smem)) return cudaErrorInvalidValue;
  if (m < 0 || n < 0 || k < 0) return cudaErrorInvalidValue;
  const int64_t tiles = ((m + bm - 1) / bm) * ((n + bn - 1) / bn);
  if (tiles == 0) return cudaSuccess;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  if (wide && !(bk % 4 == 0 && bn % 4 == 0 && sub % 4 == 0 && k % 4 == 0 && n % 4 == 0 &&
                lda % 4 == 0 && ldb % 4 == 0 &&
                (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return f32_dispatch(nr, wide != 0, [&](auto nr_c, auto wide_c) -> int {
    cudaError_t err;
    auto kernel = f32_kernel_for<decltype(nr_c)::value, decltype(wide_c)::value>(smem, &err);
    if (err != cudaSuccess) return err;
    kernel<<<unsigned(tiles), kF32Threads, smem, st>>>(static_cast<const float*>(a),
                                                       static_cast<const float*>(b), c, out_f32,
                                                       m, n, k, lda, ldb, bm, bn, bk, sub);
    return cudaGetLastError();
  });
}

// ----------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ----------------------------------------------------------------------------

constexpr int kMmaN[] = {8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256};
constexpr int kProducerThreads = 32;  // one warp, after the consumer warpgroups
constexpr int kMaxAccRegs = 512;      // N x warpgroups: N / 2 f32 accumulators a thread

__host__ __device__ constexpr int max_warpgroups(int n_pad) {
  return kMaxAccRegs / n_pad < 4 ? kMaxAccRegs / n_pad : 4;
}

// The shared memory of one CTA: two ring slots, each an A region of
// ceil(sub / 64) chunks of n_pad rows x 128 bytes (K-major) and a B region
// of `wg` chunks of sub rows x 128 bytes (MN-major); 1024 bytes of slack to
// align the slots to the swizzle atom; four mbarriers.
struct Ring {
  int n_pad, wg, sub, a_bytes, b_bytes;
  __host__ __device__ int slot() const { return a_bytes + b_bytes; }
  __host__ __device__ int smem() const { return 1024 + 2 * slot() + 4 * 8; }
};

__host__ __device__ inline Ring make_ring(int n_pad, int bn, int sub) {
  Ring r;
  r.n_pad = n_pad;
  r.wg = (bn + 63) / 64;
  r.sub = sub;
  r.a_bytes = (sub + 63) / 64 * n_pad * 128;
  r.b_bytes = r.wg * sub * 128;
  return r;
}

int mma_n(int bm) {
  for (int n : kMmaN)
    if (bm <= n) return n;
  return -1;
}

// Checks tiles, sub-step and route; on success sets the ring.
bool ring_ok(int bm, int bn, int bk, int sub, int tma, Ring* ring) {
  if (bm < 1 || bn < 1 || bk < 1 || bn > 256 || sub < 16 || sub % 16) return false;
  const int n_pad = mma_n(bm);
  if (n_pad < 0) return false;
  const Ring r = make_ring(n_pad, bn, sub);
  if (r.wg > max_warpgroups(n_pad) || r.smem() > kMaxSmem) return false;
  const int bk16 = (bk + 15) / 16 * 16;
  if (tma ? (bk % 64 || bn % 64 || sub % 64 || bk % sub) : bk16 % sub) return false;
  *ring = r;
  return true;
}

// grid (ceil(M/bm) * ceil(N/bn)): one CTA per output tile, the column tile
// fastest; 128 threads a consumer warpgroup, then the producer warp.
template <int N>
__global__ void __launch_bounds__(128 * max_warpgroups(N) + kProducerThreads)
    wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b,
                 const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                 void* __restrict__ c, int out_f32, int64_t m, int64_t n, int64_t k,
                 int64_t lda, int64_t ldb, int bm, int bn, int bk, int sub, int tma) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  const Ring ring = make_ring(N, bn, sub);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * ring.slot());
  uint64_t* empty = full + 2;
  const int64_t gn = (n + bn - 1) / bn;
  const int64_t row0 = (blockIdx.x / gn) * bm, col0 = (blockIdx.x % gn) * bn;
  const int64_t steps = (k + bk - 1) / bk;
  const int subs = tma ? bk / sub : (bk + 15) / 16 * 16 / sub;  // sub-steps a K step

  // Zero the ring once: the padding rows and columns are never written again.
  for (int i = 16 * threadIdx.x; i < 2 * ring.slot(); i += 16 * blockDim.x)
    *reinterpret_cast<uint4*>(smem + i) = make_uint4(0u, 0u, 0u, 0u);
  hopper::fence_proxy_async();
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4 * ring.wg);  // one arrival a consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 4 * ring.wg) {
    // -- producer: fill slot i % 2 with sub-step i once its last use is done --
    int i = 0;
    for (int64_t t = 0; t < steps; ++t) {
      for (int j = 0; j < subs; ++j, ++i) {
        const int64_t kbeg = t * bk + int64_t(j) * sub;
        if (kbeg >= k) break;
        const int klen = min(sub, bk - j * sub);
        const int s = i & 1;
        hopper::mbar_wait(&empty[s], ((i >> 1) & 1) ^ 1);
        unsigned char* sa = smem + s * ring.slot();
        unsigned char* sb = sa + ring.a_bytes;
        if (tma) {
          if (lane == 0) {
            const int chunks = sub / 64;
            hopper::mbar_arrive_expect_tx(&full[s], uint32_t(chunks * (bm + 64 * ring.wg) * 128));
            for (int q = 0; q < chunks; ++q) {
              hopper::tma_load_2d(sa + q * N * 128, &map_a, &full[s], int(kbeg + 64 * q),
                                  int(row0));
              for (int w = 0; w < ring.wg; ++w)
                hopper::tma_load_2d(sb + (w * sub + 64 * q) * 128, &map_b, &full[s],
                                    int(col0 + 64 * w), int(kbeg + 64 * q));
            }
          }
        } else {
          const int a_cols = ring.a_bytes / (N * 2);
          for (int e = lane; e < N * a_cols; e += 32) {
            const int r = e / a_cols, kc = e - r * a_cols;
            __nv_bfloat16 v = __float2bfloat16(0.f);
            if (r < bm && row0 + r < m && kc < klen && kbeg + kc < k)
              v = a[(row0 + r) * lda + kbeg + kc];
            *reinterpret_cast<__nv_bfloat16*>(sa + (kc >> 6) * N * 128 +
                                              hopper::sw128_offset(r, kc & 63)) = v;
          }
          const int b_cols = 64 * ring.wg;
          for (int e = lane; e < sub * b_cols; e += 32) {
            const int kr = e / b_cols, nc = e - kr * b_cols;
            __nv_bfloat16 v = __float2bfloat16(0.f);
            if (kr < klen && kbeg + kr < k && nc < bn && col0 + nc < n)
              v = b[(kbeg + kr) * ldb + col0 + nc];
            *reinterpret_cast<__nv_bfloat16*>(sb + (nc >> 6) * sub * 128 +
                                              hopper::sw128_offset(kr, nc & 63)) = v;
          }
          hopper::fence_proxy_async();
          __syncwarp();
          if (lane == 0) hopper::mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // -- consumer warpgroup w: the 64 columns [64w, 64w + 64) of the B tile --
    const int w = warp / 4;
    float d[N / 2];
#pragma unroll
    for (int r = 0; r < N / 2; ++r) d[r] = 0.f;
    int i = 0;
    for (int64_t t = 0; t < steps; ++t) {
      for (int j = 0; j < subs; ++j, ++i) {
        const int64_t kbeg = t * bk + int64_t(j) * sub;
        if (kbeg >= k) break;
        const int klen = min(sub, bk - j * sub);
        const int s = i & 1;
        hopper::mbar_wait(&full[s], (i >> 1) & 1);
        const uint32_t sa = hopper::smem_u32(smem + s * ring.slot());
        const uint32_t sb = sa + ring.a_bytes + w * sub * 128;
        hopper::wgmma_fence();
        hopper::fence_operands(d);
        for (int kk = 0; kk < (klen + 15) / 16; ++kk) {
          const uint64_t da = hopper::desc_sw128(sb + kk * 2048, sub * 128, 1024);
          const uint64_t db = hopper::desc_sw128(sa + (kk >> 2) * N * 128 + (kk & 3) * 32, 16,
                                                 1024);
          hopper::wgmma_bf16<1, 0>(d, da, db);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(d);
        if (lane == 0) hopper::mbar_arrive(&empty[s]);
      }
    }
    // d holds C^T[64w + row][col] in the wgmma fragment layout; write C.
    const int row_base = 64 * w + 16 * (warp % 4) + (lane >> 2);
#pragma unroll
    for (int r = 0; r < N / 2; ++r) {
      const int nrow = row_base + ((r >> 1) & 1) * 8;
      const int mcol = 8 * (r >> 2) + 2 * (lane & 3) + (r & 1);
      if (mcol < bm && nrow < bn && row0 + mcol < m && col0 + nrow < n) {
        const int64_t off = (row0 + mcol) * n + col0 + nrow;
        if (out_f32) {
          static_cast<float*>(c)[off] = d[r];
        } else {  // round to nearest even, as torch's .to(bfloat16)
          static_cast<__nv_bfloat16*>(c)[off] = __float2bfloat16(d[r]);
        }
      }
    }
  }
}

// f(integral_constant<N>) for the wgmma N n_pad.
template <typename F>
int bf16_dispatch(int n_pad, F&& f) {
  switch (n_pad) {
#define REMOP_MATMUL_N(N) \
  case N:                 \
    return f(std::integral_constant<int, N>{});
    REMOP_MATMUL_N(8)
    REMOP_MATMUL_N(16)
    REMOP_MATMUL_N(24)
    REMOP_MATMUL_N(32)
    REMOP_MATMUL_N(40)
    REMOP_MATMUL_N(48)
    REMOP_MATMUL_N(56)
    REMOP_MATMUL_N(64)
    REMOP_MATMUL_N(80)
    REMOP_MATMUL_N(96)
    REMOP_MATMUL_N(112)
    REMOP_MATMUL_N(128)
    REMOP_MATMUL_N(160)
    REMOP_MATMUL_N(192)
    REMOP_MATMUL_N(224)
    REMOP_MATMUL_N(256)
#undef REMOP_MATMUL_N
    default:
      return cudaErrorInvalidValue;
  }
}

template <int N>
auto bf16_kernel_for(int smem, cudaError_t* err) {
  auto kernel = wgmma_kernel<N>;
  *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return kernel;
}

int launch_bf16(const void* a, const void* b, void* c, int64_t m, int64_t n, int64_t k,
                int64_t lda, int64_t ldb, int bm, int bn, int bk, int sub, int out_f32, int tma,
                void* stream) {
  Ring ring;
  if (!ring_ok(bm, bn, bk, sub, tma, &ring)) return cudaErrorInvalidValue;
  if (m < 0 || n < 0 || k < 0) return cudaErrorInvalidValue;
  const int64_t tiles = ((m + bm - 1) / bm) * ((n + bn - 1) / bn);
  if (tiles == 0) return cudaSuccess;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  CUtensorMap map_a{}, map_b{};
  if (tma) {
    const bool aligned = k > 0 && lda % 8 == 0 && ldb % 8 == 0 &&
                         (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0;
    if (!aligned) return cudaErrorInvalidValue;
    if (!hopper::encode_bf16_2d(&map_a, a, m, k, lda, bm, 64) ||
        !hopper::encode_bf16_2d(&map_b, b, k, n, ldb, 64, 64))
      return cudaErrorNotSupported;
  }
  auto st = static_cast<cudaStream_t>(stream);
  return bf16_dispatch(ring.n_pad, [&](auto n_c) -> int {
    cudaError_t err;
    auto kernel = bf16_kernel_for<decltype(n_c)::value>(ring.smem(), &err);
    if (err != cudaSuccess) return err;
    kernel<<<unsigned(tiles), 128 * ring.wg + kProducerThreads, ring.smem(), st>>>(
        map_a, map_b, static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        c, out_f32, m, n, k, lda, ldb, bm, bn, bk, sub, tma);
    return cudaGetLastError();
  });
}

// out: CTAs resident on one SM (the occupancy calculator), registers a
// thread, local (spilled) bytes a thread, dynamic shared memory, threads.
template <typename K>
int occupancy(K kernel, int threads, int smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, threads, smem);
  out[1] = attr.numRegs;
  out[2] = int(attr.localSizeBytes);
  out[3] = smem;
  out[4] = threads;
  return err;
}

}  // namespace

extern "C" {

// a [m, k] (row stride lda), b [k, n] (row stride ldb), c [m, n] contiguous;
// out_f32 selects f32 over bf16 output.  bf16: tma picks the TMA route (else
// the element route); f32: wide asks for 16-byte staging.
int remop_matmul_bf16(const void* a, const void* b, void* c, long long m, long long n,
                      long long k, long long lda, long long ldb, int bm, int bn, int bk, int sub,
                      int out_f32, int tma, void* stream) {
  return launch_bf16(a, b, c, m, n, k, lda, ldb, bm, bn, bk, sub, out_f32, tma, stream);
}

int remop_matmul_f32(const void* a, const void* b, void* c, long long m, long long n, long long k,
                     long long lda, long long ldb, int bm, int bn, int bk, int sub, int out_f32,
                     int wide, void* stream) {
  return launch_f32(a, b, c, m, n, k, lda, ldb, bm, bn, bk, sub, out_f32, wide, stream);
}

// Occupancy of the instantiation these tiles launch, into out[5] (see
// occupancy above).
int remop_matmul_occupancy_bf16(int bm, int bn, int bk, int sub, int tma, int* out) {
  Ring ring;
  if (!ring_ok(bm, bn, bk, sub, tma, &ring)) return cudaErrorInvalidValue;
  return bf16_dispatch(ring.n_pad, [&](auto n_c) -> int {
    cudaError_t err;
    auto kernel = bf16_kernel_for<decltype(n_c)::value>(ring.smem(), &err);
    if (err != cudaSuccess) return err;
    return occupancy(kernel, 128 * ring.wg + kProducerThreads, ring.smem(), out);
  });
}

int remop_matmul_occupancy_f32(int bm, int bn, int bk, int sub, int wide, int* out) {
  int nr, smem;
  if (!f32_ok(bm, bn, bk, sub, &nr, &smem)) return cudaErrorInvalidValue;
  return f32_dispatch(nr, wide != 0, [&](auto nr_c, auto wide_c) -> int {
    cudaError_t err;
    auto kernel = f32_kernel_for<decltype(nr_c)::value, decltype(wide_c)::value>(smem, &err);
    if (err != cudaSuccess) return err;
    return occupancy(kernel, kF32Threads, smem, out);
  });
}

const char* remop_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
