// Bitonic sort and bitonic merge for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/merge_sort/merge_sort.py:
//   * remop_sort_blocks_*  <- sort_blocks (merge_sort.py:97, _bitonic_sort)
//   * remop_merge_pass_*   <- merge_pass  (merge_sort.py:115, _bitonic_merge)
//
// Both run the TPU kernels' compare-exchange network stage for stage, so the
// output is bit-identical to it, including the order of values under equal
// keys: keys go to min/max, and values follow `take_lo_first = k0 <= k1`.
// On a tie an ascending pair keeps its order and a descending pair swaps.
//
// What bounds them on this card: the bytes.  A pass reads and writes 8 bytes
// an element (a 4-byte key and a 4-byte value) and does a few integer
// operations per byte.  The design keeps as many of the network's stages as
// it can in shared memory:
//   * a chunk of 2^14 keys + 2^14 values is 128 KiB and fits one CTA's
//     dynamic shared memory, so sort_blocks (block <= 2^14) loads a chunk
//     once, runs all its stages in shared memory with __syncthreads between
//     stages, and stores it once;
//   * merge_pass with 2*run <= 2^14 does the same, reversing the second run
//     of each pair as it loads;
//   * merge_pass with 2*run > 2^14 runs the ladder's stages at distance
//     >= 2^14 as grid-wide passes over device memory (the first one reads
//     the second run reversed), then finishes the remaining stages of every
//     aligned 2^14-element chunk in shared memory.
// Keys are int32 or float32, values int32.  Float keys are compared with
// `<=`: NaN keys and the order of -0.0 against +0.0 are not pinned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunkLog2 = 14;
constexpr int kChunk = 1 << kChunkLog2;
constexpr int kThreads = 1024;
constexpr int kStageThreads = 256;

// One compare-exchange of the pair (a, b), as merge_sort.py:_cmp_exchange.
template <typename K>
__device__ __forceinline__ void cmp_exchange(K& a, K& b, int& va, int& vb,
                                             bool descending) {
  const bool take_lo_first = a <= b;
  const K lo = take_lo_first ? a : b;
  const K hi = take_lo_first ? b : a;
  const int v_lo = take_lo_first ? va : vb;
  const int v_hi = take_lo_first ? vb : va;
  if (descending) {
    a = hi; b = lo; va = v_hi; vb = v_lo;
  } else {
    a = lo; b = hi; va = v_lo; vb = v_hi;
  }
}

// Index of the first element of pair p at distance 2^j: p with a 0 bit
// inserted at position j.
__device__ __forceinline__ int64_t pair_first(int64_t p, int j) {
  return ((p >> j) << (j + 1)) | (p & ((int64_t(1) << j) - 1));
}

// Position, in the input, of logical element t of a pair of runs whose second
// run is read reversed (merge_sort.py:_merge_pair_kernel): t < run reads t,
// t >= run reads 3*run - 1 - t, all relative to the pair's start.
__device__ __forceinline__ int64_t reversed_source(int64_t t, int64_t run) {
  const int64_t q = t & (2 * run - 1);
  return q < run ? t : t - q + 3 * run - 1 - q;
}

// sort_blocks: one CTA sorts `chunk / block` adjacent blocks in shared memory.
// Stage (k, j) of block-local index i has direction bit (i >> k) & 1, which is
// _bitonic_sort's `(group >> (k - 1 - j)) & 1` with group = i >> (j + 1).
template <typename K>
__global__ void sort_chunks_kernel(const K* __restrict__ kin,
                                   const int* __restrict__ vin,
                                   K* __restrict__ kout, int* __restrict__ vout,
                                   int chunk, int block_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  K* ks = reinterpret_cast<K*>(smem);
  int* vs = reinterpret_cast<int*>(ks + chunk);
  const int64_t base = int64_t(blockIdx.x) * chunk;
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) {
    ks[t] = kin[base + t];
    vs[t] = vin[base + t];
  }
  __syncthreads();
  const int block_mask = (1 << block_log2) - 1;
  const int pairs = chunk >> 1;
  for (int k = 1; k <= block_log2; ++k) {
    for (int j = k - 1; j >= 0; --j) {
      for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
        const int i = int(pair_first(p, j));
        const int l = i + (1 << j);
        const bool descending = ((i & block_mask) >> k) & 1;
        K a = ks[i], b = ks[l];
        int va = vs[i], vb = vs[l];
        cmp_exchange(a, b, va, vb, descending);
        ks[i] = a; ks[l] = b; vs[i] = va; vs[l] = vb;
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) {
    kout[base + t] = ks[t];
    vout[base + t] = vs[t];
  }
}

// merge_pass in shared memory: the all-ascending ladder's stages j = top-1..0
// on each chunk.  With run > 0 every aligned 2*run span of the chunk is a pair
// of sorted runs and the second is reversed as it loads; with run == 0 the
// chunk continues a ladder whose wider stages already ran (in place is fine:
// a CTA loads its whole chunk before it stores any of it).
template <typename K>
__global__ void merge_chunks_kernel(const K* kin, const int* vin, K* kout,
                                    int* vout, int chunk, int run, int top) {
  extern __shared__ __align__(16) unsigned char smem[];
  K* ks = reinterpret_cast<K*>(smem);
  int* vs = reinterpret_cast<int*>(ks + chunk);
  const int64_t base = int64_t(blockIdx.x) * chunk;
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) {
    const int64_t src = run > 0 ? reversed_source(t, run) : t;
    ks[t] = kin[base + src];
    vs[t] = vin[base + src];
  }
  __syncthreads();
  const int pairs = chunk >> 1;
  for (int j = top - 1; j >= 0; --j) {
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int i = int(pair_first(p, j));
      const int l = i + (1 << j);
      K a = ks[i], b = ks[l];
      int va = vs[i], vb = vs[l];
      cmp_exchange(a, b, va, vb, false);
      ks[i] = a; ks[l] = b; vs[i] = va; vs[l] = vb;
    }
    __syncthreads();
  }
  for (int t = threadIdx.x; t < chunk; t += blockDim.x) {
    kout[base + t] = ks[t];
    vout[base + t] = vs[t];
  }
}

// One grid-wide stage of the ascending ladder at distance 2^j.  With run > 0
// (the ladder's first stage, 2^j == run) the second element of each pair is
// read from the reversed second run.  Every thread owns whole pairs, so the
// later stages run in place (kin == kout).
template <typename K>
__global__ void merge_stage_kernel(const K* kin, const int* vin, K* kout,
                                   int* vout, int64_t pairs, int j,
                                   int64_t run) {
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t p = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; p < pairs;
       p += stride) {
    const int64_t i = pair_first(p, j);
    const int64_t l = i + (int64_t(1) << j);
    const int64_t src = run > 0 ? reversed_source(l, run) : l;
    K a = kin[i], b = kin[src];
    int va = vin[i], vb = vin[src];
    cmp_exchange(a, b, va, vb, false);
    kout[i] = a; kout[l] = b; vout[i] = va; vout[l] = vb;
  }
}

int log2_exact(int64_t x) {
  int r = 0;
  while ((int64_t(1) << r) < x) ++r;
  return r;
}

// Widest power-of-two chunk (at most 2^14) made of whole `unit`-element spans
// that tiles n.
int chunk_for(int64_t n, int64_t unit) {
  int64_t chunk = unit;
  while (chunk < kChunk && n % (2 * chunk) == 0) chunk *= 2;
  return int(chunk);
}

template <typename K>
cudaError_t allow_big_smem() {
  const int bytes = kChunk * int(sizeof(K) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      sort_chunks_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(merge_chunks_kernel<K>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename K>
int sort_blocks_impl(const void* keys, const void* values, void* keys_out,
                     void* values_out, int64_t n, int64_t block, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (block < 1 || block > kChunk || (block & (block - 1)) || n % block) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = allow_big_smem<K>();
  if (err != cudaSuccess) return err;
  const int chunk = chunk_for(n, block);
  const int threads = chunk >= 2 * kThreads ? kThreads : (chunk > 1 ? chunk / 2 : 1);
  const size_t smem = size_t(chunk) * (sizeof(K) + sizeof(int));
  sort_chunks_kernel<K><<<unsigned(n / chunk), threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const K*>(keys), static_cast<const int*>(values),
      static_cast<K*>(keys_out), static_cast<int*>(values_out), chunk,
      log2_exact(block));
  return cudaGetLastError();
}

template <typename K>
int merge_pass_impl(const void* keys, const void* values, void* keys_out,
                    void* values_out, int64_t n, int64_t run, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (run < 1 || (run & (run - 1)) || n % (2 * run)) return cudaErrorInvalidValue;
  cudaError_t err = allow_big_smem<K>();
  if (err != cudaSuccess) return err;
  auto s = static_cast<cudaStream_t>(stream);
  const K* kin = static_cast<const K*>(keys);
  const int* vin = static_cast<const int*>(values);
  K* kout = static_cast<K*>(keys_out);
  int* vout = static_cast<int*>(values_out);
  const int top = log2_exact(2 * run);
  if (2 * run <= kChunk) {
    const int chunk = chunk_for(n, 2 * run);
    const int threads = chunk >= 2 * kThreads ? kThreads : chunk / 2;
    merge_chunks_kernel<K><<<unsigned(n / chunk), threads,
                             size_t(chunk) * (sizeof(K) + sizeof(int)), s>>>(
        kin, vin, kout, vout, chunk, int(run), top);
    return cudaGetLastError();
  }
  const int64_t pairs = n / 2;
  const int64_t want = (pairs + kStageThreads - 1) / kStageThreads;
  const unsigned grid = unsigned(want < (1 << 20) ? want : (1 << 20));
  merge_stage_kernel<K><<<grid, kStageThreads, 0, s>>>(kin, vin, kout, vout,
                                                       pairs, top - 1, run);
  for (int j = top - 2; j >= kChunkLog2; --j) {
    merge_stage_kernel<K><<<grid, kStageThreads, 0, s>>>(kout, vout, kout, vout,
                                                         pairs, j, 0);
  }
  merge_chunks_kernel<K><<<unsigned(n / kChunk), kThreads,
                           size_t(kChunk) * (sizeof(K) + sizeof(int)), s>>>(
      kout, vout, kout, vout, kChunk, 0, kChunkLog2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int remop_sort_blocks_i32(const void* keys, const void* values, void* keys_out,
                          void* values_out, long long n, long long block,
                          void* stream) {
  return sort_blocks_impl<int32_t>(keys, values, keys_out, values_out, n, block,
                                   stream);
}

int remop_sort_blocks_f32(const void* keys, const void* values, void* keys_out,
                          void* values_out, long long n, long long block,
                          void* stream) {
  return sort_blocks_impl<float>(keys, values, keys_out, values_out, n, block,
                                 stream);
}

int remop_merge_pass_i32(const void* keys, const void* values, void* keys_out,
                         void* values_out, long long n, long long run,
                         void* stream) {
  return merge_pass_impl<int32_t>(keys, values, keys_out, values_out, n, run,
                                  stream);
}

int remop_merge_pass_f32(const void* keys, const void* values, void* keys_out,
                         void* values_out, long long n, long long run,
                         void* stream) {
  return merge_pass_impl<float>(keys, values, keys_out, values_out, n, run,
                                stream);
}

const char* remop_merge_sort_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
