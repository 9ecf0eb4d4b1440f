// Bitonic sort and bitonic merge for Hopper (sm_90a), on one register-blocked
// stage engine.
//
// Replaces the TPU kernels of src/repro/kernels/merge_sort/merge_sort.py:
//   * remop_sort_blocks_*  <- sort_blocks (merge_sort.py:97, _bitonic_sort)
//   * remop_merge_pass_*   <- merge_pass  (merge_sort.py:115, _bitonic_merge)
//
// Both run the TPU kernels' compare-exchange network stage for stage and pair
// for pair, so the output is bit-identical to it, including the order of
// values under equal keys: keys go to min/max (-0.0 below +0.0, as
// jnp.minimum takes them), and values follow `take_lo_first = a <= b`, where
// `a` is the element of the lower index.  The stages of one pass are only
// regrouped into trips through registers and shared memory: pairs within a
// stage are disjoint, so any grouping that keeps the stages in order gives
// the same bits.
//
// What bounds them on this card: the bytes (8 an element a pass, a 4-byte key
// and a 4-byte value) and, inside a tile, shared memory.  The design:
//   * The host plans the launches (merge_sort.py:plan) and passes them here;
//     nothing below recomputes them.  A launch is one pass over device memory:
//     one CTA loads a tile of at most 2^14 (key, value) pairs, runs a range of
//     the network's stages on it and stores it.  A tile is `width` contiguous
//     elements ("chunk") or `rows` rows at stride rows*width by `width`
//     columns ("strided"), so a merge of two runs longer than 2^13 is two
//     passes: the strided tile runs the stages at distances of a tile and
//     more, then an aligned chunk tile runs the rest in place.  The first pass
//     of a merge reads each second run reversed as it loads.  The plan takes
//     tiles of 2^13 where the stages fit: two such CTAs share an SM, and one's
//     loads and stores overlap the other's stages.
//   * The engine: each of up to 512 threads holds E = 32 tile elements in
//     registers, whose tile indices differ in a window of 5 consecutive bits.
//     Stages whose distance bit lies in the window run in registers; a wider
//     stage first re-lays the tile through shared memory into the window that
//     covers it and the next stages, so one round trip buys up to 5 stages
//     (a 2^14 sort: 22 round trips for 105 stages, plus one each to and from
//     the layout in which loads and stores are coalesced).
//   * Shared memory holds (key, value) as one 8-byte pair, XOR-swizzled (pair t
//     at t ^ ((t >> 5) & 15)): at any window, a half-warp touches all 32 banks
//     once.  A relayout between windows below bit L trades elements only among
//     the 2^L threads of equal tid >> L, so it waits on a warp (L <= 5) or a
//     named barrier of that group, not on the CTA: warps drift apart, and one
//     warp's relayout overlaps another's compare-exchanges.  Stages run with
//     their directions known at compile time.
// Keys are int32 or float32, values int32.  Float keys go to min/max bit for
// bit as jnp.minimum/jnp.maximum give them on the CPU: a NaN spreads to both
// keys of its pair with its own bits (payload and sign), and of two NaNs min
// is `a` and max is `b`, swapped when `a` has its sign bit set.  A float tile
// runs that rule only when it holds a NaN as it loads (min and max of other
// keys make none); the int32 instantiation has no such branch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTileLog2 = 14;
constexpr int kTile = 1 << kTileLog2;
constexpr int kLogE = 5;           // 32 elements a thread
constexpr int kThreads = kTile >> kLogE;
constexpr int kPlanFields = 7;     // merge_sort.py:PLAN_FIELDS

enum Route { kChunk = 0, kStrided = 1 };

// One launch of the host's plan (merge_sort.py:Launch).
struct Launch {
  int route, j_hi, j_lo, rows, width, reversed, sort_log2;
};

__host__ __device__ __forceinline__ int log2i(int x) {
  int r = 0;
  while ((1 << r) < x) ++r;
  return r;
}

__host__ __device__ constexpr int lowest_bit(int i) {
  int j = 0;
  while (!((i >> j) & 1)) ++j;
  return j;
}

__device__ __forceinline__ int to_bits(int x) { return x; }
__device__ __forceinline__ int to_bits(float x) { return __float_as_int(x); }
template <typename K>
__device__ __forceinline__ K from_bits(int x) {
  if constexpr (std::is_floating_point<K>::value) {
    return __int_as_float(x);
  } else {
    return x;
  }
}

// Keys to min/max as jnp.minimum/jnp.maximum take them (-0.0 below +0.0, a
// NaN spread with its bits), values after `take_lo_first = a <= b`; a
// descending pair puts max first.  NANS: the tile may hold a NaN key; a tile
// without one never makes one, so it skips the NaN rule.
template <bool NANS, typename K>
__device__ __forceinline__ void cmp_exchange(K& a, K& b, int& va, int& vb, bool descending) {
  const bool take_lo_first = a <= b;
  // Ascending, a pair swaps unless its first key is the lower; descending,
  // when it is.
  const bool swap = take_lo_first == descending;
  K x = swap ? b : a;
  K y = swap ? a : b;
  if constexpr (std::is_floating_point<K>::value) {
    const bool na = NANS && a != a, nb = NANS && b != b;
    if (a == b || na || nb) {
      const int ba = to_bits(a), bb = to_bits(b);
      int lo, hi;
      if (a == b) {  // equal keys differ in bits only as signed zeros
        lo = ba | bb;
        hi = ba & bb;
      } else {  // a NaN spreads; of two, min is a and max b unless a has its sign bit
        lo = nb && (!na || ba < 0) ? bb : ba;
        hi = na && (!nb || ba < 0) ? ba : bb;
      }
      x = from_bits<K>(descending ? hi : lo);
      y = from_bits<K>(descending ? lo : hi);
    }
  }
  const int vx = swap ? vb : va;
  const int vy = swap ? va : vb;
  a = x;
  b = y;
  va = vx;
  vb = vy;
}

// Position of tile element t in shared memory, in (key, value) pairs of 8
// bytes: at any window the 16 lanes of a half-warp hit 16 distinct pairs of
// banks.  Linear over XOR: swizzle(x ^ y) = swizzle(x) ^ swizzle(y).
__device__ __forceinline__ int swizzle(int t) { return t ^ ((t >> 5) & 15); }

// A CTA's tile in registers: thread `tid` holds tile elements at(r), r < E,
// which differ in index bits [w, w + LOG_E).
template <typename K, int LOG_E>
struct Tile {
  static constexpr int E = 1 << LOG_E;
  K k[E];
  int v[E];
  int w;
  int tid;
  int tile_log2;

  __device__ __forceinline__ int at(int r) const {
    return ((tid >> w) << (w + LOG_E)) | (r << w) | (tid & ((1 << w) - 1));
  }

  // Place in shared memory of each register's element, visited in Gray-code
  // order so that each step is one XOR: register i ^ (i >> 1) lies at p[i].
  __device__ __forceinline__ void places(int (&p)[E]) const {
    int step[LOG_E];
#pragma unroll
    for (int j = 0; j < LOG_E; ++j) step[j] = swizzle(1 << (w + j));
    p[0] = swizzle(at(0));
#pragma unroll
    for (int i = 1; i < E; ++i) p[i] = p[i - 1] ^ step[lowest_bit(i)];
  }

  // Waits for the threads that trade elements in a relayout between windows
  // below `level`: those with equal tid >> level, which hold the tile elements
  // with equal index >> (level + LOG_E) in both windows.  Groups drift apart,
  // so each level has barriers of its own: 1..8 for groups of 64, 9..12 for
  // 128, 13..14 for 256 (barrier 0 is the CTA's).
  __device__ __forceinline__ void sync_group(int level) const {
    static_assert(kThreads == 512, "the barrier ids below count groups of 512 threads");
    const int threads = blockDim.x;
    if (threads < 32 || (1 << level) >= threads) {
      __syncthreads();
    } else if (level <= 5) {
      __syncwarp();
    } else {
      const int first = level == 6 ? 1 : level == 7 ? 9 : 13;
      asm volatile("bar.sync %0, %1;" ::"r"(first + (tid >> level)), "r"(1 << level) : "memory");
    }
  }

  // Re-lay the tile through shared memory into window `w_new`.  A thread first
  // writes the places it alone read in the last relayout, so only the reads
  // wait, and only for the threads of its group.
  __device__ __forceinline__ void relayout(int w_new, int2* pairs) {
    int p[E];
    places(p);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int r = i ^ (i >> 1);
      pairs[p[i]] = make_int2(to_bits(k[r]), v[r]);
    }
    sync_group(max(w, w_new));
    w = w_new;
    places(p);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int r = i ^ (i >> 1);
      const int2 kv = pairs[p[i]];
      k[r] = from_bits<K>(kv.x);
      v[r] = kv.y;
    }
  }

  // The window for stages b, b-1, ... down to b_lo: it holds b and as many of
  // the next stages as it can, and lies as high as that allows.
  __device__ __forceinline__ int window_for(int b, int b_lo) const {
    const int w_new = min(b, max(b - LOG_E + 1, b_lo));
    return min(w_new, tile_log2 - LOG_E);
  }

  // One stage at register bit P.  Q < 0: all ascending; Q < LOG_E: descending
  // where bit Q of r is set; Q == LOG_E: all descending.
  template <bool NANS, int P, int Q>
  __device__ __forceinline__ void register_stage() {
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if (r & (1 << P)) continue;
      const bool d = Q >= 0 && (Q == LOG_E || ((r >> Q) & 1) != 0);
      cmp_exchange<NANS>(k[r], k[r | (1 << P)], v[r], v[r | (1 << P)], d);
    }
  }

  // The stages at register bits p_hi down to p_lo of the window.
  template <bool NANS, int Q, int P = LOG_E - 1>
  __device__ __forceinline__ void window_stages(int p_hi, int p_lo) {
    if constexpr (P >= 0) {
      if constexpr (Q < 0 || Q == LOG_E || Q > P) {  // an in-window Q lies above P
        if (P <= p_hi && P >= p_lo) register_stage<NANS, P, Q>();
      }
      window_stages<NANS, Q, P - 1>(p_hi, p_lo);
    }
  }

  template <bool NANS, int Q = -1>
  __device__ __forceinline__ void window_stages_at(int q, int p_hi, int p_lo) {
    if constexpr (Q <= LOG_E) {
      if (q == Q) {
        window_stages<NANS, Q>(p_hi, p_lo);
      } else {
        window_stages_at<NANS, Q + 1>(q, p_hi, p_lo);
      }
    }
  }

  // Stages at tile bits b_hi down to b_lo; direction bit d (-1: ascending).
  // A direction bit outside the window is the thread's own: all its pairs go
  // one way.
  template <bool NANS>
  __device__ __forceinline__ void stages(int b_hi, int b_lo, int d, int2* pairs) {
    for (int b = b_hi; b >= b_lo;) {
      if (b < w || b >= w + LOG_E) relayout(window_for(b, b_lo), pairs);
      int q = -1;
      if (d >= w && d < w + LOG_E) {
        q = d - w;
      } else if (d >= 0 && ((at(0) >> d) & 1)) {
        q = LOG_E;
      }
      const int stop = max(w, b_lo);
      window_stages_at<NANS>(q, b - w, stop - w);
      b = stop - 1;
    }
  }
};

// Where the elements of tile `tile` under launch L lie: `origin` plus the
// 32-bit offset of tile element t.  `load` reads the second run reversed
// where L says so.
struct TileMap {
  Launch L;
  int log2_width, log2_rows, size, c0;
  int64_t origin;

  __device__ __forceinline__ TileMap(const Launch& launch, int64_t tile)
      : L(launch), log2_width(log2i(launch.width)), log2_rows(log2i(launch.rows)),
        size(launch.rows * launch.width) {
    if (L.route == kChunk) {
      c0 = 0;
      origin = tile * size;
    } else {
      // The tiles of one span of rows * size elements are its column blocks.
      c0 = int(tile & (L.rows - 1)) << log2_width;
      origin = (tile >> log2_rows) * L.rows * size;
    }
  }

  __device__ __forceinline__ int offset(int t, bool load) const {
    if (L.route == kChunk) {
      if (!(load && L.reversed)) return t;
      const int run = 1 << L.j_hi;
      const int q = t & (2 * run - 1);
      return q < run ? t : t - q + 3 * run - 1 - q;
    }
    // Strided: the second run's rows read the mirrored column segment backwards.
    const int r = t >> log2_width, c = t & (L.width - 1);
    if (load && L.reversed && r >= L.rows / 2)
      return (3 * L.rows / 2 - 1 - r) * size + size - 1 - c0 - c;
    return r * size + c0 + c;
  }
};

// The launch's stages on a loaded tile; `shift` maps a network bit to a tile bit.
template <bool NANS, typename K, int LOG_E>
__device__ __forceinline__ void run_stages(Tile<K, LOG_E>& tile, const Launch& L, int shift,
                                           int2* pairs) {
  if (L.sort_log2 > 0) {
    const int m = L.sort_log2;
    for (int k = 1; k <= m; ++k) tile.template stages<NANS>(k - 1, 0, k < m ? k : -1, pairs);
  } else if (L.j_hi >= L.j_lo) {
    tile.template stages<NANS>(L.j_hi - shift, L.j_lo - shift, -1, pairs);
  }
}

// One launch: load the tile at a window whose lanes read contiguous words,
// run the launch's stages, store it the same way.  In place is fine for the
// unreversed chunk launch: a CTA loads its whole tile before it stores.  Float
// tiles take the NaN rule only where they hold a NaN.
template <typename K, int LOG_E>
__global__ void __launch_bounds__(kThreads, 1)
network_kernel(const K* kin, const int* vin, K* kout, int* vout, Launch L) {
  extern __shared__ __align__(16) unsigned char smem[];
  int2* pairs = reinterpret_cast<int2*>(smem);
  const TileMap map(L, blockIdx.x);
  const int shift = L.route == kStrided ? map.log2_rows : 0;  // network bit -> tile bit

  Tile<K, LOG_E> tile;
  tile.tid = threadIdx.x;
  tile.tile_log2 = log2i(map.size);
  // Window 3 and up (or the top window of a small tile): each 8 lanes hold
  // consecutive tile elements, so a warp's loads and stores fill whole 32-byte
  // sectors.
  const int w_io = min(3, tile.tile_log2 - LOG_E);
  int first = w_io;
  if (L.sort_log2 > 0) {
    first = tile.window_for(0, 0);
  } else if (L.j_hi >= L.j_lo) {
    first = tile.window_for(L.j_hi - shift, L.j_lo - shift);
  }
  tile.w = max(first, w_io);
  {
    const K* kp = kin + map.origin;
    const int* vp = vin + map.origin;
#pragma unroll
    for (int r = 0; r < tile.E; ++r) {
      const int o = map.offset(tile.at(r), true);
      tile.k[r] = kp[o];
      tile.v[r] = vp[o];
    }
  }
  if constexpr (std::is_floating_point<K>::value) {
    bool mine = false;
#pragma unroll
    for (int r = 0; r < tile.E; ++r) mine |= tile.k[r] != tile.k[r];
    if (__syncthreads_or(mine)) {
      run_stages<true>(tile, L, shift, pairs);
    } else {
      run_stages<false>(tile, L, shift, pairs);
    }
  } else {
    run_stages<false>(tile, L, shift, pairs);
  }
  if (tile.w < w_io) tile.relayout(w_io, pairs);
  K* kp = kout + map.origin;
  int* vp = vout + map.origin;
#pragma unroll
  for (int r = 0; r < tile.E; ++r) {
    const int o = map.offset(tile.at(r), false);
    kp[o] = tile.k[r];
    vp[o] = tile.v[r];
  }
}

bool is_pow2(int64_t x) { return x > 0 && (x & (x - 1)) == 0; }

// A launch the kernel can run on n elements; `first`: it reads the input.
bool valid(const Launch& L, int64_t n, bool first) {
  if (L.route != kChunk && L.route != kStrided) return false;
  if (!is_pow2(L.rows) || !is_pow2(L.width)) return false;
  const int64_t size = int64_t(L.rows) * L.width;
  if (size > kTile || n % size) return false;
  const int tile_log2 = log2i(int(size));
  if (L.reversed && !first) return false;
  if (L.sort_log2 > 0) return L.route == kChunk && L.sort_log2 <= tile_log2 && !L.reversed;
  if (L.j_hi < L.j_lo) return !L.reversed;  // no stages: a copy
  if (L.j_lo < 0) return false;
  if (L.route == kChunk) return L.rows == 1 && L.j_hi < tile_log2;
  // Strided: the rows are the index bits log2(size) .. j_hi.
  return n % (size * L.rows) == 0 && L.rows >= 2 && L.j_lo == tile_log2 &&
         L.j_hi == tile_log2 + log2i(L.rows) - 1;
}

template <typename K, int LOG_E>
cudaError_t launch_one(const K* kin, const int* vin, K* kout, int* vout, int64_t n,
                       const Launch& L, cudaStream_t stream) {
  const int size = L.rows * L.width;
  const size_t smem = size_t(size) * sizeof(int2);  // (key, value) pairs
  cudaError_t err = cudaFuncSetAttribute(network_kernel<K, LOG_E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  network_kernel<K, LOG_E><<<unsigned(n / size), unsigned(size >> LOG_E), smem, stream>>>(
      kin, vin, kout, vout, L);
  return cudaGetLastError();
}

// Runs the plan's launches in order: the first from the input to the output,
// the others in place on the output.
template <typename K>
int run_plan(const void* keys, const void* values, void* keys_out, void* values_out,
             int64_t n, const int* plan, int launches, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (launches < 1 || launches > 2) return cudaErrorInvalidValue;
  Launch L[2];
  for (int i = 0; i < launches; ++i) {
    const int* f = plan + kPlanFields * i;
    L[i] = Launch{f[0], f[1], f[2], f[3], f[4], f[5], f[6]};
    if (!valid(L[i], n, i == 0)) return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  K* kout = static_cast<K*>(keys_out);
  int* vout = static_cast<int*>(values_out);
  for (int i = 0; i < launches; ++i) {
    const K* kin = i == 0 ? static_cast<const K*>(keys) : kout;
    const int* vin = i == 0 ? static_cast<const int*>(values) : vout;
    if (L[i].sort_log2 == 0 && L[i].j_hi < L[i].j_lo) {  // no stages (blocks of 1)
      if (kin == kout) continue;
      cudaError_t err = cudaMemcpyAsync(kout, kin, n * sizeof(K), cudaMemcpyDeviceToDevice, s);
      if (err == cudaSuccess)
        err = cudaMemcpyAsync(vout, vin, n * sizeof(int), cudaMemcpyDeviceToDevice, s);
      if (err != cudaSuccess) return err;
      continue;
    }
    // Tiles of fewer than 32 elements take 2 a thread.
    const cudaError_t err = L[i].rows * L[i].width >= (1 << kLogE)
        ? launch_one<K, kLogE>(kin, vin, kout, vout, n, L[i], s)
        : launch_one<K, 1>(kin, vin, kout, vout, n, L[i], s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename K>
int attributes(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, network_kernel<K, kLogE>);
  if (err != cudaSuccess) return err;
  const int smem = kTile * int(sizeof(int2));
  err = cudaFuncSetAttribute(network_kernel<K, kLogE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = int(attr.localSizeBytes);
  out[2] = smem;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], network_kernel<K, kLogE>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], network_kernel<K, kLogE>,
                                                       kThreads / 2, smem / 2);
}

}  // namespace

extern "C" {

int remop_sort_blocks_i32(const void* keys, const void* values, void* keys_out,
                          void* values_out, long long n, const int* plan, int launches,
                          void* stream) {
  return run_plan<int32_t>(keys, values, keys_out, values_out, n, plan, launches, stream);
}

int remop_sort_blocks_f32(const void* keys, const void* values, void* keys_out,
                          void* values_out, long long n, const int* plan, int launches,
                          void* stream) {
  return run_plan<float>(keys, values, keys_out, values_out, n, plan, launches, stream);
}

int remop_merge_pass_i32(const void* keys, const void* values, void* keys_out,
                         void* values_out, long long n, const int* plan, int launches,
                         void* stream) {
  return run_plan<int32_t>(keys, values, keys_out, values_out, n, plan, launches, stream);
}

int remop_merge_pass_f32(const void* keys, const void* values, void* keys_out,
                         void* values_out, long long n, const int* plan, int launches,
                         void* stream) {
  return run_plan<float>(keys, values, keys_out, values_out, n, plan, launches, stream);
}

// is_f32, &out[5]: registers, local (spill) bytes and dynamic shared bytes of
// the kernel at a 2^14-element tile, and its resident CTAs an SM at tiles of
// 2^14 and of 2^13.
int remop_merge_sort_attributes(int is_f32, int* out) {
  return is_f32 ? attributes<float>(out) : attributes<int32_t>(out);
}

const char* remop_merge_sort_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
