// Row gather for Hopper (sm_90a): out[i] = x[idx[i]].
//
// Replaces the TPU kernel src/repro/kernels/dispatch/dispatch.py:26
// (gather_rows).  Its rows_per_block contract (output block b is the aligned
// source block idx[b*rpb] / rpb) reaches this kernel as a gather of wider
// rows: the wrapper views x as one row a block and hands it the block
// indices (dispatch.py:block_view), so the kernel has one index path.
//
// What bounds it on this card: the bytes (each index read once, each
// gathered row read once, the output written once), and before them the
// loads in flight and the sectors.  A thread that loads its index, then its
// row, then stores it has one row in flight and waits on two memory
// latencies.  And each x read is a random row, so a warp's loads touch as
// many 32-byte sectors as it has lanes: a row narrower than a sector costs a
// whole sector's transaction through L2 (four times its bytes at 8-byte
// rows), even when x already lies in L2.  Only the loads in flight are the
// kernel's to fix.  The design:
//   * Narrow rows (one aligned unit of 4, 8 or 16 bytes; the main path's
//     (key, payload) rows narrowed to int32 are 8): a warp takes a tile of
//     32*kRows consecutive output rows, and each lane kRows = 8 of them,
//     laid out so that each of its index loads and each of its 16-byte
//     stores is one contiguous piece of the warp's.  A lane issues all 8 row
//     loads before it stores any (4 a thread read as fast at the main path's
//     rows); nothing divides.
//   * Other rows (wide rows, odd widths or alignments): a group of G lanes a
//     row, G a power of two up to a warp, each lane copying units of the
//     widest size (up to 16 bytes) that divides the row and both base
//     addresses.  A lane keeps kSlots units in flight: of several rows when
//     a row has few units a lane, of one row in passes when it has many.
//   * A persistent grid: as many CTAs as fit on the SMs at once, each
//     walking tiles at the grid's stride.
//   * Cache policy: x is read through the read-only path with an L2
//     evict-last policy, since its sectors hold several rows that other
//     threads read later; idx and out stream through with evict-first
//     (__ldcs / __stcs), so they do not push x out of L2.
// Indices must lie in [0, rows of x); the kernel does not check them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;   // rows a thread on the narrow route
constexpr int kSlots = 8;  // units a lane keeps in flight on the grouped route
enum Route { kNarrow = 0, kGrouped = 1 };

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// One unit of x through the read-only path, with the L2 policy.
__device__ __forceinline__ uint8_t load_x(const uint8_t* p, uint64_t policy) {
  unsigned int v;
  asm("ld.global.nc.L2::cache_hint.u8 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(policy));
  return uint8_t(v);
}
__device__ __forceinline__ uint16_t load_x(const uint16_t* p, uint64_t policy) {
  uint16_t v;
  asm("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;" : "=h"(v) : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ uint32_t load_x(const uint32_t* p, uint64_t policy) {
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ uint2 load_x(const uint2* p, uint64_t policy) {
  uint2 v;
  asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
      : "=r"(v.x), "=r"(v.y) : "l"(p), "l"(policy));
  return v;
}
__device__ __forceinline__ uint4 load_x(const uint4* p, uint64_t policy) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p), "l"(policy));
  return v;
}

// The C = 16 / sizeof(Unit) indices of the rows in one 16-byte store.
template <int C> struct IndexVec;
template <> struct IndexVec<1> {
  static __device__ __forceinline__ void load(const int32_t* p, int32_t* s) { s[0] = __ldcs(p); }
};
template <> struct IndexVec<2> {
  static __device__ __forceinline__ void load(const int32_t* p, int32_t* s) {
    const int2 v = __ldcs(reinterpret_cast<const int2*>(p));
    s[0] = v.x;
    s[1] = v.y;
  }
};
template <> struct IndexVec<4> {
  static __device__ __forceinline__ void load(const int32_t* p, int32_t* s) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(p));
    s[0] = v.x;
    s[1] = v.y;
    s[2] = v.z;
    s[3] = v.w;
  }
};

// The C rows of one 16-byte store, packed.
__device__ __forceinline__ uint4 chunk_of(const uint32_t* r) {
  return make_uint4(r[0], r[1], r[2], r[3]);
}
__device__ __forceinline__ uint4 chunk_of(const uint2* r) {
  return make_uint4(r[0].x, r[0].y, r[1].x, r[1].y);
}
__device__ __forceinline__ uint4 chunk_of(const uint4* r) { return r[0]; }

// Narrow route.  A warp's tile is 32*kRows rows: chunk q of lane l is the C
// rows from q*32*C + l*C, one 16-byte store.  Rows past the last whole tile
// go one a thread.
template <typename Unit>
__global__ void __launch_bounds__(kThreads, 4) gather_narrow(const Unit* __restrict__ x,
                                                             const int32_t* __restrict__ idx,
                                                             Unit* __restrict__ out, int64_t n) {
  constexpr int R = kRows;
  constexpr int C = 16 / int(sizeof(Unit));
  constexpr int Q = R / C;
  static_assert(Q * C == R && Q >= 1, "kRows must be a multiple of a 16-byte store's rows");
  const uint64_t policy = evict_last_policy();
  const int lane = threadIdx.x & 31;
  const int64_t warps = int64_t(gridDim.x) * (kThreads / 32);
  const int64_t tiles = n / (32 * R);
  for (int64_t tile = int64_t(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5); tile < tiles;
       tile += warps) {
    const int64_t base = tile * (32 * R) + lane * C;
    int32_t src[R];
#pragma unroll
    for (int q = 0; q < Q; ++q) IndexVec<C>::load(idx + base + q * 32 * C, src + q * C);
    Unit row[R];
#pragma unroll
    for (int r = 0; r < R; ++r) row[r] = load_x(x + src[r], policy);
#pragma unroll
    for (int q = 0; q < Q; ++q)
      __stcs(reinterpret_cast<uint4*>(out + base + q * 32 * C), chunk_of(row + q * C));
  }
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  for (int64_t i = tiles * (32 * R) + int64_t(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride)
    __stcs(out + i, load_x(x + __ldcs(idx + i), policy));
}

// Grouped route: G = 2^log_g lanes a row, `units` units a row.  Slot s of a
// lane holds unit lane + G*(pass*U + s % U) of row r0 + s / U, where U (units
// a lane a row in one pass, at most kSlots) and the rows a group holds at
// once, kSlots / U, follow from the row's width.
template <typename Unit>
__global__ void __launch_bounds__(kThreads) gather_grouped(const Unit* __restrict__ x,
                                                           const int32_t* __restrict__ idx,
                                                           Unit* __restrict__ out, int64_t n,
                                                           int units, int log_g) {
  const uint64_t policy = evict_last_policy();
  const int g = 1 << log_g;
  const int lane = threadIdx.x & (g - 1);
  const int per_lane = (units + g - 1) >> log_g;
  const int u = per_lane < kSlots ? per_lane : kSlots;
  const int rows = kSlots / u;
  const int passes = (per_lane + u - 1) / u;
  int slot_row[kSlots], slot_unit[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    slot_row[s] = s / u;
    slot_unit[s] = lane + (s % u) * g;
  }
  const int64_t groups = (int64_t(gridDim.x) * kThreads) >> log_g;
  for (int64_t r0 = ((int64_t(blockIdx.x) * kThreads + threadIdx.x) >> log_g) * rows; r0 < n;
       r0 += groups * rows) {
    int64_t src[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int64_t r = r0 + slot_row[s];
      src[s] = slot_row[s] < rows && r < n ? int64_t(__ldcs(idx + r)) * units : -1;
    }
    for (int pass = 0; pass < passes; ++pass) {
      Unit buf[kSlots];
      const int first = pass * u * g;
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        if (src[s] >= 0 && first + slot_unit[s] < units)
          buf[s] = load_x(x + src[s] + first + slot_unit[s], policy);
#pragma unroll
      for (int s = 0; s < kSlots; ++s)
        if (src[s] >= 0 && first + slot_unit[s] < units)
          __stcs(out + (r0 + slot_row[s]) * units + first + slot_unit[s], buf[s]);
    }
  }
}

// A persistent grid: `want` CTAs, at most as many as the SMs hold at once.
// `ctas` caches the kernel's resident CTAs an SM, asked of the driver once.
template <typename F>
cudaError_t persistent_grid(F kernel, int& ctas, int64_t want, unsigned& grid) {
  cudaError_t err = cudaSuccess;
  if (ctas == 0) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, kThreads, 0);
  int device = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t cap = int64_t(sms) * ctas;
  grid = unsigned(want < 1 ? 1 : (want < cap ? want : cap));
  return cap < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <typename Unit>
int launch_narrow(const void* x, const int32_t* idx, void* out, int64_t n, cudaStream_t s) {
  static int ctas = 0;
  unsigned grid = 0;
  const int64_t warp_tiles = n / (32 * kRows);
  const cudaError_t err = persistent_grid(
      gather_narrow<Unit>, ctas, (warp_tiles * 32 + kThreads - 1) / kThreads, grid);
  if (err != cudaSuccess) return err;
  gather_narrow<Unit><<<grid, kThreads, 0, s>>>(static_cast<const Unit*>(x), idx,
                                                static_cast<Unit*>(out), n);
  return cudaGetLastError();
}

template <typename Unit>
int launch_grouped(const void* x, const int32_t* idx, void* out, int64_t n, int64_t row_bytes,
                   int lanes, cudaStream_t s) {
  static int ctas = 0;
  const int units = int(row_bytes / int64_t(sizeof(Unit)));
  int log_g = 0;
  while ((1 << log_g) < lanes) ++log_g;
  const int per_lane = (units + lanes - 1) / lanes;
  const int rows = kSlots / (per_lane < kSlots ? per_lane : kSlots);
  const int64_t groups = (n + rows - 1) / rows;
  unsigned grid = 0;
  const cudaError_t err = persistent_grid(gather_grouped<Unit>, ctas,
                                          (groups * lanes + kThreads - 1) / kThreads, grid);
  if (err != cudaSuccess) return err;
  gather_grouped<Unit><<<grid, kThreads, 0, s>>>(static_cast<const Unit*>(x), idx,
                                                 static_cast<Unit*>(out), n, units, log_g);
  return cudaGetLastError();
}

template <typename F>
int attributes_of(F kernel, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = int(attr.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, kThreads, 0);
}

}  // namespace

extern "C" {

// route (kNarrow / kGrouped), unit bytes, lanes a row (grouped: a power of
// two up to 32; the narrow route copies a row with one lane and ignores it).
// The host checks the alignments (dispatch.py:plan).
int remop_gather_rows(const void* x, const void* idx, void* out, long long n,
                      long long row_bytes, int route, int unit, int lanes, void* stream) {
  if (n <= 0 || row_bytes <= 0) return cudaSuccess;
  const auto* ix = static_cast<const int32_t*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  if (route == kNarrow) {
    if (row_bytes != unit) return cudaErrorInvalidValue;
    switch (unit) {
      case 4: return launch_narrow<uint32_t>(x, ix, out, n, s);
      case 8: return launch_narrow<uint2>(x, ix, out, n, s);
      case 16: return launch_narrow<uint4>(x, ix, out, n, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (route != kGrouped || row_bytes % unit || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)))
    return cudaErrorInvalidValue;
  switch (unit) {
    case 16: return launch_grouped<uint4>(x, ix, out, n, row_bytes, lanes, s);
    case 8: return launch_grouped<uint2>(x, ix, out, n, row_bytes, lanes, s);
    case 4: return launch_grouped<uint32_t>(x, ix, out, n, row_bytes, lanes, s);
    case 2: return launch_grouped<uint16_t>(x, ix, out, n, row_bytes, lanes, s);
    case 1: return launch_grouped<uint8_t>(x, ix, out, n, row_bytes, lanes, s);
    default: return cudaErrorInvalidValue;
  }
}

// route, unit (as above), &out[3]: registers, local (spill) bytes and
// resident CTAs an SM of the instantiation that runs them.
int remop_gather_rows_attributes(int route, int unit, int* out) {
  if (route == kNarrow) {
    switch (unit) {
      case 4: return attributes_of(gather_narrow<uint32_t>, out);
      case 8: return attributes_of(gather_narrow<uint2>, out);
      case 16: return attributes_of(gather_narrow<uint4>, out);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (unit) {
    case 16: return attributes_of(gather_grouped<uint4>, out);
    case 8: return attributes_of(gather_grouped<uint2>, out);
    case 4: return attributes_of(gather_grouped<uint32_t>, out);
    case 2: return attributes_of(gather_grouped<uint16_t>, out);
    case 1: return attributes_of(gather_grouped<uint8_t>, out);
    default: return cudaErrorInvalidValue;
  }
}

const char* remop_gather_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
