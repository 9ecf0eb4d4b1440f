// Row gather for Hopper (sm_90a): out[i] = x[idx[i]].
//
// Replaces the TPU kernel src/repro/kernels/dispatch/dispatch.py:26
// (gather_rows), including its rows_per_block contract: with rpb > 1, output
// block b (rows b*rpb .. b*rpb+rpb-1) is the aligned source block
// idx[b*rpb] / rpb, exactly as the Pallas kernel's index map reads it.
//
// What bounds it on this card: the bytes (one read of each gathered row, one
// write of the output, plus the indices).  The kernel is a grid-stride loop
// over the output in units of `Unit` bytes: neighbouring threads copy
// neighbouring units of a row, and the wrapper picks the widest unit (up to
// 16 bytes) that divides the row and both base addresses, so each thread
// moves whole 16-byte words where the rows allow it.  Indices must lie in
// [0, rows of x); the kernel does not check them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename Unit>
__global__ void gather_rows_kernel(const Unit* __restrict__ x,
                                   const int32_t* __restrict__ idx,
                                   Unit* __restrict__ out, int64_t n,
                                   int64_t units_per_row, int rpb) {
  const int64_t total = n * units_per_row;
  const int64_t stride = int64_t(gridDim.x) * blockDim.x;
  for (int64_t w = int64_t(blockIdx.x) * blockDim.x + threadIdx.x; w < total;
       w += stride) {
    const int64_t row = w / units_per_row;
    const int64_t col = w - row * units_per_row;
    int64_t src;
    if (rpb == 1) {
      src = idx[row];
    } else {
      const int64_t blk = row / rpb;
      src = int64_t(idx[blk * rpb] / rpb) * rpb + (row - blk * rpb);
    }
    out[w] = x[src * units_per_row + col];
  }
}

template <typename Unit>
int launch(const void* x, const void* idx, void* out, int64_t n,
           int64_t row_bytes, int rpb, cudaStream_t stream) {
  const int64_t units = row_bytes / int64_t(sizeof(Unit));
  const int64_t want = (n * units + kThreads - 1) / kThreads;
  const unsigned grid = unsigned(want < (1 << 20) ? want : (1 << 20));
  gather_rows_kernel<Unit><<<grid, kThreads, 0, stream>>>(
      static_cast<const Unit*>(x), static_cast<const int32_t*>(idx),
      static_cast<Unit*>(out), n, units, rpb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int remop_gather_rows(const void* x, const void* idx, void* out, long long n,
                      long long row_bytes, int unit_bytes, int rpb,
                      void* stream) {
  if (n <= 0 || row_bytes <= 0) return cudaSuccess;
  if (rpb < 1 || n % rpb || row_bytes % unit_bytes) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (unit_bytes) {
    case 16: return launch<uint4>(x, idx, out, n, row_bytes, rpb, s);
    case 8: return launch<uint2>(x, idx, out, n, row_bytes, rpb, s);
    case 4: return launch<uint32_t>(x, idx, out, n, row_bytes, rpb, s);
    case 2: return launch<uint16_t>(x, idx, out, n, row_bytes, rpb, s);
    case 1: return launch<uint8_t>(x, idx, out, n, row_bytes, rpb, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* remop_gather_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
