// What the multi-block scans of cuda_scan.cu (K1, K2, K3) and the windowed
// float32 sweep of cuda_riccati.cu (K4) share: how many blocks of a kernel
// the card holds at once, the launch that spreads one sequence over
// several blocks (a cooperative one, so that the blocks can meet at a grid
// sync), and that sync.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <map>
#include <mutex>
#include <tuple>

namespace vidp {

// The launch of `grid` blocks, `bps` of them for each sequence.
struct Shape {
  int grid, bps;
};

// Wait for every block of the launch (bps > 1: a cooperative launch) or of
// the block (bps = 1); global writes before it are visible after it.
__device__ __forceinline__ void sync_sequence(int bps) {
  if (bps > 1) {
    cooperative_groups::this_grid().sync();
  } else {
    __syncthreads();
  }
}

// Blocks of `threads` threads with `smem` bytes of dynamic shared memory
// that fit on the current device at once for this kernel: SM count times
// occupancy, asked with the sizes the launch will use and cached per
// (kernel, device, threads, smem).  A kernel that takes more than 48 KB of
// dynamic shared memory has opted in (cudaFuncSetAttribute) before it asks.
inline cudaError_t coresident_blocks(const void* kernel, int threads, size_t smem,
                                     int& out) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, size_t>, int> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(kernel, dev, threads, smem);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    out = it->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  out = cache[key] = sms * per_sm;
  return cudaSuccess;
}

// An ordinary launch for bps = 1, a cooperative one otherwise; args are
// pointers to the kernel's arguments in order.  A cooperative grid larger
// than what fits at once is refused by the runtime, never deadlocked.
inline int launch(const void* kernel, Shape shape, int threads, size_t smem, void** args,
                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      shape.bps > 1
          ? cudaLaunchCooperativeKernel(kernel, shape.grid, threads, args, smem, st)
          : cudaLaunchKernel(kernel, shape.grid, threads, args, smem, st);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace vidp
