// Launch set-up shared by the kernels of csrc/*.cu.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>

namespace {

// Per kernel instantiation K and device: the dynamic shared memory limit,
// raised by cudaFuncSetAttribute only when a launch needs more than it was
// raised to before, and the blocks of K the card holds at once (blocks an
// SM holds at `smem` bytes times the SMs), asked of the runtime once per
// size. A launch of a size seen before makes no runtime call but
// cudaGetDevice.
template <auto K>
cudaError_t prepare(size_t smem, int threads, int* wave) {
  struct Seen {
    int dev;
    size_t smem;
    int wave;
  };
  constexpr int kDevices = 64, kSizes = 64;
  static std::mutex mu;
  static Seen seen[kSizes];
  static int n_seen = 0;
  static size_t allowed[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen; ++i) {
    if (seen[i].dev == dev && seen[i].smem == smem) {
      *wave = seen[i].wave;
      return cudaSuccess;
    }
  }
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = smem;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K, threads, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *wave = per_sm * sms;
  if (n_seen < kSizes) seen[n_seen++] = Seen{dev, smem, *wave};
  return cudaSuccess;
}

}  // namespace
