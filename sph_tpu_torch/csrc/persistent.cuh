// Launch set-up asked of the CUDA runtime once, shared by
// csrc/contact_sweep.cu and csrc/expand_rows.cu, so that a launch makes no
// runtime call but itself: `persistent_grid`, as many blocks of a kernel
// as fit at once on every SM of the device at a dynamic shared-memory
// size, queried (occupancy and SM count) once per (kernel, size, device)
// and cached.
// The kernel's shared-memory limit, one value per kernel and device, is
// raised to the largest size asked so far (a launch needs it at least as
// large as its own size, so it is never lowered); the runtime is asked
// only for a larger size. `carveout`, where not −1, is the kernel's
// preferred share of the SM's unified L1 and shared memory for shared
// memory, in percent (cudaFuncAttributePreferredSharedMemoryCarveout), set
// with the first query of a size. `device` must be the caller's current
// device (the wrappers launch under `torch.cuda.device`).

#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <vector>

namespace sph {

inline cudaError_t persistent_grid(const void* kernel, int threads, int smem,
                                   int device, int* grid,
                                   int carveout = -1) {
  struct Entry {
    const void* kernel;
    int smem, device, grid;
  };
  static std::mutex mu;  // ctypes calls run without the GIL
  static std::vector<Entry> cache;
  const std::lock_guard<std::mutex> lock(mu);
  int limit = -1;  // the largest size cached for this kernel and device
  for (const Entry& e : cache) {
    if (e.kernel != kernel || e.device != device) continue;
    if (e.smem == smem) {
      *grid = e.grid;
      return cudaSuccess;
    }
    if (e.smem > limit) limit = e.smem;
  }
  cudaError_t rc = cudaSuccess;
  if (smem > limit) {
    rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return rc;
  }
  if (carveout >= 0) {
    rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
    if (rc != cudaSuccess) return rc;
  }
  int per_sm = 0, sms = 0;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                     smem);
  if (rc != cudaSuccess) return rc;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return rc;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  cache.push_back(Entry{kernel, smem, device, per_sm * sms});
  *grid = per_sm * sms;
  return cudaSuccess;
}

}  // namespace sph
