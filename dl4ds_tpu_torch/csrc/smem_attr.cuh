// The dynamic shared memory attribute of a kernel, set once per device,
// kernel and size. cudaFuncSetAttribute is host work: made at every launch,
// it would also be made while a CUDA graph is being captured. Here the first
// launch of a kernel at a size on a device (a warm-up, before any capture)
// sets it, and later launches there at that size or less make no call. The
// attribute applies to the current device only, so the device is part of
// the key.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include <map>
#include <mutex>
#include <utility>

namespace dl4ds {

template <typename K>
cudaError_t reserve_smem(K* kernel, size_t smem) {
  static std::mutex lock;
  static std::map<std::pair<int, const void*>, size_t> reserved;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::pair<int, const void*> key(device, reinterpret_cast<const void*>(kernel));
  std::lock_guard<std::mutex> guard(lock);
  const auto it = reserved.find(key);
  if (it != reserved.end() && it->second >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) reserved[key] = smem;
  return err;
}

}  // namespace dl4ds
