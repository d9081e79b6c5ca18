// Persistent grids of the probe kernels (anyhit.cu's tensor-core any
// hit, mem.cu's shared table gather): as many blocks as the card holds at
// once with a block's dynamic shared memory, and the refusal of a block
// that would need more than an H100 block can use.
#pragma once

#include <cuda_runtime.h>

namespace restir_prof {

// Bytes of shared memory one block can use on sm_90.
constexpr size_t kBlockSmem = 232448;

// The device and size a kernel's grid was last sized for.
struct Resident {
  int dev = -1;
  size_t smem = 0;
  int blocks = 0;
};

// Blocks of `kernel` the card holds at once (every SM's) with `threads`
// threads and `smem` bytes of dynamic shared memory each, after raising
// the kernel's shared-memory limit; kept in `memo` for the last device
// and size asked. A launcher returns -smem where smem > kBlockSmem
// (the host names the limit), so no CUDA error code is taken for it.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem,
                            Resident& memo, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev == memo.dev && smem == memo.smem) {
    *blocks = memo.blocks;
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm <= 0) return cudaErrorInvalidValue;
  memo = Resident{dev, smem, per_sm * sms};
  *blocks = memo.blocks;
  return cudaSuccess;
}

}  // namespace restir_prof
