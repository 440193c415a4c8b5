// An empty kernel, launched at a given grid, block and dynamic shared
// memory: the launch floor of any kernel launched so.  Every kernel's row of
// chip_smoke.py measures its floor through this one helper
// (build.py::empty_launch), replayed in a CUDA graph like the kernel.

#include <cuda_runtime.h>

#include <atomic>

namespace {

__global__ void empty_kernel() {}

// the dynamic shared memory the empty kernel may take on each device, so
// far (cudaFuncSetAttribute is set once a device and size)
std::atomic<int> g_smem_allowed[64];

}  // namespace

// Launch the empty kernel on `stream` of `device` over a (gx, gy) grid of
// `threads`-thread blocks with `smem` bytes of dynamic shared memory.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// a geometry no kernel could launch.
extern "C" int empty_launch(long long gx, long long gy, int threads, int smem,
                            int device, cudaStream_t stream) {
  if (gx < 1 || gx > 0x7fffffffLL || gy < 1 || gy > 65535 || threads < 1 ||
      threads > 1024 || smem < 0 || device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidValue);
  int prev = -1;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024 && smem > g_smem_allowed[device].load()) {
    err = cudaFuncSetAttribute(
        empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) g_smem_allowed[device].store(smem);
  }
  if (err == cudaSuccess) {
    empty_kernel<<<dim3((unsigned)gx, (unsigned)gy), threads, (size_t)smem,
                   stream>>>();
    err = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(err);
}
