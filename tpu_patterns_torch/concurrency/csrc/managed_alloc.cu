// CUDA managed memory for PyTorch's pluggable allocator: the S memory
// kind of the concurrency suite (the original suite's SYCL USM-shared
// kind; the JAX package's unpinned_host).
//
// managed_alloc and managed_free have the signatures that
// torch.cuda.memory.CUDAPluggableAllocator takes.  Each buffer is
// allocated by cudaMallocManaged, preferred on the host and mapped for
// the device, so the device reaches host memory through the mapping and
// pages do not migrate to device memory.  A failure returns nullptr,
// which PyTorch raises as out of memory.  managed_kind tells a pointer's
// memory type (cudaMemoryTypeManaged is 3), so a caller can show that a
// tensor really lies in managed memory.

#include <cuda_runtime.h>
#include <sys/types.h>

// cudaMemAdvise for a device ordinal, or cudaCpuDeviceId for the host
// (CUDA 13 takes a cudaMemLocation in its place).
static cudaError_t advise(void* p, ssize_t size, cudaMemoryAdvise advice,
                          int device) {
#if CUDART_VERSION >= 13000
  cudaMemLocation loc;
  loc.type = device == cudaCpuDeviceId ? cudaMemLocationTypeHost
                                       : cudaMemLocationTypeDevice;
  loc.id = device == cudaCpuDeviceId ? 0 : device;
  return cudaMemAdvise(p, static_cast<size_t>(size), advice, loc);
#else
  return cudaMemAdvise(p, static_cast<size_t>(size), advice, device);
#endif
}

extern "C" {

void* managed_alloc(ssize_t size, int device, cudaStream_t stream) {
  (void)stream;
  void* p = nullptr;
  if (cudaMallocManaged(&p, static_cast<size_t>(size),
                        cudaMemAttachGlobal) != cudaSuccess) {
    cudaGetLastError();
    return nullptr;
  }
  if (advise(p, size, cudaMemAdviseSetPreferredLocation, cudaCpuDeviceId) !=
          cudaSuccess ||
      advise(p, size, cudaMemAdviseSetAccessedBy, device) != cudaSuccess) {
    cudaGetLastError();
    cudaFree(p);
    return nullptr;
  }
  return p;
}

void managed_free(void* ptr, ssize_t size, int device, cudaStream_t stream) {
  (void)size;
  (void)device;
  (void)stream;
  cudaFree(ptr);
}

// The cudaMemoryType of ptr, or -(the CUDA error) if it cannot be read.
int managed_kind(const void* ptr) {
  cudaPointerAttributes a;
  const cudaError_t e = cudaPointerGetAttributes(&a, ptr);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(e);
  }
  return static_cast<int>(a.type);
}

}  // extern "C"
