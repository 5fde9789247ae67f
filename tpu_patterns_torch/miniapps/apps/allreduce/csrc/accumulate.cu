// The ring allreduce's per-step accumulate for Hopper (sm_90a): K5.
//
// Replaces tpu_patterns/miniapps/apps/allreduce/pallas.py::accumulate,
// body _acc_kernel (:27): out = a + b elementwise over a flat shard of
// float32 or int32, which the pallas variant plugs into the ring as its
// per-step op.
//
// What bounds it on this card: bytes.  Each element is read twice and
// written once (12 bytes) for one add, so its least time is 3 x 4 x n
// bytes over 3.35 TB/s: 0.1202 ms at the ring's 2^25 elements, 0.0300 ms
// at the bandwidth-optimal ring's 2^23-element chunk.
//
// Design.  The Pallas kernel pads the shard into (2048, 128) blocks that
// fit VMEM; here nothing is padded.  A grid-stride loop over 16-byte
// vectors (four elements) when all three pointers are 16-byte aligned,
// then a scalar tail; any misaligned operand (a view that starts inside
// a buffer) takes the scalar loop for the whole shard.  The grid is
// sized to fill the SMs.  Float adds are __fadd_rn (IEEE round to
// nearest, never contracted) and int32 adds wrap through unsigned
// arithmetic, so the kernel equals a + b in torch bit for bit.
//
// Memory kinds.  A pointer to pinned host memory (the miniapp's H kind)
// is read and written through its device pointer, over the bus; managed
// memory (S) and device memory (D) directly.  A pointer the card cannot
// reach (pageable host memory) is refused.

#include <cuda_runtime.h>

#include "../../../../comm/csrc/grid_stride.cuh"

namespace acc {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

template <typename T, typename V>
__global__ void __launch_bounds__(THREADS)
    accumulate_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ o, long long n, int vec) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long done = 0;
  if (vec) {
    const long long nv = n / 4;
    const V* av = reinterpret_cast<const V*>(a);
    const V* bv = reinterpret_cast<const V*>(b);
    V* ov = reinterpret_cast<V*>(o);
    for (long long i = tid; i < nv; i += stride) {
      const V x = av[i];
      const V y = bv[i];
      V z;
      z.x = add(x.x, y.x);
      z.y = add(x.y, y.y);
      z.z = add(x.z, y.z);
      z.w = add(x.w, y.w);
      ov[i] = z;
    }
    done = nv * 4;
  }
  for (long long i = done + tid; i < n; i += stride) o[i] = add(a[i], b[i]);
}

// The address the current device reads `p` at: itself for device and
// managed memory, the mapped device pointer for pinned host memory.
// Pageable host memory gives cudaErrorInvalidValue.
inline cudaError_t device_ptr(const void* p, const void** out) {
  cudaPointerAttributes attr;
  cudaError_t e = cudaPointerGetAttributes(&attr, p);
  if (e != cudaSuccess) {
    cudaGetLastError();  // not sticky: clear it for the next launch check
    return e;
  }
  if (attr.type == cudaMemoryTypeDevice ||
      attr.type == cudaMemoryTypeManaged) {
    *out = p;
    return cudaSuccess;
  }
  if (attr.type == cudaMemoryTypeHost && attr.devicePointer != nullptr) {
    *out = attr.devicePointer;
    return cudaSuccess;
  }
  return cudaErrorInvalidValue;
}

}  // namespace acc

extern "C" {

// out = a + b over n elements of float32 (dtype 0) or int32 (dtype 1),
// on `stream` of the current device.  Returns cudaGetLastError() (0 on
// success), the error of a pointer the card cannot reach, or
// cudaErrorInvalidValue for n < 1 or an unknown dtype.  Does not
// synchronize.
int accumulate(const void* a, const void* b, void* out, long long n,
               int dtype, void* stream) {
  if (n < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const void *da, *db, *dout;
  cudaError_t e;
  if ((e = acc::device_ptr(a, &da)) != cudaSuccess ||
      (e = acc::device_ptr(b, &db)) != cudaSuccess ||
      (e = acc::device_ptr(out, &dout)) != cudaSuccess)
    return static_cast<int>(e);
  const int vec = ((reinterpret_cast<unsigned long long>(da) |
                    reinterpret_cast<unsigned long long>(db) |
                    reinterpret_cast<unsigned long long>(dout)) &
                   15) == 0;
  const int grid = grid_stride::blocks_for(vec ? n / 4 + 4 : n, acc::THREADS,
                                           acc::BLOCKS_PER_SM);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    acc::accumulate_kernel<float, float4><<<grid, acc::THREADS, 0, s>>>(
        static_cast<const float*>(da), static_cast<const float*>(db),
        static_cast<float*>(const_cast<void*>(dout)), n, vec);
  else
    acc::accumulate_kernel<int, int4><<<grid, acc::THREADS, 0, s>>>(
        static_cast<const int*>(da), static_cast<const int*>(db),
        static_cast<int*>(const_cast<void*>(dout)), n, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
