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
// fit VMEM; here nothing is padded.  A streaming add: each block takes a
// fixed tile of TILE = THREADS x VECS x 4 elements, and each thread
// issues all of its VECS 16-byte loads of a and of b (8 in flight)
// before its first add, then stores its VECS vectors: thread t of block
// k takes vectors k * THREADS * VECS + t + j * THREADS, j < VECS, so a
// warp's loads are contiguous.  The grid is sized from n (no SM count is
// read), the ragged tail of vectors is masked, and the last block also
// adds the n % 4 elements past the last whole vector.  When any of the
// three pointers is not 16-byte aligned (a view that starts inside a
// buffer) the scalar kernel takes the shard, the same tile of single
// elements.  Loads and the store are ordinary ones: the streaming hint
// (ld.global.cs) on the loads was no faster on the H100 (PERF.md), and
// the ring's next step reads the output.  Float adds are __fadd_rn (IEEE round to
// nearest, never contracted) and int32 adds wrap through unsigned
// arithmetic, so the kernel equals a + b in torch bit for bit.
//
// The launch path.  The ring launches K5 (p-1) x p times an allreduce,
// at 2^23 elements ~0.04 ms of device time each, so the host's work per
// call must stay under that.  The entry makes no query for device or
// managed memory: the wrapper says which operands are pinned host
// memory (the miniapp's H kind), and only those are looked up, for the
// device pointer the card reads them through (over the bus).  Managed
// memory (S) and device memory (D) are read directly.  The entry
// switches to the rank's device only when it is not the current one.
// A host pointer that is not pinned is refused.

#include <cuda_runtime.h>

#include "../../../../kernels/csrc/stream_tile.cuh"

namespace acc {

using Tile = stream_tile::Tile<256, 4>;
constexpr int THREADS = Tile::THREADS;
constexpr int VECS = Tile::VECS;
constexpr long long TILE = Tile::TILE;

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

template <typename T, typename V>
__global__ void __launch_bounds__(THREADS)
    accumulate_vec_kernel(const T* __restrict__ a, const T* __restrict__ b,
                          T* __restrict__ o, long long n) {
  const long long nv = n / 4;
  const long long v0 =
      static_cast<long long>(blockIdx.x) * (THREADS * VECS) + threadIdx.x;
  const V* av = reinterpret_cast<const V*>(a);
  const V* bv = reinterpret_cast<const V*>(b);
  V* ov = reinterpret_cast<V*>(o);
  V x[VECS], y[VECS];
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const long long v = v0 + j * THREADS;
    if (v < nv) {
      x[j] = av[v];
      y[j] = bv[v];
    }
  }
#pragma unroll
  for (int j = 0; j < VECS; ++j) {
    const long long v = v0 + j * THREADS;
    if (v < nv) {
      V z;
      z.x = add(x[j].x, y[j].x);
      z.y = add(x[j].y, y[j].y);
      z.z = add(x[j].z, y[j].z);
      z.w = add(x[j].w, y[j].w);
      ov[v] = z;
    }
  }
  // the n % 4 elements past the last whole vector
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < n - nv * 4) {
    const long long i = nv * 4 + threadIdx.x;
    o[i] = add(a[i], b[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    accumulate_scalar_kernel(const T* __restrict__ a,
                             const T* __restrict__ b, T* __restrict__ o,
                             long long n) {
  constexpr int ELEMS = VECS * 4;
  const long long i0 =
      static_cast<long long>(blockIdx.x) * TILE + threadIdx.x;
  T x[ELEMS], y[ELEMS];
#pragma unroll
  for (int j = 0; j < ELEMS; ++j) {
    const long long i = i0 + j * THREADS;
    if (i < n) {
      x[j] = a[i];
      y[j] = b[i];
    }
  }
#pragma unroll
  for (int j = 0; j < ELEMS; ++j) {
    const long long i = i0 + j * THREADS;
    if (i < n) o[i] = add(x[j], y[j]);
  }
}

// The address the current device reads pinned host memory `p` at.
// Memory that is not pinned host memory gives cudaErrorInvalidValue.
inline cudaError_t host_device_ptr(const void* p, const void** out) {
  cudaPointerAttributes attr;
  cudaError_t e = cudaPointerGetAttributes(&attr, p);
  if (e != cudaSuccess) {
    cudaGetLastError();  // not sticky: clear it for the next launch check
    return e;
  }
  if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr)
    return cudaErrorInvalidValue;
  *out = attr.devicePointer;
  return cudaSuccess;
}

template <typename T, typename V>
void launch(const void* a, const void* b, void* o, long long n,
            cudaStream_t s) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  T* to = static_cast<T*>(o);
  if (((reinterpret_cast<unsigned long long>(a) |
        reinterpret_cast<unsigned long long>(b) |
        reinterpret_cast<unsigned long long>(o)) &
       15) != 0) {
    const unsigned grid = static_cast<unsigned>(Tile::grid(n, false));
    accumulate_scalar_kernel<T><<<grid, THREADS, 0, s>>>(ta, tb, to, n);
    return;
  }
  const unsigned grid = static_cast<unsigned>(Tile::grid(n, true));
  accumulate_vec_kernel<T, V><<<grid, THREADS, 0, s>>>(ta, tb, to, n);
}

}  // namespace acc

extern "C" {

// The blocks K5 launches over n elements, vec 1 on the vector path and
// 0 on the scalar one (the smoke holds pallas.tile_grid to it).
long long accumulate_grid(long long n, int vec) {
  return acc::Tile::grid(n, vec != 0);
}

// out = a + b over n elements of float32 (dtype 0) or int32 (dtype 1),
// on `stream` of device `device`.  Bit i of `host` (a, b, out) marks an
// operand in pinned host memory, read through its device pointer; every
// other operand is device or managed memory, used as it is.  Returns
// cudaGetLastError() (0 on success), the error of a host pointer the
// card cannot reach, or cudaErrorInvalidValue for n < 1, n past the
// grid's reach or an unknown dtype.  Does not synchronize.
int accumulate(const void* a, const void* b, void* out, long long n,
               int dtype, int host, int device, void* stream) {
  if (n < 1 || n / acc::TILE >= 0x7fffffffLL || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int prev = -1;
  cudaError_t e = cudaGetDevice(&prev);
  if (e == cudaSuccess && prev != device) e = cudaSetDevice(device);
  const void* p[3] = {a, b, out};
  for (int i = 0; i < 3 && e == cudaSuccess; ++i)
    if (host & (1 << i)) e = acc::host_device_ptr(p[i], &p[i]);
  if (e == cudaSuccess) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
      acc::launch<float, float4>(p[0], p[1], const_cast<void*>(p[2]), n, s);
    else
      acc::launch<int, int4>(p[0], p[1], const_cast<void*>(p[2]), n, s);
    e = cudaGetLastError();
  }
  if (prev >= 0 && prev != device) cudaSetDevice(prev);
  return static_cast<int>(e);
}

}  // extern "C"
