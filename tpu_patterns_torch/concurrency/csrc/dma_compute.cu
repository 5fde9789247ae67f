// Copies and busy-wait computes in one kernel, for Hopper (sm_90a): K7.
//
// Replaces tpu_patterns/concurrency/backends.py::PallasBackend.build's
// `kernel` (:248): one program that starts n HBM->HBM async copies on
// DMA semaphores and runs m busy-wait computes on VMEM blocks.  Under
// `dma_overlap` it starts every copy, computes, then waits on the copies;
// under `dma_serial` it waits on each copy before computing.
//
// What bounds it on this card: the larger of the copies' bytes (each read
// once and written once) over 3.35 TB/s and the computes' flops
// (2 x 64 x tripcount per element) over 67 TFLOP/s of f32.  At the
// suite's "C D2D" defaults that is the flops, 0.0783 ms (the 16 MiB copy
// alone is 0.0100 ms); a compute of 1024 elements is one dependent FMA
// chain per element, so the chain's latency (~5.2 ms) and not the card's
// rate sets its time, as for K6.  Under dma_serial the mode's own floor
// is the sum of the two.
//
// Design.  One cooperative launch whose blocks take roles by blockIdx:
//   * copy blocks, the first n_copy_blocks, split among the copies (each
//     copy gets at least one): each streams its segments of its copy
//     through shared memory with the bulk asynchronous copies of
//     comm/csrc/bulk_copy.cuh, the load on an mbarrier and the store in a
//     bulk group, and ends after its bulk-group wait, when every byte it
//     stored has landed;
//   * compute blocks, the rest: one thread per element, grid-stride over
//     the computes' elements laid end to end, each element's chain from
//     busy_wait.cuh (the K6 device function).
// dma_overlap: the roles run side by side, and the kernel ends when the
// last copy block has landed its bytes.  dma_serial: each copy block,
// once its stores have landed, releases a device-scope counter; every
// compute block waits until it acquires the count of all copy blocks, so
// no compute starts before the last byte of every copy has landed,
// grid-wide.  That wait needs every block resident at once: the launch is
// cooperative (cudaLaunchCooperativeKernel refuses a grid that cannot be
// co-resident), and the grid is sized under the occupancy of the kernel
// at its shared memory times the SMs, so the wait cannot deadlock.  The
// copies share the copy blocks in both modes: they are in flight together
// with each other.
//
// A launch takes at most MAX_COPIES copies and MAX_COMPUTES computes, in
// one parameter struct passed by value.
//
// Host path.  The grid's size needs the card's SM count, the kernel's
// dynamic shared-memory allowance and its occupancy at the launch's
// shared memory; those queries cost more host time than a 128 MiB copy
// takes on the card, so each is made once per device (the occupancy once
// per shared-memory size) and kept.

#include <mutex>

#include "../../comm/csrc/bulk_copy.cuh"
#include "busy_wait.cuh"

namespace dma {

constexpr int MAX_COPIES = 8;
constexpr int MAX_COMPUTES = 8;
constexpr int THREADS = put::THREADS;

struct Compute {
  const float* x;
  float* y;
  long long n, tripcount;
};

struct Params {
  put::Plan copy[MAX_COPIES];
  // copy c is done by blocks [first[c], first[c + 1])
  long long first[MAX_COPIES + 1];
  Compute comp[MAX_COMPUTES];
  long long comp_total;  // elements over every compute
  int n_copy, n_comp;
  float a, b;
  int serial;
  unsigned int* done;  // dma_serial: copy blocks whose bytes have landed
};

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__global__ void __launch_bounds__(THREADS) dma_compute_kernel(Params p) {
  const long long bid = blockIdx.x;
  const long long n_copy_blocks = p.first[p.n_copy];
  if (bid < n_copy_blocks) {
    int c = 0;
    while (bid >= p.first[c + 1]) ++c;
    put::run(p.copy[c], bid - p.first[c], p.first[c + 1] - p.first[c]);
    if (p.serial) {
      __syncthreads();  // the threads' head and tail bytes, and thread 0's
                        // bulk-group wait
      if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(p.done, 1u);
      }
    }
    return;
  }
  if (p.serial && n_copy_blocks > 0) {
    if (threadIdx.x == 0) {
      while (load_acquire(p.done) < static_cast<unsigned int>(n_copy_blocks))
        __nanosleep(256);
    }
    __syncthreads();
  }
  const long long stride =
      (static_cast<long long>(gridDim.x) - n_copy_blocks) * THREADS;
  for (long long e = (bid - n_copy_blocks) * THREADS + threadIdx.x;
       e < p.comp_total; e += stride) {
    long long off = e;
    int c = 0;
    while (off >= p.comp[c].n) off -= p.comp[c++].n;
    p.comp[c].y[off] = busy::chain(p.comp[c].x[off], p.comp[c].tripcount,
                                   p.a, p.b);
  }
}

// What the launch's set-up asks of the runtime, per device: the SM
// count, the dynamic shared memory the kernel is allowed so far, and the
// blocks per SM at each shared-memory size met (the newest SMEM_SIZES).
constexpr int MAX_DEVICES = 64;
constexpr int SMEM_SIZES = 16;

struct DeviceInfo {
  int sms = 0;
  int smem_allowed = -1;
  int n_sizes = 0, next = 0;
  size_t smem[SMEM_SIZES];
  int per_sm[SMEM_SIZES];
};

DeviceInfo g_info[MAX_DEVICES];
std::mutex g_info_mutex;

// The number of blocks that can be resident at once with `smem` bytes of
// dynamic shared memory each, on the current device.
cudaError_t resident_blocks(size_t smem, long long* resident) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(g_info_mutex);
  DeviceInfo& d = g_info[dev];
  if (d.sms == 0) {
    e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  if (static_cast<int>(smem) > d.smem_allowed) {
    e = cudaFuncSetAttribute(dma_compute_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    d.smem_allowed = static_cast<int>(smem);
  }
  for (int i = 0; i < d.n_sizes; ++i)
    if (d.smem[i] == smem) {
      *resident = static_cast<long long>(d.per_sm[i]) * d.sms;
      return cudaSuccess;
    }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dma_compute_kernel, THREADS, smem);
  if (e != cudaSuccess) return e;
  d.smem[d.next] = smem;
  d.per_sm[d.next] = per_sm;
  d.next = (d.next + 1) % SMEM_SIZES;
  if (d.n_sizes < SMEM_SIZES) ++d.n_sizes;
  *resident = static_cast<long long>(per_sm) * d.sms;
  return cudaSuccess;
}

}  // namespace dma

extern "C" {

int dma_compute_max_copies() { return dma::MAX_COPIES; }
int dma_compute_max_computes() { return dma::MAX_COMPUTES; }

// One K7 launch on `stream`.  Copy c moves n_seg[c] segments of
// seg_bytes[c] bytes, laid end to end, from copy_src[c] to copy_dst[c];
// compute c writes the chain of comp_n[c] float32 elements of comp_x[c]
// at comp_trips[c] trips to comp_y[c].  `serial` orders every compute
// after every copy; `done` is a 4-byte device scratch word that the
// launch zeroes first.  Returns the CUDA error of the set-up or the
// launch (0 on success), cudaErrorInvalidValue for counts out of range,
// an empty copy or compute, or a negative tripcount, and
// cudaErrorCooperativeLaunchTooLarge when the copies and at least one
// compute block cannot all be resident.  Does not synchronize.
int dma_compute(const void* const* copy_src, void* const* copy_dst,
                const long long* n_seg, const long long* seg_bytes,
                int n_copy, const void* const* comp_x, void* const* comp_y,
                const long long* comp_n, const long long* comp_trips,
                int n_comp, float a, float b, int serial, void* done,
                void* stream) {
  if (n_copy < 0 || n_copy > dma::MAX_COPIES || n_comp < 0 ||
      n_comp > dma::MAX_COMPUTES || n_copy + n_comp < 1 ||
      (serial && n_copy && !done))
    return static_cast<int>(cudaErrorInvalidValue);
  dma::Params p{};
  p.n_copy = n_copy;
  p.n_comp = n_comp;
  p.a = a;
  p.b = b;
  p.serial = serial;
  p.done = static_cast<unsigned int*>(done);
  long long stage = 0, total_seg = 0;
  for (int c = 0; c < n_copy; ++c) {
    if (n_seg[c] < 1 || seg_bytes[c] < 1 || seg_bytes[c] > 0x7fffffffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long s = put::stage_for(seg_bytes[c]);
    p.copy[c] = put::Plan{static_cast<const unsigned char*>(copy_src[c]),
                          static_cast<unsigned char*>(copy_dst[c]), n_seg[c],
                          seg_bytes[c], seg_bytes[c], s};
    stage = s > stage ? s : stage;
    total_seg += n_seg[c];
  }
  for (int c = 0; c < n_comp; ++c) {
    if (comp_n[c] < 1 || comp_trips[c] < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    p.comp[c] = dma::Compute{static_cast<const float*>(comp_x[c]),
                             static_cast<float*>(comp_y[c]), comp_n[c],
                             comp_trips[c]};
    p.comp_total += comp_n[c];
  }
  const size_t smem =
      n_copy ? static_cast<size_t>(put::BAR_BYTES + put::STAGES * stage) : 0;
  long long resident = 0;
  cudaError_t e = dma::resident_blocks(smem, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  // compute blocks: one thread per element, leaving a block per copy
  long long n_cmp = (p.comp_total + dma::THREADS - 1) / dma::THREADS;
  if (n_cmp > resident - n_copy) n_cmp = resident - n_copy;
  if ((n_comp && n_cmp < 1) || resident < n_copy)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // copy blocks: the rest of the resident grid, at most one per segment;
  // each copy gets one, and the others in proportion to its segments
  long long n_cpy = resident - n_cmp;
  if (n_cpy > total_seg) n_cpy = total_seg;
  p.first[0] = 0;
  for (int c = 0; c < n_copy; ++c) {
    long long k = 1 + (n_cpy - n_copy) * n_seg[c] / total_seg;
    if (k > n_seg[c]) k = n_seg[c];
    p.first[c + 1] = p.first[c] + k;
  }
  const long long grid = p.first[n_copy] + n_cmp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (serial && n_copy) {
    e = cudaMemsetAsync(done, 0, sizeof(unsigned int), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(dma::dma_compute_kernel),
      dim3(static_cast<unsigned>(grid)), dim3(dma::THREADS), args, smem, st);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
