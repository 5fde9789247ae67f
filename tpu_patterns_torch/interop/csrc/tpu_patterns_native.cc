// tpu_patterns_torch native module: the host entry points of the interop
// suite, a plain C interface with no framework headers.
//
// The port's own copy of csrc/tpu_patterns_ffi.cc (the JAX package's
// native module) without its XLA FFI handlers.  Native (C++) parity with
// the reference's native layers (SURVEY.md §2.2):
//   * monotonic clock            — the timing core's clock
//                                  (≙ the std::chrono timing in
//                                  p2p/peer2pear.cpp:26-28 and
//                                  concurency/bench_sycl.cpp:84-121)
//   * wrapped-int32 checksum     — the data-integrity verifier's reduction
//                                  (≙ sort+sum validation,
//                                  peer2pear.cpp:55-63)
//   * saxpy (high-level interop) — typed zero-copy buffer sharing between
//                                  the framework and custom C++
//                                  (≙ OMP<->SYCL pointer sharing proof,
//                                  interop_omp_sycl.cpp:51-72)
//   * raw_info (low-level interop)— a hand-parsed DLPack capsule: version,
//                                  flags, dtype, rank, data pointer
//                                  (≙ native Level-Zero handle extraction,
//                                  interop_omp_ze_sycl.cpp:25-46); the
//                                  reference parses XLA_FFI_CallFrame here
//
// Built with g++ into one shared library and loaded with ctypes
// (tpu_patterns_torch/interop/native.py); torch.library custom ops call it
// on tensor memory (tpu_patterns_torch/interop/calls.py).
//
// Ownership: the caller (torch) owns every buffer; C++ borrows it for the
// call and keeps no pointer past it (≙ sycl ownership::keep semantics —
// borrow the native handle, never adopt it; interop_omp_ze_sycl.cpp:56-73).

#include <cstdint>
#include <ctime>

static uint64_t MonotonicNs() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000000ull +
         static_cast<uint64_t>(ts.tv_nsec);
}

// The framework's clock_ns() (core/timing.py) reads this through ctypes.
extern "C" uint64_t tp_clock_ns() { return MonotonicNs(); }

// Wrapped int32 sum of the elements truncated toward zero: the invariant
// comm/verify.py computes on the device (unsigned arithmetic = defined
// wraparound).  Elements must lie in the int32 range.
extern "C" int32_t tp_checksum_f32_direct(const float* x, uint64_t n) {
  uint32_t acc = 0;
  for (uint64_t i = 0; i < n; ++i) {
    acc += static_cast<uint32_t>(static_cast<int32_t>(x[i]));
  }
  return static_cast<int32_t>(acc);
}

extern "C" void tp_saxpy_direct(float alpha, const float* x, const float* y,
                                float* out, uint64_t n) {
  for (uint64_t i = 0; i < n; ++i) out[i] = alpha * x[i] + y[i];
}

// --------------------------------------------------------------------------
// Low-level interop: a DLManagedTensorVersioned parsed by hand, with this
// file's own copy of the DLPack >= 1.0 struct layout (dlpack.h) and no
// framework header — the counterpart of the reference's raw
// XLA_FFI_CallFrame handler.  Python hands over the pointer inside a
// "dltensor_versioned" capsule (torch's Tensor.__dlpack__(max_version=
// (1, 0))).  The capsule is borrowed: this neither renames it nor calls
// its deleter, so the tensor stays owned by its framework and the
// capsule's own destructor releases it.

namespace dl {

struct PackVersion {
  uint32_t major;
  uint32_t minor;
};

struct Device {
  int32_t device_type;  // DLDeviceType
  int32_t device_id;
};

struct DataType {
  uint8_t code;  // DLDataTypeCode
  uint8_t bits;
  uint16_t lanes;
};

struct Tensor {
  void* data;
  Device device;
  int32_t ndim;
  DataType dtype;
  int64_t* shape;
  int64_t* strides;
  uint64_t byte_offset;
};

struct ManagedTensorVersioned {
  PackVersion version;
  void* manager_ctx;
  void (*deleter)(ManagedTensorVersioned* self);
  uint64_t flags;
  Tensor dl_tensor;
};

constexpr int32_t kDLCPU = 1;
constexpr int32_t kDLCUDAHost = 3;  // pinned host memory
constexpr uint8_t kDLFloat = 2;

}  // namespace dl

// Output: s32[8] = {dlpack_major, dlpack_minor, flags, nargs (1),
// dtype_code, ndim, data_ptr_lo16, first_element_as_int}.  The first
// element is read through the shared data pointer, as a float32, and is
// -1 where the host cannot read it (a device other than kDLCPU or
// kDLCUDAHost), for another dtype, or for an empty tensor.  Returns 0, or
// -1 for a null pointer or a DLPack major version below 1.
extern "C" int32_t tp_raw_info_dlpack(const void* managed, int32_t* out8) {
  const auto* m = static_cast<const dl::ManagedTensorVersioned*>(managed);
  if (m == nullptr || out8 == nullptr || m->version.major < 1) return -1;
  const dl::Tensor& t = m->dl_tensor;
  const auto* first =
      static_cast<const char*>(t.data) + t.byte_offset;
  int64_t numel = 1;
  for (int32_t i = 0; i < t.ndim; ++i) numel *= t.shape[i];
  const bool host = t.device.device_type == dl::kDLCPU ||
                    t.device.device_type == dl::kDLCUDAHost;
  const bool f32 = t.dtype.code == dl::kDLFloat && t.dtype.bits == 32 &&
                   t.dtype.lanes == 1;
  out8[0] = static_cast<int32_t>(m->version.major);
  out8[1] = static_cast<int32_t>(m->version.minor);
  out8[2] = static_cast<int32_t>(m->flags);
  out8[3] = 1;  // one tensor per capsule
  out8[4] = static_cast<int32_t>(t.dtype.code);
  out8[5] = t.ndim;
  out8[6] = static_cast<int32_t>(reinterpret_cast<uintptr_t>(first) & 0xFFFF);
  out8[7] = host && f32 && numel > 0 && t.data != nullptr
                ? static_cast<int32_t>(*reinterpret_cast<const float*>(first))
                : -1;
  return 0;
}
