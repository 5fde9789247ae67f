"""torch-callable wrappers over the native C++ module.

Counterpart of ``tpu_patterns/interop/calls.py``, with its names.  Each
wrapper is the "pointer sharing proof" of the reference's interop suite
(interop_omp_sycl.cpp:51-72 / interop_omp_ze_sycl.cpp:92-113): data
produced by torch (possibly by a CUDA kernel, ``interop/kernel.py``)
flows into C++ without a copy, and C++ results flow back into torch
programs.  The depths:

* typed (``ffi_clock_ns``, ``ffi_checksum``, ``ffi_saxpy``):
  ``torch.library`` custom ops whose implementation hands the C++ the
  ``data_ptr()`` of a contiguous float32 tensor, no copy.  Each has a
  fake implementation, so it traces whole under ``torch.compile`` (the
  counterpart of ``jax.jit``).  They are registered for the CPU alone,
  as the reference registers its handlers for the ``cpu`` platform: a
  CUDA tensor raises.  The clock is ``int64[1]`` where the reference's
  is ``uint64[1]``, since torch supports uint64 only in part;
* raw (``raw_info``): the tensor's DLPack capsule, parsed by hand in C++;
* host callback (``host_checksum``, ``host_saxpy``): custom ops for the
  CPU and CUDA whose CUDA implementation stages the operands into pinned
  host memory, runs the C++ on the staged buffers and copies the result
  back to the device (≙ ``jax.pure_callback``);
* eager offload (``offload_checksum``, ``offload_saxpy``): the same
  staging done eagerly, outside any program (≙ PJRT transfers).

Ownership (also in ``csrc/tpu_patterns_native.cc``): torch owns every
buffer; C++ borrows it for the call (the ownership::keep discipline of
interop_omp_ze_sycl.cpp:56-73).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_patterns_torch.interop import native

_CPU = torch.device("cpu")
DLPACK_CAPSULE = b"dltensor_versioned"  # DLPack >= 1.0


def _host_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, which the C++ reads through ``data_ptr()``: a
    contiguous float32 tensor in host memory, or a ``ValueError``."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"native op: a contiguous float32 tensor, got "
                         f"{x.dtype}, contiguous={x.is_contiguous()}")
    if x.device.type != "cpu":
        raise ValueError(f"native op: a host tensor, got one on {x.device}")
    return x


def _checksum(x: torch.Tensor) -> int:
    x = _host_f32(x)
    return native.load().tp_checksum_f32_direct(x.data_ptr(), x.numel())


def _saxpy(alpha: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    x, y = _host_f32(x), _host_f32(y)
    if x.shape != y.shape:
        raise ValueError(f"saxpy: shape mismatch, {tuple(x.shape)} and "
                         f"{tuple(y.shape)}")
    out = torch.empty_like(x)
    native.load().tp_saxpy_direct(alpha, x.data_ptr(), y.data_ptr(),
                                  out.data_ptr(), out.numel())
    return out


# -- typed depth (CPU) --------------------------------------------------------


@torch.library.custom_op("tp::clock_ns", mutates_args=(), device_types="cpu")
def _clock_op(device: torch.device) -> torch.Tensor:
    return torch.tensor([native.clock_ns()], dtype=torch.int64)


@_clock_op.register_fake
def _(device):
    return torch.empty(1, dtype=torch.int64, device=device)


@torch.library.custom_op("tp::checksum_f32", mutates_args=(),
                         device_types="cpu")
def _checksum_op(x: torch.Tensor) -> torch.Tensor:
    return torch.tensor([_checksum(x)], dtype=torch.int32)


@_checksum_op.register_fake
def _(x):
    return x.new_empty(1, dtype=torch.int32)


@torch.library.custom_op("tp::saxpy", mutates_args=(), device_types="cpu")
def _saxpy_op(x: torch.Tensor, y: torch.Tensor, alpha: float) -> torch.Tensor:
    return _saxpy(alpha, x, y)


@_saxpy_op.register_fake
def _(x, y, alpha):
    return torch.empty_like(x)


def ffi_clock_ns() -> torch.Tensor:
    """Monotonic timestamp taken by C++ inside the program, ``int64[1]``
    (C4 native clock)."""
    return torch.ops.tp.clock_ns(_CPU)


def ffi_checksum(x: torch.Tensor) -> torch.Tensor:
    """Wrapped-int32 checksum computed by C++ on the tensor's memory,
    ``int32[1]`` (C5)."""
    return torch.ops.tp.checksum_f32(x.to(torch.float32).reshape(-1))


def ffi_saxpy(alpha: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``alpha*x + y`` computed by C++ zero-copy on the tensors' memory,
    into a new tensor (C13)."""
    return torch.ops.tp.saxpy(x.to(torch.float32).contiguous(),
                              y.to(torch.float32).contiguous(), float(alpha))


# -- raw depth ----------------------------------------------------------------

_get_pointer = ctypes.pythonapi.PyCapsule_GetPointer
_get_pointer.restype = ctypes.c_void_p
_get_pointer.argtypes = [ctypes.py_object, ctypes.c_char_p]


def raw_info(x: torch.Tensor) -> torch.Tensor:
    """Low-level probe (C14): C++ parses the tensor's DLPack capsule by
    hand and returns ``int32[8]`` = {dlpack_major, dlpack_minor, flags,
    nargs, dtype_code, ndim, data_ptr_lo16, first_element_as_int}
    (first element -1 where the host cannot read the memory).  The
    capsule stays Python's: the C++ borrows it."""
    t = x.detach().to(torch.float32)
    capsule = t.__dlpack__(max_version=(1, 0))
    out = torch.empty(8, dtype=torch.int32)
    rc = native.load().tp_raw_info_dlpack(
        _get_pointer(capsule, DLPACK_CAPSULE), out.data_ptr())
    if rc != 0:
        raise RuntimeError("raw_info: not a DLPack >= 1.0 tensor")
    return out


# -- host staging -------------------------------------------------------------


def stage_to_host(x: torch.Tensor) -> torch.Tensor:
    """``x`` as contiguous float32 host memory for the C++: a CUDA tensor
    is copied device to host into a pinned buffer (the copy has ended
    when this returns); a CPU tensor is used in place where it is
    already contiguous float32."""
    if x.device.type == "cuda":
        staged = torch.empty(x.shape, dtype=torch.float32, pin_memory=True)
        staged.copy_(x)
        if not staged.is_pinned():
            raise RuntimeError("host staging: the buffer is not pinned")
        return staged
    if x.device.type != "cpu":
        raise ValueError(f"host staging: no path from {x.device}")
    return x.to(torch.float32).contiguous()


def _checksum_staged(x: torch.Tensor) -> torch.Tensor:
    cs = _checksum(stage_to_host(x.reshape(-1)))
    return torch.tensor([cs], dtype=torch.int32).to(x.device)


def _saxpy_staged(alpha: float, x: torch.Tensor, y: torch.Tensor
                  ) -> torch.Tensor:
    return _saxpy(alpha, stage_to_host(x), stage_to_host(y)).to(x.device)


# -- host-callback depth (CPU and CUDA, under torch.compile) ------------------


@torch.library.custom_op("tp::host_checksum", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _host_checksum_op(x: torch.Tensor) -> torch.Tensor:
    return _checksum_staged(x)


@_host_checksum_op.register_fake
def _(x):
    return x.new_empty(1, dtype=torch.int32)


@torch.library.custom_op("tp::host_saxpy", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _host_saxpy_op(x: torch.Tensor, y: torch.Tensor,
                   alpha: float) -> torch.Tensor:
    return _saxpy_staged(alpha, x, y)


@_host_saxpy_op.register_fake
def _(x, y, alpha):
    return torch.empty_like(x)


def host_checksum(x: torch.Tensor) -> torch.Tensor:
    """Wrapped-int32 checksum via host staging inside a program, on the
    CPU or the card; ``int32[1]`` on ``x``'s device."""
    return torch.ops.tp.host_checksum(x.to(torch.float32).reshape(-1))


def host_saxpy(alpha: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``alpha*x + y`` computed by C++ on host-staged buffers inside a
    program (the staging twin of :func:`ffi_saxpy`); the result returns
    to ``x``'s device."""
    return torch.ops.tp.host_saxpy(x.to(torch.float32), y.to(torch.float32),
                                   float(alpha))


@functools.cache
def supports_host_callbacks(device: str = "cpu") -> bool:
    """Whether a compiled program on ``device`` runs a host op, probed
    with a throwaway program as the reference probes ``pure_callback``.
    A compile or run that fails raises: it is a fault, not an absent
    capability."""
    prog = torch.compile(lambda a: host_checksum(a), fullgraph=True,
                         backend="aot_eager")
    return int(prog(torch.ones(2, device=device))[0]) == 2


# -- eager offload depth ------------------------------------------------------


def offload_checksum(x: torch.Tensor) -> torch.Tensor:
    """Eager host-offload checksum: stage the tensor into host memory
    (pinned, from the card), C++ reduces the staged buffer zero-copy, and
    the ``int32[1]`` result returns to ``x``'s device."""
    return _checksum_staged(x)


def offload_saxpy(alpha: float, x: torch.Tensor, y: torch.Tensor
                  ) -> torch.Tensor:
    """Eager host-offload saxpy; C++ writes into a host buffer that is
    then copied to ``x``'s device — one copy each direction, none on the
    host."""
    return _saxpy_staged(alpha, x, y)
