"""K10: ``x + 1`` as a CUDA kernel (``csrc/add_one.cu``).

Counterpart of the inline Pallas kernel of ``tests/test_interop.py``
(``kern``, :67-68, called at :72), whose output the JAX package's
``ffi_checksum`` reads without a copy inside one compiled program.  Here
:func:`add_one` launches the kernel on a CUDA tensor, in device or
managed memory, and its output reaches the native C++ in place (managed
memory, after a synchronize) or through host staging
(``calls.offload_checksum``, ``calls.host_checksum``).  A CPU tensor
runs the plain version, :func:`add_one_reference`.

The kernel is a streaming tile (``kernels/csrc/stream_tile.cuh``, K5's)
of one 16-byte vector a thread and 1024 threads a block;
:func:`tile_grid` mirrors its grid (chip_smoke.py holds it to the C
side's ``add_one_grid``) and :func:`tile_elements` its tiles.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_patterns_torch.kernels import tile


def _library() -> ctypes.CDLL:
    """The built K10 library with its C signature declared."""
    from tpu_patterns_torch.kernels.build import load

    lib = load("add_one")
    if lib.add_one.argtypes is None:
        ptr = ctypes.c_void_p
        lib.add_one.restype = ctypes.c_int
        lib.add_one.argtypes = [ptr, ptr, ctypes.c_longlong, ptr]
        lib.add_one_grid.restype = ctypes.c_longlong
        lib.add_one_grid.argtypes = [ctypes.c_longlong, ctypes.c_int]
    return lib


# K10's tile (csrc/add_one.cu)
THREADS, VECS = 1024, 1


def tile_grid(n: int, vector: bool) -> int:
    """The blocks K10 launches over ``n`` elements, as the C side's
    ``add_one_grid`` computes them (:func:`kernels.tile.tile_grid`)."""
    return tile.tile_grid(n, vector, THREADS, VECS)


def tile_elements(n: int, vector: bool, block: int) -> torch.Tensor:
    """The element indices block ``block`` of K10's launch over ``n``
    elements writes (:func:`kernels.tile.tile_elements`)."""
    return tile.tile_elements(n, vector, block, THREADS, VECS)


def tile_plan(n: int, vector: bool):
    """(block, element) of every element K10's launch over ``n`` elements
    writes, for the whole grid at once (:func:`kernels.tile.tile_plan`)."""
    return tile.tile_plan(n, vector, THREADS, VECS)


def add_one_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain K10: ``x + 1.0`` (IEEE single add, round to nearest)."""
    return x + 1.0


def add_one(x: torch.Tensor, out: torch.Tensor | None = None
            ) -> torch.Tensor:
    """``x + 1`` elementwise over float32 of any shape (K10), into
    ``out`` when given (same shape, float32, contiguous, on ``x``'s
    device, e.g. a managed buffer), else into a new tensor.

    On a CUDA tensor the kernel launches on the device's current stream
    and is not waited for; a launch error raises.  A non-contiguous
    input, another dtype or a device with no kernel raises.  A CPU
    tensor runs the plain version."""
    if x.dtype != torch.float32:
        raise ValueError(f"add_one: float32, got {x.dtype}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device
                            or not out.is_contiguous()):
        raise ValueError("add_one: out must be a contiguous float32 tensor "
                         "of x's shape on x's device")
    if x.device.type == "cpu":
        if out is None:
            return add_one_reference(x)
        return out.copy_(add_one_reference(x))
    if x.device.type != "cuda":
        raise ValueError(f"add_one: no kernel for device {x.device}")
    if not x.is_contiguous():
        raise ValueError("add_one: the input must be contiguous")
    if out is None:
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream()
        rc = _library().add_one(x.data_ptr(), out.data_ptr(), x.numel(),
                                stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"add_one kernel launch failed: CUDA error {rc}")
    add_one.launches += 1
    return out


add_one.launches = 0


def reset_launches() -> None:
    """Set K10's launch count to 0."""
    add_one.launches = 0


def launch_counts() -> dict[str, int]:
    return {"add_one": add_one.launches}
