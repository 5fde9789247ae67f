"""The FMA busy-wait (K6): a pure-compute command with linear runtime.

Counterpart of ``tpu_patterns/concurrency/kernels.py``.  Each element
runs ``64 * tripcount`` dependent fused multiply-adds
``x <- fma(x, 0.999999, 1e-6)``, a device busy-loop whose duration scales
linearly with ``tripcount`` (the reference suite's MAD_64 ladder).  The
iteration contracts toward b / (1 - a), so values stay finite and the
result stays data-dependent.

* :func:`busy_wait` (K6) launches ``csrc/busy_wait.cu`` for a CUDA
  tensor (counted in ``busy_wait.launches``) and runs the plain version
  for a CPU tensor; there is no other path.
* :func:`busy_wait_plain` is the same function in plain torch.

Each step rounds once to float32, as the reference's ``x * _A + _B``
does once XLA contracts it into a fused multiply-add; see
:func:`busy_wait_plain`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

_A = 0.999999
_B = 1e-6
FMAS_PER_TRIP = 64  # the MAD_64 ladder
# the float32 constants the reference's weakly typed python floats become
A32 = float(np.float32(_A))
B32 = float(np.float32(_B))


def flops(n_elements: int, tripcount: int) -> int:
    """2 FLOPs per FMA."""
    return 2 * FMAS_PER_TRIP * tripcount * n_elements


def _check(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: want float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def _check_tripcount(tripcount: int) -> None:
    if tripcount < 0:
        raise ValueError(f"tripcount must be >= 0, got {tripcount}")


def busy_wait_plain(x: torch.Tensor, tripcount: int) -> torch.Tensor:
    """Plain K6: ``64 * tripcount`` steps ``x <- fl32(x * a + b)``, each
    rounded once to float32, on a new tensor.

    Not ``x * a + b`` in float32: that rounds the product and then the
    sum, and drifts from the reference by ~3.8e-6 a trip.  Each step is
    one ``addcmul`` whose operands ``a`` and ``b`` are float64, so it
    computes in float64, where the product of two float32 values is
    exact and the sum rounds once, and stores to float32: a fused
    multiply-add but for the rare double rounding through float64."""
    _check(x, "busy_wait_plain")
    _check_tripcount(tripcount)
    y = x.clone()
    a = torch.full((1,), A32, dtype=torch.float64, device=x.device)
    b = torch.full((1,), B32, dtype=torch.float64, device=x.device)
    for _ in range(FMAS_PER_TRIP * tripcount):
        torch.addcmul(b, y, a, out=y)
    return y


def _library() -> ctypes.CDLL:
    from tpu_patterns_torch.kernels.build import load

    lib = load("busy_wait")
    if lib.busy_wait.argtypes is None:
        ptr, i64, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
        lib.busy_wait.restype = ctypes.c_int
        lib.busy_wait.argtypes = [ptr, ptr, i64, i64, f32, f32, ptr]
    return lib


def busy_wait(x: torch.Tensor, tripcount: int) -> torch.Tensor:
    """K6: ``64 * tripcount`` dependent FMAs per element of a float32
    tensor, on a new tensor.  A CUDA tensor launches the kernel on the
    current stream (or raises); a CPU tensor runs
    :func:`busy_wait_plain`."""
    if x.device.type == "cpu":
        return busy_wait_plain(x, tripcount)
    _check(x, "busy_wait")
    _check_tripcount(tripcount)
    if x.device.type != "cuda":
        raise ValueError(f"busy_wait: no kernel for device {x.device}")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        rc = _library().busy_wait(
            x.data_ptr(), y.data_ptr(), x.numel(), tripcount, A32, B32,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"busy_wait kernel launch failed: CUDA error {rc}")
    busy_wait.launches += 1
    return y


busy_wait.launches = 0
