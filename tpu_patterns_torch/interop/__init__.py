"""torch <-> native C++ interop (ref: sycl_omp_ze_interopt/).

Counterpart of ``tpu_patterns/interop/``.  The reference demonstrates two
interop depths between runtimes sharing one device context (SURVEY.md
C13/C14): a high-level typed path (OpenMP 5.1 ``interop`` pragma yielding
SYCL objects, interop_omp_sycl.cpp:13-75) and a low-level native-handle
path (raw ze_driver/context/device extraction,
interop_omp_ze_sycl.cpp:14-117), each proving bidirectional pointer
sharing.

Here the two depths are: typed ``torch.library`` custom ops over the
C++ entry points (high-level, ``calls.ffi_*``), and a hand-parsed
DLPack capsule (low-level, ``calls.raw_info``) — both working zero-copy
on torch-owned memory; the card reaches the C++ through host staging
(``calls.host_*``, ``calls.offload_*``).  ``kernel.add_one`` is K10, the
CUDA kernel whose output the C++ reads in place.
"""

from tpu_patterns_torch.interop import native  # noqa: F401
from tpu_patterns_torch.interop.calls import (  # noqa: F401
    ffi_checksum,
    ffi_clock_ns,
    ffi_saxpy,
    raw_info,
)
