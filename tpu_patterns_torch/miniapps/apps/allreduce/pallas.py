"""allreduce/pallas: the kernel variant, with the per-step accumulate as
a CUDA kernel (K5, ``csrc/accumulate.cu``).

Counterpart of ``tpu_patterns/miniapps/apps/allreduce/pallas.py``, whose
accumulate is a Pallas kernel plugged into the same ring schedule
through comm/ring's ``op`` hook; the variant keeps the reference's name
so that Records compare one to one.  The library path (psum) is refused:
it has no per-step kernel to substitute.

:func:`accumulate` launches K5 whenever the rank it runs for is on a
CUDA device, whatever memory its tensors are in: pinned host tensors
(the H kind) are read and written by the kernel through their device
pointers, managed ones (S) directly.  Only a rank on the CPU runs the
plain version, :func:`accumulate_reference`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_patterns_torch.comm.mesh import fresh_like
from tpu_patterns_torch.core.results import Record, ResultWriter
from tpu_patterns_torch.kernels import tile
from tpu_patterns_torch.miniapps.apps import allreduce as core
from tpu_patterns_torch.miniapps.framework import VariantSpec

_DTYPES = {torch.float32: 0, torch.int32: 1}  # the kernel's dtype codes
# K5's tile (csrc/accumulate.cu, kernels/csrc/stream_tile.cuh): THREADS
# threads a block, each with VECS 16-byte vectors of four elements, or
# VECS x 4 single elements on the scalar path
THREADS, VECS = 256, 4
TILE = THREADS * VECS * 4


def tile_grid(n: int, vector: bool) -> int:
    """The blocks K5 launches over ``n`` elements, as the C side's
    ``accumulate_grid`` computes them (:func:`kernels.tile.tile_grid`)."""
    return tile.tile_grid(n, vector, THREADS, VECS)


def tile_elements(n: int, vector: bool, block: int) -> torch.Tensor:
    """The element indices block ``block`` of K5's launch over ``n``
    elements writes (:func:`kernels.tile.tile_elements`)."""
    return tile.tile_elements(n, vector, block, THREADS, VECS)


def tile_plan(n: int, vector: bool):
    """(block, element) of every element K5's launch over ``n`` elements
    writes, for the whole grid at once (:func:`kernels.tile.tile_plan`)."""
    return tile.tile_plan(n, vector, THREADS, VECS)


def _library() -> ctypes.CDLL:
    """The built K5 library with its C signature declared."""
    from tpu_patterns_torch.kernels.build import load

    lib = load("accumulate")
    if lib.accumulate.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.accumulate.restype = i32
        lib.accumulate.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, i32,
                                   i32, i32, ptr]
        lib.accumulate_grid.restype = ctypes.c_longlong
        lib.accumulate_grid.argtypes = [ctypes.c_longlong, i32]
    return lib


@functools.cache
def _launcher(index: int):
    """K5's C entry bound to card ``index``, looked up once per card:
    ``launch(a, b, out, n, dtype, host)`` on the card's current stream,
    read at each call (a caller may switch streams between calls)."""
    torch.cuda.init()
    fn = _library().accumulate
    raw_stream = torch._C._cuda_getCurrentRawStream

    def launch(a: int, b: int, out: int, n: int, dtype: int, host: int
               ) -> int:
        return fn(a, b, out, n, dtype, host, index, raw_stream(index))

    return launch


def accumulate_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain K5: ``a + b`` (IEEE round to nearest for float32, wrapping
    for int32)."""
    return torch.add(a, b)


def accumulate(a: torch.Tensor, b: torch.Tensor,
               device: torch.device | str | None = None) -> torch.Tensor:
    """``a + b`` elementwise (K5) for the rank on ``device`` (default:
    ``a``'s device), as a new tensor in ``a``'s memory.

    On a CUDA rank the kernel launches on the device's current stream;
    an operand in pinned host memory is read through its device pointer,
    and the launch then completes before this returns (the host's
    caching allocator cannot see a raw launch's use of a pinned block and
    would hand it out again while the kernel still reads it).  Pageable
    host memory, a tensor on another card, a dtype other than float32 or
    int32, differing shapes or a non-contiguous operand raise.  On a CPU
    rank the plain version runs."""
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"accumulate: float32 or int32 operands of one "
                         f"dtype, got {a.dtype} and {b.dtype}")
    if a.shape != b.shape:
        raise ValueError(f"accumulate: shapes differ, {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    dev = a.device if device is None else torch.device(device)
    if dev.type == "cpu":
        if a.device.type != "cpu" or b.device.type != "cpu":
            raise ValueError("accumulate: a CPU rank with CUDA tensors")
        return accumulate_reference(a, b)
    if dev.type != "cuda":
        raise ValueError(f"accumulate: no kernel for device {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    host = 0  # bit i: operand i (a, b, out) in pinned host memory
    for i, t in enumerate((a, b)):
        if not t.is_contiguous():
            raise ValueError("accumulate: operands must be contiguous")
        if t.device.type == "cpu":
            if not t.is_pinned():
                raise ValueError("accumulate: pageable host memory, which "
                                 f"{dev} cannot reach")
            host |= 1 << i
        elif t.device != dev:
            raise ValueError(f"accumulate: a tensor on {t.device} for the "
                             f"rank on {dev}")
    out = fresh_like(a)
    if a.numel() == 0:
        return out
    if host & 1:  # out is pinned too, as a is
        host |= 4
    rc = _launcher(dev.index)(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                              a.numel(), _DTYPES[a.dtype], host)
    if rc != 0:
        raise RuntimeError(f"accumulate kernel launch failed: CUDA error {rc}")
    accumulate.launches += 1
    if host:
        torch.cuda.current_stream(dev).synchronize()
    return out


accumulate.launches = 0


def reset_launches() -> None:
    """Set K5's launch count to 0."""
    accumulate.launches = 0


def launch_counts() -> dict[str, int]:
    return {"accumulate": accumulate.launches}


def run(
    mesh=None, dtype: str = "float32", writer: ResultWriter | None = None,
    **overrides,
) -> Record:
    if mesh is None:
        from tpu_patterns_torch.miniapps.framework import default_mesh

        mesh = default_mesh()
    overrides.setdefault("algorithm", "ring")
    cfg = core.AllreduceConfig(dtype=dtype, **overrides)
    if cfg.algorithm == "psum":
        raise ValueError(
            "allreduce/pallas builds only the manual ring algorithms "
            "(the library path has no per-step kernel to substitute)"
        )
    # one op per rank, each launching for its rank's device
    op = [functools.partial(accumulate, device=d) for d in mesh.devices]
    return core.run_allreduce(mesh, cfg, writer, op=op, variant="pallas")


VARIANT = VariantSpec(
    app="allreduce",
    variant="pallas",
    dtypes=("float32", "int32"),
    run=run,
    axes={"algorithm": ("ring", "ring_opt"), "mem_kind": tuple(core.MEM_KINDS)},
)
