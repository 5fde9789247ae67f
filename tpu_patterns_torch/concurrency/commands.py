"""The command language: ``C`` (compute) and ``X2Y`` copies over M/D/H/S.

Counterpart of ``tpu_patterns/concurrency/commands.py``; the parser, the
caps and the rescale are the reference's.  The original suite's
one-letter memory taxonomy -- M (host malloc), D (device), H (pinned
host), S (shared/USM) -- maps on a CUDA card to:

  M -> a pageable CPU tensor            (its copies block the host)
  D -> a CUDA tensor                    (device memory)
  H -> a pinned CPU tensor              (DMA-able host memory)
  S -> a CUDA tensor in managed memory  (``cudaMallocManaged``, preferred
                                         on the host and mapped for the
                                         device: the USM-shared analogue)

On the CPU, where pinning and managed memory need CUDA, every kind is a
plain CPU tensor: the commands and their bytes are the same, and the
memory is not.
"""

from __future__ import annotations

import ctypes
import dataclasses
import enum
import re

import numpy as np
import torch


class MemKind(enum.Enum):
    M = "pageable_host"
    D = "device"
    H = "pinned_host"
    S = "managed"


@dataclasses.dataclass
class Command:
    """One parsed command with its workload knobs (auto-tunable)."""

    text: str  # canonical text, e.g. "C" or "H2D"
    kind: str  # "compute" | "copy"
    src: MemKind | None = None
    dst: MemKind | None = None
    tripcount: int = 40_000  # compute knob (the original suite's default)
    elements: int = 1024  # compute buffer elements (rows*128)
    copy_elements: int = 1 << 22  # copy buffer elements

    @property
    def bytes(self) -> int:
        n = self.elements if self.kind == "compute" else self.copy_elements
        return 4 * n  # float32 buffers throughout, as the reference

    # Tuning caps: the linear rescale must not blow a fast command up into
    # an absurd workload (a copy far faster than a long compute would
    # otherwise demand GB-scale buffers).
    MAX_TRIPCOUNT = 10_000_000
    MAX_COPY_ELEMENTS = 1 << 25  # 128 MiB float32

    def scaled(self, factor: float) -> "Command":
        """Linear workload rescale: compute scales tripcount, copies scale
        size."""
        c = dataclasses.replace(self)
        if self.kind == "compute":
            c.tripcount = min(
                self.MAX_TRIPCOUNT, max(1, int(round(self.tripcount * factor)))
            )
        else:
            # keep the (rows, 128) layout: round to 128-element multiples
            c.copy_elements = min(
                self.MAX_COPY_ELEMENTS,
                max(128, 128 * int(round(self.copy_elements * factor / 128))),
            )
        return c


_COPY_RE = re.compile(r"^([MDHS])2([MDHS])$")


def parse_command(tok: str) -> Command:
    """'C' or 'X2Y' over {M,D,H,S}."""
    tok = tok.strip().upper()
    if tok == "C":
        return Command(text="C", kind="compute")
    m = _COPY_RE.match(tok)
    if not m:
        raise ValueError(
            f"bad command {tok!r}: expected 'C' or 'X2Y' with X,Y in M/D/H/S "
            "(e.g. 'M2D', 'H2D', 'D2S')"
        )
    src, dst = MemKind[m.group(1)], MemKind[m.group(2)]
    if src is dst and src is not MemKind.D:
        # D2D is a real on-device transfer; same-kind host copies are not
        # a device pattern
        raise ValueError(f"copy {tok!r} has identical source and destination")
    return Command(text=tok, kind="copy", src=src, dst=dst)


def parse_group(group: str) -> list[Command]:
    """One ``--commands`` group: whitespace-separated command list."""
    cmds = [parse_command(t) for t in group.split()]
    if not cmds:
        raise ValueError("empty command group")
    return cmds


# -- memory kinds ---------------------------------------------------------

# The process's managed-memory pool: the pluggable allocator and the pool
# live as long as any tensor allocated from them, so for the process.
_MANAGED: dict[str, object] = {}


def _managed_pool() -> "torch.cuda.MemPool":
    """The pool whose allocations are ``cudaMallocManaged`` buffers
    (``csrc/managed_alloc.cu``), built at first use."""
    if "pool" not in _MANAGED:
        from tpu_patterns_torch.kernels.build import build_all

        path = str(build_all()["managed_alloc"])
        alloc = torch.cuda.memory.CUDAPluggableAllocator(
            path, "managed_alloc", "managed_free")
        _MANAGED["allocator"] = alloc
        _MANAGED["pool"] = torch.cuda.MemPool(alloc.allocator())
        lib = ctypes.CDLL(path)
        lib.managed_kind.restype = ctypes.c_int
        lib.managed_kind.argtypes = [ctypes.c_void_p]
        _MANAGED["lib"] = lib
    return _MANAGED["pool"]


CUDA_MEMORY_TYPE_MANAGED = 3  # cudaMemoryTypeManaged


def is_managed(t: torch.Tensor) -> bool:
    """Whether a CUDA tensor's memory is CUDA managed memory, as the
    runtime reports it (``cudaPointerGetAttributes``)."""
    _managed_pool()
    kind = _MANAGED["lib"].managed_kind(t.data_ptr())
    if kind < 0:
        raise RuntimeError(f"cudaPointerGetAttributes failed: CUDA error "
                           f"{-kind}")
    return kind == CUDA_MEMORY_TYPE_MANAGED


def empty_in(kind: MemKind, shape, device: torch.device) -> torch.Tensor:
    """An uninitialized float32 buffer of ``shape`` in memory ``kind``
    (on the CPU: a plain CPU tensor whatever the kind)."""
    dev = torch.device(device)
    if dev.type == "cpu" or kind is MemKind.M:
        return torch.empty(shape, dtype=torch.float32)
    if kind is MemKind.H:
        return torch.empty(shape, dtype=torch.float32, pin_memory=True)
    if kind is MemKind.S:
        with torch.cuda.device(dev), torch.cuda.use_mem_pool(_managed_pool()):
            return torch.empty(shape, dtype=torch.float32, device=dev)
    return torch.empty(shape, dtype=torch.float32, device=dev)


def place(a: np.ndarray, kind: MemKind, device: torch.device) -> torch.Tensor:
    """The float32 array ``a`` copied into a new buffer in memory
    ``kind``."""
    t = empty_in(kind, a.shape, device)
    t.copy_(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)))
    return t


def alloc(cmd: Command, device: torch.device | str, seed: int = 0
          ) -> torch.Tensor:
    """Source buffer for a command, resident in its source memory kind:
    the reference's array, ``default_rng(seed).random((rows, 128))`` in
    float32, so both packages start from identical buffers."""
    rng = np.random.default_rng(seed)
    if cmd.kind == "compute":
        rows = max(1, cmd.elements // 128)
        return place(rng.random((rows, 128), dtype=np.float32), MemKind.D,
                     device)
    rows = max(1, cmd.copy_elements // 128)
    return place(rng.random((rows, 128), dtype=np.float32), cmd.src, device)
