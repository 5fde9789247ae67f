"""Build and load the package's CUDA kernels.

Every ``*.cu`` under the package is one kernel library with a plain C
interface (its stem names it, so stems are unique across the package;
``*.cuh`` headers beside it are included, not built).  Each compiles with its own ``nvcc`` process (all started
together) for ``sm_90a`` into ``build/torch_kernels/`` at the checkout's
root, named by a hash of its source and the flags, at first use; later
calls reuse the file.  The library loads with ``ctypes``.  A missing
``nvcc`` or a failed build raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> dict[str, Path]:
    """Kernel library name (the source's stem) -> its ``.cu`` file."""
    return {p.stem: p for p in sorted(PKG_DIR.rglob("*.cu"))}


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, /usr/local/cuda/bin, PATH): the CUDA "
        "kernels of tpu_patterns_torch cannot be built"
    )


def target(src: Path) -> Path:
    """The library path for ``src``: keyed by its bytes, those of the
    headers beside it and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(src.parent.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every kernel source whose library is missing, one nvcc
    per source, all in parallel; return name -> library path.  The
    compiler's ``-Xptxas -v`` report lands beside each library as
    ``.log``."""
    srcs = sources()
    out = {name: target(src) for name, src in srcs.items()}
    todo = {n: p for n, p in out.items() if not p.exists()}
    if not todo:
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, lib in todo.items():
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        out[name].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{srcs[name]} (nvcc rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[name])
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        paths = build_all()
        if name not in paths:
            raise KeyError(f"no kernel source named {name!r}")
        lib = _LIBS[name] = ctypes.CDLL(str(paths[name]))
    return lib
