"""Build and load the native C++ module (``csrc/tpu_patterns_native.cc``).

Counterpart of ``tpu_patterns/interop/native.py``.  The source is plain
C++ with no framework headers, so it builds with g++ and the reference's
flags (``csrc/Makefile:7``) at first use, into ``build/torch_native/`` at
the checkout's root, named by a hash of the source and the flags; later
calls and processes reuse the file.  Each build writes into a temporary
directory and renames its library into place, so builds started at once
(test workers, several processes of one run) leave one whole library.
The library loads with ``ctypes``.  A missing compiler or a failed build
raises, and the error is kept and raised again by every later load:
nothing falls back, and no clock is switched.

The host-side modules of later slices (the loader, the topology core)
reuse :func:`build_shared_object` and :class:`LazyLib`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "tpu_patterns_native.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
# the reference's flags: no -march, -ffast-math or -mfma, whose FMA
# contraction would break saxpy's bit-equality with the reference
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall", "-Werror")
BUILD_TIMEOUT_S = 300


def find_cxx() -> str:
    """The C++ compiler: ``g++`` on the PATH."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native module of "
                           "tpu_patterns_torch cannot be built")
    return cxx


def target(src: Path, flags: tuple[str, ...] = CXX_FLAGS,
           build_dir: Path = BUILD_DIR) -> Path:
    """The library path for ``src``: keyed by its bytes and the flags."""
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    return build_dir / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_shared_object(src: Path, flags: tuple[str, ...] = CXX_FLAGS,
                        cxx: str | None = None,
                        build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``src`` into a shared library unless it is built already;
    return the library's path.  Raises ``RuntimeError`` when the compiler
    cannot run or the build fails, with the compiler's output."""
    lib = target(src, flags, build_dir)
    if lib.exists():
        return lib
    cxx = cxx or find_cxx()
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir, prefix=".build-") as tmp:
        out = Path(tmp) / lib.name
        cmd = [cxx, *flags, "-o", str(out), str(src)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=BUILD_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native build of {src.name}: cannot run "
                               f"{cxx}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build of {src.name} failed ({' '.join(cmd)}, rc "
                f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(out, lib)
    return lib


class LazyLib:
    """One native library, built and loaded at first use.  ``configure``
    declares the C signatures on the loaded ``CDLL`` once.  A failure is
    kept (:attr:`error`) and :meth:`load` raises it again on every call."""

    def __init__(self, src: Path, configure: Callable[[ctypes.CDLL], None],
                 flags: tuple[str, ...] = CXX_FLAGS, cxx: str | None = None,
                 build_dir: Path = BUILD_DIR):
        self._src, self._configure = src, configure
        self._flags, self._cxx, self._build_dir = flags, cxx, build_dir
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.path: Path | None = None
        self.error: str | None = None

    def load(self) -> ctypes.CDLL:
        lib = self._lib
        if lib is not None:
            return lib
        with self._lock:
            if self._lib is None:
                if self.error is not None:
                    raise RuntimeError(self.error)
                try:
                    path = build_shared_object(self._src, self._flags,
                                               self._cxx, self._build_dir)
                    lib = ctypes.CDLL(str(path))
                except (RuntimeError, OSError) as e:
                    self.error = str(e)
                    raise RuntimeError(self.error) from e
                self._configure(lib)
                self.path, self._lib = path, lib
            return self._lib


def _configure(lib: ctypes.CDLL) -> None:
    ptr, u64 = ctypes.c_void_p, ctypes.c_uint64
    lib.tp_clock_ns.restype = u64
    lib.tp_clock_ns.argtypes = []
    lib.tp_checksum_f32_direct.restype = ctypes.c_int32
    lib.tp_checksum_f32_direct.argtypes = [ptr, u64]
    lib.tp_saxpy_direct.restype = None
    lib.tp_saxpy_direct.argtypes = [ctypes.c_float, ptr, ptr, ptr, u64]
    lib.tp_raw_info_dlpack.restype = ctypes.c_int32
    lib.tp_raw_info_dlpack.argtypes = [ptr, ptr]


NATIVE = LazyLib(SOURCE, _configure)


def load() -> ctypes.CDLL:
    """The native library, built first if needed; raises when it cannot
    be built."""
    return NATIVE.load()


def available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def build_error() -> str | None:
    return NATIVE.error


def clock_ns() -> int:
    """CLOCK_MONOTONIC nanoseconds, read by the native module."""
    return load().tp_clock_ns()
