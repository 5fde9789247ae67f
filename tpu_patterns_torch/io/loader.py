"""ctypes binding for the native prefetch loader (``io/csrc/loader.cc``).

Counterpart of ``tpu_patterns/io/loader.py``.  The source is this
package's copy of the JAX package's ``csrc/loader.cc``, built with g++
at first use into ``build/torch_native/`` by
``interop/native.py::LazyLib``.  A missing compiler or a failed build
raises: there is no other stream to hand back in its place.

The loader's contract, pinned by ``tests/test_torch_io.py``:

* batch t is a pure function of (seed, t) -- two instances agree element
  for element, and ``seek(t)`` replays the stream from t (what makes a
  resumed training run see the killed run's exact batches);
* ``next()`` returns a read-only numpy view of a ring slot, valid until
  the FOLLOWING ``next()``/``seek()`` -- copy it before advancing;
* producer threads fill ahead: after a few consumes, ``filled_total``
  exceeds the consumed count.

:func:`fill_reference` is the synchronous oracle, splitmix64 in numpy
(``loader.cc``'s ``mix64`` and ``to_unit``), independent of the C++.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from tpu_patterns_torch.interop.native import CXX_FLAGS, LazyLib

SOURCE = Path(__file__).resolve().parent / "csrc" / "loader.cc"


def _configure(lib: ctypes.CDLL) -> None:
    lib.tpl_create.restype = ctypes.c_void_p
    lib.tpl_create.argtypes = [
        ctypes.c_uint64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ]
    lib.tpl_destroy.argtypes = [ctypes.c_void_p]
    lib.tpl_next.restype = ctypes.POINTER(ctypes.c_float)
    lib.tpl_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.tpl_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.tpl_filled_total.restype = ctypes.c_int64
    lib.tpl_filled_total.argtypes = [ctypes.c_void_p]


# the JAX package's make target adds -pthread for the producer threads
LOADER = LazyLib(SOURCE, _configure, flags=CXX_FLAGS + ("-pthread",))


def native_available() -> bool:
    """Whether the loader builds and loads here (the doctor's
    ``native_loader`` layer)."""
    try:
        LOADER.load()
    except RuntimeError:
        return False
    return True


def build_error() -> str | None:
    return LOADER.error


def _mix64(z: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer over uint64 (wrapping) arithmetic."""
    z = z + np.uint64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def fill_reference(seed: int, elems: int, step: int) -> np.ndarray:
    """Batch ``step`` of the stream, flat float32, computed in numpy:
    uniform in [-1, 1) from the top 53 bits of
    ``mix64(mix64(seed ^ mix64(step)) ^ i)``."""
    with np.errstate(over="ignore"):
        step64 = np.array([step], np.int64).view(np.uint64)
        key = _mix64(np.array([seed], np.uint64) ^ _mix64(step64))
        bits = _mix64(key ^ np.arange(elems, dtype=np.uint64))
    u = (bits >> np.uint64(11)).astype(np.float64) * (1.0 / 9007199254740992.0)
    return (2.0 * u - 1.0).astype(np.float32)


class NativeLoader:
    """Prefetching batch stream of shape ``shape`` float32 arrays.

    Single-consumer: ``next``/``seek`` must be called from one thread.
    """

    def __init__(self, seed: int, shape: tuple[int, ...], buffers: int = 4,
                 threads: int = 2):
        self._lib = LOADER.load()
        self.shape = tuple(shape)
        self.elems = int(np.prod(self.shape))
        self._ptr = self._lib.tpl_create(seed, self.elems, buffers, threads)
        if not self._ptr:
            raise ValueError(
                f"bad loader config: elems={self.elems} buffers={buffers} "
                f"threads={threads} (need elems>0, buffers>=2, threads>=1)"
            )

    def _handle(self):
        # a NULL handle passed into the C library is a segfault, not an
        # exception: guard every entry point after close()
        if not self._ptr:
            raise RuntimeError("loader is closed")
        return self._ptr

    def next(self) -> tuple[np.ndarray, int]:
        """(batch view, step).  The view aliases a ring slot: copy it
        before the next ``next()``/``seek()``."""
        step = ctypes.c_int64()
        buf = self._lib.tpl_next(self._handle(), ctypes.byref(step))
        if not buf:
            # NULL only when the stream is shut down
            raise RuntimeError("loader stream terminated")
        arr = np.ctypeslib.as_array(buf, shape=(self.elems,)).reshape(
            self.shape
        )
        arr.flags.writeable = False
        return arr, int(step.value)

    def seek(self, step: int) -> None:
        self._lib.tpl_seek(self._handle(), step)

    @property
    def filled_total(self) -> int:
        """Batches produced so far (consumed + prefetched ahead)."""
        return int(self._lib.tpl_filled_total(self._handle()))

    def close(self) -> None:
        if self._ptr:
            self._lib.tpl_destroy(self._ptr)
            self._ptr = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass
