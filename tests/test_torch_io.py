"""The port's native prefetch loader against the JAX package's.

Both packages build their own copy of ``loader.cc`` with g++; at each
(seed, step) the port's batches equal the reference's bit for bit, and
the port's numpy splitmix64 oracle (``fill_reference``) equals the
reference's C oracle.  Seek, prefetch-ahead, the read-only view and the
refusals are the port's own contract, as ``tests/test_io.py`` pins the
reference's."""

import ctypes
import time
from pathlib import Path

import numpy as np
import pytest

from tpu_patterns.io import loader as jl
from tpu_patterns_torch.interop.native import CXX_FLAGS, LazyLib
from tpu_patterns_torch.io import loader as tl

import torch

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

SHAPE = (2, 32, 32)
ELEMS = int(np.prod(SHAPE))


def _configure_reference(lib: ctypes.CDLL) -> None:
    """The C signatures ``tpu_patterns/io/loader.py::_load`` declares."""
    tl._configure(lib)
    lib.tpl_fill_reference.argtypes = [
        ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
    ]


# The JAX package's loader, built from its own csrc/loader.cc with its
# Makefile's flags (-pthread added, as its target does), by the port's
# build: a temporary file renamed into place.  The JAX package's make
# target writes its library where other test workers may be loading it.
REFERENCE_LOADER = LazyLib(
    Path(__file__).resolve().parents[1] / "csrc" / "loader.cc",
    _configure_reference, flags=CXX_FLAGS + ("-pthread",))


@pytest.fixture(scope="module", autouse=True)
def reference_loader():
    """The JAX package's loader module, set to use REFERENCE_LOADER."""
    lib = REFERENCE_LOADER.load()
    saved = jl._lib
    jl._lib = lib
    yield jl
    jl._lib = saved


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("seed,step", [
    (0, 0), (0, 1), (7, 3), (12345, 99), (2**40 + 3, 17), (2**63 + 5, 2),
])
def test_oracle_matches_reference(seed, step):
    got = tl.fill_reference(seed, ELEMS, step)
    want = jl.fill_reference(seed, ELEMS, step)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed,start", [(0, 0), (7, 5), (12345, 1000)])
def test_batches_match_reference_bit_for_bit(seed, start):
    with tl.NativeLoader(seed, SHAPE) as p, jl.NativeLoader(seed, SHAPE) as j:
        p.seek(start)
        j.seek(start)
        for k in range(6):
            got, gstep = p.next()
            want, wstep = j.next()
            assert gstep == wstep == start + k
            assert got.shape == SHAPE and got.dtype == np.float32
            np.testing.assert_array_equal(_bits(got), _bits(want))
            np.testing.assert_array_equal(
                _bits(got.reshape(-1)), _bits(tl.fill_reference(seed, ELEMS,
                                                                gstep)))


def test_values_in_unit_range_and_seeds_differ():
    a = tl.fill_reference(1, 4096, 0)
    assert a.min() >= -1.0 and a.max() < 1.0
    assert not np.array_equal(a, tl.fill_reference(2, 4096, 0))
    assert not np.array_equal(a, tl.fill_reference(1, 4096, 1))


def test_two_instances_agree():
    with tl.NativeLoader(3, SHAPE) as a, tl.NativeLoader(3, SHAPE) as b:
        for _ in range(5):
            x, s = a.next()
            x = np.array(x)
            y, t = b.next()
            assert s == t
            np.testing.assert_array_equal(x, y)


def test_seek_replays_the_stream():
    with tl.NativeLoader(11, SHAPE) as ld:
        first = [np.array(ld.next()[0]) for _ in range(5)]
        ld.seek(2)
        for k in range(2, 5):
            x, s = ld.next()
            assert s == k
            np.testing.assert_array_equal(x, first[k])


def test_seek_forward_and_rapid_seeks():
    with tl.NativeLoader(11, SHAPE) as ld:
        for target in (40, 3, 17, 17, 0, 9):
            ld.seek(target)
        x, s = ld.next()
        assert s == 9
        np.testing.assert_array_equal(x.reshape(-1),
                                      tl.fill_reference(11, ELEMS, 9))


def test_producers_fill_ahead():
    with tl.NativeLoader(0, SHAPE, buffers=4, threads=2) as ld:
        ld.next()
        deadline = time.monotonic() + 10
        while ld.filled_total < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ld.filled_total >= 3  # one consumed + two ahead


def test_view_is_readonly_and_stable_until_next():
    with tl.NativeLoader(5, SHAPE) as ld:
        x, _ = ld.next()
        assert not x.flags.writeable
        snapshot = np.array(x)
        time.sleep(0.05)  # producers run on; this slot is held
        np.testing.assert_array_equal(x, snapshot)


@pytest.mark.parametrize("kw", [dict(buffers=1), dict(threads=0)])
def test_bad_config_rejected(kw):
    with pytest.raises(ValueError, match="bad loader config"):
        tl.NativeLoader(0, (8,), **kw)
    with pytest.raises(ValueError, match="bad loader config"):
        tl.NativeLoader(0, (0,))


def test_closed_loader_raises():
    ld = tl.NativeLoader(0, (8,))
    ld.close()
    for call in (ld.next, lambda: ld.seek(0), lambda: ld.filled_total):
        with pytest.raises(RuntimeError, match="closed"):
            call()


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback stream: a loader whose source does not build raises,
    and so does every later use."""
    bad = tmp_path / "loader.cc"
    bad.write_text("this is not C++\n")
    broken = LazyLib(bad, lambda lib: None, build_dir=tmp_path / "build")
    monkeypatch.setattr(tl, "LOADER", broken)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="native build"):
            tl.NativeLoader(0, SHAPE)
    assert broken.error is not None


def test_loader_library_is_built_in_the_checkout():
    assert isinstance(tl.LOADER.load(), ctypes.CDLL)
    assert tl.LOADER.path.parent.name == "torch_native"
    assert tl.LOADER.path.parent.parent.name == "build"
