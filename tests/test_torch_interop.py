"""The port's interop slice against the JAX package's (tests/test_interop.py,
over the port).

The same seeded numpy inputs go through the reference's FFI handlers
(``tpu_patterns.interop``) and the port's custom ops
(``tpu_patterns_torch.interop``); saxpy and the kernel K10's plain
version must agree bit for bit, checksums exactly.  ``torch.compile``
runs with ``backend="aot_eager"`` (no inductor, no C++ compile of the
graph), the counterpart of ``jax.jit``.  K10 itself and the staging from
the card run in ``chip_smoke.py``."""

import ctypes
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tpu_patterns import cli as jcli
from tpu_patterns.comm import expected_checksum as jexpected
from tpu_patterns.interop import calls as jcalls
from tpu_patterns.interop import native as jnative
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch.comm.verify import expected_checksum, fill_randomly
from tpu_patterns_torch.core import timing
from tpu_patterns_torch.interop import calls, kernel, native

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)


def _compiled(fn):
    return torch.compile(fn, fullgraph=True, backend="aot_eager")


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


# -- the native module and its clock ------------------------------------------


def test_native_clock_monotonic_and_the_references():
    a = native.clock_ns()
    b = native.clock_ns()
    assert b >= a > 0
    # both read CLOCK_MONOTONIC: a port reading falls between two of the
    # reference's
    r0 = jnative.clock_ns()
    p = native.clock_ns()
    r1 = jnative.clock_ns()
    assert r0 <= p <= r1


def test_timing_layer_uses_native_clock(monkeypatch):
    r0 = native.clock_ns()
    t = timing.clock_ns()
    r1 = native.clock_ns()
    assert r0 <= t <= r1
    monkeypatch.setattr(native, "clock_ns", lambda: 42)
    assert timing.clock_ns() == 42


def test_ffi_clock_inside_program():
    for fn in (calls.ffi_clock_ns, _compiled(lambda: calls.ffi_clock_ns())):
        t = fn()
        assert t.dtype == torch.int64 and t.shape == (1,) and int(t[0]) > 0
    r0 = jnative.clock_ns()
    t = int(calls.ffi_clock_ns()[0])
    assert r0 <= t <= jnative.clock_ns()


# -- typed depth: saxpy and checksum against the reference's handlers ---------


_saxpy_prog = _compiled(lambda a, b, alpha: calls.ffi_saxpy(alpha, a, b))


@pytest.mark.parametrize("alpha", [2.0, -0.5, 3.1])
@pytest.mark.parametrize("n", [1, 8, 1000, 4097])
def test_saxpy_bit_equal_to_reference(n, alpha):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 100).astype(np.float32)
    y = (rng.standard_normal(n) * 10).astype(np.float32)
    want = np.asarray(jcalls.ffi_saxpy(alpha, jnp.asarray(x), jnp.asarray(y)))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    eager = calls.ffi_saxpy(alpha, tx, ty)
    assert eager.dtype == torch.float32 and eager.shape == (n,)
    np.testing.assert_array_equal(_bits(eager), _bits(want))
    np.testing.assert_array_equal(_bits(_saxpy_prog(tx, ty, alpha)),
                                  _bits(want))


def test_saxpy_shape_mismatch_raises():
    with pytest.raises(ValueError, match="shape mismatch"):
        calls.ffi_saxpy(2.0, torch.ones(4), torch.ones(5))


def _checksum_inputs():
    rng = np.random.default_rng(7)
    near = (2**30 + 128 * rng.integers(0, 1000, 64)).astype(np.float32)
    return {
        # negatives and fractions: each truncated toward zero
        "fractions": rng.uniform(-1000, 1000, 4097).astype(np.float32),
        "small": np.array([-0.9, 0.9, -1.5, 1.5, -2.999, 0.0, -0.0],
                          np.float32),
        # in range, but 64 values near 2^30 sum past 2^31: the sum wraps
        "wrapping": near,
        "wrapping_negative": -near,
        "mixed": np.concatenate([near, -near[:20],
                                 rng.uniform(-5, 5, 33)]).astype(np.float32),
    }


def _wrapped_sum(a: np.ndarray) -> int:
    s = int(np.trunc(a.astype(np.float64)).astype(np.int64).sum())
    s &= 0xFFFFFFFF
    return s - (1 << 32) if s >= 1 << 31 else s


@pytest.mark.parametrize("name", list(_checksum_inputs()))
def test_checksum_equals_reference(name):
    a = _checksum_inputs()[name]
    want = int(np.asarray(jcalls.ffi_checksum(jnp.asarray(a)))[0])
    got = calls.ffi_checksum(torch.from_numpy(a))
    assert got.dtype == torch.int32 and got.shape == (1,)
    assert int(got[0]) == want == _wrapped_sum(a)


def test_checksum_matches_device_invariant():
    x = fill_randomly(5_000, "float32", seed=2)
    assert int(calls.ffi_checksum(x)[0]) == expected_checksum(5_000) \
        == jexpected(5_000, "float32")


def test_typed_ops_are_cpu_only():
    """Registered for the CPU alone, as the reference's handlers are for
    the cpu platform: a CUDA tensor has no kernel and raises; the host
    staging ops have one."""
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    for op in ("tp::checksum_f32", "tp::saxpy", "tp::clock_ns"):
        assert has(op, "CPU") and not has(op, "CUDA")
    for op in ("tp::host_checksum", "tp::host_saxpy"):
        assert has(op, "CPU") and has(op, "CUDA")
    with pytest.raises(RuntimeError, match="no kernel registered for cuda|"
                       "does not have a kernel registered for cuda"):
        torch.ops.tp.clock_ns(torch.device("cuda"))


def test_native_op_refuses_what_it_cannot_read_in_place():
    with pytest.raises(ValueError, match="contiguous float32"):
        calls._checksum(torch.ones(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous float32"):
        calls._checksum(torch.ones(4, 4).t())
    with pytest.raises(ValueError, match="host tensor"):
        calls._checksum(torch.ones(4, device="meta"))


# -- K10: the Pallas kernel of the reference test and its port ----------------


def kern(x_ref, o_ref):
    o_ref[...] = x_ref[...] + 1.0


def _pallas_add_one(x: np.ndarray) -> np.ndarray:
    xj = jnp.asarray(x)
    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(xj.shape, xj.dtype),
        interpret=True)(xj))


def _k10_inputs():
    rng = np.random.default_rng(10)
    tiny = np.finfo(np.float32).smallest_subnormal
    special = np.array(
        [0.0, -0.0, np.inf, -np.inf, tiny, -tiny, 1e-40, -1e-40, -1.0,
         -0.5, 2.0**24, -(2.0**24), 3.4e38, -3.4e38, 1e-8, -1e-8],
        np.float32)
    return {
        "zeros": np.zeros((4, 128), np.float32),
        "normal": rng.standard_normal((4, 128)).astype(np.float32),
        "wide": (rng.standard_normal((4, 128)) * 1e6).astype(np.float32),
        "special": np.resize(special, (4, 128)).astype(np.float32),
    }


@pytest.mark.parametrize("name", list(_k10_inputs()))
def test_add_one_plain_equals_pallas_kern(name):
    x = _k10_inputs()[name]
    want = _pallas_add_one(x)
    tx = torch.from_numpy(x)
    kernel.reset_launches()
    for got in (kernel.add_one(tx), kernel.add_one_reference(tx),
                kernel.add_one(tx, out=torch.empty_like(tx))):
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert kernel.launch_counts() == {"add_one": 0}  # CPU: the plain version


def test_kernel_output_flows_into_cpp():
    """The both-runtime pointer proof: the kernel's output is read by
    C++ in place, eagerly and inside one compiled program (on the CPU
    the kernel is its plain version; on the card, ``chip_smoke.py``)."""

    @jax.jit
    def program(x):
        y = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct(
            x.shape, x.dtype), interpret=True)(x)
        return jcalls.ffi_checksum(y)

    x = np.zeros((4, 128), np.float32)
    assert int(np.asarray(program(jnp.asarray(x)))[0]) == 4 * 128
    tx = torch.from_numpy(x)
    assert int(calls.ffi_checksum(kernel.add_one(tx))[0]) == 4 * 128
    prog = _compiled(lambda a: calls.ffi_checksum(kernel.add_one(a)))
    assert int(prog(tx)[0]) == 4 * 128
    y = fill_randomly(2048, "float32", seed=3)
    assert int(prog(y)[0]) == expected_checksum(2048) + 2048


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 127, 512, 4097, 16384,
                               (1 << 25) + 3])
def test_add_one_tile_plan_covers_every_element_once(n, offset):
    """K10's grid mirror (``kernel.tile_grid``, which chip_smoke.py holds
    to the C side's ``add_one_grid``) and its tiles: every element of
    [0, n) written by exactly one thread of one block, none past n, at
    the proof's 512, edge sizes around a vector and a tile, and a
    ragged 2^25.  An operand one float32 into its buffer takes the
    scalar path."""
    vector = offset == 0
    grid = kernel.tile_grid(n, vector)
    tile = kernel.THREADS * kernel.VECS * 4
    assert grid >= 1 and (grid - 1) * tile < n
    block, i = kernel.tile_plan(n, vector)
    assert i.min() >= 0 and i.max() < n
    # every block writes something, and nothing but blocks of the grid
    assert (np.bincount(block, minlength=grid) > 0).all()
    assert block.min() >= 0 and block.max() < grid
    # n indices in [0, n) that cover [0, n): each element exactly once
    seen = np.zeros(n, dtype=np.uint8)
    seen[i] = 1
    assert i.size == n and seen.all()


def test_add_one_has_no_fallback():
    with pytest.raises(ValueError, match="no kernel"):
        kernel.add_one(torch.empty((4, 128), device="meta"))
    with pytest.raises(ValueError, match="float32"):
        kernel.add_one(torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="out must be"):
        kernel.add_one(torch.zeros(4), out=torch.zeros(5))
    with pytest.raises(ValueError, match="out must be"):
        kernel.add_one(torch.zeros(4, 4), out=torch.zeros(4, 4).t())
    assert kernel.add_one.launches == 0


# -- raw depth: the DLPack capsule parsed by hand -----------------------------


def test_raw_info_fields():
    x = torch.full((16,), 9.0)
    info = [int(v) for v in calls.raw_info(x)]
    major, minor, flags, nargs, dtype, ndim, ptr, first = info
    assert (major, minor) >= (1, 0)
    assert not flags & 2  # DLPACK_FLAG_BITMASK_IS_COPIED
    assert nargs == 1
    assert dtype == 2  # kDLFloat
    assert ndim == 1
    assert ptr == x.data_ptr() & 0xFFFF
    assert first == 9  # read through the shared pointer
    # the reference's frame: the same argument count, rank and element
    want = np.asarray(jcalls.raw_info(jnp.full((16,), 9.0)))
    assert (nargs, ndim, first) == (want[3], want[5], want[7])
    # the tensor is untouched and still usable, and exports again
    x.add_(1.0)
    assert float(x.sum()) == 160.0
    assert int(calls.raw_info(x)[7]) == 10
    assert torch.from_dlpack(x).data_ptr() == x.data_ptr()


def test_raw_info_other_ranks_and_dtypes():
    x = torch.arange(-6.0, 6.0).reshape(3, 4)
    info = calls.raw_info(x[1:])  # a view: the first element is -2
    assert int(info[5]) == 2 and int(info[7]) == -2
    assert int(calls.raw_info(torch.tensor([-7.9], dtype=torch.float64))[7]) \
        == -7  # converted to float32, truncated toward zero
    assert int(calls.raw_info(torch.empty(0))[7]) == -1  # nothing to read


def test_raw_info_borrows_the_capsule():
    """The C++ neither renames the capsule nor calls its deleter: the
    capsule is still a valid ``dltensor_versioned`` afterwards and a
    consumer can take it, sharing the tensor's memory."""
    x = torch.arange(8.0)
    cap = x.__dlpack__(max_version=(1, 0))
    out = torch.empty(8, dtype=torch.int32)
    ptr = calls._get_pointer(cap, calls.DLPACK_CAPSULE)
    assert native.load().tp_raw_info_dlpack(ptr, out.data_ptr()) == 0
    assert int(out[6]) == x.data_ptr() & 0xFFFF
    is_valid = ctypes.pythonapi.PyCapsule_IsValid
    is_valid.restype = ctypes.c_int
    is_valid.argtypes = [ctypes.py_object, ctypes.c_char_p]
    assert is_valid(cap, calls.DLPACK_CAPSULE) == 1
    y = torch.from_dlpack(cap)
    assert y.data_ptr() == x.data_ptr()
    x[0] = 5.0
    assert float(y[0]) == 5.0


# -- host offload: inside a program and eager ---------------------------------


def test_host_callbacks_under_compile_match_reference():
    assert calls.supports_host_callbacks()
    a = np.arange(256, dtype=np.float32)
    b = np.ones(256, np.float32)

    @jax.jit
    def jprogram(x, y):
        z = jcalls.host_saxpy(2.0, x, y)
        return z + jcalls.host_checksum(x).astype(jnp.float32)

    want = np.asarray(jprogram(jnp.asarray(a), jnp.asarray(b)))
    prog = _compiled(lambda x, y: calls.host_saxpy(2.0, x, y)
                     + calls.host_checksum(x).to(torch.float32))
    got = prog(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_allclose(got.numpy(), 2 * a + 1 + a.sum())


def test_offload_roundtrip_matches_reference():
    rng = np.random.default_rng(5)
    a = (rng.standard_normal(512) * 1000).astype(np.float32)
    b = np.full(512, 3.0, np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    cs = calls.offload_checksum(ta)
    assert cs.dtype == torch.int32 and cs.device.type == "cpu"
    assert int(cs[0]) == int(np.asarray(
        jcalls.offload_checksum(jnp.asarray(a)))[0]) == _wrapped_sum(a)
    got = calls.offload_saxpy(0.5, ta, tb)
    want = np.asarray(jcalls.offload_saxpy(0.5, jnp.asarray(a),
                                           jnp.asarray(b)))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    x = torch.arange(512, dtype=torch.float32)
    assert int(calls.offload_checksum(x)[0]) == int(np.arange(512).sum())


# -- the build ----------------------------------------------------------------


def test_failed_build_raises(tmp_path):
    missing = str(tmp_path / "no-such-g++")
    with pytest.raises(RuntimeError, match="cannot run"):
        native.build_shared_object(native.SOURCE, cxx=missing,
                                   build_dir=tmp_path)
    lib = native.LazyLib(native.SOURCE, lambda lib: None, cxx=missing,
                         build_dir=tmp_path)
    for _ in range(2):  # the failure is kept, not retried into a None
        with pytest.raises(RuntimeError, match="no-such-g"):
            lib.load()
    assert "no-such-g++" in lib.error
    bad = tmp_path / "bad.cc"
    bad.write_text("int f() { return undeclared; }\n")
    with pytest.raises(RuntimeError, match="undeclared"):
        native.build_shared_object(bad, build_dir=tmp_path)
    assert not list(tmp_path.glob("*.so"))


def test_concurrent_builds_give_one_library(tmp_path):
    start = threading.Barrier(2)
    paths, errors = [], []

    def build():
        start.wait(timeout=30)
        try:
            paths.append(native.build_shared_object(native.SOURCE,
                                                    build_dir=tmp_path))
        except RuntimeError as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(paths) == 2 and paths[0] == paths[1]
    assert sorted(p.name for p in tmp_path.iterdir()) == [paths[0].name]
    lib = ctypes.CDLL(str(paths[0]))
    lib.tp_clock_ns.restype = ctypes.c_uint64
    assert lib.tp_clock_ns() > 0


def test_library_is_keyed_by_source_and_flags(tmp_path):
    a = native.target(native.SOURCE, build_dir=tmp_path)
    assert a.parent == tmp_path and a.suffix == ".so"
    assert native.target(native.SOURCE, build_dir=tmp_path) == a
    assert native.target(native.SOURCE, native.CXX_FLAGS + ("-g",),
                         build_dir=tmp_path) != a
    assert native.NATIVE.load() is native.load()
    assert native.NATIVE.path == native.target(native.SOURCE)
    assert native.available() and native.build_error() is None


# -- the CLI ------------------------------------------------------------------


def _records(path):
    return [json.loads(ln) for ln in path.read_text().splitlines() if ln]


def test_cli_records_match_reference(tmp_path, capsys):
    jl, tl = tmp_path / "ref.jsonl", tmp_path / "port.jsonl"
    assert jcli.main(["--jsonl", str(jl), "interop"]) == 0
    assert tcli.main(["--jsonl", str(tl), "interop", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "## native | clock | SUCCESS" in out

    def key(r):
        return (r["pattern"], r["mode"], r["commands"], r["verdict"])

    want = sorted(map(key, _records(jl)))
    got = sorted(map(key, _records(tl)))
    assert got == want
    assert len(got) == 7 and {k[1] for k in got} == {"native", "offload:cpu"}
    assert all(k[3] == "SUCCESS" for k in got)


def test_cli_without_compiler_records_skipped(monkeypatch, tmp_path):
    failing = native.LazyLib(native.SOURCE, lambda lib: None,
                             cxx=str(tmp_path / "no-such-g++"),
                             build_dir=tmp_path)
    monkeypatch.setattr(native, "NATIVE", failing)
    buf = io.StringIO()
    from tpu_patterns_torch.core.results import ResultWriter

    writer = ResultWriter(stream=buf)
    tcli._interop(tcli.build_parser().parse_args(
        ["interop", "--device", "cpu"]), writer)
    assert buf.getvalue().splitlines() == ["## native | interop | SKIPPED"]
    assert writer.exit_code == 0
    with pytest.raises(RuntimeError, match="no-such-g"):
        timing.clock_ns()  # no quiet switch of clocks
