"""The port's ring layer (``comm/mesh.py``, ``comm/ring.py``), K5's and
K9's plain versions and the ring-put mode of ``run_onesided`` against
the JAX package's.

The same seeded numpy inputs go through the reference under
``shard_map`` on the conftest's CPU mesh (its Pallas kernels in
interpret mode, as tests/test_onesided.py and the miniapp's pallas
variant run them on the CPU) and through the port over a CPU rank
mesh, where each kernel wrapper runs its plain version.  The ring's
adds happen in the reference's order, so every comparison but the
library contrast's is bit for bit; random data (not the miniapp's rank
ids, whose sums any ring order gets right) makes the order show."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_patterns.comm import onesided as jo
from tpu_patterns.comm import ring as jring
from tpu_patterns.miniapps.apps.allreduce import pallas as jpallas
from tpu_patterns_torch.comm import mesh as tmesh
from tpu_patterns_torch.comm import onesided as to
from tpu_patterns_torch.comm import ring as tring
from tpu_patterns_torch.core.results import Verdict
from tpu_patterns_torch.miniapps.apps.allreduce import pallas as tpallas

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

N = 320  # per-rank elements: divisible by 4 and 8, not by 128


def _data(p, dtype, seed=0, n=N):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:  # the full range: the adds wrap
        return rng.integers(-2**31, 2**31, (p, n), dtype=np.int32)
    return rng.standard_normal((p, n)).astype(np.float32)


def _jax_ring(fn, data, op=None):
    """The reference ring ``fn`` over the first p CPU devices."""
    p = data.shape[0]
    mesh = Mesh(np.array(jax.devices()[:p]), ("x",))
    f = jax.jit(jax.shard_map(
        lambda v: fn(v, "x", p, op=op), mesh=mesh, in_specs=P("x"),
        out_specs=P("x"), check_vma=op is None))
    return np.asarray(f(jnp.asarray(data.reshape(-1)))).reshape(p, -1)


def _port_ring(fn, data, op=None):
    mesh = tmesh.default_mesh(data.shape[0], "cpu")
    out = fn(mesh.scatter(data.reshape(-1)), op)
    return mesh.gather(out).numpy().reshape(data.shape)


_JAX_ACC = functools.partial(jpallas.accumulate, interpret=True)
RINGS = {"naive": (jring.ring_allreduce_naive, tring.ring_allreduce_naive),
         "optimal": (jring.ring_allreduce_optimal,
                     tring.ring_allreduce_optimal)}


# -- K5 ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("n", [1, 127, 128, 2048 * 128, 2048 * 128 + 5])
def test_accumulate_reference_matches_pallas(n, dtype):
    """Tolerance: none (bit for bit): an IEEE add, a wrapping int add."""
    a, b = _data(2, dtype, seed=n, n=n)
    want = np.asarray(_JAX_ACC(jnp.asarray(a), jnp.asarray(b)))
    got = tpallas.accumulate_reference(torch.from_numpy(a),
                                       torch.from_numpy(b)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_accumulate_runs_plain_only_for_a_cpu_rank():
    a, b = (torch.from_numpy(x) for x in _data(2, np.float32))
    tpallas.reset_launches()
    assert torch.equal(tpallas.accumulate(a, b),
                       tpallas.accumulate_reference(a, b))
    assert torch.equal(tpallas.accumulate(a, b, device="cpu"), a + b)
    assert tpallas.launch_counts() == {"accumulate": 0}
    # a CUDA rank launches the kernel or raises: never the plain version
    with pytest.raises(ValueError, match="pageable host memory"):
        tpallas.accumulate(a, b, device="cuda:0")
    for bad in ((a.double(), b.double()), (a.bfloat16(), b.bfloat16()),
                (a, b.int()), (a, b[:-1])):
        with pytest.raises(ValueError):
            tpallas.accumulate(*bad)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 4097, (1 << 23) + 3, 1 << 25])
def test_accumulate_tile_plan_covers_every_element_once(n, offset):
    """K5's tile plan (``pallas.tile_grid`` and ``tile_elements``, the
    mirror chip_smoke.py holds to the C side's grid): every element of
    [0, n) written by exactly one thread of one block, none past n.  An operand one float32 into its
    buffer is not 16-byte aligned and takes the scalar path; 2^25 is the
    ring's shard, 2^23 + 3 the bandwidth-optimal ring's chunk with a
    ragged tail."""
    vector = (offset * 4) % 16 == 0
    grid = tpallas.tile_grid(n, vector)
    assert grid >= 1 and (grid - 1) * tpallas.TILE < max(n, 1)
    block, i = tpallas.tile_plan(n, vector)
    assert i.min() >= 0 and i.max() < n
    # every block writes something, and nothing but blocks of the grid
    assert (np.bincount(block, minlength=grid) > 0).all()
    assert block.min() >= 0 and block.max() < grid
    seen = np.zeros(n, dtype=np.uint8)
    seen[i] = 1
    assert i.size == n and seen.all()


@pytest.mark.parametrize("vector", [True, False],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 4097, 3 * 4096 + 7])
def test_tile_plan_is_the_per_block_tiles(n, vector):
    """``tile_plan`` (every block at once) is ``tile_elements`` block by
    block, in K5's and K10's tiles."""
    from tpu_patterns_torch.interop import kernel as k10

    for mod in (tpallas, k10):
        block, i = mod.tile_plan(n, vector)
        for b in range(mod.tile_grid(n, vector)):
            np.testing.assert_array_equal(
                np.sort(i[block == b]),
                np.sort(mod.tile_elements(n, vector, b).numpy()))


# -- the ring ----------------------------------------------------------------


@pytest.mark.parametrize("with_kernel", [False, True],
                         ids=["plus", "accumulate"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("ring", sorted(RINGS))
def test_ring_allreduce_matches_reference(ring, p, dtype, with_kernel):
    """Tolerance: none (bit for bit), the ring's order of adds being the
    reference's."""
    jfn, tfn = RINGS[ring]
    data = _data(p, dtype, seed=p)
    want = _jax_ring(jfn, data, _JAX_ACC if with_kernel else None)
    got = _port_ring(tfn, data,
                     tpallas.accumulate if with_kernel else None)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("ring", sorted(RINGS))
def test_a_reversed_ring_fails_the_comparison(ring, monkeypatch):
    """The comparison above sees ring order: shifting the other way round
    gives other float32 bits than the reference."""
    jfn, tfn = RINGS[ring]
    data = _data(4, np.float32, seed=4)
    want = _jax_ring(jfn, data)
    np.testing.assert_array_equal(_port_ring(tfn, data), want)
    monkeypatch.setattr(tring, "ring_perm",
                        lambda n, shift=1: [(i, (i - shift) % n)
                                            for i in range(n)])
    assert not np.array_equal(_port_ring(tfn, data), want)


def test_ring_perm_and_shift_match_reference():
    for n in range(1, 9):
        assert tring.ring_perm(n) == jring.ring_perm(n)
        assert tring.ring_perm(n, 3) == jring.ring_perm(n, 3)
    mesh = tmesh.default_mesh(4, "cpu")
    xs = mesh.scatter(np.arange(8, dtype=np.int32))
    got = mesh.gather(tring.ring_shift(xs)).numpy()
    np.testing.assert_array_equal(got, np.roll(np.arange(8), 2))
    assert all(a.data_ptr() != b.data_ptr()
               for a, b in zip(xs, tring.ring_shift(xs)))


def test_library_allreduce_matches_psum():
    """Tolerance: 1e-6 relative (torch's order of adds is not XLA's)."""
    data = _data(4, np.float32, seed=9)
    want = _jax_ring(lambda v, a, s, op=None: jring.library_allreduce(v, a),
                     data)
    got = _port_ring(lambda xs, op: tring.library_allreduce(xs), data)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    ints = _data(4, np.int32, seed=9)
    got = _port_ring(lambda xs, op: tring.library_allreduce(xs), ints)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got[0], ints.sum(0, dtype=np.int32))


def test_ring_optimal_needs_divisible_length():
    xs = tmesh.default_mesh(4, "cpu").scatter(np.zeros(4 * 130, np.float32))
    with pytest.raises(ValueError, match="not divisible by ring size 4"):
        tring.ring_allreduce_optimal(xs)
    with pytest.raises(ValueError, match="unknown allreduce variant"):
        tring.allreduce(xs, "tree")


def test_one_rank_is_the_identity():
    xs = tmesh.default_mesh(1, "cpu").scatter(np.ones(6, np.float32))
    for variant in ("ring", "ring_opt", "psum"):
        assert torch.equal(tring.allreduce(xs, variant)[0], xs[0])


def test_default_mesh_places_ranks_compactly(monkeypatch):
    mesh = tmesh.default_mesh(4, "cpu")
    assert mesh.size == 4 and mesh.cards() == [torch.device("cpu")]
    assert "4 ranks on the CPU" in mesh.note()
    assert tmesh.default_mesh(0, "cpu").size == 1
    # placement over g cards: rank r on card r * g // n
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = tmesh.default_mesh(4, "cuda")
    assert [d.index for d in cuda.devices] == [0, 0, 1, 1]
    assert cuda.note() == ("4 ranks on 2 GPUs: ring shifts are "
                           "device-memory copies, not a fabric")
    assert [d.index for d in tmesh.default_mesh(0, "cuda").devices] == [0, 1]
    assert tmesh.default_mesh(2, "cuda").note() is None
    with pytest.raises(ValueError, match="not divisible"):
        mesh.scatter(np.zeros(6))


# -- K9 ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_put_matches_reference(mesh1d, dtype):
    """Tolerance: none (bit for bit): a put copies."""
    n, rows, cols = 8, 3, 128
    x = np.random.default_rng(1).standard_normal(
        (n * rows, cols)).astype(np.float32)
    jx = jax.device_put(jnp.asarray(x).astype(dtype),
                        NamedSharding(mesh1d, P("x")))
    f = jax.jit(jax.shard_map(
        lambda a: jo.ring_put(a, "x", n, interpret=True), mesh=mesh1d,
        in_specs=P("x"), out_specs=P("x"), check_vma=False))
    want = np.asarray(f(jx).astype(jnp.float32))
    mesh = tmesh.default_mesh(n, "cpu")
    shards = mesh.scatter(x, dtype=getattr(torch, dtype))
    to.reset_launches()
    got = mesh.gather(to.ring_put(shards)).float().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.roll(np.asarray(jx.astype(jnp.float32)), rows, 0))
    assert to.launch_counts()["ring_put"] == 0
    assert torch.equal(mesh.gather(to.ring_put_reference(shards)).float(),
                       torch.from_numpy(got))


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 16383, 16384, 16385,
                               188_743_680])
def test_ring_put_pieces_cover_the_shard_once(n):
    """K9's grid (``ring_put_pieces``, the mirror chip_smoke.py holds to
    the C side's ``ring_put_grid``): one block a ``STREAM_STEP`` piece
    (16 KB), at least one block for a shard of a byte or more, the
    pieces in order and covering [0, n) exactly once, each but the last
    a whole step starting 16-byte aligned.  188,743,680 bytes is the
    reference's 92,160 x 512 float32 shard: 11,520 blocks."""
    assert to.STREAM_STEP == 16384
    pieces = to.ring_put_pieces(n)
    assert len(pieces) == -(-n // to.STREAM_STEP)
    assert n == 0 or len(pieces) >= 1
    pos = 0
    for start, stop in pieces:
        assert start == pos and 0 < stop - start <= to.STREAM_STEP
        assert start % 16 == 0
        pos = stop
    assert pos == n
    assert all(stop - start == to.STREAM_STEP for start, stop in pieces[:-1])
    if n == 188_743_680:
        assert len(pieces) == 11520


def test_ring_put_refuses_mixed_devices():
    with pytest.raises(ValueError, match="together"):
        to.ring_put([torch.zeros(2, 4), torch.zeros(2, 4, device="meta")])


def test_run_onesided_ring_put_record_matches_reference(devices):
    cfg = dict(count=2048, reps=2, warmup=1)
    want, = jo.run_onesided(Mesh(np.array(devices[:4]), ("x",)),
                            jo.OneSidedConfig(**cfg))
    got, = to.run_onesided(to.OneSidedConfig(**cfg),
                           mesh=tmesh.default_mesh(4, "cpu"))
    for rec in (want, got):
        assert rec.mode == "ring_put"
        assert rec.verdict.value == "SUCCESS", rec.notes
        assert rec.metrics["checksum_ok"] == 1.0
        assert "hbm_plausible" not in rec.metrics
    assert got.verdict is Verdict.SUCCESS
    assert got.commands == want.commands == "4dev x 0MB"
    assert set(got.metrics) == set(want.metrics)
    assert got.metrics["bytes_per_put"] == want.metrics["bytes_per_put"]
    assert got.config["world"] == 4
    assert any("4 ranks on the CPU" in n for n in got.notes)


def test_run_onesided_one_rank_mesh_is_the_local_put():
    rec, = to.run_onesided(to.OneSidedConfig(count=2048, reps=2, warmup=1,
                                             kernel="mono"),
                           mesh=tmesh.default_mesh(1, "cpu"))
    assert rec.mode == "local_put" and rec.verdict is Verdict.SUCCESS
