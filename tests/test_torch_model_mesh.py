"""The port's train step over a dp x sp x tp rank mesh against the JAX
package's sharded step, the layout (``param_specs``, ``shard_params``,
``gather_params``), the named mesh, the dots remat policy and the
``flagship`` CLI on a mesh.

The reference's params (its ``init_params``, handed over as numpy) and
one seeded numpy batch go through the reference's ``make_train_step`` on
the conftest's 8 CPU devices (``attn="xla"``) and through the port on 8
CPU ranks, with ``attn`` "dense" (the plain ring) and "kernel" (the
fused ring, K3 and K4, whose plain versions run on CPU tensors).  Shapes
are the reference's own test shapes (E 64, H 8, D 8, B 4, L 32); the
objective is normalised by the element count.  Float32; loss rtol 1e-5;
the updated params after one step at lr 1.0 (so they carry the grads
whole) within atol 1e-6; after a step every dp/sp replica of a leaf is
bit-identical."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_patterns.core.results import ResultWriter as JWriter
from tpu_patterns.longctx.attention import stripe as jstripe
from tpu_patterns.models import transformer as jtr
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch.comm.mesh import NamedMesh, RankMesh, model_mesh
from tpu_patterns_torch.convert import block_params_from_jax, params_to_numpy
from tpu_patterns_torch.models import flagship as tfl
from tpu_patterns_torch.models import transformer as ttr

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

E, H, D, B, L = 64, 8, 8, 4, 32
N_GLOBAL = float(B * L * E)
LR = 1.0
AXES = ("dp", "sp", "tp")
# name -> (mesh shape, extra config)
CASES = {
    "222": ((2, 2, 2), {}),
    "421": ((4, 2, 1), {}),
    "142": ((1, 4, 2), {}),
    "gqa_rope": ((2, 2, 2), dict(kv_heads=4, rope=True)),
    "striped_rope": ((1, 4, 2), dict(attn_layout="striped", rope=True)),
    "moe": ((2, 2, 2), dict(moe=True)),
    "depth2_remat": ((2, 2, 2), dict(depth=2, remat=True)),
}


def batch() -> np.ndarray:
    return np.random.RandomState(1).randn(B, L, E).astype(np.float32)


def jmesh(shape, axes=AXES):
    return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                axes)


@functools.lru_cache(maxsize=None)
def reference(name):
    """(params as numpy, updated params as numpy, loss) of one reference
    step of ``CASES[name]``."""
    shape, kw = CASES[name]
    jcfg = jtr.ModelConfig(embed=E, heads=H, head_dim=D, **kw)
    mesh = jmesh(shape)
    params = jtr.init_params(jax.random.key(3), jcfg,
                             n_experts=shape[2] if jcfg.moe else 0)
    step, _ = jtr.make_train_step(mesh, jcfg, lr=LR, n_global=N_GLOBAL)
    x = batch()
    if jcfg.attn_layout == "striped":
        x = np.asarray(jstripe(x, shape[1], axis=1))
    sx = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("dp", "sp",
                                                              None)))
    new, loss = step(jtr.shard_params(params, mesh, jcfg), sx)
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in new.items()}, float(loss))


def port_cfg(kw, attn):
    return ttr.ModelConfig(embed=E, heads=H, head_dim=D, attn=attn,
                           block_q=16, block_k=16, **kw)


def shard_batch(mesh, x):
    return mesh.shard(torch.from_numpy(x), ("dp", "sp", None))


def assert_replicas_equal(mesh, cfg, params):
    """Every dp/sp replica of each leaf's block (and every rank's copy
    of a tp-replicated leaf) is bit-identical."""
    specs = ttr.param_specs(cfg, ttr.n_experts(mesh, cfg))
    for k, shards in params.items():
        for g in ttr.reduce_groups(mesh, specs[k][1], AXES):
            for r in g[1:]:
                assert torch.equal(shards[g[0]].view(torch.int32),
                                   shards[r].view(torch.int32)), (k, g)


@pytest.mark.parametrize("attn", ["dense", "kernel"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_train_step_matches_reference(name, attn):
    flat, want, want_loss = reference(name)
    shape, kw = CASES[name]
    mesh = model_mesh(8, shape[0], shape[2], device="cpu")
    assert (mesh.dim("dp"), mesh.dim("sp"), mesh.dim("tp")) == shape
    cfg = port_cfg(kw, attn)
    x = batch()
    if cfg.attn_layout == "striped":
        x = np.asarray(jstripe(x, shape[1], axis=1))
    step = ttr.make_train_step(mesh, cfg, lr=LR, n_global=N_GLOBAL)
    sharded = ttr.shard_params(block_params_from_jax(flat, cfg), mesh, cfg)
    new, loss = step(sharded, shard_batch(mesh, x))
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got = params_to_numpy(ttr.gather_params(new, mesh, cfg), cfg)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert_replicas_equal(mesh, cfg, new)


def test_one_rank_equals_the_one_device_step():
    """``mesh=None`` is the (1, 1, 1) mesh on x's device: the same
    bits."""
    cfg = port_cfg(dict(depth=2), "kernel")
    p = ttr.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(batch())
    a, la = ttr.make_train_step(None, cfg, lr=1e-2)(p, x)
    mesh = model_mesh(1, device="cpu")
    b, lb = ttr.make_train_step(mesh, cfg, lr=1e-2)(
        {k: [v] for k, v in p.items()}, [x])
    assert float(la) == float(lb)
    for k in a:
        assert torch.equal(a[k], b[k][0]), k


# -- the layout and the named mesh -------------------------------------------


def test_named_mesh_is_the_reference_reshape():
    mesh = model_mesh(8, 2, 2, device="cpu")
    ref = np.arange(8).reshape(2, 2, 2)
    for r in range(8):
        c = mesh.coord(r)
        assert ref[c["dp"], c["sp"], c["tp"]] == r == mesh.rank(**c)
    # the sp group of (d, t), in sp order
    assert mesh.group("sp", mesh.rank(dp=1, sp=0, tp=1)) == [5, 7]
    assert mesh.groups("tp") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.groups(("dp", "sp")) == [[0, 2, 4, 6], [1, 3, 5, 7]]
    m4 = model_mesh(8, 1, 2, pp=2, device="cpu")
    sub, ranks = m4.sub("pp", 1)
    assert sub.axes == AXES and sub.shape == (1, 2, 2)
    assert ranks == [1, 3, 5, 7]
    with pytest.raises(ValueError, match="not divisible"):
        model_mesh(6, 4, 1, device="cpu")


@pytest.mark.parametrize("kw", [{}, dict(kv_heads=4), dict(moe=True),
                                dict(depth=2)])
def test_param_specs_are_the_references(kw):
    tp = 2
    jcfg = jtr.ModelConfig(embed=E, heads=H, head_dim=D, **kw)
    cfg = port_cfg(kw, "dense")
    want = jtr.param_specs(jcfg, tp if cfg.moe else 0)
    got = ttr.param_specs(cfg, tp if cfg.moe else 0)
    assert list(got) == list(want)
    for k, (shape, spec) in got.items():
        jshape, jspec = want[k]
        lead = 0 if cfg.depth > 1 else 1  # the port always stacks
        assert shape[lead:] == jshape, k
        assert tuple(spec[lead:]) == tuple(jspec) + (None,) * (
            len(jshape) - len(jspec)), k


def test_shard_then_gather_is_the_identity():
    mesh = model_mesh(8, 2, 2, device="cpu")
    cfg = port_cfg(dict(kv_heads=4, moe=True), "dense")
    p = ttr.init_params(torch.Generator().manual_seed(1), cfg, "cpu",
                        ttr.n_experts(mesh, cfg))
    sharded = ttr.shard_params(p, mesh, cfg)
    assert sharded["wq"][1].shape == (1, E, H // 2, D)  # tp rank 1's heads
    assert sharded["wg"][1].shape == p["wg"].shape  # replicated
    back = ttr.gather_params(sharded, mesh, cfg)
    for k in p:
        assert torch.equal(back[k], p[k]), k


def test_local_positions_follow_the_layout():
    for layout, want in (("contiguous", [8, 9, 10, 11]),
                         ("striped", [2, 6, 10, 14])):
        cfg = port_cfg(dict(attn_layout=layout), "dense")
        got = ttr.local_positions(4, cfg, sp_rank=2, sp=4)
        assert got.tolist() == want


def test_kv_heads_must_divide_over_tp():
    mesh = model_mesh(4, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="kv_heads 2 must divide"):
        ttr.make_train_step(mesh, port_cfg(dict(kv_heads=2), "dense"))


def test_only_the_gate_off_tp_rank_0_may_miss_the_objective():
    """At depth 1 the gate of a tp rank other than 0 reaches no counted
    output and gets zeros; any other leaf cut off from the objective is
    an error, not a silent zero update."""
    mesh = model_mesh(8, 2, 2, device="cpu")
    cfg = port_cfg(dict(moe=True), "dense")
    specs = ttr.param_specs(cfg, ttr.n_experts(mesh, cfg))
    unused = ttr.unused_ok(mesh, specs)
    assert unused == {("wg", r) for r in range(8)
                      if mesh.coord(r)["tp"] == 1}
    assert ttr.unused_ok(model_mesh(8, 2, 1, device="cpu"), specs) == set()
    p = ttr.shard_params(ttr.init_params(torch.Generator().manual_seed(3),
                                         cfg, "cpu", 2), mesh, cfg)
    xs = shard_batch(mesh, batch())

    def loss_fn(leaves):
        return ttr.loss_mesh(mesh, leaves, xs, cfg, N_GLOBAL)

    _, grads = ttr.world_grads(loss_fn, p, unused)
    assert not any(bool(grads["wg"][r].any()) for _, r in unused)
    with pytest.raises(RuntimeError, match="'wg' of rank 1 does not reach"):
        ttr.world_grads(loss_fn, p)

    def cut(leaves):  # we1 of rank 0 detached from the graph
        return loss_fn({**leaves, "we1": [leaves["we1"][0].detach(),
                                          *leaves["we1"][1:]]})

    with pytest.raises(RuntimeError, match="'we1' of rank 0 does not"):
        ttr.world_grads(cut, p, unused)


# -- remat_policy="dots" -------------------------------------------------------


class _Count(TorchDispatchMode):
    """aten ops run while active: the projections' products (mm, or bmm
    over a batch of 1) and the attention's exponentials (the ring's
    online softmax)."""

    def __init__(self):
        super().__init__()
        self.proj = self.exp = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        aten = torch.ops.aten
        if func is aten.bmm.default and args[0].shape[0] == 1:
            self.proj += 1
        elif func is aten.mm.default:
            self.proj += 1
        elif func is aten.exp.default:
            self.exp += 1
        return func(*args, **(kwargs or {}))


def _backward_counts(cfg, mesh, params, xs):
    leaves = {k: [t.detach().requires_grad_() for t in v]
              for k, v in params.items()}
    loss = ttr.loss_mesh(mesh, leaves, xs, cfg, N_GLOBAL)
    counter = _Count()
    with counter:
        grads = torch.autograd.grad(loss, [t for v in leaves.values()
                                           for t in v])
    return float(loss.detach()), grads, counter


def test_remat_dots_policy_same_math_recompute_between():
    """The dots policy (the reference's
    ``test_remat_dots_policy_same_math_memory_between``, counted where
    the CPU has no memory analysis): the same loss and grads as no remat
    and full remat; its backward recomputes the attention (the softmax,
    as full remat does; none without remat) but none of the projection
    or MLP products (full remat re-runs every one of them).  At sp 2 the
    attention is the plain ring, whose softmax is its exponentials."""
    mesh = model_mesh(8, 2, 2, device="cpu")
    base = port_cfg(dict(depth=4), "dense")
    p = ttr.shard_params(ttr.init_params(torch.Generator().manual_seed(8),
                                         base), mesh, base)
    xs = shard_batch(mesh, batch())
    runs = {}
    for name, kw in (("none", dict(remat=False)),
                     ("dots", dict(remat=True, remat_policy="dots")),
                     ("full", dict(remat=True))):
        runs[name] = _backward_counts(dataclasses.replace(base, **kw), mesh,
                                      p, xs)
    loss, grads, none = runs["none"]
    for name in ("dots", "full"):
        assert runs[name][0] == pytest.approx(loss, rel=1e-6)
        for a, b in zip(runs[name][1], grads):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6)
    dots, full = runs["dots"][2], runs["full"][2]
    assert none.exp == 0 and dots.exp == full.exp > 0
    assert dots.proj == none.proj < full.proj


# -- run_flagship and the CLI on a mesh --------------------------------------


def _ref_record(shape, **kw):
    cfg = jtr.FlagshipConfig(embed=E, heads=H, head_dim=D, seq=L, batch=B,
                             dtype="float32", attn="xla", reps=1, warmup=0,
                             **kw)
    recs = jtr.run_flagship(jmesh(shape), cfg, JWriter())
    return recs[0]


@pytest.mark.parametrize("shape,kw", [
    ((2, 2, 2), dict(moe=True, optimizer="zero-adam")),
    ((1, 4, 2), dict(attn_layout="striped", remat=True,
                     remat_policy="dots", depth=2)),
])
def test_run_flagship_on_a_mesh_matches_reference_record(shape, kw):
    ref = _ref_record(shape, **kw)
    cfg = tfl.FlagshipConfig(embed=E, heads=H, head_dim=D, seq=L, batch=B,
                             dtype="float32", attn="kernel", block_q=16,
                             block_k=16, reps=2, warmup=1, device="cpu",
                             **kw)
    rec, = tfl.run_flagship(cfg, mesh=model_mesh(8, shape[0], shape[2],
                                                 device="cpu"))
    assert rec.verdict.value == "SUCCESS", rec.notes
    assert rec.mode == ref.mode.replace("xla", "kernel")
    assert rec.commands == ref.commands
    assert rec.metrics["flops"] == ref.metrics["flops"]
    assert any("8 ranks on the CPU" in n for n in rec.notes)


def test_run_flagship_refuses_what_the_reference_refuses():
    mesh = model_mesh(8, 2, 2, device="cpu")
    for kw, match in ((dict(batch=3), "divisible by dp"),
                      (dict(attn_grid="compact"), "sp>1"),
                      (dict(optimizer="adamw"), "unknown optimizer")):
        cfg = tfl.FlagshipConfig(**{**dict(embed=E, heads=H, head_dim=D,
                                           seq=L, batch=B, device="cpu"),
                                    **kw})
        with pytest.raises(ValueError, match=match):
            tfl.run_flagship(cfg, mesh=mesh)


def test_cli_flagship_on_a_mesh(capsys):
    rc = tcli.main(["flagship", "--device", "cpu", "--devices", "8",
                    "--dp", "2", "--tp", "2", "--embed", "64", "--heads", "8",
                    "--head_dim", "8", "--seq", "32", "--batch", "4",
                    "--dtype", "float32", "--block_q", "16", "--block_k",
                    "16", "--reps", "1", "--warmup", "0"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "## kernel | dp2 sp2 tp2 B4 L32 E64 float32 causal | SUCCESS" in (
        out)
    with pytest.raises(SystemExit):
        tcli.main(["flagship", "--device", "cpu", "--devices", "6",
                   "--dp", "4"])


@pytest.mark.parametrize("cmd", ["decode", "lm", "loadgen"])
def test_other_model_commands_refuse_the_mesh_flags(cmd, capsys):
    """``loadgen`` and ``serve`` take the mesh flags since step 8d (the
    sharded serve) and refuse only a dp other than 1, with the
    reference's message; ``decode`` and ``lm`` take them and refuse only
    a mesh that dp*tp does not divide."""
    if cmd == "loadgen":
        for sub in ("loadgen", "serve"):
            args = tcli.build_parser().parse_args(
                [sub, "--device", "cpu", "--devices", "4", "--tp", "2"])
            assert tcli._mesh3d(args).shape == (1, 2, 2)
            with pytest.raises(SystemExit, match=f"{sub} requires --dp 1 "
                               r"\(fold devices into sp\)"):
                tcli.main([sub, "--device", "cpu", "--devices", "4",
                           "--dp", "2"])
        return
    args = tcli.build_parser().parse_args(
        [cmd, "--device", "cpu", "--devices", "8", "--dp", "2", "--tp", "2"])
    assert tcli._mesh3d(args).shape == (2, 2, 2)
    with pytest.raises(SystemExit, match="not divisible"):
        tcli.main([cmd, "--device", "cpu", "--devices", "6", "--dp", "4"])


def test_single_mesh_is_cached_per_device():
    a = ttr.single_mesh(torch.device("cpu"))
    assert a is ttr.single_mesh(torch.device("cpu"))
    assert isinstance(a, NamedMesh) and a.ranks == RankMesh(
        (torch.device("cpu"),))
