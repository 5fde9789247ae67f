"""The port's token LM over a dp x sp x tp rank mesh against the JAX
package's, on the CPU: the vocab-parallel loss and one SGD step, the
decoder's greedy and sampled ids (the dp and tp key folds), the
vocab-parallel samplers' layout invariance, and the ``lm`` Record and
CLI on a mesh.

The reference's own small shapes (``tests/test_lm.py``: E 64, H 8, D 8,
V 64, B 4, L 16; its ``mesh3d`` is (2, 2, 2)) go through the
reference's ``shard_map`` programs on the conftest's CPU devices and
through the port on CPU ranks, the weights handed over as numpy
(``convert.params_from_jax``).  Float32: the loss within 1e-5 absolute;
the params after one step at lr 1.0 (so they carry the gradients whole)
within 1e-6 absolute; ids equal."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_patterns.longctx.attention import stripe as jstripe
from tpu_patterns.models import lm as jlm
from tpu_patterns.models import transformer as jtr
from tpu_patterns_torch import cli as tcli
from tpu_patterns_torch.comm.mesh import model_mesh
from tpu_patterns_torch.convert import params_from_jax, params_to_numpy
from tpu_patterns_torch.core.results import ResultWriter
from tpu_patterns_torch.models import lm as tlm
from tpu_patterns_torch.models import prng
from tpu_patterns_torch.models import transformer as ttr

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

CFG = dict(embed=64, heads=8, head_dim=8, dtype="float32", causal=True)
V, B, L, GEN = 64, 4, 16, 8


def jmesh(shape):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape),
                ("dp", "sp", "tp"))


def tmesh(shape):
    return model_mesh(int(np.prod(shape)), shape[0], shape[2], device="cpu")


def _cfgs(**kw):
    return jtr.ModelConfig(**CFG, **kw), ttr.ModelConfig(**CFG, **kw)


def _params(jcfg, n_exp=0):
    return {k: np.asarray(v) for k, v in jlm.init_lm_params(
        jax.random.key(0), jcfg, V, n_experts=n_exp).items()}


def _tokens():
    return np.asarray(jax.random.randint(jax.random.key(1), (B, L), 0, V),
                      np.int32)


TRAIN = {
    "222": ((2, 2, 2), dict(rope=True)),
    "striped_141": ((1, 4, 1), dict(rope=True, attn_layout="striped")),
}


@pytest.fixture(scope="module")
def trained():
    """Per case: the reference's params, loss and params after one step
    at lr 1.0, on striped tokens where the layout asks."""
    out = {}
    for name, (shape, kw) in TRAIN.items():
        jcfg, _ = _cfgs(**kw)
        flat = _params(jcfg)
        toks = _tokens()
        if jcfg.attn_layout == "striped":
            toks = np.asarray(jstripe(toks, shape[1], axis=1))
        mesh = jmesh(shape)
        step, _ = jlm.make_lm_train_step(mesh, jcfg, V, lr=1.0)
        new, loss = step(jlm.shard_lm_params(flat, mesh, jcfg),
                         jax.device_put(toks, NamedSharding(mesh,
                                                            P("dp", "sp"))))
        out[name] = (flat, toks, float(loss),
                     {k: np.asarray(v) for k, v in new.items()})
    return out


@pytest.mark.parametrize("name", list(TRAIN))
def test_loss_and_train_step_match_reference(trained, name):
    flat, toks, want_loss, want = trained[name]
    shape, kw = TRAIN[name]
    _, tcfg = _cfgs(**kw)
    mesh = tmesh(shape)
    params = tlm.shard_lm_params(params_from_jax(flat, tcfg), mesh, tcfg)
    st = mesh.shard(torch.tensor(toks), ("dp", "sp"))
    loss = tlm.lm_loss_mesh(mesh, params, st, tcfg)
    np.testing.assert_allclose(float(loss), want_loss, rtol=0, atol=1e-5)
    step = tlm.make_lm_train_step(tcfg, V, lr=1.0, mesh=mesh)
    new, loss1 = step(params, st)
    assert float(loss1) == float(loss)
    got = params_to_numpy(tlm.gather_lm_params(new, mesh, tcfg), tcfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    # every replica of a leaf steps to the same bits
    specs = tlm.lm_param_specs(tcfg, V)
    for k, shards in new.items():
        for g in ttr.reduce_groups(mesh, specs[k][1], ttr.MESH_AXES):
            for r in g[1:]:
                assert torch.equal(shards[g[0]], shards[r]), (k, g)


def test_striped_halo_takes_the_next_stripe():
    """Striped shard s's targets are stripe s+1's tokens, the last
    stripe's the first stripe's shifted one on; positions r + sp*i."""
    _, tcfg = _cfgs(attn_layout="striped")
    mesh = tmesh((1, 4, 1))
    toks = torch.arange(16, dtype=torch.int32).reshape(1, 16)
    st = mesh.shard(torch.from_numpy(jstripe(toks.numpy(), 4, axis=1)),
                    ("dp", "sp"))
    for r, (tg, pos) in enumerate(tlm._targets(mesh, st, tcfg)):
        np.testing.assert_array_equal(pos.numpy(), r + 4 * np.arange(4))
        want = (pos.numpy() + 1) % 16  # the successor; the wrap is masked
        np.testing.assert_array_equal(tg[0].numpy(), want)


# (mesh, temperature, top_k): greedy at (2, 2, 2); the full-vocab
# sampler (dp and tp folds) and top-k (dp fold only) at (2, 1, 2)
ROLLOUTS = {
    "greedy_222": ((2, 2, 2), 0.0, 0),
    "sample_212": ((2, 1, 2), 0.8, 0),
    "topk_212": ((2, 1, 2), 0.8, 16),
}


@pytest.fixture(scope="module")
def rollouts():
    jcfg, _ = _cfgs(rope=True)
    flat = _params(jcfg)
    toks = _tokens()
    out = {}
    for name, (shape, temperature, top_k) in ROLLOUTS.items():
        mesh = jmesh(shape)
        kw = dict(temperature=temperature, seed=7, top_k=top_k)
        pre, gen = jlm.make_lm_decoder(mesh, jcfg, V, B, L, GEN)
        tk = jax.device_put(toks, NamedSharding(mesh, P("dp", "sp")))
        c, t0 = pre(flat, tk, **kw)
        _, ids = gen(flat, c, t0, jnp.asarray(L), GEN, **kw)
        out[name] = (np.asarray(t0), np.asarray(ids))
    return flat, toks, out


def _port_rollout(tcfg, flat, toks, shape, **kw):
    mesh = tmesh(shape)
    sp = mesh.dim("sp")
    p = tlm.shard_lm_params(params_from_jax(flat, tcfg), mesh, tcfg)
    if tcfg.attn_layout == "striped":
        toks = jstripe(toks, sp, axis=1)
    pre, gen = tlm.make_lm_decoder(tcfg, V, B, L, GEN + (-GEN % sp),
                                   mesh=mesh, **kw.pop("dec", {}))
    c, t0 = pre(p, mesh.shard(torch.tensor(toks), ("dp", "sp")), **kw)
    _, ids = gen(p, c, t0, L, GEN, **kw)
    return (mesh.assemble(t0, ("dp",)).numpy(),
            mesh.assemble(ids, ("dp", None)).numpy())


@pytest.mark.parametrize("name", list(ROLLOUTS))
def test_decoder_ids_equal_reference(rollouts, name):
    flat, toks, out = rollouts
    shape, temperature, top_k = ROLLOUTS[name]
    _, tcfg = _cfgs(rope=True)
    t0, ids = _port_rollout(tcfg, flat, toks, shape,
                            temperature=temperature, seed=7, top_k=top_k)
    np.testing.assert_array_equal(t0, out[name][0])
    np.testing.assert_array_equal(ids, out[name][1])
    if temperature > 0:  # the draw moves with the seed
        _, other = _port_rollout(tcfg, flat, toks, shape,
                                 temperature=temperature, seed=8,
                                 top_k=top_k)
        assert not np.array_equal(other, ids)


@pytest.mark.parametrize("kw,shape", [
    (dict(moe=True, rope=True), (2, 2, 2)),
    (dict(rope=True, attn_layout="striped"), (1, 4, 1)),
    (dict(rope=True, kv_heads=2, dec=dict(cache_int8=True)), (2, 2, 2)),
], ids=["moe_222", "striped_141", "gqa2_int8_222"])
def test_greedy_rollout_is_mesh_invariant(kw, shape):
    """The reference's mesh-invariance gates (``tests/test_lm.py``): the
    same greedy ids on the mesh as on one rank running every expert."""
    dec = kw.pop("dec", {})
    jcfg, tcfg = _cfgs(**kw)
    flat = _params(jcfg, n_exp=2 if jcfg.moe else 0)
    toks = _tokens()
    got = _port_rollout(tcfg, flat, toks, shape, dec=dec)
    want = _port_rollout(tcfg, flat, toks, (1, 1, 1), dec=dec)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert ((want[1] >= 0) & (want[1] < V)).all()


@pytest.mark.parametrize("tp", [2, 4])
def test_vocab_parallel_pieces_equal_one_device(tp):
    """Over a tp group the greedy argmax (ties to the lowest id), the
    CE, the top-k sampler and the per-row sampler equal their
    one-device versions on the whole vocab (the top-k and per-row draws
    are keyed by nothing that depends on the layout)."""
    mesh = tmesh((1, 1, tp))
    g = torch.Generator().manual_seed(2)
    logits = torch.randn(5, 64, generator=g)
    logits[0, 3] = logits[0, 40] = logits[0].max() + 1  # a tie over ranks
    logits[1, 5:60] = 0.5  # ties inside and across ranks
    shards = mesh.shard(logits, (None, "tp"))
    assert all(torch.equal(a, tlm.sharded_argmax(logits))
               for a in tlm.argmax_mesh(mesh, shards))
    assert int(tlm.argmax_mesh(mesh, shards)[0][0]) == 3
    tg = torch.randint(0, 64, (5,), generator=g)
    ce = tlm._ce_mesh(mesh, [s[:, None] for s in shards],
                      [tg[:, None]] * tp)
    torch.testing.assert_close(
        ce[0], tlm.vocab_parallel_ce(logits[:, None], tg[:, None]),
        rtol=0, atol=1e-6)
    key = prng.key(9)
    for k in (1, 5, 16, 100):
        want = tlm.sharded_topk_sample(logits, key, 0.8, k)
        for got in tlm.topk_sample_mesh(mesh, shards, [key] * tp, 0.8, k):
            assert torch.equal(got, want), k
    rows = (torch.tensor([1, 2, 3, 4, 5], dtype=torch.int32),
            torch.tensor([0, 7, 2, 9, 4], dtype=torch.int32),
            torch.tensor([0.8, 0.0, 1.3, 0.5, 0.9]),
            torch.tensor([0, 0, 5, 40, 2], dtype=torch.int32),
            torch.tensor([1.0, 1.0, 0.9, 0.5, 1.0]))
    want = tlm.sample_token_rows(logits, *rows)
    for got in tlm.rows_mesh(mesh, shards, [rows] * tp):
        assert torch.equal(got, want)


SMALL = dict(vocab=V, embed=64, heads=8, head_dim=8, depth=1, batch=2,
             seq=16, steps=2, gen=4)


def test_run_lm_record_matches_reference():
    class Sink:
        def record(self, rec):
            self.rec = rec

    kw = dict(moe=True, layout="striped")
    (want,) = jlm.run_lm(jmesh((1, 2, 2)), jlm.LMConfig(**SMALL, **kw),
                         Sink())
    (got,) = tlm.run_lm(tlm.LMConfig(**SMALL, **kw, device="cpu"),
                        ResultWriter(stream=io.StringIO()),
                        mesh=tmesh((1, 2, 2)))
    assert got.mode == want.mode == "V64_striped_moe"
    assert got.commands == want.commands
    assert set(got.metrics) == set(want.metrics)
    assert got.verdict.value == want.verdict.value == "SUCCESS", got.notes
    assert any("4 ranks on the CPU" in n for n in got.notes)


def test_cli_lm_on_a_mesh(capsys):
    rc = tcli.main(["lm", "--device", "cpu", "--devices", "8", "--dp", "2",
                    "--tp", "2", "--vocab", "64", "--embed", "32",
                    "--heads", "4", "--head_dim", "8", "--depth", "1",
                    "--seq", "16", "--steps", "2", "--gen", "4",
                    "--temperature", "0.8", "--top_k", "8"])
    assert rc == 0
    assert "## V64_T0.8_k8_seed0 | B4 L16 depth1 E32 float32 steps2 gen4 | " \
        "SUCCESS" in capsys.readouterr().out
