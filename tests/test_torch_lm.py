"""The port's token LM against the JAX package's on the CPU: the
cross-entropy, the loss and one SGD step, the global-seed samplers, the
decoder's sampled and greedy ids, and the ``lm`` Record.

The same seeded numpy weights, logits and tokens go through the
reference (eagerly, or on a (1, 1, 1) mesh) and through the port on
``device="cpu"``.  Float32 losses, gradients and updated params agree
within 1e-5 of their magnitude; sampling noise is the reference's bit
for bit (the threefry words), its Gumbel values within 1e-6 (XLA's
``log`` and torch's differ by an ulp), and every id is equal.
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_patterns.models import lm as jlm
from tpu_patterns.models import transformer as jtr
from tpu_patterns_torch import cli as tcli
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

REL = 1e-5
VOCAB, B, LP, GEN = 64, 3, 12, 6


def _rel_err(got, want) -> float:
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got, np.float32) - want).max()) / scale


def _cfgs(**kw):
    base = dict(embed=32, heads=4, head_dim=8, dtype="float32", depth=2,
                rope=True)
    base.update(kw)
    return jtr.ModelConfig(**base), ttr.ModelConfig(**base)


@pytest.fixture(scope="module")
def mesh(devices):
    return Mesh(np.array(devices[:1]).reshape(1, 1, 1), ("dp", "sp", "tp"))


@pytest.fixture(scope="module")
def lm_params():
    jcfg, tcfg = _cfgs()
    flat = {k: np.asarray(v) for k, v in
            jlm.init_lm_params(jax.random.key(0), jcfg, VOCAB).items()}
    return jcfg, tcfg, flat


def _tokens(seed, shape):
    return np.random.RandomState(seed).randint(0, VOCAB, shape).astype(
        np.int32)


def test_vocab_parallel_ce_and_its_gradient():
    rng = np.random.RandomState(1)
    logits = (rng.randn(2, 5, 16) * 3).astype(np.float32)
    targets = rng.randint(0, 16, (2, 5)).astype(np.int32)
    targets[0, 0], targets[1, 4] = -1, 16  # outside the vocab: logit 0

    def jloss(lg):
        return jlm.vocab_parallel_ce(lg, jnp.asarray(targets), None).sum()

    want = jlm.vocab_parallel_ce(jnp.asarray(logits), jnp.asarray(targets),
                                 None)
    want_grad = jax.grad(jloss)(jnp.asarray(logits))
    lg = torch.tensor(logits, requires_grad=True)
    got = tlm.vocab_parallel_ce(lg, torch.from_numpy(targets))
    assert tuple(got.shape) == (2, 5) and got.dtype == torch.float32
    got.sum().backward()
    assert _rel_err(got.detach(), want) <= REL
    assert _rel_err(lg.grad, want_grad) <= REL


def test_loss_and_one_train_step_match_reference(mesh, lm_params):
    jcfg, tcfg, flat = lm_params
    toks = _tokens(2, (2, 16))
    want_loss = jlm.lm_loss_shard(
        {k: jnp.asarray(v) for k, v in flat.items()}, jnp.asarray(toks),
        jcfg)
    params = params_from_jax(flat, tcfg)
    got_loss = tlm.lm_loss_shard(params, torch.from_numpy(toks), tcfg)
    assert abs(float(got_loss) - float(want_loss)) <= REL * float(want_loss)

    jstep, _ = jlm.make_lm_train_step(mesh, jcfg, VOCAB, lr=0.5)
    jnew, jl = jstep(flat, jnp.asarray(toks))
    step = tlm.make_lm_train_step(tcfg, VOCAB, lr=0.5)
    new, loss = step(params, torch.from_numpy(toks))
    assert abs(float(loss) - float(jl)) <= REL * float(jl)
    got = params_to_numpy(new, tcfg)
    assert set(got) == set(jnew)
    for k, want in jnew.items():
        want = np.asarray(want)
        # the update itself, p - p_new, within 1e-5 of its magnitude
        assert _rel_err(flat[k] - got[k], flat[k] - want) <= REL, k
    with pytest.raises(ValueError, match="vocab"):
        tlm.make_lm_train_step(tcfg, VOCAB + 1)(params,
                                                 torch.from_numpy(toks))


@pytest.mark.parametrize("shape", [(3, 64), (5, 16), (2, 1)])
@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_gumbel_bits_equal_reference(seed, shape):
    """Both samplers' draws: [B, V] from fold_in(key, 0) (the full
    softmax) and [B, k] from the key itself (top-k)."""
    b, v = shape
    for fold in (None, 0):
        jk = jax.random.fold_in(jax.random.key(seed), 5)
        tk = prng.fold_in(prng.key(seed), 5)
        if fold is not None:
            jk, tk = jax.random.fold_in(jk, fold), prng.fold_in(tk, fold)
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
        got = prng.random_bits(tk, b * v).reshape(b, v)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        g = prng.gumbel(tk, b * v).reshape(b, v).numpy()
        np.testing.assert_allclose(
            g, np.asarray(jax.random.gumbel(jk, shape, jnp.float32)),
            rtol=1e-6, atol=1e-6)


def _logits(seed, b=8, v=VOCAB):
    rng = np.random.RandomState(seed)
    lg = (rng.randn(b, v) * 2).astype(np.float32)
    lg[0] = np.round(lg[0])  # ties
    lg[1, ::3] = -0.0
    lg[1, 1::3] = 0.0  # +-0 ties across the top
    lg[1, 2::3] = -5.0
    lg[2] = 1.0  # a constant row
    return lg


@pytest.mark.parametrize("temperature", [0.0, 0.5, 1.0, 2.0])
def test_sharded_sample_ids_equal_reference(temperature):
    for seed in range(4):
        lg = _logits(10 + seed)
        for n in (0, 3, tlm.PREFILL_FOLD):
            jk = jax.random.fold_in(jax.random.key(seed), n)
            tk = prng.fold_in(prng.key(seed), n)
            want = jlm.sharded_sample(jnp.asarray(lg), jk, temperature, None)
            got = tlm.sharded_sample(torch.from_numpy(lg), tk, temperature)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 5, 16, 100])
def test_sharded_topk_sample_ids_equal_reference(k):
    for seed in range(4):
        lg = _logits(20 + seed)
        for temperature in (0.0, 0.8):
            jk = jax.random.fold_in(jax.random.key(seed), 2)
            tk = prng.fold_in(prng.key(seed), 2)
            want = jlm.sharded_topk_sample(jnp.asarray(lg), jk, temperature,
                                           k, None)
            got = tlm.sharded_topk_sample(torch.from_numpy(lg), tk,
                                          temperature, k)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 0), (0.8, 16)])
def test_decoder_global_seed_ids_equal_reference(mesh, lm_params,
                                                 temperature, top_k):
    """Prefill's token, then generation in two calls (lockstep at n0 0,
    then continued at n0 3, so the second call's keys start at index
    3): every id equals the reference's."""
    jcfg, tcfg, flat = lm_params
    toks = _tokens(3, (B, LP))
    kw = dict(temperature=temperature, seed=11, top_k=top_k)
    jpre, jgen = jlm.make_lm_decoder(mesh, jcfg, VOCAB, B, LP, GEN)
    jc, jtok0 = jpre(flat, jnp.asarray(toks), **kw)
    jc, ja = jgen(flat, jc, jtok0, LP, 3, **kw)
    _, jb = jgen(flat, jc, ja[:, -1], LP + 3, GEN - 3, **kw)

    params = params_from_jax(flat, tcfg)
    pre, gen = tlm.make_lm_decoder(tcfg, VOCAB, B, LP, GEN)
    c, tok0 = pre(params, torch.from_numpy(toks), **kw)
    c, a = gen(params, c, tok0, LP, 3, **kw)
    _, b = gen(params, c, a[:, -1], LP + 3, GEN - 3, **kw)
    np.testing.assert_array_equal(tok0.numpy(), np.asarray(jtok0))
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    if temperature == 0:
        # the greedy default is the same path: no keyword, same ids
        c, tok0 = pre(params, torch.from_numpy(toks))
        _, a = gen(params, c, tok0, LP, 3)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))


SMALL = dict(vocab=VOCAB, embed=32, heads=4, head_dim=8, depth=2, batch=2,
             seq=16, steps=3, gen=4)


class _Sink:
    def record(self, rec):
        self.rec = rec


@pytest.mark.parametrize("kw", [dict(), dict(temperature=0.8, top_k=16,
                                             seed=3)])
def test_run_lm_record_matches_reference(mesh, kw):
    (want,) = jlm.run_lm(mesh, jlm.LMConfig(**SMALL, **kw), _Sink())
    (got,) = tlm.run_lm(tlm.LMConfig(**SMALL, **kw, device="cpu"),
                        ResultWriter(stream=io.StringIO()))
    assert got.pattern == want.pattern == "lm"
    assert got.mode == want.mode
    assert got.commands == want.commands
    assert set(got.metrics) == set(want.metrics)
    assert got.verdict.value == want.verdict.value == "SUCCESS", got.notes
    assert got.metrics["loss_final"] < got.metrics["loss_first"]


def test_run_lm_sampled_ids_repeat_at_one_seed(monkeypatch):
    """Two runs at one seed generate the same ids, bit for bit; another
    seed draws others."""
    seen = []
    real = tlm.make_lm_decoder

    def recording(*a, **k):
        pre, gen = real(*a, **k)

        def gen_rec(*ga, **gk):
            out = gen(*ga, **gk)
            seen.append(out[1].clone())
            return out

        return pre, gen_rec

    monkeypatch.setattr(tlm, "make_lm_decoder", recording)
    for seed in (5, 5, 6):
        tlm.run_lm(tlm.LMConfig(**{**SMALL, "gen": 12}, temperature=0.8,
                                top_k=16, seed=seed, device="cpu"),
                   ResultWriter(stream=io.StringIO()))
    assert torch.equal(seen[1], seen[3])  # the timed calls
    assert not torch.equal(seen[3], seen[5])


def test_lm_config_is_the_references_plus_device():
    ref = {f.name: f.default for f in dataclasses.fields(jlm.LMConfig)}
    port = {f.name: f.default for f in dataclasses.fields(tlm.LMConfig)}
    assert port.pop("device") == "cuda"
    assert port == ref


def test_cli_lm_runs_on_the_cpu(capsys):
    rc = tcli.main(["lm", "--device", "cpu", "--vocab", "64", "--embed",
                    "32", "--heads", "4", "--head_dim", "8", "--seq", "16",
                    "--steps", "3", "--gen", "4", "--temperature", "0.8",
                    "--top_k", "16"])
    assert rc == 0
    assert ("## V64_T0.8_k16_seed0 | B4 L16 depth2 E32 float32 steps3 gen4"
            " | SUCCESS") in capsys.readouterr().out
