"""The port's fleet prefix store (``tpu_patterns_torch/serve/store.py``)
against the JAX package's: the same block fingerprints, the same on-disk
layout, so that a store either package publishes fetches in the other
with equal leaves (float32, int8 with its scale planes, and bfloat16,
which numpy lacks), the same shallow-first scan, and the same loud
refusals of a foreign config, a wrong block_len or a corrupt entry."""

import os
import zipfile

import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_patterns.serve import store as jstore
from tpu_patterns_torch.serve import store as tstore

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

BL = 4
FP = {"vocab": 64, "embed": 32, "block_len": BL, "seed": 0}
# pool leaf name -> (per-block shape [depth, bl, Hkv, D], numpy, torch)
LEAVES = {
    "f32": {"k": ((2, BL, 2, 8), np.float32, torch.float32),
            "v": ((2, BL, 2, 8), np.float32, torch.float32)},
    "int8": {"k": ((2, BL, 2, 8), np.int8, torch.int8),
             "v": ((2, BL, 2, 8), np.int8, torch.int8),
             "ks": ((2, BL, 2), np.float32, torch.float32),
             "vs": ((2, BL, 2), np.float32, torch.float32)},
    "bf16": {"k": ((1, BL, 2, 8), ml_dtypes.bfloat16, torch.bfloat16),
             "v": ((1, BL, 2, 8), ml_dtypes.bfloat16, torch.bfloat16)},
}


def _stores(kind, root):
    leaves = LEAVES[kind]
    j = jstore.PrefixStore(
        root, {n: (s, np.dtype(nd)) for n, (s, nd, _) in leaves.items()},
        block_len=BL, fingerprint=FP)
    t = tstore.PrefixStore(
        root, {n: (s, td) for n, (s, _, td) in leaves.items()},
        block_len=BL, fingerprint=FP)
    return j, t


def _block(kind, seed):
    """One block's leaves, as numpy (the reference's) and as tensors."""
    rng = np.random.RandomState(seed)
    out_np, out_t = {}, {}
    for n, (shape, nd, td) in LEAVES[kind].items():
        if nd is np.int8:
            a = rng.randint(-128, 128, size=shape).astype(np.int8)
        else:
            a = rng.standard_normal(shape).astype(np.float32).astype(nd)
        out_np[n] = a
        t = (torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
             if td == torch.bfloat16 else torch.from_numpy(a.copy()))
        out_t[n] = t
    return out_np, out_t


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.contiguous().numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


PATHS = [tuple(range(BL)), tuple(range(2 * BL)), (9,) * BL,
         tuple(range(3 * BL))]


@pytest.mark.parametrize("path", PATHS + [(1, 2), [3, 4, 5, 6]])
def test_block_fingerprint_matches(path):
    assert tstore.block_fingerprint(path) == jstore.block_fingerprint(path)


@pytest.mark.parametrize("kind", sorted(LEAVES))
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_store_one_package_publishes_fetches_in_the_other(kind, writer,
                                                            tmp_path):
    j, t = _stores(kind, str(tmp_path / "store"))
    blocks = [_block(kind, s) for s in range(len(PATHS))]
    for path, (b_np, b_t) in zip(PATHS, blocks):
        n_bytes = (j.publish(b_np, path) if writer == "jax"
                   else t.publish(b_t, path))
        assert n_bytes == j.block_nbytes() == t.block_nbytes()
    assert len(j) == len(t) == len(PATHS)
    assert t.scan() == j.scan()
    assert [p for p, _ in t.scan()] == sorted(PATHS, key=lambda p: (len(p),
                                                                   p))
    for path, (b_np, _) in zip(PATHS, blocks):
        got_t, got_j = t.fetch(path), j.fetch(path)
        assert set(got_t) == set(got_j) == set(b_np)
        for n in b_np:
            assert got_t[n].dtype == LEAVES[kind][n][2]
            assert tuple(got_t[n].shape) == LEAVES[kind][n][0]
            assert _bytes(got_t[n]) == _bytes(got_j[n]) == _bytes(b_np[n])
    assert t.fetch((7,) * BL) is None and j.fetch((7,) * BL) is None


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_the_entry_files_are_the_same_bytes(kind, tmp_path):
    """Same leaves, same path: the two packages' npz members agree byte
    for byte, the meta included (a bfloat16 member's header names its
    two-byte void type as ``|V2`` where the JAX package's says ``<V2``;
    both read back the same bytes, the test above)."""
    j, _ = _stores(kind, str(tmp_path / "j"))
    _, t = _stores(kind, str(tmp_path / "t"))
    b_np, b_t = _block(kind, 3)
    j.publish(b_np, PATHS[1])
    t.publish(b_t, PATHS[1])
    zj = zipfile.ZipFile(j.entry_path(PATHS[1]))
    zt = zipfile.ZipFile(t.entry_path(PATHS[1]))
    assert sorted(zj.namelist()) == sorted(zt.namelist())
    for name in zj.namelist():
        assert zj.read(name) == zt.read(name), name


@pytest.mark.parametrize("case", ["fingerprint", "block_len", "digest",
                                  "unreadable", "shape", "leaves"])
def test_refusals_match(case, tmp_path):
    root = str(tmp_path / "store")
    j, t = _stores("f32", root)
    b_np, b_t = _block("f32", 0)
    path = PATHS[0]
    if case in ("shape", "leaves"):
        bad = dict(b_t)
        if case == "shape":
            bad["k"] = bad["k"][:1]
        else:
            bad.pop("v")
        bad_np = {n: (v.numpy() if n in bad else None)
                  for n, v in bad.items()}
        with pytest.raises(ValueError) as want:
            j.publish(bad_np, path)
        with pytest.raises(ValueError) as got:
            t.publish(bad, path)
        assert str(got.value).split(":")[0] == str(want.value).split(":")[0]
        return
    t.publish(b_t, path)
    if case == "fingerprint":
        j = jstore.PrefixStore(root, j.leaf_meta, block_len=BL,
                               fingerprint={**FP, "seed": 1})
        t = tstore.PrefixStore(root, t.leaf_meta, block_len=BL,
                               fingerprint={**FP, "seed": 1})
    elif case == "block_len":
        j = jstore.PrefixStore(root, j.leaf_meta, block_len=2,
                               fingerprint=FP)
        t = tstore.PrefixStore(root, t.leaf_meta, block_len=2,
                               fingerprint=FP)
    elif case == "digest":
        data = dict(np.load(t.entry_path(path)))
        data["k"] = data["k"] + 1
        with open(t.entry_path(path), "wb") as f:
            np.savez(f, **data)
    else:
        with open(t.entry_path(path), "wb") as f:
            f.write(b"not a zip")
    with pytest.raises(ValueError) as want:
        j.fetch(path)
    with pytest.raises(ValueError) as got:
        t.fetch(path)
    assert str(got.value).split("(")[0] == str(want.value).split("(")[0]
    # the advisory scan skips what fetch refuses, alike
    assert t.scan() == j.scan()


def test_tmp_siblings_are_not_entries(tmp_path):
    j, t = _stores("f32", str(tmp_path / "store"))
    t.publish(_block("f32", 1)[1], PATHS[0])
    open(os.path.join(t.root, "x.npz.1.0.tmp"), "wb").close()
    assert len(t) == len(j) == 1
    assert t.scan() == j.scan()
    assert tstore.scan(str(tmp_path / "absent")) == []


# -- the engine's store hooks, held against the JAX package's engine ------

SERVE = dict(vocab=64, embed=32, heads=4, head_dim=8, depth=1, slots=4,
             block_len=8, requests=6, gen=4, seed=0)


def _engines(tmp_path):
    """Each package's (engine factory, trace) over the kv-tier pool of
    the session trace, on the same (reference-drawn) weights."""
    import jax
    import numpy as np_
    from jax.sharding import Mesh

    from tpu_patterns.models.lm import init_lm_params as j_init
    from tpu_patterns.models.transformer import ModelConfig as JModel
    from tpu_patterns.serve import engine as jengine
    from tpu_patterns_torch.convert import params_from_jax
    from tpu_patterns_torch.serve import engine as tengine

    jcfg = jengine.ServeConfig(**SERVE)
    tcfg = tengine.ServeConfig(**SERVE, device="cpu")
    jm = JModel(embed=32, heads=4, head_dim=8, mlp_mult=4, causal=True,
                dtype="float32", depth=1, kv_heads=0, rope=True)
    flat = j_init(jax.random.key(0), jm, 64)
    mesh = Mesh(np_.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "sp", "tp"))
    jdec, jparams, _ = jengine._kv_tier_pool(mesh, jcfg, jm, flat)
    tm = tengine.model_config(tcfg)
    tdec = tengine._kv_tier_pool(tcfg, tm, "cpu")
    tparams = tdec.stack_params(params_from_jax(
        {k: np_.asarray(v) for k, v in flat.items()}, tm))
    jtrace, _ = jengine._session_trace(jcfg)
    ttrace, _ = tengine.session_trace(tcfg)
    assert [r.tokens for r in jtrace] == [r.tokens for r in ttrace]

    def jeng(store):
        return jengine.ServeEngine(jdec, jparams, slots=4, kv_host_tier=True,
                                   prefix_store=store)

    def teng(store):
        return tengine.ServeEngine(tdec, tparams, slots=4, kv_host_tier=True,
                                   prefix_store=store)

    return (jeng, jtrace), (teng, ttrace)


def _serve(make, trace, store):
    import dataclasses

    eng = make(store)
    out = eng.run([dataclasses.replace(r) for r in trace])
    assert eng.leaked_blocks() == 0
    keys = ("store_publishes", "store_publish_bytes", "store_hits",
            "store_fetch_bytes", "store_fallbacks",
            "prompt_fresh_full_blocks", "prefix_hit_blocks")
    return out, {k: eng.stats[k] for k in keys}


@pytest.mark.parametrize("publisher", ["jax", "torch"])
def test_engine_publishes_and_fetches_as_the_reference(publisher,
                                                       tmp_path):
    """A publisher engine fills the store, then a cold fetcher engine on
    the same trace fetches instead of prefilling: the port's engines
    publish and fetch what the reference's do, with the same ids, and a
    store one package's engine published serves the other's fetcher."""
    (jeng, jtrace), (teng, ttrace) = _engines(tmp_path)
    want_pub = _serve(jeng, jtrace, str(tmp_path / "j"))
    want_fetch = _serve(jeng, jtrace, str(tmp_path / "j"))
    got_pub = _serve(teng, ttrace, str(tmp_path / "t"))
    assert got_pub == want_pub
    assert want_pub[1]["store_publishes"] > 0
    # the cross leg: one package's published store, the other's fetcher
    cross = str(tmp_path / "x")
    if publisher == "jax":
        _serve(jeng, jtrace, cross)
        got_fetch = _serve(teng, ttrace, cross)
    else:
        _serve(teng, ttrace, cross)
        got_fetch = _serve(jeng, jtrace, cross)
    assert got_fetch == want_fetch
    assert want_fetch[1]["store_hits"] > 0
