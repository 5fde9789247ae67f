"""The port's disaggregated prefill/decode serving against the JAX
package's, on the CPU: the engine roles (``serve/engine.py``'s handoff
wave and adoption), the KV-block wire (``comm/p2p.py::make_block_stream``
under ``PagedDecoder.stream``), the spool format and the
``disagg.transfer``/``disagg.adopt`` fault sites.

The reference's ``tests/test_disagg.py`` cases (E 64, 8 heads of 8,
depth 1, block_len 8, 13 blocks, 40-token tables, 3 slots), with the
reference's weights handed across as numpy (``convert.py``): a prefill
engine and a decode engine of the port, on one pool layout, must retire
the ids of the reference's unified engine, greedy and sampled, float32
and with an int8 pool; a spooled payload must hold exactly the prompt's
blocks, its members as the reference spools them (int8 values bit for
bit, float leaves within 64 float32 eps of their magnitude: both sides
do float32 math in their own order, as in ``test_torch_serve_mesh.py``);
a payload either package spools must adopt in the other with the
reference's ids; a bfloat16 payload is spooled as the reference spools
it (two-byte void members) and adopts in the port bit for bit, from
either package (the reference's adoption refuses a bfloat16 spool, its
own included: ROADMAP.md Queue 3); adopted blocks must equal the spool,
bit for bit, with the refcounts closed; and every fault case must take
the reference's outcome with exact ids."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tpu_patterns import faults as jfaults
from tpu_patterns.models.lm import init_lm_params as j_init_lm_params
from tpu_patterns.models.transformer import ModelConfig as JModelConfig
from tpu_patterns.serve import Request as JRequest
from tpu_patterns.serve import ServeEngine as JServeEngine
from tpu_patterns.serve import make_paged_lm_decoder as j_make_decoder
from tpu_patterns_torch import faults as tfaults
from tpu_patterns_torch.comm.mesh import model_mesh
from tpu_patterns_torch.comm.p2p import make_block_stream
from tpu_patterns_torch.convert import params_from_jax
from tpu_patterns_torch.models.transformer import ModelConfig
from tpu_patterns_torch.serve import engine as tengine
from tpu_patterns_torch.serve.paged import TRASH_BLOCK, make_paged_lm_decoder

# one intra-op thread: torch's OpenMP pool spins while it waits, and
# test workers of eight threads each on a loaded host run these cases
# tens of times slower (every worker imports every test module, so this
# holds for the whole run)
torch.set_num_threads(1)

VOCAB = 64
EPS64 = 64 * np.finfo(np.float32).eps
MODEL = dict(embed=64, heads=8, head_dim=8)
POOL = dict(n_blocks=13, block_len=8, max_len=40)


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in (jfaults, tfaults):
        f.configure(None)
    yield
    for f in (jfaults, tfaults):
        f.configure(None)


def _trace(n, min_p=3, max_p=20, max_gen=6, seed=1):
    """The reference test's trace: ragged prompts, 1..max_gen tokens."""
    rng = np.random.RandomState(seed)
    return [(i, rng.randint(0, VOCAB, size=rng.randint(min_p, max_p + 1))
             .tolist(), int(rng.randint(1, max_gen + 1))) for i in range(n)]


def _sampled():
    """The reference's TestAdoptedSampling requests."""
    return [(i, [(i * 3 + j) % VOCAB for j in range(7)], 5,
             dict(temperature=0.8, top_k=8, seed=17 + i)) for i in range(3)]


def _reqs(R, trace):
    return [R(rid=t[0], tokens=list(t[1]), n_gen=t[2],
              **(t[3] if len(t) > 3 else {})) for t in trace]


@functools.lru_cache(maxsize=None)
def _flat(dtype):
    jcfg = JModelConfig(**MODEL, causal=True, dtype=dtype)
    return {k: np.asarray(v) for k, v in j_init_lm_params(
        jax.random.key(0), jcfg, VOCAB).items()}


def _jdec(dtype="float32", int8=False, sampling=False):
    jcfg = JModelConfig(**MODEL, causal=True, dtype=dtype)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "sp", "tp"))
    dec = j_make_decoder(mesh, jcfg, VOCAB, cache_int8=int8,
                         sampling=sampling, **POOL)
    return dec, dec.stack_params(
        {k: jax.numpy.asarray(v) for k, v in _flat(dtype).items()})


def _tdec(shape=(1, 1, 1), dtype="float32", int8=False, sampling=False):
    cfg = ModelConfig(**MODEL, dtype=dtype)
    mesh = (None if shape == (1, 1, 1) else
            model_mesh(int(np.prod(shape)), shape[0], shape[2],
                       device="cpu"))
    dec = make_paged_lm_decoder(cfg, VOCAB, cache_int8=int8,
                                sampling=sampling, device="cpu", mesh=mesh,
                                **POOL)
    return dec, dec.stack_params(params_from_jax(_flat(dtype), cfg))


@functools.lru_cache(maxsize=None)
def _unified(int8=False, sampled=False, trace_args=(6,)):
    """The reference's unified engine's ids on the trace."""
    dec, params = _jdec(int8=int8, sampling=sampled)
    trace = _sampled() if sampled else _trace(*trace_args)
    slots = 2 if sampled else 3
    return JServeEngine(dec, params, slots=slots).run(_reqs(JRequest, trace))


def _pair(dec, params, spool, slots=3):
    pre = tengine.ServeEngine(dec, params, slots=slots, role="prefill",
                              spool_dir=str(spool))
    return pre, tengine.ServeEngine(dec, params, slots=slots, role="decode")


def _split_run(pre, de, reqs, transfer=None, adopt=None):
    """Prefill everything, hand every manifest over FIFO, decode."""
    tfaults.configure(transfer)
    try:
        got = pre.run(reqs)
    finally:
        tfaults.configure(None)
    de.adopt_queue.extend(pre.handoffs[r] for r in sorted(pre.handoffs))
    tfaults.configure(adopt)
    try:
        got.update(de.run([]))
    finally:
        tfaults.configure(None)
    return got


# -- registry and validation -------------------------------------------------


@pytest.mark.parametrize("text", [
    "disagg.transfer:error:rid=3", "disagg.adopt:error:replica=1",
    "disagg.transfer:kill:replica=0:count=1",
    "disagg.adopt:error:count=99:blocks=2",
])
def test_disagg_sites_parse_as_the_reference(text):
    for site in ("disagg.transfer", "disagg.adopt"):
        assert site in tfaults.KNOWN_SITES and site in jfaults.KNOWN_SITES
    assert "blocks" in tfaults.MATCH_KEYS
    got = [dataclasses.asdict(s) for s in tfaults.parse_spec(text)]
    assert got == [dataclasses.asdict(s) for s in jfaults.parse_spec(text)]


@pytest.mark.parametrize("kw,match", [
    (dict(role="router"), "role must be"),
    (dict(role="prefill"), "requires spool_dir"),
    (dict(role="decode", kv_host_tier=True, prefix_store="st"),
     "prefix_store is incompatible"),
])
def test_role_validation_refuses_as_the_reference(kw, match, tmp_path):
    kw = {k: (str(tmp_path / v) if k == "prefix_store" else v)
          for k, v in kw.items()}
    jdec, jparams = _jdec()
    with pytest.raises(ValueError, match=match) as want:
        JServeEngine(jdec, jparams, slots=2, **kw)
    tdec, tparams = _tdec()
    with pytest.raises(ValueError, match=match) as got:
        tengine.ServeEngine(tdec, tparams, slots=2, **kw)
    assert str(got.value) == str(want.value)


# -- the block stream --------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 2, 1), (1, 2, 2),
                                   (1, 4, 1)])
def test_block_stream_round_trip_is_bit_identical(shape):
    """Every leaf of every rank crosses its sp pair and back: the output
    equals the input bit for bit, in fresh buffers, and the input dict
    is consumed."""
    mesh = model_mesh(int(np.prod(shape)), shape[0], shape[2],
                      device="cpu")
    g = torch.Generator().manual_seed(7)
    vals = {"k": [torch.randn(2, 3, 4, generator=g)
                  for _ in range(mesh.size)],
            "ks": [torch.randint(-128, 128, (2, 3), generator=g,
                                 dtype=torch.int8)
                   for _ in range(mesh.size)],
            "b": [torch.randn(5, generator=g).to(torch.bfloat16)
                  for _ in range(mesh.size)]}
    want = {k: [t.clone() for t in v] for k, v in vals.items()}
    held = [t for v in vals.values() for t in v]  # the staging buffers
    ptrs = {t.data_ptr() for t in held}
    wire = make_block_stream(mesh, axis="sp")(vals)
    assert vals == {}
    for k, leaves in want.items():
        for r, t in enumerate(leaves):
            assert wire[k][r].dtype == t.dtype
            assert torch.equal(wire[k][r], t), (k, r)
            assert wire[k][r].data_ptr() not in ptrs


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 2, 2)])
def test_decoder_stream_lands_bit_identical(shape, int8):
    """``PagedDecoder.stream`` of a global-layout payload (the reference's
    ``stream_jit`` case, int8 scales included) returns it bit for bit on
    rank 0's device, as the reference's returns its own."""
    dec, _ = _tdec(shape, int8=int8)
    rng = np.random.RandomState(7)
    k = 4
    vals = {}
    for name, (shp, dt) in dec._pool_leaves().items():
        s = (shp[0], k, *shp[2:])
        vals[name] = (rng.randint(-128, 128, size=s).astype(np.int8)
                      if dt == torch.int8 else rng.randn(*s).astype(np.float32))
    wire = dec.stream({n: torch.from_numpy(v.copy())
                       for n, v in vals.items()})
    for name, v in vals.items():
        assert wire[name].device == dec.device
        np.testing.assert_array_equal(wire[name].numpy(), v)
    jdec, _ = _jdec(int8=int8)
    jwire = jdec.stream_jit(k)({n: np.asarray(v) for n, v in vals.items()})
    for name, v in vals.items():
        np.testing.assert_array_equal(np.asarray(jwire[name]), v)


# -- engine pair exactness ---------------------------------------------------


@pytest.mark.parametrize("shape,int8", [((1, 1, 1), False),
                                        ((1, 2, 2), False),
                                        ((1, 2, 2), True)])
def test_split_matches_reference_unified(shape, int8, tmp_path):
    """prefill -> ship -> adopt -> decode -> retire gives the reference's
    unified ids, with nothing leaked on either side; every multi-token
    request crossed with a real payload, single-token rows retired at
    prefill."""
    dec, params = _tdec(shape, int8=int8)
    trace = _trace(6)
    pre, de = _pair(dec, params, tmp_path)
    got = _split_run(pre, de, _reqs(tengine.Request, trace))
    assert pre.leaked_blocks() == 0 and de.leaked_blocks() == 0
    assert set(pre.handoffs) == {t[0] for t in trace if t[2] > 1}
    for m in pre.handoffs.values():
        assert not m["recompute"] and m["blocks"] >= 1 and m["nbytes"] > 0
    assert de.stats["adopts"] == len(pre.handoffs)
    assert pre.stats["handoffs"] == len(pre.handoffs)
    assert pre.stats["transfer_bytes"] == sum(
        m["nbytes"] for m in pre.handoffs.values())
    # every spool file was adopted and unlinked
    assert not list(tmp_path.iterdir())
    assert got == _unified(int8=int8)


def test_spool_holds_the_prompt_blocks_as_the_reference_spools(tmp_path):
    """Both packages' prefill engines on the same prompts: each manifest
    equals the reference's (its clock stamps and path aside) and each
    file holds exactly blocks_for(len(prompt)) blocks a leaf, with the
    reference's members, shapes and dtypes; int8 values bit for bit,
    float leaves within 64 float32 eps of their magnitude."""
    trace = _trace(4, max_gen=4, seed=3)
    for int8 in (False, True):
        manifests, files = {}, {}
        for pkg, (dec, params), Eng, R in (
                ("jax", _jdec(int8=int8), JServeEngine, JRequest),
                ("torch", _tdec(int8=int8), tengine.ServeEngine,
                 tengine.Request)):
            spool = tmp_path / f"{pkg}{int(int8)}"
            spool.mkdir()
            pre = Eng(dec, params, slots=3, role="prefill",
                      spool_dir=str(spool))
            pre.run(_reqs(R, trace))
            manifests[pkg] = {
                rid: {k: v for k, v in m.items()
                      if k not in ("path", "t_submit_ns", "t_first_ns",
                                   "jid")}
                for rid, m in pre.handoffs.items()}
            files[pkg] = {}
            for rid, m in pre.handoffs.items():
                with np.load(m["path"]) as data:
                    files[pkg][rid] = {n: data[n].copy() for n in data.files}
        assert manifests["torch"] == manifests["jax"]
        lay = _tdec(int8=int8)[0].layout
        for rid, want in files["jax"].items():
            got = files["torch"][rid]
            assert set(got) == set(want)
            n_ship = lay.blocks_for(len(trace[rid][1]))
            for name, w in want.items():
                g = got[name]
                assert g.shape == w.shape and g.shape[1] == n_ship
                assert g.dtype == w.dtype, name
                if g.dtype == np.int8:
                    np.testing.assert_array_equal(g, w)
                else:
                    scale = max(1.0, float(np.abs(w).max()))
                    assert float(np.abs(g - w).max()) / scale <= EPS64


def test_adopted_bytes_bit_identical_and_refcounts_close(tmp_path):
    """The int8 pool, the strictest wire: adopted blocks re-gathered from
    the decode pool equal the spool bit for bit, each referenced once,
    none on the free list, none the trash block; then everything
    retires with nothing leaked."""
    dec, params = _tdec((1, 2, 2), int8=True)
    pre, de = _pair(dec, params, tmp_path)
    pre.run(_reqs(tengine.Request, _trace(4, max_gen=5, seed=5)))
    shipped = {}
    for rid, m in pre.handoffs.items():
        with np.load(m["path"]) as data:
            shipped[rid] = {n: data[n].copy() for n in data.files}
    de.adopt_queue.extend(pre.handoffs[r] for r in sorted(pre.handoffs))
    de._admit_adopts()
    assert not de.adopt_queue and len(de.active) == len(shipped)
    adopted = set()
    for s in de.active:
        table = list(s.table[:dec.layout.blocks_for(s.lens)])
        adopted.update(table)
        for b in table:
            assert b != TRASH_BLOCK and de.ref[b] == 1
        back = dec.gather_blocks(de.pool, table)
        for name, v in shipped[s.rid].items():
            np.testing.assert_array_equal(back[name].numpy(), v)
    assert not adopted & set(de.free) and TRASH_BLOCK not in de.free
    de.run([])
    assert de.leaked_blocks() == 0


# -- spooled in one package, adopted in the other ----------------------------


def _manifests(pre) -> list[dict]:
    return [dict(pre.handoffs[r]) for r in sorted(pre.handoffs)]


def test_payloads_adopt_across_the_packages(tmp_path):
    """The reference's prefill spool adopts in the port's decode engine,
    and the port's in the reference's, each finishing with the
    reference's unified ids."""
    trace = _trace(6)
    want = _unified()
    jdec, jparams = _jdec()
    tdec, tparams = _tdec()
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jpre = JServeEngine(jdec, jparams, slots=3, role="prefill",
                        spool_dir=str(tmp_path / "j"))
    tpre = tengine.ServeEngine(tdec, tparams, slots=3, role="prefill",
                               spool_dir=str(tmp_path / "t"))
    got_j = jpre.run(_reqs(JRequest, trace))
    got_t = tpre.run(_reqs(tengine.Request, trace))
    tde = tengine.ServeEngine(tdec, tparams, slots=3, role="decode")
    tde.adopt_queue.extend(_manifests(jpre))
    got_j.update(tde.run([]))
    jde = JServeEngine(jdec, jparams, slots=3, role="decode")
    jde.adopt_queue.extend(_manifests(tpre))
    got_t.update(jde.run([]))
    assert tde.stats["adopts"] == len(jpre.handoffs) > 0
    assert jde.stats["adopts"] == len(tpre.handoffs)
    assert tde.leaked_blocks() == 0 and jde.leaked_blocks() == 0
    assert got_j == want and got_t == want


def test_bfloat16_spool_crosses_as_void_members(tmp_path):
    """A bfloat16 pool's payload: the port spools its leaves as the
    reference does (two-byte void members), and adopts its own spool and
    the reference's, each landing in its pool bit for bit.  The
    reference's adoption casts the void members into a bfloat16 buffer
    and refuses (numpy has no such cast) its own spool and the port's
    alike (ROADMAP.md Queue 3)."""
    trace = _trace(3, max_gen=4, seed=2)
    jdec, jparams = _jdec("bfloat16")
    tdec, tparams = _tdec(dtype="bfloat16")
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jpre = JServeEngine(jdec, jparams, slots=3, role="prefill",
                        spool_dir=str(tmp_path / "j"))
    tpre = tengine.ServeEngine(tdec, tparams, slots=3, role="prefill",
                               spool_dir=str(tmp_path / "t"))
    jpre.run(_reqs(JRequest, trace))
    tpre.run(_reqs(tengine.Request, trace))

    def spooled(pre):
        out = {}
        for rid, m in pre.handoffs.items():
            with np.load(m["path"]) as data:
                out[rid] = {n: data[n].copy() for n in data.files}
        return out

    from_j, from_t = spooled(jpre), spooled(tpre)
    assert set(from_t) == set(from_j) and from_t
    for rid, leaves in from_t.items():
        for name, a in leaves.items():
            assert a.dtype == from_j[rid][name].dtype
            assert a.dtype.kind == "V" and a.dtype.itemsize == 2
            assert a.shape == from_j[rid][name].shape
    for pre, shipped in ((jpre, from_j), (tpre, from_t)):
        # the reference first: its refused adoption leaves the file, the
        # port's adoption unlinks it
        jde = JServeEngine(jdec, jparams, slots=3, role="decode")
        jde.adopt_queue.extend(_manifests(pre))
        with pytest.raises(ValueError, match="cast"):
            jde._admit_adopts()
        tde = tengine.ServeEngine(tdec, tparams, slots=3, role="decode")
        tde.adopt_queue.extend(_manifests(pre))
        tde._admit_adopts()
        assert len(tde.active) == len(shipped)
        for s in tde.active:
            back = tdec.gather_blocks(
                tde.pool, s.table[:tdec.layout.blocks_for(s.lens)])
            for name, v in shipped[s.rid].items():
                np.testing.assert_array_equal(
                    back[name].view(torch.int16).numpy(), v.view(np.int16))


# -- fault sites -------------------------------------------------------------


FAULTS = {
    "transfer_transient": ("disagg.transfer:error:count=1", None),
    "transfer_deterministic": ("disagg.transfer:error:count=99", None),
    "adopt_transient": (None, "disagg.adopt:error:count=1"),
    "adopt_deterministic": (None, "disagg.adopt:error:count=99"),
}


def _stats(pre, de) -> dict:
    return {"handoff_recomputes": pre.stats["handoff_recomputes"],
            "handoffs": pre.stats["handoffs"], "adopts": de.stats["adopts"],
            "adopt_recomputes": de.stats["adopt_recomputes"],
            "recompute": [m["recompute"] for _, m in
                          sorted(pre.handoffs.items())],
            "blocks": [m["blocks"] for _, m in sorted(pre.handoffs.items())],
            "leaked": (pre.leaked_blocks(), de.leaked_blocks())}


def _reference_pair(transfer, adopt, tmp_path):
    dec, params = _jdec()
    pre = JServeEngine(dec, params, slots=3, role="prefill",
                       spool_dir=str(tmp_path))
    de = JServeEngine(dec, params, slots=3, role="decode")
    jfaults.configure(transfer)
    try:
        got = pre.run(_reqs(JRequest, _trace(5, max_gen=5, seed=9)))
    finally:
        jfaults.configure(None)
    de.adopt_queue.extend(pre.handoffs[r] for r in sorted(pre.handoffs))
    jfaults.configure(adopt)
    try:
        got.update(de.run([]))
    finally:
        jfaults.configure(None)
    return got, _stats(pre, de)


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_fault_sites_take_the_reference_outcome(case, tmp_path):
    """A transient error retries and ships (or adopts); a deterministic
    transfer error ships no-payload manifests that re-prefill on the
    decode pool; a deterministic adopt error returns the blocks and
    re-prefills locally.  The same counts as the reference's, the
    reference's unified ids, nothing leaked."""
    transfer, adopt = FAULTS[case]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want, want_stats = _reference_pair(transfer, adopt, tmp_path / "j")
    dec, params = _tdec((1, 2, 1))
    pre, de = _pair(dec, params, tmp_path / "t")
    got = _split_run(pre, de, _reqs(tengine.Request,
                                    _trace(5, max_gen=5, seed=9)),
                     transfer=transfer, adopt=adopt)
    assert _stats(pre, de) == want_stats
    assert got == want == _unified(trace_args=(5, 3, 20, 5, 9))
    assert want_stats["leaked"] == (0, 0)
    if case == "transfer_deterministic":
        assert all(m["path"] == "" for m in pre.handoffs.values())


# -- adopted sampling ----------------------------------------------------------


def test_adopted_row_continues_the_sampled_stream(tmp_path):
    """The (seed, gen_offset + position) key stream depends only on the
    request, so sampled rows decoded on the adopting pool equal the
    reference's unified engine draw for draw."""
    dec, params = _tdec(sampling=True)
    pre, de = _pair(dec, params, tmp_path, slots=2)
    got = _split_run(pre, de, _reqs(tengine.Request, _sampled()))
    assert de.stats["adopts"] == 3 and de.leaked_blocks() == 0
    assert got == _unified(sampled=True)
