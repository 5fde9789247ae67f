"""Token-level LM: embedding, cross-entropy, greedy argmax, the two
samplers, tied-weight params, the train step, the dense decoder, and
the measured ``lm`` pattern (train, then generate).

Counterpart of ``tpu_patterns/models/lm.py``.  The weights are tied:
logits are ``y @ wemb.T``.  Over a dp x sp x tp rank mesh
(``comm/mesh.py::NamedMesh``; per-rank lists, as in
``models/transformer.py``) the table ``wemb`` is split over tp by rows,
and the vocab-parallel patterns make their collectives explicit sums,
maxes and mins over each tp group: the embedding (each rank looks up its
own id range, then a tp sum), the cross-entropy (a max over the group
before the exponent, sums of the normalizer and the target logit; the
full [B, L, V] logits never exist), the greedy argmax (the group's max,
then the lowest global id holding it) and the samplers.  Next-token
targets cross the sp boundary by the layout's halo (``ring_shift``).
On one rank every piece is the plain one-device op it reduces to.

Sampling noise is ``jax.random``'s, bit for bit (``models/prng.py``):
the per-row replay sampler of the serve path keys ``(seed, index)`` a
row, the global-seed samplers of ``make_lm_decoder``
``fold_in(fold_in(key(seed), step), dp rank)``, the full-vocab one
folding each tp rank's slice of the noise in once more.  The reference
trains with ``attn="xla"``, the dense attention, so nothing here
launches a hand-written kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_patterns_torch.comm.mesh import NamedMesh
from tpu_patterns_torch.comm.ring import library_all_gather, ring_shift
from tpu_patterns_torch.models import decode as D
from tpu_patterns_torch.models import prng
from tpu_patterns_torch.models.transformer import (
    MESH_AXES,
    ModelConfig,
    _check_kv_heads_shardable,
    _loss_ranks,
    _tp_sum,
    forward_mesh,
    init_params,
    max_over,
    min_over,
    n_experts,
    param_specs,
    reduce_groups,
    sgd_update,
    single_mesh,
    sum_over,
    unused_ok,
    world_grads,
)
from tpu_patterns_torch.runtime import resolve_device


def _tp_rank(mesh: NamedMesh, r: int) -> int:
    return mesh.coord(r)["tp"]


def _offsets(mesh: NamedMesh, shards: list) -> list[int]:
    """Each rank's first vocab id: its tp rank times its shard's width
    (the last axis of ``shards[r]``)."""
    return [_tp_rank(mesh, r) * t.shape[-1] for r, t in enumerate(shards)]


def embed_tokens(wemb: torch.Tensor, tokens: torch.Tensor,
                 offset: int = 0) -> torch.Tensor:
    """wemb [V_loc, E] (the vocab rows from id ``offset`` on), tokens
    [B, L] global ids -> [B, L, E]; ids outside the shard embed to
    zeros, so a tp sum of every shard's lookup is the full lookup."""
    v = wemb.shape[0]
    rel = tokens - offset
    ok = (rel >= 0) & (rel < v)
    x = wemb[rel.clamp(0, v - 1).long()]
    return torch.where(ok[..., None], x, 0)


def _embed_mesh(mesh: NamedMesh, wembs: list, toks: list) -> list:
    """The vocab-parallel lookup: each rank's shard, summed over tp."""
    offs = [_tp_rank(mesh, r) * w.shape[0] for r, w in enumerate(wembs)]
    return _tp_sum(mesh, [embed_tokens(w, t, o)
                          for w, t, o in zip(wembs, toks, offs)])


def sharded_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Greedy ids [B] from logits [B, V], compared in float32; ties go to
    the lowest id (``torch.argmax`` returns the first maximum)."""
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)


def argmax_mesh(mesh: NamedMesh, logits: list) -> list:
    """Greedy ids from each rank's vocab shard [B, V/tp] without a
    gather: the local (max, argmax), the group's max, then the lowest
    global id among the ranks that hold it (the reference's pmax and
    pmin).  Every rank of a tp group gets the same ids."""
    if mesh.dim("tp") == 1:
        return [sharded_argmax(lg) for lg in logits]
    groups = mesh.groups("tp")
    f32 = [lg.to(torch.float32) for lg in logits]
    loc_max = [f.amax(dim=-1) for f in f32]
    m = max_over(groups, loc_max)
    big = torch.iinfo(torch.int32).max
    cand = [torch.where(lm >= mm, o + f.argmax(dim=-1).to(torch.int32), big)
            for f, lm, mm, o in zip(f32, loc_max, m, _offsets(mesh, f32))]
    return min_over(groups, cand)


def _ce_mesh(mesh: NamedMesh, logits: list, targets: list) -> list:
    """Per-position cross-entropy [B, L] in nats from each rank's vocab
    shard of the logits [B, L, V/tp] and the global target ids, in
    float32: ``log(z) + m - target_logit``, ``m`` the group's max (on
    detached values: a stabilizer only, as the reference's
    ``stop_gradient``), ``z`` and the target logit (contributed by the
    one rank that owns the id; 0 for an id outside the vocab) summed
    over tp."""
    groups = mesh.groups("tp")
    f32 = [lg.to(torch.float32) for lg in logits]
    ms = max_over(groups, [f.detach().amax(dim=-1) for f in f32])
    zs, tls = [], []
    for f, m, t, o in zip(f32, ms, targets, _offsets(mesh, f32)):
        v = f.shape[-1]
        rel = t - o
        ok = (rel >= 0) & (rel < v)
        zs.append(torch.exp(f - m[..., None]).sum(dim=-1))
        tl = f.gather(-1, rel.clamp(0, v - 1).long()[..., None])[..., 0]
        tls.append(torch.where(ok, tl, 0.0))
    zs, tls = _tp_sum(mesh, zs), _tp_sum(mesh, tls)
    return [torch.log(z) + m - tl for z, m, tl in zip(zs, ms, tls)]


def vocab_parallel_ce(logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """:func:`_ce_mesh` on one device: logits [B, L, V], targets [B, L]."""
    return _ce_mesh(single_mesh(logits.device), [logits], [targets])[0]


def _top_ids(f32: torch.Tensor, k: int) -> torch.Tensor:
    """Ids [B, min(k, V)] of the largest values of f32 [B, V], id
    ascending, picked as the reference's XLA ``top_k`` picks on the CPU:
    values in total order (-0.0 below +0.0), the lower id first among
    equal bits (a stable descending sort of the total-order keys)."""
    bits = f32.view(torch.int32)
    total = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    pick = torch.sort(total, dim=-1, descending=True, stable=True)[1]
    return torch.sort(pick[:, :k], dim=-1)[0]


def _gathered_top(mesh: NamedMesh, f32: list, k: int) -> list:
    """Each rank's (values, global ids) [B, tp * min(k, V/tp)]: every
    rank's local top-k (:func:`_top_ids`, any global top-k entry is in
    its owner's) gathered over its tp group in rank order, so the ids
    ascend across the list and a stable pick by value takes the lower
    id among equal bits, as over the whole vocab."""
    vals, ids = [], []
    for f, o in zip(f32, _offsets(mesh, f32)):
        pick = _top_ids(f, k)
        vals.append(f.gather(1, pick))
        ids.append(pick + o)
    out_v, out_i = list(vals), list(ids)
    for g in mesh.groups("tp"):
        for r, v, i in zip(g, library_all_gather([vals[r] for r in g], 1),
                           library_all_gather([ids[r] for r in g], 1)):
            out_v[r], out_i[r] = v, i
    return list(zip(out_v, out_i))


def sample_mesh(mesh: NamedMesh, logits: list, keys: list,
                temperature: float) -> list:
    """Ids drawn from softmax(logits / T) over the vocab shards by
    Gumbel-max without a gather: rank r draws its [B, V/tp] slice of the
    noise from ``fold_in(keys[r], tp rank)`` (its draw's counters run
    over the flattened shape), then :func:`argmax_mesh`.  ``temperature
    <= 0`` is greedy."""
    if temperature <= 0:
        return argmax_mesh(mesh, logits)
    noisy = []
    for r, (lg, key) in enumerate(zip(logits, keys)):
        b, v = lg.shape
        g = prng.gumbel(prng.fold_in(key, _tp_rank(mesh, r)),
                        b * v).reshape(b, v)
        noisy.append(lg.to(torch.float32) / temperature + g)
    return argmax_mesh(mesh, noisy)


def sharded_sample(logits: torch.Tensor, key: torch.Tensor,
                   temperature: float) -> torch.Tensor:
    """:func:`sample_mesh` on one device (the noise key folds in tp rank
    0): logits [B, V], key [2]."""
    return sample_mesh(single_mesh(logits.device), [logits], [key],
                       temperature)[0]


def _pick_among(vals, cands, key, temperature):
    g = prng.gumbel(key, cands.numel()).reshape(cands.shape)
    choice = torch.argmax(vals / temperature + g, dim=-1)
    return cands.gather(1, choice[:, None])[:, 0].to(torch.int32)


def topk_sample_mesh(mesh: NamedMesh, logits: list, keys: list,
                     temperature: float, k: int) -> list:
    """Top-k temperature sampling over the vocab shards: the gathered
    local top-k lists (:func:`_gathered_top`), their top ``k`` by value
    (lower id first among equal bits), ordered by id, and a Gumbel-max
    draw ``[B, k]`` from ``keys[r]`` (not folded by the tp rank: every
    rank holds the same candidates and draws the same token).
    ``temperature <= 0`` is greedy."""
    if temperature <= 0:
        return argmax_mesh(mesh, logits)
    f32 = [lg.to(torch.float32) for lg in logits]
    if mesh.dim("tp") == 1:
        out = []
        for f, key in zip(f32, keys):
            cands = _top_ids(f, k)
            out.append(_pick_among(f.gather(1, cands), cands, key,
                                   temperature))
        return out
    out = []
    for (vals, ids), key in zip(_gathered_top(mesh, f32, k), keys):
        pos = _top_ids(vals, k)
        out.append(_pick_among(vals.gather(1, pos), ids.gather(1, pos), key,
                               temperature))
    return out


def sharded_topk_sample(logits: torch.Tensor, key: torch.Tensor,
                        temperature: float, k: int) -> torch.Tensor:
    """:func:`topk_sample_mesh` on one device: the k largest logits
    (:func:`_top_ids`), by id, then a Gumbel-max draw ``[B, k]`` from
    ``key``.  ``temperature <= 0`` is greedy."""
    return topk_sample_mesh(single_mesh(logits.device), [logits], [key],
                            temperature, k)[0]


# Candidate-list width of the per-row sampler: any top-k/top-p truncation
# up to 64 survivors is exact (the reference's value).
SAMPLE_CANDIDATES = 64


def _rows_pick(vals, gids, seeds, gidx, temp, topk, topp, cap: int):
    """The per-row draw over candidates (vals, global ids) [B, c] in id
    order: the top ``cap`` by value (a stable descending sort, zeros made
    +0.0, so equal values keep id order), then top-p, top-k and a keyed
    Gumbel-max (:func:`sample_token_rows`)."""
    by_value = torch.sort(torch.where(vals == 0, 0.0, vals), dim=-1,
                          descending=True, stable=True)[1][:, :cap]
    vals = vals.gather(1, by_value)
    gids = gids.gather(1, by_value).to(torch.int32)
    greedy = gids[:, 0]
    c = vals.shape[-1]
    scaled = vals / torch.clamp_min(temp, 1e-6)[:, None]
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs
    rank = torch.arange(c, dtype=torch.int32, device=vals.device)[None, :]
    keep = ((topp[:, None] >= 1.0) | (cum < topp[:, None])) & (
        (topk[:, None] <= 0) | (rank < topk[:, None])
    )
    masked = torch.where(keep, scaled, -1e30)
    keys = prng.fold_in(prng.fold_in(prng.key(0, vals.device), seeds), gidx)
    choice = torch.argmax(masked + prng.gumbel(keys, c), dim=-1)
    sampled = gids.gather(1, choice[:, None])[:, 0]
    return torch.where(temp > 0, sampled, greedy)


def sample_token_rows(logits, seeds, gidx, temp, topk, topp,
                      cap: int = SAMPLE_CANDIDATES) -> torch.Tensor:
    """Per-row seeded temperature/top-k/top-p sampling: ids [B] from
    logits [B, V] and per-row ``seeds``/``gidx``/``topk`` (int32) and
    ``temp``/``topp`` (float32) [B], all on the logits' device.

    Row b's draw is keyed ``fold_in(fold_in(key(0), seeds[b]),
    gidx[b])`` (``models/prng.py``), ``gidx`` being the request's global
    generated-token index, and nothing else, so the same (seed, index)
    draws the same token whatever batch, mesh or backend served it.
    Rows with ``temp <= 0`` return the greedy id, the first candidate:
    :func:`sharded_argmax`'s, unless the maximum is shared by -0.0 and
    +0.0, where the candidate order below puts +0.0 first.

    The candidates are the top ``cap`` in (value desc, id asc) order,
    picked and ordered as the reference's XLA ops do on the CPU: its
    ``top_k`` compares floats in total order (-0.0 below +0.0, lower
    ids first among equal bits), and its id sort then stable value sort
    compares -0.0 equal to +0.0.  Here the pick is a stable descending
    sort of the values' total-order keys, the order a stable
    descending sort of the picked values with zeros made +0.0 (so CUDA's
    radix sort cannot split them either).  Then the
    values are scaled by ``max(temp, 1e-6)``, masked by top-p
    (exclusive cumulative probability < topp, rank 0 always kept; 1.0
    disables) and top-k (candidate rank < topk; 0 disables), masked
    entries set to -1e30, and a Gumbel-max draw picks the token."""
    f32 = logits.to(torch.float32)
    pick = _top_ids(f32, cap)  # id ascending
    return _rows_pick(f32.gather(1, pick), pick, seeds, gidx, temp, topk,
                      topp, cap)


def rows_mesh(mesh: NamedMesh, logits: list, rows: list) -> list:
    """:func:`sample_token_rows` over the vocab shards: each rank's local
    top-``SAMPLE_CANDIDATES`` gathered over its tp group (the one
    collective it adds), then the same draw on every rank.  ``rows[r]``
    is rank r's (seeds, gidx, temp, topk, topp) for its dp block, or
    None where no row samples (the greedy ids)."""
    if all(rw is None for rw in rows):
        return argmax_mesh(mesh, logits)
    greedy = (argmax_mesh(mesh, logits)
              if any(rw is None for rw in rows) else None)
    f32 = [lg.to(torch.float32) for lg in logits]
    cands = (_gathered_top(mesh, f32, SAMPLE_CANDIDATES)
             if mesh.dim("tp") > 1 else
             [(f.gather(1, p), p) for f in f32
              for p in (_top_ids(f, SAMPLE_CANDIDATES),)])
    return [greedy[r] if rw is None else
            _rows_pick(v, i, *rw, SAMPLE_CANDIDATES)
            for r, ((v, i), rw) in enumerate(zip(cands, rows))]


def sample_rows_on(device, seeds, gidx, temp, topk, topp) -> tuple | None:
    """The sampler's five per-row arrays on ``device`` in ONE host-to-
    device copy (a [5, B] int32 block; the float32 rows travel as their
    bits), or None when no row samples (every ``temp <= 0``), where the
    greedy argmax gives the same ids."""
    temp = np.asarray(temp, np.float32)
    if not (temp > 0).any():
        return None
    block = np.stack([
        np.asarray(seeds, np.int32), np.asarray(gidx, np.int32),
        temp.view(np.int32), np.asarray(topk, np.int32),
        np.asarray(topp, np.float32).view(np.int32),
    ])
    d = torch.from_numpy(block).to(device)
    f = d.view(torch.float32)
    return d[0], d[1], f[2], d[3], f[4]


def init_lm_params(
    seed: int, cfg: ModelConfig, vocab: int, device=None,
    n_experts: int = 0,
) -> dict[str, torch.Tensor]:
    """Block params (``n_experts`` for a ``moe`` model) plus the tied
    embedding ``wemb [V, E]`` (normal, scaled ``E ** -0.5``), drawn from
    a CPU ``torch.Generator`` seeded with ``seed`` so every device gets
    the same weights."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = init_params(gen, cfg, dev, n_experts)
    wemb = torch.randn((vocab, cfg.embed), generator=gen) * cfg.embed**-0.5
    params["wemb"] = wemb.to(device=dev, dtype=cfg.torch_dtype)
    return params


def lm_param_specs(cfg: ModelConfig, vocab: int, n_experts: int = 0
                   ) -> dict[str, tuple[tuple[int, ...], tuple]]:
    """Each leaf's global shape and spec (``transformer.param_specs``)
    plus the tied table, split over tp by rows."""
    specs = param_specs(cfg, n_experts)
    specs["wemb"] = ((vocab, cfg.embed), ("tp", None))
    return specs


def shard_lm_params(params: dict, mesh: NamedMesh, cfg: ModelConfig
                    ) -> dict[str, list[torch.Tensor]]:
    """Global LM params -> per-rank lists over ``mesh``
    (:func:`lm_param_specs`)."""
    _check_kv_heads_shardable(cfg, mesh)
    specs = lm_param_specs(cfg, params["wemb"].shape[0],
                           n_experts(mesh, cfg))
    return {k: mesh.shard(v, specs[k][1]) for k, v in params.items()}


def gather_lm_params(sharded: dict, mesh: NamedMesh, cfg: ModelConfig
                     ) -> dict[str, torch.Tensor]:
    """The inverse of :func:`shard_lm_params`, on rank 0's device."""
    vocab = sharded["wemb"][0].shape[0] * mesh.dim("tp")
    specs = lm_param_specs(cfg, vocab, n_experts(mesh, cfg))
    return {k: mesh.assemble(v, specs[k][1]) for k, v in sharded.items()}


def _targets(mesh: NamedMesh, toks: list, cfg: ModelConfig):
    """Each rank's (next-token targets, global positions) [B, L_loc] and
    [L_loc]: contiguous shards take their last column's successor from
    the next sp rank (a one-column ring shift), striped shards the next
    stripe's whole block (the last stripe shifted one step on).  The
    slot after the final global position wraps and is masked by the
    loss."""
    sp = mesh.dim("sp")
    l_loc = toks[0].shape[1]
    out = [None] * mesh.size
    if sp == 1:
        for r, t in enumerate(toks):
            out[r] = (torch.cat([t[:, 1:], t[:, :1]], dim=1),
                      torch.arange(l_loc, device=t.device))
        return out
    striped = cfg.attn_layout == "striped"
    for g in mesh.groups("sp"):
        if striped:
            nxt = ring_shift([toks[r] for r in g], -1)
        else:
            halo = ring_shift([toks[r][:, :1] for r in g], -1)
        for s, r in enumerate(g):
            t, dev = toks[r], toks[r].device
            i = torch.arange(l_loc, device=dev)
            if striped:
                n = nxt[s]
                tg = torch.cat([n[:, 1:], n[:, :1]], dim=1) if s == sp - 1 \
                    else n
                out[r] = (tg, s + sp * i)
            else:
                out[r] = (torch.cat([t[:, 1:], halo[s]], dim=1),
                          s * l_loc + i)
    return out


def lm_loss_mesh(mesh: NamedMesh, params: dict, toks: list,
                 cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of the tied-weight LM over the
    world (a tensor on rank 0's device): params a dict of per-rank
    lists, toks each rank's [B/dp, L/sp] ids.  Embedding, the
    ``cfg.depth`` blocks (``transformer.forward_mesh``), each rank's
    logits against its vocab shard, the vocab-parallel CE; the last
    global position predicts nothing.  Each (dp, sp) shard counts once
    (tp rank 0's, the tp replicas being equal)."""
    wembs = params["wemb"]
    blocks = {k: v for k, v in params.items() if k != "wemb"}
    ys = _embed_mesh(mesh, wembs, toks)
    for i in range(cfg.depth):
        ys = forward_mesh(mesh, D._layer_of(mesh, blocks, i), ys, cfg)
    logits = [torch.einsum("ble,ve->blv", y, w) for y, w in zip(ys, wembs)]
    tg = _targets(mesh, toks, cfg)
    ce = _ce_mesh(mesh, logits, [t for t, _ in tg])
    l_global = toks[0].shape[1] * mesh.dim("sp")
    home = ce[0].device
    num = den = None
    for r in _loss_ranks(mesh):
        w = (tg[r][1] < l_global - 1).to(ce[r].dtype)[None, :]
        n_r = (ce[r] * w).sum().to(home)
        d_r = w.expand_as(ce[r]).sum().to(home)
        num, den = (n_r, d_r) if num is None else (num + n_r, den + d_r)
    return num / den


def lm_loss_shard(params: dict, tokens: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """:func:`lm_loss_mesh` on one device: params a dict of tensors,
    tokens [B, L]."""
    return lm_loss_mesh(single_mesh(tokens.device),
                        {k: [v] for k, v in params.items()}, [tokens], cfg)


def make_lm_train_step(cfg: ModelConfig, vocab: int, lr: float = 1e-2,
                       mesh: NamedMesh | None = None):
    """``step(params, toks) -> (new_params, loss)``: the LM loss, its
    gradient (autograd over the world, each leaf's then summed over the
    ranks that hold a replica of its block, as
    ``transformer.make_mesh_grads``) and SGD ``p - lr * g`` in p's
    dtype, over ``mesh`` (params a dict of per-rank lists, toks each
    rank's [B/dp, L/sp] shard; striped: the caller stripes).
    ``mesh=None``: one device, a dict of tensors and one tokens
    tensor."""
    if mesh is None:
        steps = {}

        def one(params: dict, tokens: torch.Tensor):
            if params["wemb"].shape[0] != vocab:
                raise ValueError(f"wemb has {params['wemb'].shape[0]} "
                                 f"rows, the vocab is {vocab}")
            inner = steps.get(tokens.device)
            if inner is None:
                inner = steps[tokens.device] = make_lm_train_step(
                    cfg, vocab, lr, single_mesh(tokens.device))
            new, loss = inner({k: [v] for k, v in params.items()},
                              [tokens])
            return {k: v[0] for k, v in new.items()}, loss

        return one
    tp = mesh.dim("tp")
    if vocab % tp:
        raise ValueError(f"vocab {vocab} must divide over tp={tp}")
    _check_kv_heads_shardable(cfg, mesh)
    specs = lm_param_specs(cfg, vocab, n_experts(mesh, cfg))
    groups = {k: reduce_groups(mesh, s, MESH_AXES)
              for k, (_, s) in specs.items()}
    unused = unused_ok(mesh, specs)

    def step(params: dict, toks: list):
        loss, gs = world_grads(
            lambda leaves: lm_loss_mesh(mesh, leaves, toks, cfg), params,
            unused)
        gs = {k: sum_over(groups[k], g) for k, g in gs.items()}
        return sgd_update(params, gs, lr), loss

    return step


def _global_keys(seed: int, folds, device, dp_rank: int = 0
                 ) -> torch.Tensor:
    """[..., 2] keys ``fold_in(fold_in(key(seed), f), dp_rank)`` for the
    fold index ``folds`` (an int, or a tensor of them on ``device``):
    each batch shard draws its own noise, sp and tp ranks share it."""
    return prng.fold_in(prng.fold_in(prng.key(seed, device), folds),
                        dp_rank)


# the fold index of the prefill's draw: distinct from every generation
# step's index n (fold data is non-negative)
PREFILL_FOLD = 0x7FFFFFFF


def make_lm_decoder(
    cfg: ModelConfig,
    vocab: int,
    batch: int,
    prefill_len: int,
    gen_cap: int,
    cache_int8: bool = False,
    mesh: NamedMesh | None = None,
):
    """Token generation over a dense KV cache.

    ``prefill(params, tokens, lens=None, return_logits=False) -> (cache,
    first_token[, logits])`` runs the right-padded prompt [batch,
    prefill_len]; ``generate(params, cache, token, t0, n_steps,
    return_logits=False) -> (cache, tokens [B, n_steps][, logits
    [B, n_steps, V]])`` feeds each id back and updates the cache in
    place.  ``t0`` is a scalar global position (every row at full
    prefill_len) or a tuple ``(lens, n0)`` for ragged rows.  With
    ``mesh=None`` params, tokens and the cache live on one device: the
    serve engine's oracle (no pool, no scheduler, no batching across
    requests).  Over ``mesh`` (dp x sp x tp) params are a dict of
    per-rank lists (:func:`shard_lm_params`), the prompt each rank's
    [B/dp, prefill/sp] shard (``cfg.attn_layout`` striped: the caller
    stripes), caches, tokens and logits (each rank's vocab shard) per
    rank; ``lens`` and ``sample_rows`` stay global.

    Both take ``temperature``, ``seed`` and ``top_k``: at temperature 0
    the id is the greedy argmax; above it a Gumbel-max draw over the
    whole vocab (:func:`sample_mesh`) or over the top ``top_k``
    (:func:`topk_sample_mesh`), keyed ``fold_in(fold_in(key(seed),
    PREFILL_FOLD), dp rank)`` for the prefill's token and
    ``fold_in(fold_in(key(seed), n), dp rank)`` for generation index
    ``n`` (counted from ``n0``), as the reference's scan carries it.

    Both also take ``sample_rows=(seeds, gidx, temp, topk, topp)``,
    host arrays [batch], for the per-row fixed-seed sampler
    (:func:`sample_token_rows`, the serve cores' replay rule): prefill
    emits each row's generated token ``gidx[b]``, and generate's step
    ``n`` (counted from ``n0``) emits token ``gidx[b] + n + 1``."""
    if mesh is None:
        return _lm_one_device(cfg, vocab, batch, prefill_len, gen_cap,
                              cache_int8)
    return _lm_mesh_pair(mesh, cfg, vocab, batch, prefill_len, gen_cap,
                         cache_int8)


def _lm_mesh_pair(mesh, cfg, vocab, batch, prefill_len, gen_cap,
                  cache_int8):
    tp = mesh.dim("tp")
    if vocab % tp:
        raise ValueError(f"vocab {vocab} must divide over tp={tp}")
    dec = D.MeshDecoder(mesh, cfg, batch, prefill_len, gen_cap, cache_int8)
    b_loc = batch // mesh.dim("dp")

    def device_of(r):
        return mesh.devices[r]

    def dp_of(r):
        return mesh.coord(r)["dp"]

    def split(params):
        return (params["wemb"],
                {k: v for k, v in params.items() if k != "wemb"})

    def embed(wembs, toks):
        return [x.to(cfg.torch_dtype)
                for x in _embed_mesh(mesh, wembs, toks)]

    def rows_on(sample_rows):
        """Each rank's dp block of the per-row sampler arrays on its
        device (:func:`sample_rows_on`)."""
        out = []
        for r in range(mesh.size):
            d = dp_of(r)
            out.append(sample_rows_on(device_of(r), *(
                np.asarray(a)[d * b_loc:(d + 1) * b_loc]
                if mesh.dim("dp") > 1 else a for a in sample_rows)))
        return out

    def pick_global(logits, keys, temperature, top_k):
        if top_k > 0 and temperature > 0:
            return topk_sample_mesh(mesh, logits, keys, temperature, top_k)
        return sample_mesh(mesh, logits, keys, temperature)

    def logits_last(wembs, ys):  # y [B, 1, E] -> [B, V/tp]
        return [y[:, 0, :] @ w.T for y, w in zip(ys, wembs)]

    @torch.no_grad()
    def prefill(params, tokens, lens=None, return_logits=False,
                sample_rows=None, temperature=0.0, seed=0, top_k=0):
        wembs, blocks = split(params)
        toks = [torch.as_tensor(t, device=device_of(r))
                for r, t in enumerate(tokens)]
        caches, ys = dec.prefill(blocks, embed(wembs, toks), dec.lens(lens))
        logits = logits_last(wembs, ys)
        if temperature > 0 and not sample_rows:
            keys = [_global_keys(seed, PREFILL_FOLD, device_of(r), dp_of(r))
                    for r in range(mesh.size)]
            tok = pick_global(logits, keys, temperature, top_k)
        elif sample_rows:
            tok = rows_mesh(mesh, logits, rows_on(sample_rows))
        else:
            tok = argmax_mesh(mesh, logits)
        return (caches, tok, logits) if return_logits else (caches, tok)

    @torch.no_grad()
    def generate(params, cache, tok, t0, n_steps, return_logits=False,
                 sample_rows=None, temperature=0.0, seed=0, top_k=0):
        wembs, blocks = split(params)
        lens, n0 = dec.start(t0)
        n_steps = int(n_steps)
        toks = [torch.as_tensor(t, dtype=torch.int32, device=device_of(r))
                for r, t in enumerate(tok)]
        rows = rows_on(sample_rows) if sample_rows else None
        if rows is not None and all(rw is None for rw in rows):
            rows = None  # no row samples: as if none were given
        keys = None
        if temperature > 0 and rows is None:
            keys = [_global_keys(seed, torch.arange(n0, n0 + n_steps,
                                                    device=device_of(r)),
                                 device_of(r), dp_of(r))
                    for r in range(mesh.size)]
        out, logit_rows = [], []
        for n in range(n0, n0 + n_steps):
            ys = dec.step(blocks, cache, embed(wembs, [t[:, None]
                                                      for t in toks]),
                          lens, n)
            logits = logits_last(wembs, ys)
            if keys is not None:
                toks = pick_global(logits, [k[n - n0] for k in keys],
                                   temperature, top_k)
            elif rows is not None:
                toks = rows_mesh(mesh, logits, [
                    None if rw is None else (rw[0], rw[1] + n + 1, *rw[2:])
                    for rw in rows])
            else:
                toks = argmax_mesh(mesh, logits)
            out.append(toks)
            if return_logits:
                logit_rows.append(logits)
        per_rank = [torch.stack([o[r] for o in out], dim=1) if out
                    else toks[r][:, None][:, :0] for r in range(mesh.size)]
        if return_logits:
            return cache, per_rank, [
                torch.stack([lg[r] for lg in logit_rows], dim=1)
                for r in range(mesh.size)]
        return cache, per_rank

    return prefill, generate


def _lm_one_device(cfg, vocab, batch, prefill_len, gen_cap, cache_int8):
    """:func:`make_lm_decoder` on one device: the mesh decoder on the
    (1, 1, 1) mesh of the params' device, with tensors in and out."""
    made = {}

    def pair(device):
        if device not in made:
            made[device] = _lm_mesh_pair(single_mesh(device), cfg, vocab,
                                         batch, prefill_len, gen_cap,
                                         cache_int8)
        return made[device]

    def unwrap(res):
        return tuple(v[0] for v in res)

    def prefill(params, tokens, lens=None, **kw):
        dev = params["wemb"].device
        return unwrap(pair(dev)[0]({k: [v] for k, v in params.items()},
                                   [torch.as_tensor(tokens, device=dev)],
                                   lens, **kw))

    def generate(params, cache, tok, t0, n_steps, **kw):
        dev = params["wemb"].device
        return unwrap(pair(dev)[1]({k: [v] for k, v in params.items()},
                                   [cache], [tok], t0, n_steps, **kw))

    return prefill, generate


@dataclasses.dataclass
class LMConfig:
    """CLI ``lm`` subcommand: train-then-generate measured pattern."""

    vocab: int = 1024
    embed: int = 256
    heads: int = 8
    head_dim: int = 32
    mlp_mult: int = 4
    depth: int = 2
    dtype: str = "float32"
    rope: bool = True
    kv_heads: int = 0
    cache_int8: bool = False
    layout: str = "contiguous"  # token/KV-cache layout (or "striped")
    moe: bool = False  # top-1 mixture FFN, experts one per tp rank
    batch: int = 4
    seq: int = 256  # training sequence length
    steps: int = 20
    lr: float = 0.5
    gen: int = 32  # tokens generated after training
    temperature: float = 0.0  # 0 = greedy; >0 = Gumbel-max sampling
    top_k: int = 0  # restrict sampling to the k highest logits (0 = all)
    seed: int = 0
    device: str = "cuda"  # "cpu" runs on the CPU


def model_config(cfg: LMConfig) -> ModelConfig:
    """The block config of an ``lm`` run."""
    return ModelConfig(
        embed=cfg.embed, heads=cfg.heads, head_dim=cfg.head_dim,
        mlp_mult=cfg.mlp_mult, causal=True, dtype=cfg.dtype,
        depth=cfg.depth, rope=cfg.rope, kv_heads=cfg.kv_heads,
        attn_layout=cfg.layout, moe=cfg.moe,
    )


def lm_inputs(cfg: LMConfig, mesh: NamedMesh):
    """(block config, global params, global tokens) of an ``lm`` run over
    ``mesh``, on its first rank's device: weights and tokens from
    ``torch.Generator``s seeded from ``cfg.seed`` (``n_experts`` = tp
    for ``moe``), the tokens striped for the striped layout (shard r
    holds tokens r::sp: the loss's halo and the decode cache both assume
    it)."""
    from tpu_patterns_torch.longctx.attention import stripe

    dev = mesh.devices[0]
    mcfg = model_config(cfg)
    params = init_lm_params(cfg.seed, mcfg, cfg.vocab, dev,
                            n_experts(mesh, mcfg))
    toks = torch.randint(
        0, cfg.vocab, (cfg.batch, cfg.seq), dtype=torch.int32,
        generator=torch.Generator().manual_seed(cfg.seed + 1),
    ).to(dev)
    if cfg.layout == "striped":
        toks = stripe(toks, mesh.dim("sp"), axis=1)
    return mcfg, params, toks


def run_lm(cfg: LMConfig, writer=None, mesh: NamedMesh | None = None
           ) -> list:
    """Measured LM pattern over ``mesh`` (dp x sp x tp; None: one rank
    on ``cfg.device``): train (the loss must drop), then generate from
    the training context, greedy at temperature 0 and Gumbel-max
    sampled above it (deterministic given the seed); the generated ids
    must stay in the vocab.  Weights and tokens come from
    ``torch.Generator``s seeded from ``cfg.seed``, not the reference's
    ``jax.random`` streams, so the losses differ from its at one seed.
    With ranks sharing a card, ``train_steps_per_s`` and
    ``gen_tokens_per_s`` are the world's serial time on it."""
    from tpu_patterns_torch import obs
    from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict
    from tpu_patterns_torch.core.timing import clock_ns

    writer = writer or ResultWriter()
    # mesh=None runs the one-device step and decoder on tensors; a mesh,
    # the per-rank lists
    one = mesh is None
    if one:
        mesh = single_mesh(resolve_device(cfg.device))
    sp = mesh.dim("sp")
    mcfg, params, toks = lm_inputs(cfg, mesh)
    on = None if one else mesh
    step = make_lm_train_step(mcfg, cfg.vocab, lr=cfg.lr, mesh=on)
    if one:
        p, st = params, toks
    else:
        p, st = shard_lm_params(params, mesh, mcfg), mesh.shard(
            toks, ("dp", "sp"))
    _, first = step(p, st)
    first = float(first)
    loss = first  # steps=0: the initial loss, nothing trained
    with obs.span("lm.train", steps=cfg.steps, vocab=cfg.vocab):
        t0 = clock_ns()
        for _ in range(cfg.steps):
            p, loss = step(p, st)
        loss = float(loss)
        train_s = (clock_ns() - t0) / 1e9

    # capacity padded up to a multiple of sp (the cache layout divides
    # the gen segment over sp); still generate exactly cfg.gen tokens
    gen_cap = cfg.gen + (-cfg.gen % sp)
    pre, gen = make_lm_decoder(mcfg, cfg.vocab, cfg.batch, cfg.seq,
                               gen_cap, cache_int8=cfg.cache_int8, mesh=on)

    def ids(out):
        return (out if one else mesh.assemble(out, ("dp", None))).cpu()

    gen_kw = dict(temperature=cfg.temperature, seed=cfg.seed,
                  top_k=cfg.top_k)
    caches, tok0 = pre(p, st, **gen_kw)
    # warm first: the rollout is deterministic in (caches, tok0, seed),
    # so the timed second call does the same work
    ids(gen(p, caches, tok0, cfg.seq, cfg.gen, **gen_kw)[1])
    with obs.span("lm.generate", tokens=cfg.batch * cfg.gen):
        t1 = clock_ns()
        _, out = gen(p, caches, tok0, cfg.seq, cfg.gen, **gen_kw)
        out = ids(out).numpy()
        gen_s = (clock_ns() - t1) / 1e9
    tps = cfg.batch * cfg.gen / gen_s if gen_s > 0 else 0.0

    learned = bool(np.isfinite(loss) and loss < first)
    in_vocab = bool(((out >= 0) & (out < cfg.vocab)).all())
    rec = Record(
        pattern="lm",
        mode=f"V{cfg.vocab}"
        + (f"_gqa{cfg.kv_heads}" if cfg.kv_heads else "")
        + ("_int8" if cfg.cache_int8 else "")
        + ("_striped" if cfg.layout == "striped" else "")
        + ("_moe" if cfg.moe else "")
        + (
            f"_T{cfg.temperature}"
            + (f"_k{cfg.top_k}" if cfg.top_k else "")
            + f"_seed{cfg.seed}"
            if cfg.temperature > 0
            else ""
        ),
        commands=(
            f"B{cfg.batch} L{cfg.seq} depth{cfg.depth} E{cfg.embed} "
            f"{cfg.dtype} steps{cfg.steps} gen{cfg.gen}"
        ),
        metrics={
            "loss_first": round(first, 4),
            "loss_final": round(loss, 4),
            "train_steps_per_s": round(cfg.steps / train_s, 3),
            "gen_tokens_per_s": round(tps, 1),
        },
        verdict=Verdict.SUCCESS if (learned and in_vocab) else Verdict.FAILURE,
    )
    if not learned:
        rec.notes.append(f"loss did not drop: {first} -> {loss}")
    if not in_vocab:
        rec.notes.append("generated ids outside the vocab")
    if note := mesh.note("tp sums, sp combines and ring shifts"):
        rec.notes.append(note)
    writer.record(rec)
    return [rec]
