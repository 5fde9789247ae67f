"""Token-level LM: embedding, cross-entropy, greedy argmax, the two
samplers, tied-weight params, the train step, the per-request dense
decoder, and the measured ``lm`` pattern (train, then generate).

Counterpart of ``tpu_patterns/models/lm.py`` on one device: the vocab is
not sharded, so the vocab-parallel lookup, cross-entropy and argmax
reduce to plain indexing, a log-sum-exp and ``argmax`` with the lowest
id winning a tie, and the samplers' candidate gather is the identity.
The weights are tied: logits are ``y @ wemb.T``.  Sampling noise is
``jax.random``'s, bit for bit (``models/prng.py``): the per-row replay
sampler of the serve path keys ``(seed, index)`` a row, the global-seed
samplers of ``make_lm_decoder`` ``fold_in(key(seed), step)``.  The
reference trains with ``attn="xla"``, the dense attention, so nothing
here launches a hand-written kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_patterns_torch.models import decode as D
from tpu_patterns_torch.models import prng
from tpu_patterns_torch.models.transformer import (
    ModelConfig,
    forward_stack,
    init_params,
)
from tpu_patterns_torch.runtime import resolve_device


def embed_tokens(wemb: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """wemb [V, E], tokens [B, L] -> [B, L, E]; out-of-range ids embed
    to zeros, as a vocab shard that does not own them would."""
    v = wemb.shape[0]
    ok = (tokens >= 0) & (tokens < v)
    x = wemb[tokens.clamp(0, v - 1).long()]
    return torch.where(ok[..., None], x, 0)


def sharded_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Greedy ids [B] from logits [B, V], compared in float32; ties go to
    the lowest id (``torch.argmax`` returns the first maximum)."""
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)


def vocab_parallel_ce(logits: torch.Tensor,
                      targets: torch.Tensor) -> torch.Tensor:
    """Per-position cross-entropy [B, L] in nats from logits [B, L, V]
    and target ids [B, L], in float32: ``log(z) + m - target_logit``.
    The max ``m`` is a stabilizer only and is detached, as the
    reference's ``stop_gradient``; an id outside the vocab contributes a
    target logit of 0."""
    f32 = logits.to(torch.float32)
    v = f32.shape[-1]
    m = f32.detach().amax(dim=-1)
    z = torch.exp(f32 - m[..., None]).sum(dim=-1)
    ok = (targets >= 0) & (targets < v)
    tl = f32.gather(-1, targets.clamp(0, v - 1).long()[..., None])[..., 0]
    return torch.log(z) + m - torch.where(ok, tl, 0.0)


def _top_ids(f32: torch.Tensor, k: int) -> torch.Tensor:
    """Ids [B, min(k, V)] of the largest values of f32 [B, V], id
    ascending, picked as the reference's XLA ``top_k`` picks on the CPU:
    values in total order (-0.0 below +0.0), the lower id first among
    equal bits (a stable descending sort of the total-order keys)."""
    bits = f32.view(torch.int32)
    total = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    pick = torch.sort(total, dim=-1, descending=True, stable=True)[1]
    return torch.sort(pick[:, :k], dim=-1)[0]


def sharded_sample(logits: torch.Tensor, key: torch.Tensor,
                   temperature: float) -> torch.Tensor:
    """Ids [B] drawn from softmax(logits / T) by Gumbel-max: the argmax
    of ``logits / T + G`` with G a ``[B, V]`` Gumbel draw from
    ``fold_in(key, 0)`` (the reference folds in the tp rank, 0 here;
    its draw's counters run over the flattened shape).  ``temperature
    <= 0`` is greedy."""
    if temperature <= 0:
        return sharded_argmax(logits)
    b, v = logits.shape
    g = prng.gumbel(prng.fold_in(key, 0), b * v).reshape(b, v)
    return sharded_argmax(logits.to(torch.float32) / temperature + g)


def sharded_topk_sample(logits: torch.Tensor, key: torch.Tensor,
                        temperature: float, k: int) -> torch.Tensor:
    """Top-k temperature sampling: the k largest logits (:func:`_top_ids`),
    re-sorted by id, then a Gumbel-max draw ``[B, k]`` from ``key``
    picks among them.  ``temperature <= 0`` is greedy."""
    if temperature <= 0:
        return sharded_argmax(logits)
    f32 = logits.to(torch.float32)
    cands = _top_ids(f32, k)
    vals = f32.gather(1, cands)
    g = prng.gumbel(key, cands.numel()).reshape(cands.shape)
    choice = torch.argmax(vals / temperature + g, dim=-1)
    return cands.gather(1, choice[:, None])[:, 0].to(torch.int32)


# Candidate-list width of the per-row sampler: any top-k/top-p truncation
# up to 64 survivors is exact (the reference's value).
SAMPLE_CANDIDATES = 64


def sample_token_rows(logits, seeds, gidx, temp, topk, topp,
                      cap: int = SAMPLE_CANDIDATES) -> torch.Tensor:
    """Per-row seeded temperature/top-k/top-p sampling: ids [B] from
    logits [B, V] and per-row ``seeds``/``gidx``/``topk`` (int32) and
    ``temp``/``topp`` (float32) [B], all on the logits' device.

    Row b's draw is keyed ``fold_in(fold_in(key(0), seeds[b]),
    gidx[b])`` (``models/prng.py``), ``gidx`` being the request's global
    generated-token index, and nothing else, so the same (seed, index)
    draws the same token whatever batch or backend served it.  Rows
    with ``temp <= 0`` return the greedy id, the first candidate:
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
    vals = f32.gather(1, pick)
    by_value = torch.sort(torch.where(vals == 0, 0.0, vals), dim=-1,
                          descending=True, stable=True)[1]
    vals = vals.gather(1, by_value)
    gids = pick.gather(1, by_value).to(torch.int32)
    greedy = gids[:, 0]
    c = vals.shape[-1]
    scaled = vals / torch.clamp_min(temp, 1e-6)[:, None]
    probs = torch.softmax(scaled, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs
    rank = torch.arange(c, dtype=torch.int32, device=f32.device)[None, :]
    keep = ((topp[:, None] >= 1.0) | (cum < topp[:, None])) & (
        (topk[:, None] <= 0) | (rank < topk[:, None])
    )
    masked = torch.where(keep, scaled, -1e30)
    keys = prng.fold_in(prng.fold_in(prng.key(0, f32.device), seeds), gidx)
    choice = torch.argmax(masked + prng.gumbel(keys, c), dim=-1)
    sampled = gids.gather(1, choice[:, None])[:, 0]
    return torch.where(temp > 0, sampled, greedy)


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
    seed: int, cfg: ModelConfig, vocab: int, device=None
) -> dict[str, torch.Tensor]:
    """Block params plus the tied embedding ``wemb [V, E]`` (normal,
    scaled ``E ** -0.5``), drawn from a CPU ``torch.Generator`` seeded
    with ``seed`` so every device gets the same weights."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = init_params(gen, cfg, dev)
    wemb = torch.randn((vocab, cfg.embed), generator=gen) * cfg.embed**-0.5
    params["wemb"] = wemb.to(device=dev, dtype=cfg.torch_dtype)
    return params


def _blocks(params: dict, layer: int) -> dict:
    return {k: v[layer] for k, v in params.items() if k != "wemb"}


def lm_loss_shard(params: dict, tokens: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of the tied-weight LM over tokens
    [B, L]: embedding, the ``cfg.depth`` blocks, logits ``y @ wemb.T``,
    targets shifted by one; the last position predicts nothing (its
    wrapped target is weighted 0)."""
    wemb = params["wemb"]
    blocks = {k: v for k, v in params.items() if k != "wemb"}
    y = forward_stack(blocks, embed_tokens(wemb, tokens), cfg)
    logits = torch.einsum("ble,ve->blv", y, wemb)
    targets = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    ce = vocab_parallel_ce(logits, targets)
    l = tokens.shape[1]
    w = (torch.arange(l, device=ce.device) < l - 1).to(ce.dtype)[None, :]
    return (ce * w).sum() / w.expand_as(ce).sum()


def make_lm_train_step(cfg: ModelConfig, vocab: int, lr: float = 1e-2):
    """``step(params, tokens) -> (new_params, loss)``: the LM loss, its
    gradient through ``torch.autograd`` and SGD ``p - lr * g`` in p's
    dtype, as the reference's jitted step on a (1, 1, 1) mesh."""

    def step(params: dict, tokens: torch.Tensor):
        if params["wemb"].shape[0] != vocab:
            raise ValueError(f"wemb has {params['wemb'].shape[0]} rows, "
                             f"the vocab is {vocab}")
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss = lm_loss_shard(leaves, tokens, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            new = {k: p - lr * g.to(p.dtype)
                   for (k, p), g in zip(leaves.items(), grads)}
        return new, loss.detach()

    return step


def _global_keys(seed: int, folds, device) -> torch.Tensor:
    """[..., 2] keys ``fold_in(fold_in(key(seed), f), 0)`` for the fold
    index ``folds`` (an int, or a tensor of them on ``device``); the
    reference's second fold is the dp rank, 0 here."""
    return prng.fold_in(prng.fold_in(prng.key(seed, device), folds), 0)


def _global_pick(logits, key, temperature: float, top_k: int):
    if top_k > 0 and temperature > 0:
        return sharded_topk_sample(logits, key, temperature, top_k)
    return sharded_sample(logits, key, temperature)


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
):
    """Token generation over a dense per-request KV cache.

    ``prefill(params, tokens, lens=None, return_logits=False) -> (cache,
    first_token[, logits [B, V]])`` runs the right-padded prompt [batch,
    prefill_len]; ``generate(params, cache, token, t0, n_steps,
    return_logits=False) -> (cache, tokens [B, n_steps][, logits
    [B, n_steps, V]])`` feeds each id back.  ``t0`` is
    a scalar global position (every row at full prefill_len) or a tuple
    ``(lens, n0)`` for ragged rows.  Params and tokens live on one
    device; the cache is made there and generate updates it in place.
    This is the serve engine's oracle: no pool, no scheduler, no
    batching across requests.

    Both take ``temperature``, ``seed`` and ``top_k``: at temperature 0
    the id is the greedy argmax; above it a Gumbel-max draw over the
    whole vocab (:func:`sharded_sample`) or over the top ``top_k``
    (:func:`sharded_topk_sample`), keyed ``fold_in(fold_in(key(seed),
    PREFILL_FOLD), 0)`` for the prefill's token and ``fold_in(fold_in(
    key(seed), n), 0)`` for generation index ``n`` (counted from
    ``n0``), as the reference's scan carries it.

    Both also take ``sample_rows=(seeds, gidx, temp, topk, topp)``,
    host arrays [batch], for the per-row fixed-seed sampler
    (:func:`sample_token_rows`, the serve cores' replay rule): prefill
    emits each row's generated token ``gidx[b]``, and generate's step
    ``n`` (counted from ``n0``) emits token ``gidx[b] + n + 1``."""
    layout = D._CacheLayout(prefill_len, gen_cap)

    def _logits_last(wemb, y):  # y [B, 1, E] -> [B, V]
        return y[:, 0, :] @ wemb.T

    def _pick(logits, rows, offset: int):
        if rows is None:
            return sharded_argmax(logits)
        seeds, gidx, temp, topk, topp = rows
        return sample_token_rows(logits, seeds, gidx + offset, temp, topk,
                                 topp)

    @torch.no_grad()
    def prefill(params, tokens, lens=None, return_logits=False,
                sample_rows=None, temperature=0.0, seed=0, top_k=0):
        wemb = params["wemb"]
        dev = wemb.device
        tokens = torch.as_tensor(tokens, device=dev)
        if lens is None:
            lens = torch.full((batch,), prefill_len, dtype=torch.int32)
        lens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        x = embed_tokens(wemb, tokens).to(cfg.torch_dtype)
        cache = D._zero_cache(cfg, layout, tokens.shape[0], dev, cache_int8)
        for i in range(cfg.depth):
            cache_l = {n: leaf[i] for n, leaf in cache.items()}
            x = D._prefill_layer(_blocks(params, i), x, cache_l, layout, cfg)
        idx = (lens - 1).clamp(0, prefill_len - 1).long()
        y_last = x[torch.arange(x.shape[0], device=dev), idx][:, None, :]
        logits = _logits_last(wemb, y_last)
        if temperature > 0 and not sample_rows:
            key = _global_keys(seed, PREFILL_FOLD, dev)
            tok = _global_pick(logits, key, temperature, top_k)
        else:
            rows = sample_rows_on(dev, *sample_rows) if sample_rows else None
            tok = _pick(logits, rows, 0)
        return (cache, tok, logits) if return_logits else (cache, tok)

    @torch.no_grad()
    def generate(params, cache, tok, t0, n_steps, return_logits=False,
                 sample_rows=None, temperature=0.0, seed=0, top_k=0):
        wemb = params["wemb"]
        dev = wemb.device
        if isinstance(t0, tuple):
            lens, n0 = t0
            lens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        else:
            lens = torch.full((batch,), prefill_len, dtype=torch.int32,
                              device=dev)
            n0 = int(t0) - prefill_len
        n0, n_steps = int(n0), int(n_steps)
        tok = torch.as_tensor(tok, dtype=torch.int32, device=dev)
        rows = sample_rows_on(dev, *sample_rows) if sample_rows else None
        keys = None
        if temperature > 0 and rows is None:
            keys = _global_keys(
                seed, torch.arange(n0, n0 + n_steps, device=dev), dev)
        out, logit_rows = [], []
        for n in range(n0, n0 + n_steps):
            x = embed_tokens(wemb, tok[:, None]).to(cfg.torch_dtype)
            mask = D._decode_mask(layout, lens, n)
            for i in range(cfg.depth):
                cache_l = {k: leaf[i] for k, leaf in cache.items()}
                x = D._decode_layer(
                    _blocks(params, i), x, cache_l, lens, n, layout, cfg,
                    mask,
                )
            logits = _logits_last(wemb, x)
            if keys is not None:
                tok = _global_pick(logits, keys[n - n0], temperature, top_k)
            else:
                tok = _pick(logits, rows, n + 1)
            out.append(tok)
            if return_logits:
                logit_rows.append(logits)
        toks = torch.stack(out, dim=1) if out else tok[:, None][:, :0]
        if return_logits:
            return cache, toks, torch.stack(logit_rows, dim=1)
        return cache, toks

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
    layout: str = "contiguous"  # "striped" is refused (sp > 1)
    moe: bool = False  # refused: the mixture FFN is not ported
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
    """The block config of an ``lm`` run; raises NotImplementedError for
    what is not ported (``moe``, the striped layout)."""
    if cfg.moe or cfg.layout == "striped":
        raise NotImplementedError(
            "lm: moe and the striped layout run across ranks, not "
            "ported yet (ROADMAP.md Queue 1 step 8c, decode and lm "
            "across ranks)")
    return ModelConfig(
        embed=cfg.embed, heads=cfg.heads, head_dim=cfg.head_dim,
        mlp_mult=cfg.mlp_mult, causal=True, dtype=cfg.dtype,
        depth=cfg.depth, rope=cfg.rope, kv_heads=cfg.kv_heads,
        attn_layout=cfg.layout, moe=cfg.moe,
    )


def run_lm(cfg: LMConfig, writer=None) -> list:
    """Measured LM pattern: train (the loss must drop), then generate
    from the training context, greedy at temperature 0 and Gumbel-max
    sampled above it (deterministic given the seed); the generated ids
    must stay in the vocab.  Weights and tokens come from
    ``torch.Generator``s seeded from ``cfg.seed``, not the reference's
    ``jax.random`` streams, so the losses differ from its at one seed."""
    from tpu_patterns_torch import obs
    from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict
    from tpu_patterns_torch.core.timing import clock_ns

    writer = writer or ResultWriter()
    dev = resolve_device(cfg.device)
    mcfg = model_config(cfg)
    params = init_lm_params(cfg.seed, mcfg, cfg.vocab, dev)
    toks = torch.randint(
        0, cfg.vocab, (cfg.batch, cfg.seq), dtype=torch.int32,
        generator=torch.Generator().manual_seed(cfg.seed + 1),
    ).to(dev)
    step = make_lm_train_step(mcfg, cfg.vocab, lr=cfg.lr)
    p = params
    _, first = step(p, toks)
    first = float(first)
    loss = first  # steps=0: the initial loss, nothing trained
    with obs.span("lm.train", steps=cfg.steps, vocab=cfg.vocab):
        t0 = clock_ns()
        for _ in range(cfg.steps):
            p, loss = step(p, toks)
        loss = float(loss)
        train_s = (clock_ns() - t0) / 1e9

    pre, gen = make_lm_decoder(mcfg, cfg.vocab, cfg.batch, cfg.seq,
                               cfg.gen, cache_int8=cfg.cache_int8)
    gen_kw = dict(temperature=cfg.temperature, seed=cfg.seed,
                  top_k=cfg.top_k)
    caches, tok0 = pre(p, toks, **gen_kw)
    # warm first: the rollout is deterministic in (caches, tok0, seed),
    # so the timed second call does the same work
    gen(p, caches, tok0, cfg.seq, cfg.gen, **gen_kw)[1].cpu()
    with obs.span("lm.generate", tokens=cfg.batch * cfg.gen):
        t1 = clock_ns()
        _, out = gen(p, caches, tok0, cfg.seq, cfg.gen, **gen_kw)
        out = out.cpu().numpy()
        gen_s = (clock_ns() - t1) / 1e9
    tps = cfg.batch * cfg.gen / gen_s if gen_s > 0 else 0.0

    learned = bool(np.isfinite(loss) and loss < first)
    in_vocab = bool(((out >= 0) & (out < cfg.vocab)).all())
    rec = Record(
        pattern="lm",
        mode=f"V{cfg.vocab}"
        + (f"_gqa{cfg.kv_heads}" if cfg.kv_heads else "")
        + ("_int8" if cfg.cache_int8 else "")
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
    writer.record(rec)
    return [rec]
