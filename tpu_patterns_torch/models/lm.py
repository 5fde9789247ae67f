"""Token boundary of the LM: embedding, greedy argmax, the seeded per-row
sampler, tied-weight params and the per-request dense decoder that
serves as the exactness oracle.

Counterpart of ``tpu_patterns/models/lm.py`` on one device: the vocab is
not sharded, so the vocab-parallel lookup and argmax reduce to plain
indexing and ``argmax`` with the lowest id winning a tie, and the
sampler's candidate gather is the identity.  The weights are tied:
logits are ``y @ wemb.T``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_patterns_torch.models import decode as D
from tpu_patterns_torch.models import prng
from tpu_patterns_torch.models.transformer import ModelConfig, init_params
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
    bits = f32.view(torch.int32)
    total = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    pick = torch.sort(total, dim=-1, descending=True, stable=True)[1]
    pick = torch.sort(pick[:, :cap], dim=-1)[0]  # id ascending
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


def make_lm_decoder(
    cfg: ModelConfig,
    vocab: int,
    batch: int,
    prefill_len: int,
    gen_cap: int,
    cache_int8: bool = False,
):
    """Greedy token generation over a dense per-request KV cache.

    ``prefill(params, tokens, lens=None, return_logits=False) -> (cache,
    first_token[, logits [B, V]])`` runs the right-padded prompt [batch,
    prefill_len]; ``generate(params, cache, token, t0, n_steps,
    return_logits=False) -> (cache, tokens [B, n_steps][, logits
    [B, n_steps, V]])`` feeds each greedy id back.  ``t0`` is
    a scalar global position (every row at full prefill_len) or a tuple
    ``(lens, n0)`` for ragged rows.  Params and tokens live on one
    device; the cache is made there.  This is the serve engine's oracle:
    no pool, no scheduler, no batching across requests.

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
                sample_rows=None):
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
        rows = sample_rows_on(dev, *sample_rows) if sample_rows else None
        tok = _pick(logits, rows, 0)
        return (cache, tok, logits) if return_logits else (cache, tok)

    @torch.no_grad()
    def generate(params, cache, tok, t0, n_steps, return_logits=False,
                 sample_rows=None):
        wemb = params["wemb"]
        dev = wemb.device
        if isinstance(t0, tuple):
            lens, n0 = t0
            lens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        else:
            lens = torch.full((batch,), prefill_len, dtype=torch.int32,
                              device=dev)
            n0 = int(t0) - prefill_len
        tok = torch.as_tensor(tok, dtype=torch.int32, device=dev)
        rows = sample_rows_on(dev, *sample_rows) if sample_rows else None
        out, logit_rows = [], []
        for n in range(int(n0), int(n0) + int(n_steps)):
            x = embed_tokens(wemb, tok[:, None]).to(cfg.torch_dtype)
            for i in range(cfg.depth):
                cache_l = {k: leaf[i] for k, leaf in cache.items()}
                x = D._decode_layer(
                    _blocks(params, i), x, cache_l, lens, n, layout, cfg
                )
            logits = _logits_last(wemb, x)
            tok = _pick(logits, rows, n + 1)
            out.append(tok)
            if return_logits:
                logit_rows.append(logits)
        toks = torch.stack(out, dim=1) if out else tok[:, None][:, :0]
        if return_logits:
            return cache, toks, torch.stack(logit_rows, dim=1)
        return cache, toks

    return prefill, generate
