"""Token boundary of the LM: embedding, greedy argmax, tied-weight params
and the per-request dense decoder that serves as the exactness oracle.

Counterpart of ``tpu_patterns/models/lm.py`` on one device: the vocab is
not sharded, so the vocab-parallel lookup and argmax reduce to plain
indexing and ``argmax`` with the lowest id winning a tie.  The weights
are tied: logits are ``y @ wemb.T``.
"""

from __future__ import annotations

import torch

from tpu_patterns_torch.models import decode as D
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
    no pool, no scheduler, no batching across requests."""
    layout = D._CacheLayout(prefill_len, gen_cap)

    def _logits_last(wemb, y):  # y [B, 1, E] -> [B, V]
        return y[:, 0, :] @ wemb.T

    @torch.no_grad()
    def prefill(params, tokens, lens=None, return_logits=False):
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
        tok = sharded_argmax(logits)
        return (cache, tok, logits) if return_logits else (cache, tok)

    @torch.no_grad()
    def generate(params, cache, tok, t0, n_steps, return_logits=False):
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
        out, logit_rows = [], []
        for n in range(int(n0), int(n0) + int(n_steps)):
            x = embed_tokens(wemb, tok[:, None]).to(cfg.torch_dtype)
            for i in range(cfg.depth):
                cache_l = {k: leaf[i] for k, leaf in cache.items()}
                x = D._decode_layer(
                    _blocks(params, i), x, cache_l, lens, n, layout, cfg
                )
            logits = _logits_last(wemb, x)
            tok = sharded_argmax(logits)
            out.append(tok)
            if return_logits:
                logit_rows.append(logits)
        toks = torch.stack(out, dim=1) if out else tok[:, None][:, :0]
        if return_logits:
            return cache, toks, torch.stack(logit_rows, dim=1)
        return cache, toks

    return prefill, generate
