"""Ulysses sequence parallelism: all-to-all head/sequence re-sharding.

Counterpart of ``tpu_patterns/longctx/ulysses.py``.  Instead of rotating
k/v around a ring, an all-to-all flips the sharded dimension from the
sequence to the heads: each rank then computes exact full-sequence
attention for its H/sp heads, and a second all-to-all flips back.  Two
collectives in all, at the cost of needing heads % sp == 0.  The
reference's ``lax.all_to_all`` becomes, over per-rank lists
(``comm/mesh.py``), ``comm/ring.py::all_to_all``: a gather of each
rank's slice from every rank, a copy in card memory between ranks that
share a card.
"""

from __future__ import annotations

import torch

from tpu_patterns_torch.comm.ring import all_to_all
from tpu_patterns_torch.longctx import attention as att


def seq_to_heads(xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """[L/sp, H, D] a rank -> [L, H/sp, D] a rank: rank r takes heads
    [r*H/sp, (r+1)*H/sp) of every rank's shard, in rank order.  Each
    result is a fresh contiguous tensor on rank r's device (the flash
    kernels refuse strided input)."""
    return all_to_all(xs, split=1, concat=0)


def heads_to_seq(ys: list[torch.Tensor]) -> list[torch.Tensor]:
    """[L, H/sp, D] a rank -> [L/sp, H, D] a rank: rank r takes rows
    [r*L/sp, (r+1)*L/sp) of every rank's heads, in rank order (the
    inverse of :func:`seq_to_heads`; autograd carries each rank's head
    slice of the gradient back the same way)."""
    return all_to_all(ys, split=0, concat=1)


def ulysses_attention(qs, ks, vs, causal: bool = False,
                      scale: float | None = None, block_impl: str = "xla",
                      block_q: int = 1024, block_k: int = 1024,
                      grid_mode: str = "dense") -> list[torch.Tensor]:
    """Exact attention via head re-sharding from per-rank [L_local, H, D]
    sequence shards with H % sp == 0; returns each rank's [L_local, H, D]
    output shard.  ``block_impl="pallas"`` runs each rank's
    full-sequence attention through ``flash.flash_attention_diff`` (K2,
    or K3 and K4 under autograd; ``grid_mode="compact"`` applies, as the
    post-collective view is the single-shard case); "xla" through
    ``attention_reference``."""
    if block_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown block_impl {block_impl!r}; want xla|pallas")
    scale = float(scale) if scale is not None else None

    def local_attn(q, k, v):
        if block_impl == "pallas":
            from tpu_patterns_torch.longctx.flash import flash_attention_diff

            return flash_attention_diff(q, k, v, causal, scale, block_q,
                                        block_k, grid_mode)
        return att.attention_reference(q, k, v, causal=causal, scale=scale)

    sp = len(qs)
    if sp == 1:
        return [local_attn(qs[0], ks[0], vs[0])]
    h = qs[0].shape[1]
    if h % sp != 0:
        raise ValueError(f"heads {h} not divisible by sp axis {sp}")
    outs = [local_attn(q, k, v) for q, k, v in zip(
        seq_to_heads(qs), seq_to_heads(ks), seq_to_heads(vs))]
    return heads_to_seq(outs)


def run_sharded(q, k, v, mesh, causal: bool = False,
                scale: float | None = None) -> torch.Tensor:
    """Scatter global [L, H, D] tensors over ``mesh``'s ranks and run
    Ulysses attention (the plain local op)."""
    return att.run_sharded(ulysses_attention, q, k, v, mesh, causal=causal,
                           scale=scale)
