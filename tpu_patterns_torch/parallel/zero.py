"""ZeRO-style sharded optimizer over the data-parallel ranks.

Counterpart of ``tpu_patterns/parallel/zero.py``.  The ring allreduce
decomposes into a reduce-scatter and an all-gather; ZeRO (stage 1) runs
the optimizer between the halves:

    reduce_scatter(dp) grads  ->  update MY 1/dp shard  ->  all_gather(dp)

Same bytes between ranks as the allreduce, but the optimizer state and
the update math shrink by the dp factor.  The update rule is any
:class:`~tpu_patterns_torch.parallel.optim.Optimizer` whose update is
elementwise (the port's ``sgd`` and ``adam``, optax's rules).

There each function runs inside ``shard_map``, one program a device.
Here every argument that varies by rank is a list over the ranks of
a rank mesh (``comm/mesh.py``), element r being rank r's tree (a tensor,
or a dict, list or tuple of trees); the scatter and the gather are
``comm/ring.py``'s library collectives.  Parameters stay replicated
between steps (every rank holds the whole tree); grads may arrive
unreduced (``grads_reduced=False``: the reduce-scatter sums them) or
already summed (each rank slices its shard).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
from torch.utils import _pytree

from tpu_patterns_torch.comm.ring import (
    library_all_gather,
    library_reduce_scatter,
)
from tpu_patterns_torch.parallel.optim import apply_updates, tree_leaves


def shard_size(n: int, axis_size: int) -> int:
    """Per-rank flat shard length (ceil so every element is owned)."""
    return -(-n // axis_size)


def _padded_flat(a: torch.Tensor, axis_size: int) -> torch.Tensor:
    """Flatten and zero-pad to a multiple of ``axis_size`` (zeros are
    inert for gradient sums and sliced off on rebuild)."""
    flat = a.reshape(-1)
    pad = shard_size(flat.numel(), axis_size) * axis_size - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def param_shard(ps: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Rank r's flat 1/p slice of a replicated parameter (``ps[r]`` is
    rank r's replica), for every rank."""
    n = len(ps)
    out = []
    for r, p in enumerate(ps):
        flat = _padded_flat(p, n)
        k = flat.numel() // n
        out.append(flat[r * k:(r + 1) * k])
    return out


def grad_shard(gs: Sequence[torch.Tensor], grads_reduced: bool = False
               ) -> list[torch.Tensor]:
    """Rank r's flat slice of the rank-summed gradient, for every rank.
    Unreduced grads take the reduce-scatter (the first half of the
    optimal ring allreduce); summed grads just slice."""
    if grads_reduced:
        return param_shard(gs)
    return library_reduce_scatter([_padded_flat(g, len(gs)) for g in gs])


def unshard(ps: Sequence[torch.Tensor], shards: Sequence[torch.Tensor]
            ) -> list[torch.Tensor]:
    """All-gather the updated shards and restore each replica's shape and
    dtype (the second half of the optimal ring allreduce)."""
    return [flat[:p.numel()].reshape(p.shape).to(p.dtype)
            for p, flat in zip(ps, library_all_gather(shards))]


def _leafwise(fn: Callable[..., list], *by_rank: Sequence[Any]) -> list:
    """``fn`` leaf by leaf over trees given by rank: each argument is a
    list over the ranks of trees of one structure; ``fn`` takes, for one
    leaf, the list over ranks of it from each argument and returns a list
    over ranks.  Returns the list over ranks of result trees."""
    n = len(by_rank[0])
    flat = [[_pytree.tree_flatten(t)[0] for t in trees] for trees in by_rank]
    spec = _pytree.tree_flatten(by_rank[0][0])[1]
    results = [fn(*[[leaves[r][j] for r in range(n)] for leaves in flat])
               for j in range(len(flat[0][0]))]
    return [_pytree.tree_unflatten([res[r] for res in results], spec)
            for r in range(n)]


def zero_init(tx, params: Sequence[Any]) -> list:
    """Optimizer state over each rank's shard of every leaf: 1/p of the
    replicated state's footprint.  ``params[r]`` is rank r's replica."""
    return [tx.init(s) for s in _leafwise(param_shard, params)]


def zero_apply(tx, grads: Sequence[Any], opt_state: Sequence[Any],
               params: Sequence[Any], grads_reduced: bool = False
               ) -> tuple[list, list]:
    """One sharded optimizer step; returns (new params, new optimizer
    state), each a list over the ranks."""
    gs = _leafwise(lambda g: grad_shard(g, grads_reduced), grads)
    ps = _leafwise(param_shard, params)
    new_ps, new_state = [], []
    for g, st, p in zip(gs, opt_state, ps):
        updates, st = tx.update(g, st, p)
        new_ps.append(apply_updates(p, updates))
        new_state.append(st)
    return _leafwise(unshard, params, new_ps), new_state


def memory_model(params: Any, axis_size: int, state_arrays: int = 2
                 ) -> dict:
    """Analytic bytes a rank of optimizer state: replicated vs ZeRO.

    ``params`` is one replica's tree; ``state_arrays``: state tensors a
    parameter (2 for Adam's moments, 1 for momentum).  The dp-factor
    saving is the pattern's headline."""
    n_bytes = sum(leaf.numel() * leaf.element_size()
                  for leaf in tree_leaves(params))
    return {
        "opt_state_bytes_replicated": float(state_arrays * n_bytes),
        "opt_state_bytes_zero": float(
            state_arrays * -(-n_bytes // axis_size)),
        "wire_bytes_per_device": float(
            2 * (axis_size - 1) / axis_size * n_bytes),
    }
