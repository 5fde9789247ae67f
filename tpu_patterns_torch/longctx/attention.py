"""Attention building blocks: the dense twins of the flash kernels.

Counterpart of ``tpu_patterns/longctx/attention.py`` on one device:

* ``attention_reference`` — plain softmax attention, the ground truth
  and the ``attn="dense"`` path of the train step;
* ``block_attention`` — one K/V block's partial attention, returning the
  online-softmax statistics (o unnormalized, running max m, normalizer
  l); ``combine_blocks`` merges two partials, ``empty_state`` is the
  merge's identity and ``finalize`` normalizes;
* ``stripe`` — global token order to the striped shard layout;
* ``run_sharded`` — the mesh launcher of the sequence-parallel
  strategies (``ring_attention.py``, ``ulysses.py``) over a rank mesh
  (``comm/mesh.py``).

Layout as in the reference: q/k/v [seq, heads, head_dim]; statistics
[heads, seq].
"""

from __future__ import annotations

import numpy as np
import torch

# Finite stand-in for -inf: exp() of it is exactly 0 with no NaN from
# (-inf) - (-inf) on a wholly masked row.  -1e30 is exact in f32/bf16.
NEG_INF = -1e30


def neg_inf(dtype: torch.dtype) -> float:
    """The finite -inf stand-in representable in ``dtype``."""
    return max(NEG_INF, float(torch.finfo(dtype).min) / 2)


def _scale(q: torch.Tensor, scale: float | None) -> float:
    return float(scale) if scale is not None else q.shape[-1] ** -0.5


def stripe(a, sp: int, axis: int = 0):
    """Global token order -> the striped shard layout along ``axis``:
    a contiguous sp-way sharding of the result gives shard r exactly
    tokens ``r::sp``.  numpy in -> numpy out, torch in -> torch out;
    ``sp <= 1`` is the identity."""
    if sp <= 1:
        return a
    sl = [slice(None)] * a.ndim
    parts = []
    for r in range(sp):
        sl[axis] = slice(r, None, sp)
        parts.append(a[tuple(sl)])
    if isinstance(a, torch.Tensor):
        return torch.cat(parts, dim=axis)
    return np.concatenate(parts, axis=axis)


def causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """[Lq, Lk] boolean mask: a query sees keys at <= its position."""
    return q_pos[:, None] >= k_pos[None, :]


def attention_reference(q, k, v, causal: bool = False,
                        scale: float | None = None) -> torch.Tensor:
    """Ground-truth softmax attention in the inputs' dtype.
    q: [Lq, H, D]; k, v: [Lk, H, D]."""
    s = torch.einsum("qhd,khd->hqk", q, k) * _scale(q, scale)
    if causal:
        lq, lk = q.shape[0], k.shape[0]
        mask = causal_mask(torch.arange(lq, device=q.device),
                           torch.arange(lk, device=q.device))
        s = torch.where(mask[None], s, neg_inf(s.dtype))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v)


def block_attention(q, k, v, scale: float | None = None,
                    mask: torch.Tensor | None = None):
    """Partial attention of q against one K/V block: (o [Lq, H, D]
    unnormalized, m [H, Lq], l [H, Lq])."""
    s = torch.einsum("qhd,khd->hqk", q, k) * _scale(q, scale)
    ninf = neg_inf(s.dtype)
    if mask is not None:
        s = torch.where(mask[None], s, ninf)
    m = s.amax(dim=-1)
    # a wholly masked row: exp(ninf - ninf) would be 1
    p = torch.exp(s - m[..., None]) * (m[..., None] > ninf / 2)
    l = p.sum(dim=-1)
    o = torch.einsum("hqk,khd->qhd", p, v)
    return o, m, l


def combine_blocks(state, block):
    """Associative merge of two (o, m, l) online-softmax partials."""
    o1, m1, l1 = state
    o2, m2, l2 = block
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    l = a1 * l1 + a2 * l2
    w1 = a1.transpose(0, 1)[..., None]  # [H, Lq] -> [Lq, H, 1]
    w2 = a2.transpose(0, 1)[..., None]
    return o1 * w1 + o2 * w2, m, l


def empty_state(q: torch.Tensor):
    """Identity of :func:`combine_blocks` for queries shaped like q."""
    base = q[:, :, 0].transpose(0, 1) * 0  # [H, Lq]
    return torch.zeros_like(q), base + neg_inf(q.dtype), base


def finalize(state) -> torch.Tensor:
    """Normalize an accumulated (o, m, l) state into the output."""
    o, _, l = state
    denom = l.transpose(0, 1)[..., None]
    return o / torch.where(denom == 0.0, 1.0, denom)


def run_sharded(attn_fn, q, k, v, mesh, causal: bool = False,
                scale: float | None = None) -> torch.Tensor:
    """Shared launcher of the sequence-parallel strategies: scatter global
    [L, H, D] tensors (numpy or torch) over the ranks of ``mesh`` (a
    ``comm/mesh.py::RankMesh``, rank r holding rows ``[r*L/p,
    (r+1)*L/p)``) and run ``attn_fn``, a shard-level function taking and
    returning per-rank lists (``attn_fn(qs, ks, vs, causal=, scale=)``).
    Returns the global output on rank 0's device.  Eager torch has
    nothing to retrace, so no program cache stands in for the
    reference's."""
    outs = attn_fn(*(mesh.scatter(a) for a in (q, k, v)), causal=causal,
                   scale=scale)
    return torch.cat([o.to(mesh.devices[0]) for o in outs])
