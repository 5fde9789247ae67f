"""Ring attention: context parallelism over a rank mesh.

Counterpart of ``tpu_patterns/longctx/ring_attention.py``.  The sequence
is sharded over the ranks of a rank mesh (``comm/mesh.py``): each rank
keeps its q shard and the k/v shards travel one ring step per iteration
(``comm/ring.py::ring_shift``, rank i's buffer to rank i + 1, the
reference's ``ppermute``), each step's partial attention merged with the
online-softmax monoid (``longctx/attention.py``).  After sp steps every
query has seen every key.  Where the reference runs one program per
device inside ``shard_map``, a function here takes and returns per-rank
lists (rank r's tensor is shard r) and loops over the ranks; ranks that
share a card run one after another, and a ring step between them is a
copy in that card's memory.

At step t rank r holds the k/v shard that started on rank (r - t) mod
sp, so its global offset is :func:`_shard_geometry`'s ``kv_off(t)``.
Causal masking is by global position; a wholly masked block is still
launched, as the reference runs every ring step on every rank (the
flash kernels skip its tiles).

* ``block_impl="xla"`` — the plain lineage: ``block_attention`` and
  ``combine_blocks`` in torch ops, differentiated by autograd (the
  reference's XLA twin of the same loop);
* ``block_impl="pallas"`` — the fused lineage: K3 (``flash_block``) a
  step forward, and a custom backward that is a second ring, K4
  (``flash_block_bwd``) a step, with each shard's dk/dv accumulators
  travelling with it and dq summed at home.  A call launches sp² K3
  forward and sp² dq + sp² dk/dv K4 backward.

The reference's interpret-mode XLA twins (``_block_fwd_xla``,
``_block_bwd_xla``) have no counterpart: on CPU tensors the kernel
wrappers run their plain versions (``flash_block_reference``,
``flash_block_bwd_reference``).
"""

from __future__ import annotations

import torch

from tpu_patterns_torch.comm.ring import ring_shift
from tpu_patterns_torch.longctx import attention as att


def _shard_geometry(r: int, sp: int, lq: int, lk: int, striped: bool):
    """(q_off, kv_off(t), pos_stride): global-position addressing of rank
    r's shards under either layout (striped: token i of shard r sits at
    global position r + i * sp)."""
    if striped:
        q_off, stride = r, sp
    else:
        q_off, stride = r * lq, 1

    def kv_off(t: int) -> int:
        kv_rank = (r - t) % sp
        return kv_rank if striped else kv_rank * lk

    return q_off, kv_off, stride


def _geometry(qs, ks, striped):
    sp = len(qs)
    return [_shard_geometry(r, sp, qs[0].shape[0], ks[0].shape[0], striped)
            for r in range(sp)]


def _ring_flash_forward(qs, ks, vs, causal, scale, striped):
    """The forward ring with K3 a step: each rank's (out in q's dtype,
    lse [H, Lq] f32), lse being the residual the second ring recomputes
    score tiles from."""
    from tpu_patterns_torch.longctx.flash import _row_stats, flash_block

    sp = len(qs)
    geo = _geometry(qs, ks, striped)
    states = [att.empty_state(q.float()) for q in qs]
    kb, vb = list(ks), list(vs)
    for t in range(sp):
        for r, (q_off, kv_off, stride) in enumerate(geo):
            block = flash_block(qs[r], kb[r], vb[r], q_off=q_off,
                                k_off=kv_off(t), causal=causal, scale=scale,
                                pos_stride=stride)
            states[r] = att.combine_blocks(states[r], block)
        if t < sp - 1:  # the last step's shift would only be discarded
            kb, vb = ring_shift(kb), ring_shift(vb)
    outs, lses = [], []
    for q, state in zip(qs, states):
        out, lse = _row_stats(*state)
        outs.append(out.to(q.dtype))
        lses.append(lse)
    return outs, lses


def _ring_flash_backward(qs, ks, vs, outs, lses, gs, causal, scale,
                         striped):
    """The second ring: K4 a (rank, step); dq accumulates at home in
    f32, the dk/dv accumulators travel with their k/v shard, and one
    more shift after the last step brings them home."""
    from tpu_patterns_torch.longctx.flash import _delta, flash_block_bwd

    sp = len(qs)
    geo = _geometry(qs, ks, striped)
    deltas = [_delta(g, o) for g, o in zip(gs, outs)]
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in qs]
    dkb = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
           for k in ks]
    dvb = [torch.zeros_like(d) for d in dkb]
    kb, vb = list(ks), list(vs)
    for t in range(sp):
        for r, (q_off, kv_off, stride) in enumerate(geo):
            dq_c, dk_c, dv_c = flash_block_bwd(
                qs[r], kb[r], vb[r], gs[r], lses[r], deltas[r], q_off=q_off,
                k_off=kv_off(t), causal=causal, scale=scale,
                pos_stride=stride)
            dqs[r] = dqs[r] + dq_c
            dkb[r] = dkb[r] + dk_c
            dvb[r] = dvb[r] + dv_c
        # sp shifts in all: each accumulator arrives home carrying the
        # contributions of every rank its shard visited
        dkb, dvb = ring_shift(dkb), ring_shift(dvb)
        if t < sp - 1:
            kb, vb = ring_shift(kb), ring_shift(vb)
    return ([d.to(q.dtype) for d, q in zip(dqs, qs)],
            [d.to(k.dtype) for d, k in zip(dkb, ks)],
            [d.to(v.dtype) for d, v in zip(dvb, vs)])


class _RingFlash(torch.autograd.Function):
    """``apply(sp, causal, scale, striped, *qs, *ks, *vs)`` -> each rank's
    output; K3's forward ring, K4's second ring backward."""

    @staticmethod
    def forward(ctx, sp, causal, scale, striped, *qkv):
        qs, ks, vs = qkv[:sp], qkv[sp:2 * sp], qkv[2 * sp:]
        outs, lses = _ring_flash_forward(qs, ks, vs, causal, scale, striped)
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.args = (sp, causal, scale, striped)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        sp, causal, scale, striped = ctx.args
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * sp:(i + 1) * sp]
                                  for i in range(5))
        dqs, dks, dvs = _ring_flash_backward(
            qs, ks, vs, outs, lses, [g.contiguous() for g in gs], causal,
            scale, striped)
        return (None, None, None, None, *dqs, *dks, *dvs)


def ring_flash_attention(qs, ks, vs, causal: bool = False,
                         scale: float | None = None,
                         striped: bool = False) -> list[torch.Tensor]:
    """Differentiable fused ring attention over per-rank shards; the
    contract of :func:`ring_attention` with ``block_impl="pallas"``."""
    return list(_RingFlash.apply(len(qs), causal, scale, striped, *qs, *ks,
                                 *vs))


def _ring_plain(qs, ks, vs, causal, scale, striped):
    """The plain lineage: ``block_attention`` a (rank, step) under the
    global-position mask, merged by ``combine_blocks``."""
    sp = len(qs)
    lq, lk = qs[0].shape[0], ks[0].shape[0]
    geo = _geometry(qs, ks, striped)
    states = [att.empty_state(q) for q in qs]
    kb, vb = list(ks), list(vs)
    for t in range(sp):
        for r, (q_off, kv_off, stride) in enumerate(geo):
            mask = None
            if causal:
                dev = qs[r].device
                mask = att.causal_mask(
                    q_off + torch.arange(lq, device=dev) * stride,
                    kv_off(t) + torch.arange(lk, device=dev) * stride)
            block = att.block_attention(qs[r], kb[r], vb[r], scale=scale,
                                        mask=mask)
            states[r] = att.combine_blocks(states[r], block)
        if t < sp - 1:
            kb, vb = ring_shift(kb), ring_shift(vb)
    return [att.finalize(s).to(q.dtype) for s, q in zip(states, qs)]


def ring_attention(qs, ks, vs, causal: bool = False,
                   scale: float | None = None, block_impl: str = "xla",
                   layout: str = "contiguous") -> list[torch.Tensor]:
    """Full attention over the global sequence from per-rank shards.

    qs, ks, vs: one [L_local, H, D] tensor a rank, shards of an
    [L_local * sp, H, D] sequence per ``layout``: "contiguous" (shard r
    holds tokens [r*L_local, (r+1)*L_local)) or "striped" (shard r holds
    tokens r, r+sp, ...; the caller stripes and unstripes, see
    ``attention.stripe``).  For causal runs striping balances the mask
    across ring steps.  ``block_impl``: "xla" (the plain lineage) or
    "pallas" (K3, and K4 under autograd).  Returns each rank's output
    shard."""
    if block_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown block_impl {block_impl!r}")
    if layout not in ("contiguous", "striped"):
        raise ValueError(f"unknown layout {layout!r}")
    scale = float(scale) if scale is not None else None
    if len(qs) == 1:
        if block_impl == "pallas":
            from tpu_patterns_torch.longctx.flash import flash_attention_diff

            return [flash_attention_diff(qs[0], ks[0], vs[0], causal, scale,
                                         1024, 1024)]
        return [att.attention_reference(qs[0], ks[0], vs[0], causal=causal,
                                        scale=scale)]
    striped = layout == "striped"
    if block_impl == "pallas":
        return ring_flash_attention(qs, ks, vs, causal, scale, striped)
    return _ring_plain(qs, ks, vs, causal, scale, striped)


def run_sharded(q, k, v, mesh, causal: bool = False,
                scale: float | None = None) -> torch.Tensor:
    """Scatter global [L, H, D] tensors over ``mesh``'s ranks and run
    ring attention (the plain lineage, contiguous layout)."""
    return att.run_sharded(ring_attention, q, k, v, mesh, causal=causal,
                           scale=scale)
