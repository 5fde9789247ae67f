"""Autoregressive decode over a sequence-sharded two-segment KV cache.

Counterpart of ``tpu_patterns/models/decode.py``: int8 KV quantization,
the MLP, masked attention against a cache and the cache layout (the
pieces the paged serve path reuses and the per-request dense oracle,
``models/lm.py``, is built from), the decoder ``make_decoder`` (prefill,
then a self-feeding generation loop), and the measured ``decode``
pattern ``run_decode`` with its two gates: teacher-forced decode must
equal the training forward at every position, for lockstep and for
ragged rows.

Over a dp x sp x tp rank mesh (``comm/mesh.py::NamedMesh``) every rank
holds its [B/dp, Hkv/tp, L/sp] block of the cache, contiguous or
striped (:class:`_CacheLayout`).  Where the reference runs one program
a device inside ``shard_map``, the functions here take per-rank lists
and make its collectives explicit: a decode step's attention takes the
max of each sp group's local scores (``pmax``) before the exponent, then
sums the normalizers and weighted values over the group (``psum``); the
prefill's attention is the plain ring (``longctx/ring_attention.py``);
the row-parallel products and the mixture's combine are tp sums.  Only
the rank that owns a generated token's slot writes it.  Every op is a
torch op: the reference's decode runs no Pallas kernel either (its
cache attention is einsums, its sp prefill ring ``block_impl="xla"``).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from tpu_patterns_torch.comm.mesh import NamedMesh
from tpu_patterns_torch.longctx.ring_attention import ring_attention
from tpu_patterns_torch.models.transformer import (
    ModelConfig,
    _check_kv_heads_shardable,
    _moe_ffn,
    _tp_sum,
    apply_rope,
    forward_stack,
    init_params,
    max_over,
    n_experts,
    qkv_native,
    rope_tables,
    shard_params,
    single_mesh,
    sum_over,
)


def _neg_inf(dtype: torch.dtype) -> float:
    return torch.finfo(dtype).min


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot symmetric int8: x [..., L, D] -> (int8 values, float32
    scale [..., L]).  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    xf = x.to(torch.float32)
    s = xf.abs().amax(dim=-1) / 127.0
    s = torch.clamp_min(s, 1e-8)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def _mlp(params: dict, y: torch.Tensor) -> torch.Tensor:
    """The block's dense ReLU FFN with its residual, on one device."""
    hidden = torch.relu(torch.einsum("ble,ef->blf", y, params["w1"]))
    return y + torch.einsum("blf,fe->ble", hidden, params["w2"])


def _mlp_mesh(mesh: NamedMesh, layers: list, ys: list,
              cfg: ModelConfig) -> list:
    """The FFN with its residual on every rank: the dense MLP (hidden
    tp-local, the product summed over tp) or, for ``moe``, the training
    path's top-1 mixture at ep = tp (``transformer._moe_ffn``): decode
    activations are tp-replicated after the attention's tp sum, as its
    dispatch assumes."""
    if cfg.moe:
        return [y + m for y, m in zip(ys, _moe_ffn(mesh, layers, ys, cfg))]
    ms = [torch.einsum("blf,fe->ble",
                       torch.relu(torch.einsum("ble,ef->blf", y, p["w1"])),
                       p["w2"]) for y, p in zip(ys, layers)]
    return [y + m for y, m in zip(ys, _tp_sum(mesh, ms))]


def _sp_max(xs: list) -> list:
    """Each rank's copy of the elementwise max over one sp group (the
    reference's ``pmax``); one rank keeps its own tensor."""
    return max_over([list(range(len(xs)))], xs)


def _sp_sum(xs: list) -> list:
    """Each rank's copy of the sum over one sp group (``psum``); one rank
    keeps its own tensor."""
    return sum_over([list(range(len(xs)))], xs)


def _masked_scores(q, cache_k, mask, k_scale=None):
    """Scores [B, Hkv, g, Lq, L] of q [B, Lq, H, D] against a cache
    [B, Hkv, L, D], in q's dtype, with masked slots at that dtype's most
    negative finite value.  GQA groups q as [B, Lq, Hkv, g, D] so each
    cached head serves its H/Hkv query heads without a copy; an int8
    cache's k scale folds in after the einsum."""
    b, lq, h, d = q.shape
    hkv = cache_k.shape[1]
    qg = q.reshape(b, lq, hkv, h // hkv, d)
    ck = cache_k.to(q.dtype) if cache_k.dtype == torch.int8 else cache_k
    s = torch.einsum("bqkgd,bkld->bkgql", qg, ck) * (d**-0.5)
    if k_scale is not None:
        s = s * k_scale[:, :, None, None, :].to(s.dtype)
    return torch.where(mask[:, None, None], s, _neg_inf(s.dtype))


def _partials(s, m, cache_v, v_scale=None):
    """(denom [B, Hkv, g, Lq, 1], numer [B, Hkv, g, Lq, D]) of scores
    ``s`` under the row max ``m``.  The max is clamped first: a query
    with no visible slot (anywhere in its sp group) keeps m == finfo.min,
    and the clamp makes its probabilities exactly 0 (the output 0/eps,
    never NaN).  An int8 cache's v scale folds into the probabilities
    after the normalizer is summed."""
    m = torch.clamp_min(m, _neg_inf(s.dtype) / 2)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[:, :, None, None, :].to(p.dtype)
    cv = cache_v.to(p.dtype) if cache_v.dtype == torch.int8 else cache_v
    return denom, torch.einsum("bkgql,bkld->bkgqd", p, cv)


def _finish(numer, denom, shape) -> torch.Tensor:
    """numer / denom as [B, Lq, H, D]."""
    out = numer / torch.clamp_min(denom, 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(shape)


def _distributed_attention(
    q, cache_k, cache_v, mask, k_scale=None, v_scale=None
):
    """Masked softmax attention of q [B, Lq, H, D] against a cache
    [B, Hkv, L, D] on one device; ``mask`` [B or 1, Lq, L] says which
    slots each query sees.  Scores stay in q's dtype, as in the JAX
    package (:func:`_masked_scores`, :func:`_partials`)."""
    s = _masked_scores(q, cache_k, mask, k_scale)
    denom, numer = _partials(s, s.amax(dim=-1, keepdim=True), cache_v,
                             v_scale)
    return _finish(numer, denom, q.shape)


def _group_attention(qs: list, caches: list, masks: list) -> list:
    """:func:`_distributed_attention` over one sp group whose ranks hold
    the cache's slots between them (rank i: q ``qs[i]``, its cache
    block ``caches[i]`` and mask ``masks[i]`` [B or 1, Lq, L_loc]): the
    local scores' row max is taken over the group before any exponent,
    so every rank normalizes by the same max, then the normalizers and
    weighted values are summed over the group.  Every rank gets the same
    output."""
    ss = [_masked_scores(q, c["k"], m, c.get("ks"))
          for q, c, m in zip(qs, caches, masks)]
    ms = _sp_max([s.amax(dim=-1, keepdim=True) for s in ss])
    parts = [_partials(s, m, c["v"], c.get("vs"))
             for s, m, c in zip(ss, ms, caches)]
    denoms = _sp_sum([d for d, _ in parts])
    numers = _sp_sum([n for _, n in parts])
    return [_finish(n, d, q.shape) for n, d, q in zip(numers, denoms, qs)]


def kv_slot_bytes(
    head_dim: int, kv_heads: int, dtype: torch.dtype, cache_int8: bool
) -> int:
    """Bytes of one K+V cache slot (one token, one layer): int8 stores a
    byte per element plus a 4-byte scale per head; float stores the
    dtype's itemsize per element."""
    if cache_int8:
        return 2 * (kv_heads * head_dim + kv_heads * 4)
    return 2 * kv_heads * head_dim * torch.finfo(dtype).bits // 8


class _CacheLayout:
    """Two-segment per-rank cache slots with closed-form global
    positions, for the ``sp`` ranks of a sequence-sharded cache (one
    rank: slots [0, prefill) the prompt, then the gen_cap generated
    tokens by generation index).

    ``layout="contiguous"``: rank r's prompt slots [0, lp_loc) hold
    positions r*lp_loc + i, and generated tokens fill the ranks' second
    segments in rank order (gen index n on rank n // lg_loc).
    ``layout="striped"`` (the data layout of a striped-trained model):
    rank r's prompt slot i holds position r + i*sp, and gen index n
    lands on rank n % sp at slot lp_loc + n // sp.  Either way every
    slot's position is a function of (rank, slot), so unwritten slots
    sit at future positions and no causal query sees them.  Methods
    take the sp rank as a Python int."""

    def __init__(self, prefill: int, gen_cap: int, sp: int = 1,
                 layout: str = "contiguous"):
        if prefill % sp or gen_cap % sp:
            raise ValueError(
                f"prefill {prefill} and gen capacity {gen_cap} must both "
                f"divide over sp={sp}"
            )
        if layout not in ("contiguous", "striped"):
            raise ValueError(f"unknown cache layout {layout!r}")
        self.prefill, self.gen_cap, self.sp = prefill, gen_cap, sp
        self.layout = layout
        self.lp_loc = prefill // sp
        self.lg_loc = gen_cap // sp
        self.lc_loc = self.lp_loc + self.lg_loc

    @property
    def striped(self) -> bool:
        return self.layout == "striped"

    def prompt_positions(self, device, rank: int = 0) -> torch.Tensor:
        """[lp_loc] global position of each local prompt slot."""
        i = torch.arange(self.lp_loc, dtype=torch.int32, device=device)
        return rank + i * self.sp if self.striped else rank * self.lp_loc + i

    def gen_indices(self, device, rank: int = 0) -> torch.Tensor:
        """[lg_loc] generation index held by each local gen slot."""
        j = torch.arange(self.lg_loc, dtype=torch.int32, device=device)
        return rank + j * self.sp if self.striped else rank * self.lg_loc + j

    def prompt_local_slot(self, pos: torch.Tensor, rank: int = 0):
        """(local slot, owned) of global prompt positions ``pos``: the
        inverse of :meth:`prompt_positions`."""
        if self.striped:
            idx = torch.div(pos, self.sp, rounding_mode="floor")
            owned = ((pos % self.sp == rank) & (idx < self.lp_loc)
                     & (pos >= 0))
        else:
            idx = pos - rank * self.lp_loc
            owned = (idx >= 0) & (idx < self.lp_loc)
        return idx, owned

    def kv_positions(self, device, rank: int = 0) -> torch.Tensor:
        """[lc_loc] global position of each local slot (lockstep rows:
        gen index n sits at position prefill + n)."""
        return torch.cat([self.prompt_positions(device, rank),
                          self.prefill + self.gen_indices(device, rank)])

    def write_offset_gen(self, n: int, rank: int = 0) -> tuple[int, bool]:
        """(local slot, owned) of the n-th generated token: every row
        writes its n-th token into the same slot, on the one rank that
        owns it."""
        if self.striped:
            j = n // self.sp
            return (self.lp_loc + j,
                    n % self.sp == rank and j < self.lg_loc and n >= 0)
        rel = n - rank * self.lg_loc
        return self.lp_loc + rel, 0 <= rel < self.lg_loc

    def slot_meta(self, device, rank: int = 0):
        """(prompt_pos, gen_index, is_gen), each [lc_loc]: a prompt slot
        is visible to row b iff prompt_pos < lens[b], a gen slot iff
        gen_index <= the current step."""
        far = torch.iinfo(torch.int32).max
        lp, lg = self.lp_loc, self.lg_loc
        prompt_pos = torch.cat([
            self.prompt_positions(device, rank),
            torch.full((lg,), far, dtype=torch.int32, device=device)])
        gen_index = torch.cat([
            torch.full((lp,), far, dtype=torch.int32, device=device),
            self.gen_indices(device, rank)])
        is_gen = torch.arange(lp + lg, device=device) >= lp
        return prompt_pos, gen_index, is_gen


def _zero_cache(cfg: ModelConfig, layout: _CacheLayout, batch, device,
                cache_int8: bool, tp: int = 1) -> dict:
    """One rank's empty cache dict, [depth, B_loc, Hkv/tp, lc_loc, ...]
    leaves."""
    kv_shape = (cfg.depth, batch, cfg.n_kv // tp, layout.lc_loc,
                cfg.head_dim)
    if cache_int8:
        return {
            "k": torch.zeros(kv_shape, dtype=torch.int8, device=device),
            "v": torch.zeros(kv_shape, dtype=torch.int8, device=device),
            "ks": torch.zeros(kv_shape[:-1], dtype=torch.float32,
                              device=device),
            "vs": torch.zeros(kv_shape[:-1], dtype=torch.float32,
                              device=device),
        }
    return {
        "k": torch.zeros(kv_shape, dtype=cfg.torch_dtype, device=device),
        "v": torch.zeros(kv_shape, dtype=cfg.torch_dtype, device=device),
    }


def _cache_write(cache_l: dict, kt, vt, off: int) -> None:
    """Write k/v [B, Hkv, Lw, D] at slot ``off`` of one layer's cache,
    in place; quantizing on the way in when the cache is int8."""
    lw = kt.shape[2]
    if "ks" in cache_l:
        kq, ks = _quantize_kv(kt)
        vq, vs = _quantize_kv(vt)
        cache_l["k"][:, :, off:off + lw] = kq
        cache_l["v"][:, :, off:off + lw] = vq
        cache_l["ks"][:, :, off:off + lw] = ks
        cache_l["vs"][:, :, off:off + lw] = vs
        return
    cache_l["k"][:, :, off:off + lw] = kt.to(cache_l["k"].dtype)
    cache_l["v"][:, :, off:off + lw] = vt.to(cache_l["v"].dtype)


def _cache_attend(cache_l: dict, q, mask):
    return _distributed_attention(
        q, cache_l["k"], cache_l["v"], mask,
        k_scale=cache_l.get("ks"), v_scale=cache_l.get("vs"),
    )


def _sp_rank(mesh: NamedMesh, r: int) -> int:
    return mesh.coord(r)["sp"]


def _rotate(cfg: ModelConfig, q, k, pos):
    """q and k rotated by global positions ``pos`` ([L] or [B, L])."""
    if not cfg.rope:
        return q, k
    cos, sin = rope_tables(pos, cfg.head_dim, cfg.rope_theta, q.dtype)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


def _prefill_attend(mesh: NamedMesh, layout: _CacheLayout, qs, ks, vs,
                    caches: list) -> list:
    """Causal attention of each rank's prompt shard.  One sp rank reads
    its cache (quantized values included, so prefill sees what decode
    will see; right-padding sits at positions no valid query reaches).
    Over sp > 1 the queries differ between ranks, so the combine is the
    training path's plain ring over each sp group, the unquantized k/v
    repeated to H heads for the one pass and folded with the batch into
    [L_loc, B*H, D]."""
    if layout.sp == 1:
        out = []
        for q, c in zip(qs, caches):
            q_pos = torch.arange(layout.lp_loc, dtype=torch.int32,
                                 device=q.device)
            mask = (layout.kv_positions(q.device)[None, :]
                    <= q_pos[:, None])[None]
            out.append(_cache_attend(c, q, mask))
        return out
    b, lp, h, d = qs[0].shape
    g = h // ks[0].shape[2]

    def fold(a):
        if a.shape[2] != h:
            a = a.repeat_interleave(g, dim=2)
        return a.transpose(0, 1).reshape(lp, b * h, d)

    out = [None] * mesh.size
    for grp in mesh.groups("sp"):
        res = ring_attention([fold(qs[r]) for r in grp],
                             [fold(ks[r]) for r in grp],
                             [fold(vs[r]) for r in grp], causal=True,
                             block_impl="xla", layout=layout.layout)
        for r, o in zip(grp, res):
            out[r] = o.reshape(lp, b, h, d).transpose(0, 1)
    return out


def _decode_attend(mesh: NamedMesh, qs, caches: list, masks: list) -> list:
    """Each rank's attention over its sp group's cache
    (:func:`_group_attention`)."""
    out = [None] * mesh.size
    for grp in mesh.groups("sp"):
        res = _group_attention([qs[r] for r in grp],
                               [caches[r] for r in grp],
                               [masks[r] for r in grp])
        for r, o in zip(grp, res):
            out[r] = o
    return out


def _block_out(mesh: NamedMesh, layers: list, xs: list, attn: list,
               cfg: ModelConfig) -> list:
    """The block's tail: the out-projection summed over tp, the
    residual, then the FFN."""
    os_ = [torch.einsum("blhd,hde->ble", a, p["wo"])
           for a, p in zip(attn, layers)]
    ys = [x + o for x, o in zip(xs, _tp_sum(mesh, os_))]
    return _mlp_mesh(mesh, layers, ys, cfg)


def _prefill_layer(mesh: NamedMesh, layers: list, xs: list, caches: list,
                   layout: _CacheLayout, cfg: ModelConfig) -> list:
    """One layer over every rank's right-padded prompt shard
    [B_loc, lp_loc, E]: each rank writes its k/v (RoPE'd by the layout's
    global positions: the cache stores the rotated k) into its prompt
    segment, then attends causally (:func:`_prefill_attend`)."""
    qs, ks, vs = [], [], []
    for r, (p, x, c) in enumerate(zip(layers, xs, caches)):
        q, k, v = qkv_native(p, x)
        q, k = _rotate(cfg, q, k, layout.prompt_positions(
            x.device, _sp_rank(mesh, r)))
        _cache_write(c, k.transpose(1, 2), v.transpose(1, 2), 0)
        qs.append(q)
        ks.append(k)
        vs.append(v)
    attn = _prefill_attend(mesh, layout, qs, ks, vs, caches)
    return _block_out(mesh, layers, xs, attn, cfg)


def _decode_mask(layout: _CacheLayout, lens, n: int, rank: int = 0,
                 meta=None) -> torch.Tensor:
    """[B, lc_loc] slots of sp rank ``rank`` visible to each row's n-th
    generated token: prompt slots below lens[b] and gen slots up to n
    (``meta``: the rank's :meth:`_CacheLayout.slot_meta`, if at hand)."""
    prompt_pos, gen_index, is_gen = meta or layout.slot_meta(lens.device,
                                                             rank)
    return torch.where(
        is_gen[None, :], gen_index[None, :] <= n,
        prompt_pos[None, :] < lens[:, None],
    )


def _decode_layer(mesh: NamedMesh, layers: list, xs: list, caches: list,
                  lens: list, n: int, layout: _CacheLayout,
                  cfg: ModelConfig, masks: list) -> list:
    """One layer for each row's n-th generated token x [B_loc, 1, E] on
    every rank: row b's token sits at position lens[b] + n and is written
    to gen slot n on the one sp rank that owns it (only there: the slot
    index is the same on every rank, so a write elsewhere would land in
    another gen index's slot); a row sees the slots of ``masks[r]``
    (:func:`_decode_mask`, the same for every layer of a step)."""
    qs = []
    for r, (p, x, c) in enumerate(zip(layers, xs, caches)):
        q, k, v = qkv_native(p, x)
        q, k = _rotate(cfg, q, k, (lens[r] + n).to(torch.int32)[:, None])
        off, owned = layout.write_offset_gen(n, _sp_rank(mesh, r))
        if owned:
            _cache_write(c, k.transpose(1, 2), v.transpose(1, 2), off)
        qs.append(q)
    masks = [m[:, None, :] for m in masks]
    return _block_out(mesh, layers, xs, _decode_attend(mesh, qs, caches,
                                                       masks), cfg)


def _stacked_params(seed: int, cfg: ModelConfig, device,
                    n_experts: int = 0) -> dict:
    """Block params with a leading [depth] axis (the port's layout at
    every depth, depth 1 included), drawn from a ``torch.Generator``
    seeded with ``seed``; ``n_experts`` for a ``moe`` model."""
    return init_params(torch.Generator().manual_seed(seed), cfg, device,
                       n_experts)


def _gather_last_valid(y, lens, layout: _CacheLayout,
                       rank: int = 0) -> torch.Tensor:
    """[B, 1, E] output at each row's last valid prompt position
    ``lens[b] - 1`` where sp rank ``rank`` holds it (the layout's inverse
    map), zeros where it does not: summed over the sp group, every rank
    gets each row's output."""
    idx, owned = layout.prompt_local_slot(lens.to(torch.int64) - 1, rank)
    rows = torch.arange(y.shape[0], device=y.device)
    gathered = y[rows, idx.clamp(0, layout.lp_loc - 1)][:, None, :]
    return torch.where(owned[:, None, None], gathered, 0)


def _gather_last_mesh(mesh: NamedMesh, ys: list, lens: list,
                      layout: _CacheLayout) -> list:
    """:func:`_gather_last_valid` on every rank, summed over each sp
    group (the reference's ``psum``): the owning rank's row on every
    rank."""
    parts = [_gather_last_valid(y, ln, layout, _sp_rank(mesh, r))
             for r, (y, ln) in enumerate(zip(ys, lens))]
    return sum_over(mesh.groups("sp"), parts)


def _layer_of(mesh: NamedMesh, tree: dict, i: int) -> list:
    """Each rank's layer ``i`` of a dict of per-rank ``[depth, ...]``
    lists."""
    return [{k: v[r][i] for k, v in tree.items()} for r in range(mesh.size)]


def _rows_of(mesh: NamedMesh, a, batch: int) -> list:
    """A global per-row int32 array [batch] (host or tensor) as each
    rank's dp block on its device."""
    t = torch.as_tensor(a.cpu() if isinstance(a, torch.Tensor)
                        else np.asarray(a), dtype=torch.int32)
    dp = mesh.dim("dp")
    if dp == 1:
        return [t.to(dev) for dev in mesh.devices]
    b_loc = batch // dp
    out = []
    for r, dev in enumerate(mesh.devices):
        d = mesh.coord(r)["dp"]
        out.append(t[d * b_loc:(d + 1) * b_loc].to(dev))
    return out


class MeshDecoder:
    """Prefill and generation over a dp x sp x tp mesh on per-rank lists
    (:func:`make_decoder` builds it; ``models/lm.py``'s token decoder
    runs the same layers).  ``params`` is a dict of per-rank lists of
    ``[depth, ...]`` blocks (``transformer.shard_params``); a prompt
    arrives as each rank's [B/dp, prefill/sp, E] shard (``layout``
    striped: the caller stripes, as in training); ``lens`` is a global
    [batch] array of true prompt lengths."""

    def __init__(self, mesh: NamedMesh, cfg: ModelConfig, batch: int,
                 prefill_len: int, gen_cap: int, cache_int8: bool = False):
        dp = mesh.dim("dp")
        if batch % dp:
            raise ValueError(f"batch {batch} % dp={dp} != 0")
        _check_kv_heads_shardable(cfg, mesh)
        self.mesh, self.cfg, self.batch = mesh, cfg, batch
        self.prefill_len, self.cache_int8 = prefill_len, cache_int8
        self.layout = _CacheLayout(prefill_len, gen_cap, mesh.dim("sp"),
                                   cfg.attn_layout)
        self._meta = None

    def lens(self, lens=None) -> list:
        """Each rank's block of the global prompt lengths (None: every
        row at the full prefill)."""
        if lens is None:
            lens = np.full((self.batch,), self.prefill_len, np.int32)
        return _rows_of(self.mesh, lens, self.batch)

    def prefill(self, params: dict, xs: list, lens: list
                ) -> tuple[list, list]:
        """(caches, y_last): every layer over the prompt shards, each
        rank's cache a dict of [depth, B_loc, Hkv/tp, lc_loc, ...]
        leaves, and each row's output at its last valid position
        [B_loc, 1, E] on every rank."""
        mesh, cfg = self.mesh, self.cfg
        caches = [_zero_cache(cfg, self.layout, x.shape[0], x.device,
                              self.cache_int8, mesh.dim("tp")) for x in xs]
        ys = list(xs)
        for i in range(cfg.depth):
            ys = _prefill_layer(mesh, _layer_of(mesh, params, i), ys,
                                [{k: v[i] for k, v in c.items()}
                                 for c in caches], self.layout, cfg)
        return caches, _gather_last_mesh(mesh, ys, lens, self.layout)

    def step(self, params: dict, caches: list, xs: list, lens: list,
             n: int) -> list:
        """Every layer for generation index ``n``: each rank's
        [B_loc, 1, E] output."""
        mesh = self.mesh
        if self._meta is None:  # each rank's slot positions, made once
            self._meta = [self.layout.slot_meta(ln.device, _sp_rank(mesh, r))
                          for r, ln in enumerate(lens)]
        masks = [_decode_mask(self.layout, ln, n, meta=m)
                 for ln, m in zip(lens, self._meta)]
        for i in range(self.cfg.depth):
            xs = _decode_layer(mesh, _layer_of(mesh, params, i), xs,
                               [{k: v[i] for k, v in c.items()}
                                for c in caches], lens, n, self.layout,
                               self.cfg, masks)
        return xs

    def start(self, t0) -> tuple[list, int]:
        """(each rank's lens, n0) of a generate call's ``t0``: a global
        position (lockstep rows at full prefill, ``t0 - prefill``
        generated already) or ``(lens, n0)``."""
        if isinstance(t0, tuple):
            lens, n0 = t0
            return self.lens(lens), int(n0)
        return self.lens(), int(t0) - self.prefill_len


def make_decoder(
    cfg: ModelConfig,
    batch: int,
    prefill_len: int,
    gen_cap: int,
    cache_int8: bool = False,
    donate: bool = False,
    mesh: NamedMesh | None = None,
):
    """The (prefill, generate) pair over a dense cache.

    * ``prefill(params, x, lens=None) -> (caches, y_last)``: the
      right-padded prompt [batch, prefill_len, E] through every layer,
      filling the prompt segment; ``lens`` [batch] gives each row's true
      prompt length (None: all prefill_len).  ``y_last`` [batch, 1, E]
      is each row's output at its last valid position, the first decode
      input.
    * ``generate(params, caches, y0, t0, n_steps) -> (caches, ys)``:
      ``n_steps`` of self-feeding decode, ys [batch, n_steps, E].  ``t0``
      is a global position (lockstep: every row at full prefill_len,
      ``t0 - prefill_len`` tokens generated already) or ``(lens, n0)``
      for ragged rows.  A write past ``gen_cap`` is dropped.

    ``mesh=None``: one device, params a dict of tensors, caches dicts of
    [depth, B, Hkv, lc, ...] leaves on x's device.  Over ``mesh`` (dp x
    sp x tp) everything is a per-rank list (:class:`MeshDecoder`): params
    a dict of per-rank lists, x and y0 each rank's shard (x
    [B/dp, prefill/sp, E], y0 [B/dp, 1, E], replicated over sp and tp),
    caches each rank's dict; ``lens`` stays global.  ``cfg.attn_layout``
    "striped" is the striped cache (the caller stripes the prompt);
    ``cfg.moe`` routes through the training path's top-1 experts, one a
    tp rank.  int8 K/V with per-slot float32 scales ``ks``/``vs`` under
    ``cache_int8``.  ``donate=True`` updates the caller's caches in place
    and returns them; ``donate=False`` works on copies.  One Python loop
    runs the steps; nothing in it reads a device value back to the
    host."""
    if mesh is None:
        return _one_device(cfg, batch, prefill_len, gen_cap, cache_int8,
                           donate)
    return _mesh_pair(mesh, cfg, batch, prefill_len, gen_cap, cache_int8,
                      donate)


def _mesh_pair(mesh, cfg, batch, prefill_len, gen_cap, cache_int8, donate):
    dec = MeshDecoder(mesh, cfg, batch, prefill_len, gen_cap, cache_int8)

    @torch.no_grad()
    def prefill(params, xs, lens=None):
        return dec.prefill(params, xs, dec.lens(lens))

    @torch.no_grad()
    def generate(params, caches, y0, t0, n_steps):
        lens, n0 = dec.start(t0)
        if not donate:
            caches = [{k: v.clone() for k, v in c.items()} for c in caches]
        ys, out = list(y0), []
        for n in range(n0, n0 + int(n_steps)):
            ys = dec.step(params, caches, ys, lens, n)
            out.append(ys)
        if not out:
            return caches, [y[:, :0] for y in y0]
        return caches, [torch.stack([o[r][:, 0] for o in out], dim=1)
                        for r in range(mesh.size)]

    return prefill, generate


def _one_device(cfg, batch, prefill_len, gen_cap, cache_int8, donate):
    """:func:`make_decoder` on one device: the mesh decoder on the
    (1, 1, 1) mesh of x's device, with tensors in and out."""
    made = {}

    def pair(device):
        if device not in made:
            made[device] = _mesh_pair(single_mesh(device), cfg, batch,
                                      prefill_len, gen_cap, cache_int8,
                                      donate)
        return made[device]

    def prefill(params, x, lens=None):
        caches, y = pair(x.device)[0]({k: [v] for k, v in params.items()},
                                      [x], lens)
        return caches[0], y[0]

    def generate(params, caches, y0, t0, n_steps):
        caches, ys = pair(y0.device)[1](
            {k: [v] for k, v in params.items()}, [caches], [y0], t0,
            n_steps)
        return caches[0], ys[0]

    return prefill, generate


@dataclasses.dataclass
class DecodeConfig:
    """CLI ``decode`` subcommand."""

    embed: int = 1024
    heads: int = 8
    head_dim: int = 128
    mlp_mult: int = 4
    dtype: str = "bfloat16"
    depth: int = 4
    kv_heads: int = 0  # GQA: K/V heads (0 = MHA); cache shrinks H/kv-fold
    rope: bool = False  # rotary position embeddings on q/k
    cache_int8: bool = False  # int8 K/V cache with per-slot scales
    layout: str = "contiguous"  # KV-cache/token layout (or "striped")
    moe: bool = False  # top-1 mixture FFN, experts one per tp rank
    batch: int = 8
    prefill: int = 4096  # prompt tokens (the long-context side)
    gen: int = 128  # generated tokens per rep
    reps: int = 5
    warmup: int = 1
    min_tokens_per_s: float = -1.0
    seed: int = 0
    device: str = "cuda"  # "cpu" runs on the CPU


def model_config(cfg: DecodeConfig) -> ModelConfig:
    """The block config of a ``decode`` run."""
    return ModelConfig(
        embed=cfg.embed, heads=cfg.heads, head_dim=cfg.head_dim,
        mlp_mult=cfg.mlp_mult, causal=True, dtype=cfg.dtype,
        depth=cfg.depth, kv_heads=cfg.kv_heads, rope=cfg.rope,
        attn_layout=cfg.layout, moe=cfg.moe,
    )


def _timed_ms(fn, dev: torch.device) -> float:
    """Milliseconds of one ``fn()``: CUDA events on the card, the host
    clock on the CPU."""
    from tpu_patterns_torch.core.timing import clock_ns

    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = clock_ns()
    fn()
    return (clock_ns() - t0) / 1e6


def run_decode(cfg: DecodeConfig, writer=None,
               mesh: NamedMesh | None = None) -> list:
    """Measured pattern: prefill a long context, then time the
    self-feeding generation loop, over ``mesh`` (dp x sp x tp; None: one
    rank on ``cfg.device``).  Gate: teacher-forced decode equals the
    training forward (:func:`_teacher_forcing_gate`, on a small probe
    shape scaled to the mesh, every position), and ``min_tokens_per_s``
    when set.  With ranks sharing a card, ``ms_per_token`` and
    ``prefill_ms`` are the world's serial time on it."""
    from tpu_patterns_torch import obs
    from tpu_patterns_torch.core import timing
    from tpu_patterns_torch.core.results import Record, ResultWriter, Verdict
    from tpu_patterns_torch.longctx.attention import stripe
    from tpu_patterns_torch.runtime import resolve_device

    writer = writer or ResultWriter()
    if mesh is None:
        mesh = single_mesh(resolve_device(cfg.device))
    dev = mesh.devices[0]
    mcfg = model_config(cfg)
    sp = mesh.dim("sp")
    gen_cap = cfg.gen + (-cfg.gen % sp)
    # the measured pattern owns its cache: generate updates it in place
    prefill, generate = make_decoder(
        mcfg, cfg.batch, cfg.prefill, gen_cap, cache_int8=cfg.cache_int8,
        donate=True, mesh=mesh,
    )
    params = shard_params(
        _stacked_params(cfg.seed, mcfg, dev, n_experts(mesh, mcfg)), mesh,
        mcfg)
    x = _probe_input(cfg.seed + 1, (cfg.batch, cfg.prefill, cfg.embed),
                     dev).to(mcfg.torch_dtype)
    xs = mesh.shard(stripe(x, sp, axis=1) if cfg.layout == "striped"
                    else x, ("dp", "sp", None))
    del x
    caches, y0 = prefill(params, xs)
    # time to first token: one warmed prefill over the full context
    with obs.span("decode.prefill", tokens=cfg.batch * cfg.prefill):
        prefill_ms = _timed_ms(lambda: (prefill(params, xs),
                                        mesh.ranks.join()), dev)

    gate = _teacher_forcing_gate(mcfg, cache_int8=cfg.cache_int8,
                                 device=dev, mesh=mesh)

    def fresh():
        return [{k: v.clone() for k, v in c.items()} for c in caches]

    def build_chain(k: int):
        def run():
            # every iteration regenerates the same positions (t0 fixed),
            # fed by the previous one's last output; generation consumes
            # its cache, so the chain starts from a fresh copy of the
            # prefill cache
            c, y = fresh(), y0
            for _ in range(k):
                c, out = generate(params, c, y, cfg.prefill, cfg.gen)
                y = [o[:, -1:, :] for o in out]
            mesh.ranks.join()

        return run

    res = timing.measure_chain(build_chain, reps=cfg.reps,
                               warmup=cfg.warmup, device=dev)
    tokens = cfg.batch * cfg.gen
    sec = res.per_op_ns * 1e-9
    tps = tokens / sec if sec > 0 else 0.0
    # the copy rides inside every timed window (CHAIN_K generate calls)
    clone_ns = timing.measure_chain(
        lambda k: lambda: [fresh() for _ in range(k)], reps=3, warmup=1,
        device=dev).per_op_ns
    clone_share = clone_ns / (res.per_op_ns * timing.CHAIN_K)
    obs.gauge("tpu_patterns_decode_tokens_per_s").set(tps)
    obs.gauge("tpu_patterns_decode_prefill_ms").set(prefill_ms)
    if cfg.gen > 0 and sec > 0:
        obs.histogram("tpu_patterns_decode_step_ms").observe(
            1e3 * sec / cfg.gen
        )
    obs.counter("tpu_patterns_decode_tokens_total").inc(tokens)
    max_len = cfg.prefill + gen_cap
    cache_mb = (
        cfg.depth * cfg.batch * max_len
        * kv_slot_bytes(cfg.head_dim, cfg.kv_heads or cfg.heads,
                        mcfg.torch_dtype, cfg.cache_int8) / 1e6
    )
    ok = gate and np.isfinite(tps) and tps > 0
    if cfg.min_tokens_per_s > 0:
        ok = ok and tps >= cfg.min_tokens_per_s
    rec = Record(
        pattern="decode",
        mode=f"sp{sp}"
        + (f"_gqa{cfg.kv_heads}" if cfg.kv_heads else "")
        + ("_rope" if cfg.rope else "")
        + ("_int8" if cfg.cache_int8 else "")
        + ("_striped" if cfg.layout == "striped" else "")
        + ("_moe" if cfg.moe else ""),
        commands=(
            f"B{cfg.batch} prefill{cfg.prefill} gen{cfg.gen} "
            f"depth{cfg.depth} {cfg.dtype}"
        ),
        metrics={
            "tokens_per_s": round(tps, 1),
            "ms_per_token": round(1e3 * sec / cfg.gen, 3),
            "prefill_ms": round(prefill_ms, 2),
            "cache_MB": round(cache_mb, 3),
            "prefill_context": float(cfg.prefill),
            "timing_converged": float(res.converged),
        },
        verdict=Verdict.SUCCESS if ok else Verdict.FAILURE,
    )
    if note := res.noise_note("tokens/s"):
        rec.notes.append(note)
    if clone_share > 0.01:
        rec.notes.append(
            f"the cache copy at the head of each timed chain is "
            f"{100 * clone_share:.2f}% of its window (in ms_per_token)"
        )
    if note := mesh.note("sp combines, tp sums and ring shifts"):
        rec.notes.append(note)
    if not gate:
        rec.notes.append("teacher-forcing gate FAILED: cache path diverges")
    writer.record(rec)
    return [rec]


@contextlib.contextmanager
def _exact_matmuls(dev: torch.device):
    """TF32 off for the block on the card (restored after), so float32
    products are float32 on both sides of a gate."""
    if dev.type != "cuda":
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _probe_input(seed: int, shape, device) -> torch.Tensor:
    """Standard normal float32 ``shape`` from a CPU generator seeded with
    ``seed`` (the same values on every device), moved to ``device``."""
    return torch.randn(
        shape, generator=torch.Generator().manual_seed(seed)
    ).to(device)


def _probe_shape(mesh: NamedMesh) -> tuple[int, int]:
    """(heads, batch) of a gate's probe over ``mesh``: 8 heads (tp when
    tp does not divide 8) and 2 rows a dp rank, as the reference's."""
    tp = mesh.dim("tp")
    return (8 if 8 % tp == 0 else tp), 2 * mesh.dim("dp")


def _decode_probe(mesh: NamedMesh, cfg: ModelConfig, params: dict,
                  b: int, lp: int, gen: int, cache_int8: bool = False):
    """(prefill, generate) over ``mesh`` for a gate: the global
    ``params`` sharded, the global prompt striped as the layout wants
    and sharded, tokens fed global [B, 1, E]; outputs come back global
    (dp blocks assembled on the first rank's device)."""
    from tpu_patterns_torch.longctx.attention import stripe

    pre, gen_fn = make_decoder(cfg, b, lp, gen, cache_int8=cache_int8,
                               mesh=mesh)
    sharded = shard_params(params, mesh, cfg)
    sp = mesh.dim("sp")

    def glob(ys):
        return mesh.assemble(ys, ("dp", None, None))

    def prefill(x, lens=None):
        xp = stripe(x, sp, axis=1) if cfg.attn_layout == "striped" else x
        c, y = pre(sharded, mesh.shard(xp, ("dp", "sp", None)), lens)
        return c, glob(y)

    def generate(c, tok, t0):
        c, ys = gen_fn(sharded, c, mesh.shard(tok, ("dp", None, None)),
                       t0, 1)
        return c, glob(ys)

    return prefill, generate


def teacher_forced(cfg: ModelConfig, params: dict, x: torch.Tensor,
                   half: int, cache_int8: bool = False,
                   mesh: NamedMesh | None = None):
    """(got, want) [B, L - half + 1, E] float32 numpy: the decoder's
    outputs at positions half-1 .. L-1 (prefill of x[:, :half], then
    x[:, t] fed at each t; teacher forcing, so every step meets the
    forward's input) over ``mesh`` (None: x's device), and
    :func:`forward_stack`'s over the whole of x on one device."""
    b, l, _ = x.shape
    with torch.no_grad():
        want = forward_stack(params, x, cfg)
    prefill, generate = _decode_probe(mesh or single_mesh(x.device), cfg,
                                      params, b, half, l - half,
                                      cache_int8)
    c, y_last = prefill(x[:, :half])
    got = [y_last[:, 0]]
    for t in range(half, l):
        c, ys = generate(c, x[:, t:t + 1], t)
        got.append(ys[:, 0])
    return (torch.stack(got, dim=1).float().cpu().numpy(),
            want[:, half - 1:].float().cpu().numpy())


def _teacher_forcing_gate(big: ModelConfig, cache_int8: bool = False,
                          device="cpu", mesh: NamedMesh | None = None
                          ) -> bool:
    """Decode against the training forward on a probe shape (embed 64,
    heads of 8, float32, half the tokens prefilled) at ``big``'s depth,
    RoPE, layout, mixture and GQA layout, over ``mesh`` (None: one rank
    on ``device``): every position within 64 eps of the output's
    magnitude, 8% for an int8 cache (its honest quantization noise; a
    misrouted slot is an O(1) error).  The probe scales with the mesh as
    the reference's: 8 heads (tp if 8 does not divide), 2 rows a dp
    rank, 32 tokens (4 a sp rank where 2*sp does not divide 32), and a
    GQA probe keeps half the heads as K/V heads where tp divides them."""
    mesh = mesh or single_mesh(torch.device(device))
    dev = mesh.devices[0]
    sp, tp = mesh.dim("sp"), mesh.dim("tp")
    heads, b = _probe_shape(mesh)
    l = 32 if 32 % (2 * sp) == 0 else 4 * sp
    kv = 0
    if big.kv_heads:
        kv = heads // 2 if heads // 2 and (heads // 2) % tp == 0 else heads
    cfg = dataclasses.replace(big, embed=64, heads=heads, head_dim=8,
                              dtype="float32", causal=True, kv_heads=kv)
    with _exact_matmuls(dev):
        params = _stacked_params(17, cfg, dev, n_experts(mesh, cfg))
        x = _probe_input(18, (b, l, cfg.embed), dev)
        got, ref = teacher_forced(cfg, params, x, (l // 2 // sp) * sp or sp,
                                  cache_int8, mesh)
    scale = max(1.0, float(np.abs(ref).max()))
    tol = (0.08 * scale if cache_int8
           else 64 * np.finfo(np.float32).eps * scale)
    return bool(np.abs(got - ref).max() <= tol)


def _ragged_gate(big: ModelConfig, lens_fn=None, device="cpu",
                 mesh: NamedMesh | None = None) -> bool:
    """Ragged decode against the forward over ``mesh`` (None: one rank
    on ``device``): rows with different true prompt lengths (right-padded
    to the probe's prefill), each teacher-forced ``2 * sp`` steps (so
    every sp rank writes at least two gen slots), must equal the plain
    causal forward of the row's own unpadded stream at positions
    lens[b] - 1 .. lens[b] + 2*sp - 1, within 64 eps of the row's
    magnitude.  Run it with ``big.rope`` so an off-by-one slot shifts a
    rotary phase.  The probe: 2 rows a dp rank, a 16-token prefill (4 a
    sp rank where sp does not divide 16), MHA, no mixture, depth 1;
    ``lens_fn(b, lp)`` overrides the default lengths ``lp - 3*i``."""
    mesh = mesh or single_mesh(torch.device(device))
    dev = mesh.devices[0]
    sp = mesh.dim("sp")
    heads, b = _probe_shape(mesh)
    lp = 16 if 16 % sp == 0 else 4 * sp
    gen = 2 * sp
    cfg = dataclasses.replace(big, embed=64, heads=heads, head_dim=8,
                              depth=1, dtype="float32", causal=True,
                              moe=False, kv_heads=0)
    if lens_fn is None:
        lens_np = np.array([max(1, lp - 3 * i) for i in range(b)], np.int32)
    else:
        lens_np = np.asarray(lens_fn(b, lp), np.int32)
        if lens_np.shape != (b,) or lens_np.min() < 1 or lens_np.max() > lp:
            raise ValueError(
                f"lens_fn must return [b={b}] lengths in [1, {lp}], "
                f"got {lens_np!r}"
            )
    eps = 64 * np.finfo(np.float32).eps

    def row_ok(got_row, ref_row) -> bool:
        scale = max(1.0, float(np.abs(ref_row).max()))
        return bool(np.abs(got_row - ref_row).max() <= eps * scale)

    with _exact_matmuls(dev), torch.no_grad():
        params = _stacked_params(21, cfg, dev)
        x = _probe_input(22, (b, lp + gen, cfg.embed), dev)
        want = np.zeros((b, lp + gen, cfg.embed), np.float32)
        for row in range(b):
            ln = int(lens_np[row])
            seq = torch.cat([x[row, :ln], x[row, lp:lp + gen]])[None]
            want[row, :ln + gen] = (
                forward_stack(params, seq, cfg)[0].cpu().numpy())
        prefill, generate = _decode_probe(mesh, cfg, params, b, lp, gen)
        c, y0 = prefill(x[:, :lp], lens_np)
        y0 = y0.cpu().numpy()
        ok = all(row_ok(y0[row, 0], want[row, lens_np[row] - 1])
                 for row in range(b))
        for n in range(gen):
            c, ys = generate(c, x[:, lp + n:lp + n + 1], (lens_np, n))
            ys = ys.cpu().numpy()
            ok = ok and all(row_ok(ys[row, 0], want[row, lens_np[row] + n])
                            for row in range(b))
    return ok
