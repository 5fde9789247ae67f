"""Paged KV cache: a block pool plus per-sequence block tables.

Counterpart of ``tpu_patterns/serve/paged.py``: one decoder
(:class:`PagedDecoder`) over an sp x tp rank mesh, one device being the
(1, 1, 1) mesh.  The cache is a pool of fixed-size blocks,

    k/v: [depth, n_blocks, block_len, Hkv, D]   (int8 adds f32 ks/vs
                                                 [depth, n_blocks, block_len, Hkv])

and each sequence owns a table of physical block ids covering its
positions.  Prefill and decode write through the table, attention reads
through it, and a finished sequence returns its blocks, so cache memory
follows the pool, not the ``slots x max_len`` rectangle.

Physical block 0 is the TRASH block: never allocated, it absorbs the
writes of padding positions and inactive rows.  Several rows may route
a write there in one call, and which of the colliding writes lands is
unspecified on CUDA; that is harmless only because no query ever reads
block 0 unmasked (the kernel skips it, the dense path masks it).

The pool is updated IN PLACE (``index_put_``) by every prefill and
step, the analogue of the JAX package's donated pool: one set of device
buffers lives for the engine's whole run.  ``attn`` picks the decode
and verify attention: ``"kernel"`` (the default) runs the fused paged
kernel (``serve/paged_kernel.py``, combined by :func:`paged_attend`),
``"dense"`` gathers the page window and reruns the dense masked
attention.  Prefill always runs the dense
path.

Tables are the only binding between rows and blocks, so one physical
block may sit in many tables: copy-on-write prefix sharing
(``serve/prefix.py``, refcounts in the engine) aliases common prompt
prefixes onto one copy, prefill's per-row ``start`` fence keeps shared
blocks read-only, and ``copy_blocks`` clones the one boundary block
where writes diverge.  ``verify`` runs a k+1-token window for
speculative decoding; ``step`` is ``verify`` at a window of one token.
``gather_blocks`` and ``onload_blocks`` move whole blocks between the
pool and the host kv tier (``serve/kvtier.py``); like the reference's
gather and onload they are plain indexing, not a kernel.  ``stream`` is
the disaggregated handoff's wire: a gathered payload pair-exchanged
over ``sp`` and back (``comm/p2p.py::make_block_stream``).

A decoder made with ``sampling=True`` takes five more per-row host
arrays ``(seeds, gidx, temp, topk, topp)`` in ``prefill``, ``step`` and
``verify`` and returns ids from the seeded sampler
(``models/lm.py::sample_token_rows``): row b's token at position t of
a call is keyed ``(seeds[b], gidx[b] + t)``, the key the one-token step
would use after committing t tokens, so a verified sampled stream
equals plain decode's.  Rows with ``temp <= 0`` keep the greedy ids of
the unsampled cores, bit for bit.

Over a mesh (the reference's sharded serve; dp must be 1) ``tp`` shards
the kv heads as the dense cache does, and ``sp`` shards WITHIN each
block: rank r owns in-block offsets ``[r * bl_loc, (r + 1) * bl_loc)``
(``bl_loc = block_len / sp``), so every rank holds a stripe of every
block, a write lands on the one rank that owns its offset (the others
route it to the trash block, row by row), gathers are rank-local, and
the attention combines each sp group's partials: K1's triples, or the
dense windows through the dense cache's group attention.  Queries stay
replicated over sp, so prefill needs no ring pass.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_patterns_torch import ckpt
from tpu_patterns_torch.comm.mesh import NamedMesh
from tpu_patterns_torch.core.timing import device_barrier
from tpu_patterns_torch.models.decode import (
    _block_out,
    _decode_attend,
    _layer_of,
    _quantize_kv,
    _rotate,
    _sp_max,
    _sp_sum,
    kv_slot_bytes,
)
from tpu_patterns_torch.models.lm import (
    _embed_mesh,
    argmax_mesh,
    rows_mesh,
    sample_rows_on,
    shard_lm_params,
)
from tpu_patterns_torch.models.transformer import (
    ModelConfig,
    _check_kv_heads_shardable,
    param_shapes,
    qkv_native,
    single_mesh,
)
from tpu_patterns_torch.runtime import resolve_device
from tpu_patterns_torch.serve import paged_kernel
from tpu_patterns_torch.serve.paged_kernel import NEG_INF, TRASH_BLOCK

# how a pool leaf splits over the mesh (the reference's pool_specs):
# block slots over sp, kv heads over tp
POOL_SPEC = (None, None, "sp", "tp", None)
SCALE_SPEC = (None, None, "sp", "tp")


class PagedLayout:
    """Closed-form slot math for the block pool: global position ``t``
    lives in logical block ``t // block_len`` at offset
    ``o = t % block_len``, which sp rank ``o // bl_loc`` owns at local
    offset ``o % bl_loc`` (``bl_loc = block_len / sp``); the table maps
    the logical block to a physical one."""

    def __init__(self, n_blocks: int, block_len: int, sp: int = 1):
        if n_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (one is the trash block), got {n_blocks}"
            )
        if block_len % sp:
            raise ValueError(
                f"block_len {block_len} must divide over sp={sp}"
            )
        self.n_blocks, self.block_len, self.sp = n_blocks, block_len, sp
        self.bl_loc = block_len // sp

    def blocks_for(self, n_positions: int) -> int:
        """Blocks covering positions [0, n_positions)."""
        return -(-n_positions // self.block_len)

    def write_slot(self, pos, tables, rank: int = 0):
        """(physical block, local offset, owned by sp rank ``rank``) of
        each global position of ``pos`` [B, L] written through row b's
        table ``tables[b]``."""
        j = (pos // self.block_len).clamp(0, tables.shape[1] - 1).long()
        o = pos % self.block_len
        return tables.gather(1, j), o % self.bl_loc, o // self.bl_loc == rank

    def page_positions(self, n_pages: int, device,
                       rank: int = 0) -> torch.Tensor:
        """[n_pages * bl_loc] global position of each local slot of sp
        rank ``rank``'s gathered page window (page j, local offset s:
        ``j * block_len + rank * bl_loc + s``)."""
        j = torch.arange(n_pages, dtype=torch.int32, device=device)
        s = torch.arange(self.bl_loc, dtype=torch.int32, device=device)
        return (j[:, None] * self.block_len + rank * self.bl_loc
                + s[None, :]).reshape(-1)


def _pool_write(pool_l: dict, kt, vt, pb, ob) -> None:
    """Scatter per-row k/v [N, Hkv, D] into one layer's pool leaves at
    ``(pb, ob)`` [N] each, in place; quantizing on the way in when int8.
    Rows routed to the trash block may collide: their values are
    garbage by design."""
    pb, ob = pb.long(), ob.long()
    if "ks" in pool_l:
        kq, ks = _quantize_kv(kt[:, :, None, :])
        vq, vs = _quantize_kv(vt[:, :, None, :])
        pool_l["k"].index_put_((pb, ob), kq[:, :, 0, :])
        pool_l["v"].index_put_((pb, ob), vq[:, :, 0, :])
        pool_l["ks"].index_put_((pb, ob), ks[:, :, 0])
        pool_l["vs"].index_put_((pb, ob), vs[:, :, 0])
        return
    pool_l["k"].index_put_((pb, ob), kt.to(pool_l["k"].dtype))
    pool_l["v"].index_put_((pb, ob), vt.to(pool_l["v"].dtype))


def _write_through(pool_l: dict, k, v, pos, own, tables, layout, rank):
    """Write k/v [B, L, Hkv, D] at global positions ``pos`` [B, L] where
    ``own`` [B, L] and sp rank ``rank`` holds the slot; every other lane
    goes to the trash block (a select, not a branch: rows sit at
    different positions, so ownership is per row)."""
    b, lw, hkv, d = k.shape
    phys, off, mine = layout.write_slot(pos, tables, rank)
    own = own & mine
    pb = torch.where(own, phys, TRASH_BLOCK).reshape(-1)
    ob = torch.where(own, off, 0).reshape(-1)
    _pool_write(pool_l, k.reshape(b * lw, hkv, d), v.reshape(b * lw, hkv, d),
                pb, ob)


def _windows(pool_l: dict, tables, layout: PagedLayout) -> dict:
    """Each row's gathered page window of one layer's leaves, pages
    flattened into the cache axis: [B, Hkv, n_pages * bl_loc, ...]."""
    b = tables.shape[0]
    tb = tables.clamp(0, layout.n_blocks - 1).long()

    def pages(leaf):  # [n_blocks, bl, Hkv, ...] -> [B, Hkv, L, ...]
        g = leaf[tb].movedim(3, 1)  # [B, Hkv, n_pages, bl, ...]
        return g.reshape(b, g.shape[1], -1, *g.shape[4:])

    return {n: pages(leaf) for n, leaf in pool_l.items()}


def _prefill_write(p_l, x, pool_l, lens, start, tables, layout: PagedLayout,
                   cfg: ModelConfig, rank: int = 0):
    """The first half of a prefill layer on one rank over right-padded
    prompts x [B, Lp, E] (replicated over sp: the pool, not the
    activations, carries the sp sharding): the queries, and sp rank
    ``rank``'s stripe of every valid position's k/v written through the
    tables.  ``start`` [B] is the write fence: positions below it
    already sit in the pool and their writes go to the trash block.
    Returns (q, the causal mask [B, Lp, n_pages * bl_loc] of the rank's
    window)."""
    b, lp, _ = x.shape
    n_pages = tables.shape[1]
    t = torch.arange(lp, dtype=torch.int32, device=x.device)
    q, k, v = qkv_native(p_l, x)
    q, k = _rotate(cfg, q, k, t)
    own = (t[None, :] < lens[:, None]) & (t[None, :] >= start[:, None])
    _write_through(pool_l, k, v, t[None, :].expand(b, lp), own, tables,
                   layout, rank)
    posn = layout.page_positions(n_pages, x.device, rank)
    tvalid = (tables > TRASH_BLOCK).repeat_interleave(layout.bl_loc, dim=1)
    mask = (
        (posn[None, None, :] <= t[None, :, None])
        & (posn[None, None, :] < lens[:, None, None])
        & tvalid[:, None, :]
    )  # [B, Lp, L]
    return q, mask


def _verify_write(p_l, x, pool_l, pos0, n_draft, active, tables,
                  layout: PagedLayout, cfg: ModelConfig, rank: int = 0):
    """The first half of a verify layer on one rank: x [B, W, E] holds
    each row's last committed token and up to ``n_draft`` [B] drafted
    ones, token i at global position ``pos0 + i``.  Writes sp rank
    ``rank``'s stripe of every fed position through the tables (lanes
    ``i > n_draft`` are padding: their writes go to the trash block, as
    they may lie past the row's reserved lifetime) and returns (q, the
    positions [B, W])."""
    w = x.shape[1]
    q, k, v = qkv_native(p_l, x)
    i = torch.arange(w, dtype=torch.int32, device=x.device)
    pos = pos0[:, None] + i[None, :]  # [B, W] global positions
    q, k = _rotate(cfg, q, k, pos)
    own = active[:, None] & (i[None, :] <= n_draft[:, None])
    _write_through(pool_l, k, v, pos, own, tables, layout, rank)
    return q, pos


def _verify_mask(pos, active, tables, layout: PagedLayout, rank: int = 0):
    """[B, W, n_pages * bl_loc]: the slots of sp rank ``rank``'s window
    that each fed query sees (the dense verify path)."""
    posn = layout.page_positions(tables.shape[1], pos.device, rank)
    tvalid = (tables > TRASH_BLOCK).repeat_interleave(layout.bl_loc, dim=1)
    return ((posn[None, None, :] <= pos[:, :, None])
            & tvalid[:, None, :] & active[:, None, None])


def _normalized(o, l, q):
    """o / l regrouped to q's [B, W, H, D] and dtype."""
    b, w, h, d = q.shape
    out = o / torch.clamp_min(l, 1e-30)[..., None]  # [B, Hkv, G*W, D]
    hkv = out.shape[1]
    out = out.reshape(b, hkv, h // hkv, w, d).permute(0, 3, 1, 2, 4)
    return out.reshape(b, w, h, d).to(q.dtype)


def paged_attend(pools_l: list, qs: list, tables: list, pos0: list,
                 active: list, layout: PagedLayout) -> list:
    """K1's attention over one sp group, normalized and regrouped to
    q's [B, W, H, D] and dtype: rank i of the group holds stripe i of
    every block (``pools_l[i]``, one layer's leaves) and its copy of the
    replicated q and row arrays.  Each rank's kernel gives its partial
    triple; the group's max of m (clamped, so that a row no rank sees
    keeps alpha exactly 0 and its output exactly 0) rescales each, and
    the rescaled l and o are summed over the group (the reference's
    ``paged_attend`` under ``shard_map``).  Every rank gets the same
    output; a group of one is the unsharded attention."""
    # through the module, where a launch recorder may stand in for it
    parts = [paged_kernel.paged_block(
        q.contiguous(), pl["k"], pl["v"], tb, p0, act,
        block_len=layout.block_len, rank=i,
        k_scale=pl.get("ks"), v_scale=pl.get("vs"),
    ) for i, (pl, q, tb, p0, act) in enumerate(zip(pools_l, qs, tables,
                                                   pos0, active))]
    m_g = [torch.clamp_min(m, NEG_INF / 2)
           for m in _sp_max([m for _, m, _ in parts])]
    alphas = [torch.exp(m - mg) for (_, m, _), mg in zip(parts, m_g)]
    ls = _sp_sum([l * a for (_, _, l), a in zip(parts, alphas)])
    os_ = _sp_sum([o * a[..., None] for (o, _, _), a in zip(parts, alphas)])
    return [_normalized(o, l, q) for o, l, q in zip(os_, ls, qs)]


def _prefill_layer(mesh: NamedMesh, layers, xs, pools, rows,
                   layout: PagedLayout, cfg: ModelConfig) -> list:
    """One layer over a batch of right-padded prompts x [B, Lp, E] on
    every rank: each rank writes its stripe of every valid position's
    k/v through the tables, then attends causally by reading its written
    pages back (so prefill sees exactly what decode will, quantized
    values included), and the sp group combines the windows (the dense
    cache's group attention: no ring pass, the queries being
    replicated); the out-projection is summed over tp and the FFN runs
    tp-sharded (``decode._block_out``)."""
    qs, masks, wins = [], [], []
    for r, (p, x, pl, a) in enumerate(zip(layers, xs, pools, rows)):
        q, mask = _prefill_write(p, x, pl, a["lens"], a["start"],
                                 a["tables"], layout, cfg,
                                 mesh.coord(r)["sp"])
        qs.append(q)
        masks.append(mask)
        wins.append(_windows(pl, a["tables"], layout))
    return _block_out(mesh, layers, xs,
                      _decode_attend(mesh, qs, wins, masks), cfg)


def _verify_layer(mesh: NamedMesh, layers, xs, pools, rows,
                  layout: PagedLayout, cfg: ModelConfig, attn: str) -> list:
    """One layer of the speculative wide step (:func:`_verify_write`) on
    every rank: a prefill at a per-row offset, each query attending
    causally over its own prefix (K1's partial triples of each sp group
    combined by :func:`paged_attend`, or the dense windows), so output i
    is what the one-token step would emit after committing tokens 0..i;
    then the tp-summed block tail.  The one-token step is this layer at
    W = 1 with no draft.  Slots holding drafts a previous wide step
    rejected are rewritten here before a trusted query reads them: the
    window advances at most ``accepted + 1 <= W`` positions a step."""
    qs, pos = [], []
    for r, (p, x, pl, a) in enumerate(zip(layers, xs, pools, rows)):
        q, ps = _verify_write(p, x, pl, a["pos0"], a["n_draft"],
                              a["active"], a["tables"], layout, cfg,
                              mesh.coord(r)["sp"])
        qs.append(q)
        pos.append(ps)
    if attn == "kernel":
        att = [None] * mesh.size
        for grp in mesh.groups("sp"):
            out = paged_attend(
                [pools[r] for r in grp], [qs[r] for r in grp],
                *([rows[r][n] for r in grp]
                  for n in ("tables", "pos0", "active")), layout)
            for r, o in zip(grp, out):
                att[r] = o
    else:
        att = _decode_attend(
            mesh, qs, [_windows(pl, a["tables"], layout)
                       for pl, a in zip(pools, rows)],
            [_verify_mask(ps, a["active"], a["tables"], layout,
                          mesh.coord(r)["sp"])
             for r, (ps, a) in enumerate(zip(pos, rows))])
    return _block_out(mesh, layers, xs, att, cfg)


@dataclasses.dataclass(frozen=True)
class PagedDecoder:
    """(prefill, step, verify, copy_blocks) over the paged pool, on one
    device or over an sp x tp rank mesh (``comm/mesh.py::NamedMesh``,
    dp 1: the reference's sharded serve path).

    * ``prefill(params, pool, tokens, lens, start, tables, active) ->
      tok0``: run a bucket of right-padded prompts [B, Lpad], write
      their K/V through their tables from position ``start`` on
      (earlier positions sit in shared blocks already: prefix sharing's
      write fence), and return each row's greedy first token (0 for
      inactive rows).
    * ``step(params, pool, tok, lens, steps, tables, active) -> next``:
      one iteration for a bucket of rows, each at its own position
      ``lens + steps``; returns the next greedy ids.
    * ``verify(params, pool, toks, lens, steps, n_draft, tables,
      active) -> ids [B, W]``: the speculative wide step; toks [B, W]
      holds each row's last committed token and up to ``n_draft[b]``
      drafted ones, and the greedy id at every fed position comes back.
    * ``copy_blocks(pool, src, dst)``: the CoW boundary copy, whole
      blocks of every layer and leaf (scales included).
    * ``gather_blocks(pool, src)`` and ``onload_blocks(pool, vals,
      dst)``: the kv tier's block copies out of and into the pool.

    With ``sampling`` the three cores take ``seeds, gidx, temp, topk,
    topp`` [B] after ``active`` and sample (inactive rows still give 0).
    All update ``pool`` in place.  The cores take host arrays, moved to
    every rank's device on the way in, and return rank 0's ids.

    The cores always run over a mesh (:attr:`ranks`): ``mesh``, or with
    ``mesh=None`` the (1, 1, 1) mesh of ``device``, whose caller hands
    in and gets back plain tensors where a mesh's caller has per-rank
    lists.  Over a mesh every rank holds its stripe of every block over
    sp and its kv heads over tp (:data:`POOL_SPEC`: leaves ``[depth,
    n_blocks, bl_loc, Hkv/tp, D]``), params are per-rank lists
    (``shard_lm_params``: the embedding vocab-parallel), and the token
    rows, queries and activations are replicated.  A write lands only on
    the rank whose stripe holds its slot (the others route it to the
    trash block), attention combines each sp group's partials, the
    out-projection and the FFN sum over tp, and the greedy and sampled
    ids come from the vocab shards (``argmax_mesh``, ``rows_mesh``).
    The pool's conversions (:meth:`pool_ptrs`, :meth:`pool_tree`,
    :meth:`pool_template`, :meth:`load_pool`), :meth:`sync` and the
    block copies, which move blocks in the GLOBAL layout, are the
    decoder's, so the engine, the host tier and its session files never
    learn how the pool is laid out."""

    cfg: ModelConfig
    vocab: int
    layout: PagedLayout
    n_pages: int  # table width: blocks covering the longest sequence
    device: torch.device  # rank 0's
    cache_int8: bool = False
    attn: str = "kernel"
    sampling: bool = False
    mesh: NamedMesh | None = None

    def __post_init__(self):
        if self.attn not in ("dense", "kernel"):
            raise ValueError(
                f"attn must be 'dense' or 'kernel', got {self.attn!r}"
            )
        mesh = self.ranks
        if mesh.dim("dp") != 1:
            raise ValueError(
                "serve shards the pool over sp/tp only: fold dp into sp "
                "(batch rows are scheduler slots, not a data axis)"
            )
        if self.layout.sp != mesh.dim("sp"):
            raise ValueError("layout.sp must match the mesh sp axis")
        tp = mesh.dim("tp")
        if self.vocab % tp:
            raise ValueError(f"vocab {self.vocab} must divide over tp={tp}")
        _check_kv_heads_shardable(self.cfg, mesh)

    @property
    def ranks(self) -> NamedMesh:
        """The mesh the cores run over."""
        return self.mesh or single_mesh(self.device)

    def _per_rank(self, tree: dict) -> dict:
        """The caller's pool or params as per-rank lists (one device's
        tensors each a list of one)."""
        if self.mesh is None:
            return {k: [v] for k, v in tree.items()}
        return tree

    def _to_caller(self, tree: dict) -> dict:
        """Per-rank lists as the caller holds them (:meth:`_per_rank`'s
        inverse)."""
        if self.mesh is None:
            return {k: v[0] for k, v in tree.items()}
        return tree

    # -- pool ------------------------------------------------------------

    def pool_nbytes(self) -> int:
        """The pool's bytes over every rank (each holds its stripe and
        heads, nothing twice)."""
        lay, cfg = self.layout, self.cfg
        slots = lay.n_blocks * lay.block_len
        return cfg.depth * slots * kv_slot_bytes(
            cfg.head_dim, cfg.n_kv, cfg.torch_dtype, self.cache_int8
        )

    def _pool_leaves(self) -> dict[str, tuple[tuple, torch.dtype]]:
        """(global shape, dtype) a pool leaf: the one table behind
        :meth:`init_pool` and the kv tier's per-block leaf table."""
        lay, cfg = self.layout, self.cfg
        kv = (cfg.depth, lay.n_blocks, lay.block_len, cfg.n_kv, cfg.head_dim)
        if self.cache_int8:
            return {
                "k": (kv, torch.int8), "v": (kv, torch.int8),
                "ks": (kv[:-1], torch.float32),
                "vs": (kv[:-1], torch.float32),
            }
        return {"k": (kv, cfg.torch_dtype), "v": (kv, cfg.torch_dtype)}

    @staticmethod
    def _spec(name: str) -> tuple:
        return SCALE_SPEC if name in ("ks", "vs") else POOL_SPEC

    def init_pool(self) -> dict:
        """A fresh zeroed pool: each leaf the ranks' blocks."""
        mesh = self.ranks
        pool = {}
        for n, (shape, dt) in self._pool_leaves().items():
            local = list(shape)
            local[2] //= mesh.dim("sp")
            local[3] //= mesh.dim("tp")
            pool[n] = [torch.zeros(local, dtype=dt, device=d)
                       for d in mesh.devices]
        return self._to_caller(pool)

    def pool_ptrs(self, pool) -> dict[str, int]:
        """Device addresses of the pool's buffers: unchanged across a run
        iff every call updated the pool in place."""
        return {f"{n}/{r}": t.data_ptr()
                for n, leaves in self._per_rank(pool).items()
                for r, t in enumerate(leaves)}

    def pool_tree(self, pool) -> dict:
        """The pool as a ``ckpt.save`` tree: each leaf a
        ``ckpt.Sharded`` array over the ranks, so a snapshot holds the
        global pool, which any mesh (or one device) restores."""
        return {n: ckpt.Sharded.over(self.ranks, leaves, self._spec(n))
                for n, leaves in self._per_rank(pool).items()}

    def pool_template(self, pool) -> dict:
        """A ``ckpt.restore`` template for :meth:`pool_tree`'s tree."""
        return self.pool_tree(pool)

    def load_pool(self, pool, tree) -> None:
        """Copy a restored tree into the pool's own buffers."""
        for n, leaves in self._per_rank(pool).items():
            for leaf, got in zip(leaves, tree[n].shards):
                leaf.copy_(got)

    def sync(self) -> None:
        """Wait for the work queued on every rank's device."""
        for dev in self.ranks.ranks.cards():
            device_barrier(dev)

    # -- cores -----------------------------------------------------------

    def _bcast(self, a, dtype) -> list[torch.Tensor]:
        """A host array (or tensor) on every rank's device, one copy a
        device."""
        t = torch.as_tensor(a)
        on = {}
        return [on.setdefault(d, t.to(device=d, dtype=dtype))
                for d in self.ranks.devices]

    def _rows(self, rows: tuple) -> list:
        """The sampler's per-row arrays on each rank's device (one copy a
        device), or Nones where the greedy argmax serves: an unsampled
        decoder, or no row with ``temp > 0``."""
        if bool(rows) != self.sampling:
            raise ValueError(
                f"a decoder with sampling={self.sampling} takes "
                f"{'5' if self.sampling else 'no'} per-row sampling "
                f"arrays, got {len(rows)}"
            )
        on = {}
        return [on.setdefault(d, sample_rows_on(d, *rows) if rows else None)
                for d in self.ranks.devices]

    def _pick(self, logits: list, rows: list, w: int) -> torch.Tensor:
        """Rank 0's ids [B, w] from each rank's vocab shard of the logits
        [B * w, V/tp]: the greedy argmax, or row b's position t drawn
        with key ``(seeds[b], gidx[b] + t)``."""
        mesh = self.ranks
        if all(rw is None for rw in rows):
            return argmax_mesh(mesh, logits)[0].reshape(-1, w)
        wide = []
        for rw in rows:
            seeds, gidx, temp, topk, topp = rw
            t = torch.arange(w, dtype=torch.int32, device=seeds.device)
            wide.append((seeds.repeat_interleave(w),
                         (gidx[:, None] + t[None, :]).reshape(-1),
                         temp.repeat_interleave(w), topk.repeat_interleave(w),
                         topp.repeat_interleave(w)))
        return rows_mesh(mesh, logits, wide)[0].reshape(-1, w)

    def _embed(self, wembs: list, toks: list) -> list:
        return [x.to(self.cfg.torch_dtype)
                for x in _embed_mesh(self.ranks, wembs, toks)]

    @staticmethod
    def _layer(pool: dict, params: dict, mesh: NamedMesh, i: int):
        """Layer ``i`` of every rank: (params, pool leaves)."""
        blocks = {k: v for k, v in params.items() if k != "wemb"}
        return (_layer_of(mesh, blocks, i),
                [{n: leaves[r][i] for n, leaves in pool.items()}
                 for r in range(mesh.size)])

    @torch.no_grad()
    def prefill(self, params, pool, tokens, lens, start, tables, active,
                *rows):
        rows = self._rows(rows)
        lpad = tokens.shape[1]
        if lpad > self.n_pages * self.layout.block_len:
            raise ValueError(
                f"prompt_len {lpad} exceeds the table window "
                f"({self.n_pages} blocks x {self.layout.block_len})"
            )
        mesh, params, pool = (self.ranks, self._per_rank(params),
                              self._per_rank(pool))
        a = [dict(zip(("lens", "start", "tables", "active"), v)) for v in zip(
            self._bcast(lens, torch.int32), self._bcast(start, torch.int32),
            self._bcast(tables, torch.int32), self._bcast(active, torch.bool))]
        xs = self._embed(params["wemb"], self._bcast(tokens, torch.int32))
        for i in range(self.cfg.depth):
            layers, pools = self._layer(pool, params, mesh, i)
            xs = _prefill_layer(mesh, layers, xs, pools, a, self.layout,
                                self.cfg)
        logits = []
        for x, w, ar in zip(xs, params["wemb"], a):
            idx = (ar["lens"] - 1).clamp(0, lpad - 1).long()
            logits.append(x[torch.arange(x.shape[0], device=x.device), idx]
                          @ w.T)
        tok0 = self._pick(logits, rows, 1)[:, 0]
        return torch.where(a[0]["active"], tok0, 0)

    def step(self, params, pool, tok, lens, steps, tables, active, *rows):
        tok = torch.as_tensor(tok, dtype=torch.int32)
        no_draft = torch.zeros_like(tok, device="cpu")
        return self.verify(params, pool, tok[:, None], lens, steps,
                           no_draft, tables, active, *rows)[:, 0]

    @torch.no_grad()
    def verify(self, params, pool, toks, lens, steps, n_draft, tables,
               active, *rows):
        rows = self._rows(rows)
        mesh, params, pool = (self.ranks, self._per_rank(params),
                              self._per_rank(pool))
        pos0 = (torch.as_tensor(lens, dtype=torch.int32).cpu()
                + torch.as_tensor(steps, dtype=torch.int32).cpu())
        names = ("pos0", "n_draft", "tables", "active")
        a = [dict(zip(names, v)) for v in zip(
            self._bcast(pos0, torch.int32), self._bcast(n_draft, torch.int32),
            self._bcast(tables, torch.int32), self._bcast(active, torch.bool))]
        xs = self._embed(params["wemb"], self._bcast(toks, torch.int32))
        for i in range(self.cfg.depth):
            layers, pools = self._layer(pool, params, mesh, i)
            xs = _verify_layer(mesh, layers, xs, pools, a, self.layout,
                               self.cfg, self.attn)
        b, w, _ = xs[0].shape
        logits = [x.reshape(b * w, -1) @ wm.T
                  for x, wm in zip(xs, params["wemb"])]
        out = self._pick(logits, rows, w)
        return torch.where(a[0]["active"][:, None], out, 0)

    @torch.no_grad()
    def copy_blocks(self, pool, src, dst) -> None:
        """Clone pool blocks ``src[i] -> dst[i]`` across every layer and
        leaf, scales included, in place, on every rank.  Padding lanes
        pass ``src == dst == TRASH_BLOCK`` (a self-copy of garbage)."""
        srcs = self._bcast(src, torch.long)
        dsts = self._bcast(dst, torch.long)
        for leaves in self._per_rank(pool).values():
            for leaf, s_, d_ in zip(leaves, srcs, dsts):
                leaf[:, d_] = leaf[:, s_]

    # -- the kv tier's block copies ---------------------------------------

    @torch.no_grad()
    def gather_blocks(self, pool, src) -> dict[str, torch.Tensor]:
        """The device->host half of the kv tier's handoff: blocks
        ``src[i]`` of every layer and leaf (scales included) as fresh
        device tensors in the GLOBAL layout ``[depth, len(src),
        block_len, Hkv, ...]`` on rank 0's device, each rank's stripe
        and heads assembled (the reference's gather out-spec is the
        pool's).  The pool is read, never changed: until the host copy
        is committed the device copy stays authoritative (the mid-evict
        contract).  Exactly ``len(src)`` blocks are read; the reference
        pads the wave to a power of two only to bound its compiled
        shapes."""
        srcs = self._bcast(src, torch.long)
        return {n: self.ranks.assemble([leaf[:, s_] for leaf, s_
                                        in zip(leaves, srcs)], self._spec(n))
                for n, leaves in self._per_rank(pool).items()}

    @torch.no_grad()
    def onload_blocks(self, pool, vals, dst) -> None:
        """The host->device half: global-layout ``vals[leaf]`` ``[depth,
        len(dst), ...]`` split over the ranks and written into blocks
        ``dst[i]`` of every layer and leaf, in place (the pool's buffers
        stay the same, as ``pool_ptrs`` checks).  The targets came off
        the free list: their old contents were garbage."""
        dsts = self._bcast(dst, torch.long)
        for n, leaves in self._per_rank(pool).items():
            parts = self.ranks.shard(vals[n].to(leaves[0].dtype),
                                     self._spec(n))
            for leaf, d_, part in zip(leaves, dsts, parts):
                leaf.index_copy_(1, d_, part)

    @torch.no_grad()
    def stream(self, vals: dict) -> dict[str, torch.Tensor]:
        """The disagg prefill->decode wire (the reference's
        ``stream_jit``, ``comm/p2p.py::make_block_stream``): a global-
        layout payload from :meth:`gather_blocks`, split over the ranks
        as the pool is, pair-exchanged across ``sp`` and back, and
        assembled again on rank 0's device, bit-identical.  ``vals`` is
        consumed (emptied), as the reference donates it."""
        from tpu_patterns_torch.comm.p2p import make_block_stream

        mesh = self.ranks
        specs = {n: self._spec(n) for n in vals}
        parts = {n: mesh.shard(vals[n], specs[n]) for n in vals}
        vals.clear()
        wire = make_block_stream(mesh, axis="sp")(parts)
        return {n: mesh.assemble(leaves, specs[n])
                for n, leaves in wire.items()}

    # -- params ----------------------------------------------------------

    def stack_params(self, params: dict) -> dict:
        """Flat reference-layout params on the decoder's ranks: a leading
        [depth] axis on every block leaf (added when a depth-1 dict lacks
        it), ``wemb`` [V, E], then split over the mesh
        (``shard_lm_params``)."""
        shapes = param_shapes(self.cfg)
        out = {}
        for k, v in params.items():
            v = torch.as_tensor(v)
            if k != "wemb":
                if v.ndim == len(shapes[k]):
                    v = v[None]
                if tuple(v.shape) != (self.cfg.depth, *shapes[k]):
                    raise ValueError(
                        f"{k} {tuple(v.shape)} != "
                        f"{(self.cfg.depth, *shapes[k])}"
                    )
            out[k] = v.to(device=self.device, dtype=self.cfg.torch_dtype)
        if out["wemb"].shape != (self.vocab, self.cfg.embed):
            raise ValueError(
                f"wemb {tuple(out['wemb'].shape)} != "
                f"({self.vocab}, {self.cfg.embed})"
            )
        return self._to_caller(shard_lm_params(out, self.ranks, self.cfg))


def make_paged_lm_decoder(
    cfg: ModelConfig,
    vocab: int,
    *,
    n_blocks: int,
    block_len: int,
    max_len: int,
    cache_int8: bool = False,
    attn: str = "kernel",
    sampling: bool = False,
    device=None,
    mesh: NamedMesh | None = None,
) -> PagedDecoder:
    """The paged token decoder: ``n_blocks`` physical blocks of
    ``block_len`` slots (block 0 is trash), tables covering ``max_len``
    positions per sequence, on ``device`` (cuda unless "cpu" is named)
    or over ``mesh`` (sp x tp, dp 1; ``device`` is then the mesh's);
    ``sampling`` gives the cores the per-row seeded sampler."""
    sp = 1 if mesh is None else mesh.dim("sp")
    layout = PagedLayout(n_blocks, block_len, sp)
    return PagedDecoder(
        cfg=cfg, vocab=vocab, layout=layout,
        n_pages=layout.blocks_for(max_len),
        device=resolve_device(device) if mesh is None else mesh.devices[0],
        cache_int8=cache_int8, attn=attn, sampling=sampling, mesh=mesh,
    )
