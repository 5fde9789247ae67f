"""Paged KV cache: a block pool plus per-sequence block tables.

Counterpart of ``tpu_patterns/serve/paged.py`` on one device.  The cache
is a pool of fixed-size blocks,

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
attention: ``"kernel"`` (the default) runs the fused paged kernel
(``serve/paged_kernel.py``), ``"dense"`` gathers the page window and
reruns the dense masked attention.  Prefill always runs the dense path.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_patterns_torch.models.decode import (
    _distributed_attention,
    _mlp,
    _quantize_kv,
    kv_slot_bytes,
)
from tpu_patterns_torch.models.lm import embed_tokens, sharded_argmax
from tpu_patterns_torch.models.transformer import (
    ModelConfig,
    apply_rope,
    param_shapes,
    qkv_native,
    rope_tables,
)
from tpu_patterns_torch.runtime import resolve_device
from tpu_patterns_torch.serve.paged_kernel import TRASH_BLOCK, paged_attend


class PagedLayout:
    """Closed-form slot math for the block pool: global position ``t``
    lives in logical block ``t // block_len`` at offset
    ``t % block_len``; the table maps the logical block to a physical
    one."""

    def __init__(self, n_blocks: int, block_len: int):
        if n_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (one is the trash block), got {n_blocks}"
            )
        self.n_blocks, self.block_len = n_blocks, block_len

    def blocks_for(self, n_positions: int) -> int:
        """Blocks covering positions [0, n_positions)."""
        return -(-n_positions // self.block_len)

    def write_slot(self, pos, tables):
        """Per-row (physical block, offset) for writing position ``pos``
        [B] through ``tables`` [B, n_pages]."""
        n_pages = tables.shape[1]
        j = (pos // self.block_len).clamp(0, n_pages - 1).long()
        phys = tables.gather(1, j[:, None])[:, 0]
        return phys, pos % self.block_len

    def page_positions(self, n_pages: int, device) -> torch.Tensor:
        """[n_pages * block_len] global position of each slot of a
        gathered page window."""
        return torch.arange(n_pages * self.block_len, dtype=torch.int32,
                            device=device)


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


def _pool_attend(pool_l: dict, q, tables, mask, layout: PagedLayout):
    """Attention of q [B, Lq, H, D] against the rows' gathered pages:
    gather each row's table window, flatten pages into the cache axis,
    and run the dense masked attention."""
    b = q.shape[0]
    tb = tables.clamp(0, layout.n_blocks - 1).long()

    def pages(leaf):  # [n_blocks, bl, Hkv, ...] -> [B, Hkv, L, ...]
        g = leaf[tb].movedim(3, 1)  # [B, Hkv, n_pages, bl, ...]
        return g.reshape(b, g.shape[1], -1, *g.shape[4:])

    return _distributed_attention(
        q, pages(pool_l["k"]), pages(pool_l["v"]), mask,
        k_scale=pages(pool_l["ks"]) if "ks" in pool_l else None,
        v_scale=pages(pool_l["vs"]) if "vs" in pool_l else None,
    )


def _paged_prefill_layer(p_l, x, pool_l, lens, start, tables,
                         layout: PagedLayout, cfg: ModelConfig):
    """One layer over a batch of right-padded prompts x [B, Lp, E]:
    write every valid position's k/v through the tables, then attend
    causally by reading the written pages back, so prefill sees exactly
    what decode will (quantized values included).  ``start`` [B] is the
    write fence: positions below it already sit in the pool and their
    writes go to the trash block."""
    b, lp, _ = x.shape
    n_pages = tables.shape[1]
    dev = x.device
    q, k, v = qkv_native(p_l, x)
    if cfg.rope:
        pos = torch.arange(lp, dtype=torch.int32, device=dev)
        cos, sin = rope_tables(pos, cfg.head_dim, cfg.rope_theta, q.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    t = torch.arange(lp, dtype=torch.int32, device=dev)
    j = (t // layout.block_len).clamp(0, n_pages - 1).long()
    o = t % layout.block_len
    phys = tables[:, j]  # [B, Lp]
    own = (t[None, :] < lens[:, None]) & (t[None, :] >= start[:, None])
    pb = torch.where(own, phys, TRASH_BLOCK).reshape(-1)
    ob = torch.where(own, o[None, :], 0).reshape(-1)
    hkv, d = k.shape[2], k.shape[3]
    _pool_write(pool_l, k.reshape(b * lp, hkv, d), v.reshape(b * lp, hkv, d),
                pb, ob)

    posn = layout.page_positions(n_pages, dev)
    tvalid = (tables > TRASH_BLOCK).repeat_interleave(layout.block_len, dim=1)
    mask = (
        (posn[None, None, :] <= t[None, :, None])
        & (posn[None, None, :] < lens[:, None, None])
        & tvalid[:, None, :]
    )  # [B, Lp, L]
    attn = _pool_attend(pool_l, q, tables, mask, layout)
    y = x + torch.einsum("blhd,hde->ble", attn, p_l["wo"])
    return _mlp(p_l, y)


def _paged_decode_layer(p_l, x, pool_l, pos, active, tables,
                        layout: PagedLayout, cfg: ModelConfig,
                        attn: str = "kernel"):
    """One layer for each active row's next token x [B, 1, E] at global
    position ``pos`` [B]: write its k/v to the row's tail block, then
    attend through the tables (fused kernel or dense gather)."""
    q, k, v = qkv_native(p_l, x)
    if cfg.rope:
        cos, sin = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta,
                               q.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    phys, o_loc = layout.write_slot(pos, tables)
    _pool_write(
        pool_l, k[:, 0], v[:, 0],
        torch.where(active, phys, TRASH_BLOCK),
        torch.where(active, o_loc, 0),
    )
    if attn == "kernel":
        att = paged_attend(pool_l, q, tables, pos, active, layout)
    else:
        n_pages = tables.shape[1]
        posn = layout.page_positions(n_pages, x.device)
        tvalid = (tables > TRASH_BLOCK).repeat_interleave(
            layout.block_len, dim=1
        )
        mask = (posn[None, :] <= pos[:, None]) & tvalid & active[:, None]
        att = _pool_attend(pool_l, q, tables, mask[:, None, :], layout)
    y = x + torch.einsum("blhd,hde->ble", att, p_l["wo"])
    return _mlp(p_l, y)


@dataclasses.dataclass(frozen=True)
class PagedDecoder:
    """(prefill, step) over the paged pool on one device.

    * ``prefill(params, pool, tokens, lens, start, tables, active) ->
      tok0``: run a bucket of right-padded prompts [B, Lpad], write
      their K/V through their tables from position ``start`` on, and
      return each row's greedy first token (0 for inactive rows).
    * ``step(params, pool, tok, lens, steps, tables, active) -> next``:
      one iteration for a bucket of rows, each at its own position
      ``lens + steps``; returns the next greedy ids.

    Both update ``pool`` in place.  Host arrays are moved to the
    decoder's device on the way in."""

    cfg: ModelConfig
    vocab: int
    layout: PagedLayout
    n_pages: int  # table width: blocks covering the longest sequence
    device: torch.device
    cache_int8: bool = False
    attn: str = "kernel"

    def __post_init__(self):
        if self.attn not in ("dense", "kernel"):
            raise ValueError(
                f"attn must be 'dense' or 'kernel', got {self.attn!r}"
            )

    # -- pool ------------------------------------------------------------

    def pool_nbytes(self) -> int:
        lay, cfg = self.layout, self.cfg
        slots = lay.n_blocks * lay.block_len
        return cfg.depth * slots * kv_slot_bytes(
            cfg.head_dim, cfg.n_kv, cfg.torch_dtype, self.cache_int8
        )

    def init_pool(self) -> dict[str, torch.Tensor]:
        """A fresh zeroed pool on the decoder's device."""
        lay, cfg = self.layout, self.cfg
        kv = (cfg.depth, lay.n_blocks, lay.block_len, cfg.n_kv, cfg.head_dim)
        dev = self.device
        if self.cache_int8:
            return {
                "k": torch.zeros(kv, dtype=torch.int8, device=dev),
                "v": torch.zeros(kv, dtype=torch.int8, device=dev),
                "ks": torch.zeros(kv[:-1], dtype=torch.float32, device=dev),
                "vs": torch.zeros(kv[:-1], dtype=torch.float32, device=dev),
            }
        return {
            "k": torch.zeros(kv, dtype=cfg.torch_dtype, device=dev),
            "v": torch.zeros(kv, dtype=cfg.torch_dtype, device=dev),
        }

    # -- cores -----------------------------------------------------------

    def _dev(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(a).to(device=self.device, dtype=dtype)

    def _layers(self, params: dict, pool: dict):
        for i in range(self.cfg.depth):
            p_l = {k: v[i] for k, v in params.items() if k != "wemb"}
            yield p_l, {n: leaf[i] for n, leaf in pool.items()}

    @torch.no_grad()
    def prefill(self, params, pool, tokens, lens, start, tables, active):
        lpad = tokens.shape[1]
        if lpad > self.n_pages * self.layout.block_len:
            raise ValueError(
                f"prompt_len {lpad} exceeds the table window "
                f"({self.n_pages} blocks x {self.layout.block_len})"
            )
        tokens = self._dev(tokens, torch.int32)
        lens = self._dev(lens, torch.int32)
        start = self._dev(start, torch.int32)
        tables = self._dev(tables, torch.int32)
        active = self._dev(active, torch.bool)
        wemb = params["wemb"]
        x = embed_tokens(wemb, tokens).to(self.cfg.torch_dtype)
        for p_l, pool_l in self._layers(params, pool):
            x = _paged_prefill_layer(
                p_l, x, pool_l, lens, start, tables, self.layout, self.cfg
            )
        idx = (lens - 1).clamp(0, lpad - 1).long()
        y_last = x[torch.arange(x.shape[0], device=self.device), idx]
        tok0 = sharded_argmax(y_last @ wemb.T)
        return torch.where(active, tok0, 0)

    @torch.no_grad()
    def step(self, params, pool, tok, lens, steps, tables, active):
        tok = self._dev(tok, torch.int32)
        pos = self._dev(lens, torch.int32) + self._dev(steps, torch.int32)
        tables = self._dev(tables, torch.int32)
        active = self._dev(active, torch.bool)
        wemb = params["wemb"]
        x = embed_tokens(wemb, tok[:, None]).to(self.cfg.torch_dtype)
        for p_l, pool_l in self._layers(params, pool):
            x = _paged_decode_layer(
                p_l, x, pool_l, pos, active, tables, self.layout, self.cfg,
                attn=self.attn,
            )
        nxt = sharded_argmax(x[:, 0, :] @ wemb.T)
        return torch.where(active, nxt, 0)

    # -- params ----------------------------------------------------------

    def stack_params(self, params: dict) -> dict[str, torch.Tensor]:
        """Params on the decoder's device with a leading [depth] axis on
        every block leaf (added when a depth-1 dict lacks it); ``wemb``
        stays [V, E]."""
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
        return out


def make_paged_lm_decoder(
    cfg: ModelConfig,
    vocab: int,
    *,
    n_blocks: int,
    block_len: int,
    max_len: int,
    cache_int8: bool = False,
    attn: str = "kernel",
    device=None,
) -> PagedDecoder:
    """The paged token decoder: ``n_blocks`` physical blocks of
    ``block_len`` slots (block 0 is trash), tables covering ``max_len``
    positions per sequence, on ``device`` (cuda unless "cpu" is
    named)."""
    layout = PagedLayout(n_blocks, block_len)
    return PagedDecoder(
        cfg=cfg,
        vocab=vocab,
        layout=layout,
        n_pages=layout.blocks_for(max_len),
        device=resolve_device(device),
        cache_int8=cache_int8,
        attn=attn,
    )
