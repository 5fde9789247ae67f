"""Dense KV-cache decode math: int8 KV quantization, the MLP, masked
attention against a cache, and the two-segment cache layout.

Counterpart of ``tpu_patterns/models/decode.py`` on one device (no
sequence or tensor sharding).  These are the pieces the paged serve
path reuses and the per-request dense oracle (``models/lm.py``) is
built from.
"""

from __future__ import annotations

import torch

from tpu_patterns_torch.models.transformer import (
    ModelConfig,
    apply_rope,
    qkv_native,
    rope_tables,
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
    """The block's dense ReLU FFN with its residual."""
    hidden = torch.relu(torch.einsum("ble,ef->blf", y, params["w1"]))
    return y + torch.einsum("blf,fe->ble", hidden, params["w2"])


def _distributed_attention(
    q, cache_k, cache_v, mask, k_scale=None, v_scale=None
):
    """Masked softmax attention of q [B, Lq, H, D] against a cache
    [B, Hkv, L, D]; ``mask`` [B or 1, Lq, L] says which slots each query
    sees.  Scores stay in q's dtype and masked slots take that dtype's
    most negative finite value, as in the JAX package.  With GQA each
    cached head serves H/Hkv contiguous query heads.  int8 caches fold
    their per-slot scales in after the einsums: k's on the scores, v's
    on the probabilities after the normalizer is summed."""
    b, lq, h, d = q.shape
    hkv = cache_k.shape[1]
    g = h // hkv
    qg = q.reshape(b, lq, hkv, g, d)
    ck = cache_k.to(q.dtype) if cache_k.dtype == torch.int8 else cache_k
    s = torch.einsum("bqkgd,bkld->bkgql", qg, ck) * (d**-0.5)
    if k_scale is not None:
        s = s * k_scale[:, :, None, None, :].to(s.dtype)
    neg = _neg_inf(s.dtype)
    s = torch.where(mask[:, None, None], s, neg)
    m = s.amax(dim=-1, keepdim=True)
    # a query with no visible slot keeps m == finfo.min: clamp so its
    # probabilities are exactly 0 and the output 0/eps, never NaN
    m = torch.clamp_min(m, neg / 2)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * v_scale[:, :, None, None, :].to(p.dtype)
    cv = cache_v.to(p.dtype) if cache_v.dtype == torch.int8 else cache_v
    numer = torch.einsum("bkgql,bkld->bkgqd", p, cv)
    out = numer / torch.clamp_min(denom, 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, lq, h, d)


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
    """Two-segment contiguous cache on one device: slots [0, prefill)
    hold prompt positions, slots [prefill, prefill + gen_cap) hold
    generated tokens by generation index.  Every slot's position is a
    closed-form function of its index, so unwritten slots sit at future
    positions and no causal query sees them."""

    def __init__(self, prefill: int, gen_cap: int):
        self.prefill, self.gen_cap = prefill, gen_cap
        self.lc = prefill + gen_cap

    def kv_positions(self, device) -> torch.Tensor:
        """[lc] global position of each slot (gen index n at prefill+n)."""
        return torch.arange(self.lc, dtype=torch.int32, device=device)

    def slot_meta(self, device):
        """(prompt_pos, gen_index, is_gen), each [lc]: a prompt slot is
        visible to row b iff prompt_pos < lens[b], a gen slot iff
        gen_index <= the current step."""
        far = torch.iinfo(torch.int32).max
        i = torch.arange(self.lc, dtype=torch.int32, device=device)
        is_gen = i >= self.prefill
        prompt_pos = torch.where(is_gen, far, i)
        gen_index = torch.where(is_gen, i - self.prefill, far)
        return prompt_pos, gen_index, is_gen


def _zero_cache(cfg: ModelConfig, layout: _CacheLayout, batch, device,
                cache_int8: bool) -> dict:
    """Empty cache dict, [depth, B, Hkv, lc, ...] leaves."""
    kv_shape = (cfg.depth, batch, cfg.n_kv, layout.lc, cfg.head_dim)
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


def _prefill_layer(p_l, x, cache_l, layout: _CacheLayout, cfg: ModelConfig):
    """One layer over the whole right-padded prompt x [B, prefill, E]:
    write every position's k/v into the prompt segment, then attend
    causally over the cache (quantized values included, so prefill sees
    what decode will see)."""
    q, k, v = qkv_native(p_l, x)
    if cfg.rope:
        pos = torch.arange(layout.prefill, dtype=torch.int32, device=x.device)
        cos, sin = rope_tables(pos, cfg.head_dim, cfg.rope_theta, q.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    _cache_write(cache_l, k.transpose(1, 2), v.transpose(1, 2), 0)
    q_pos = torch.arange(layout.prefill, dtype=torch.int32, device=x.device)
    mask = (layout.kv_positions(x.device)[None, :] <= q_pos[:, None])[None]
    attn = _cache_attend(cache_l, q, mask)
    y = x + torch.einsum("blhd,hde->ble", attn, p_l["wo"])
    return _mlp(p_l, y)


def _decode_layer(p_l, x, cache_l, lens, n: int, layout: _CacheLayout,
                  cfg: ModelConfig):
    """One layer for each row's n-th generated token x [B, 1, E]: row b's
    token sits at position lens[b] + n and is written to the shared gen
    slot n; a row sees its prompt slots below lens[b] and gen slots up
    to n."""
    q, k, v = qkv_native(p_l, x)
    if cfg.rope:
        pos = (lens + n).to(torch.int32)[:, None]
        cos, sin = rope_tables(pos, cfg.head_dim, cfg.rope_theta, q.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    if 0 <= n < layout.gen_cap:
        _cache_write(
            cache_l, k.transpose(1, 2), v.transpose(1, 2), layout.prefill + n
        )
    prompt_pos, gen_index, is_gen = layout.slot_meta(x.device)
    mask = torch.where(
        is_gen[None, :], gen_index[None, :] <= n,
        prompt_pos[None, :] < lens[:, None],
    )
    out = _cache_attend(cache_l, q, mask[:, None, :])
    y = x + torch.einsum("blhd,hde->ble", out, p_l["wo"])
    return _mlp(p_l, y)
