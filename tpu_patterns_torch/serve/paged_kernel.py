"""Fused paged attention: the serve decode hot op.

``paged_block`` computes one layer's attention of q [B, W, H, D] against
each row's pool pages, read through the block tables with no gathered
window, and returns the unnormalized (o, m, l) triple; ``paged_attend``
normalizes it and regroups the heads.  On a CUDA tensor ``paged_block``
launches the hand-written kernel ``csrc/paged_attention.cu`` (built for
sm_90a at first use) or raises; on a CPU tensor it runs
:func:`paged_block_reference`, the same function in plain torch.  There
is no other path.

Counterpart of ``tpu_patterns/serve/paged_kernel.py`` (``paged_block``,
``paged_attend``) on one device: query rows regroup g-major to
[B, Hkv, G*W, D] (row r is query ``r % W`` of group ``r // W``),
causality is by global position (query w at ``pos0 + w``), pages that
are TRASH, belong to an inactive row or lie wholly in the future are
skipped, and int8 pools dequantize inside the math (k's scale on the
score, v's on the probability after the normalizer sums).
"""

from __future__ import annotations

import ctypes

import torch

TRASH_BLOCK = 0  # block 0 is the write sink (serve/paged.py contract)
NEG_INF = -1e30  # masked score, as longctx/tuning.py's NEG_INF

_KERNEL_D = (32, 64, 128, 256)
_Q_KIND = {torch.float32: 0, torch.bfloat16: 1}
_KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _regroup_q(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """[B, W, H, D] -> [B, Hkv, G*W, D], g-major rows."""
    b, w, h, d = q.shape
    g = h // hkv
    return q.reshape(b, w, hkv, g, d).permute(0, 2, 3, 1, 4).reshape(
        b, hkv, g * w, d
    )


def paged_block_reference(
    q, k, v, tables, pos0, active, *, block_len, k_scale=None, v_scale=None
):
    """Plain-torch K1: the kernel's function by gather, in float32, with
    the kernel's masks and order of scaling.  Shapes as
    :func:`paged_block`."""
    b, w, h, d = q.shape
    n_blocks, bl, hkv, _ = k.shape
    n_pages = tables.shape[1]
    gw = (h // hkv) * w
    dev = q.device
    tb = tables.clamp(0, n_blocks - 1).long()

    def window(leaf):  # [n_blocks, bl, Hkv, ...] -> [B, Hkv, n_pages*bl, ...]
        g = leaf[tb].to(torch.float32)  # [B, n_pages, bl, Hkv, ...]
        g = g.movedim(3, 1)
        return g.reshape(b, hkv, n_pages * bl, *g.shape[4:])

    qt = _regroup_q(q, hkv).to(torch.float32)
    s = qt @ window(k).transpose(-1, -2) * d**-0.5  # [B, Hkv, GW, L]
    if k_scale is not None:
        s = s * window(k_scale)[:, :, None, :]
    j = torch.arange(n_pages, device=dev)
    live = (
        (tb != TRASH_BLOCK)
        & active.to(torch.bool)[:, None]
        & (j[None, :] * block_len <= pos0[:, None] + w - 1)
    )  # [B, n_pages]
    live = live.repeat_interleave(bl, dim=1)  # [B, L]
    k_pos = torch.arange(n_pages * bl, device=dev)
    q_pos = pos0[:, None] + torch.arange(gw, device=dev)[None, :] % w
    visible = (k_pos[None, None, :] <= q_pos[:, :, None]) & live[:, None, :]
    s = torch.where(visible[:, None], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * (m > NEG_INF / 2)[..., None]
    l = p.sum(dim=-1)
    if v_scale is not None:
        p = p * window(v_scale)[:, :, None, :]
    o = p @ window(v)
    return o, m, l


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_block: {msg}")


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from tpu_patterns_torch.kernels.build import load

    lib = load("paged_attention")
    if lib.paged_attention.argtypes is None:
        lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib.paged_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.paged_attention.restype = ctypes.c_int
        lib.paged_attention.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11
            + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        )
    return lib


def _launch_kernel(q, k, v, tables, pos0, active, block_len, k_scale,
                   v_scale):
    b, w, h, d = q.shape
    n_blocks, bl, hkv, _ = k.shape
    n_pages = tables.shape[1]
    int8 = k.dtype == torch.int8
    dev = q.device
    _check(q.dtype in _Q_KIND, f"q dtype {q.dtype} not float32/bfloat16")
    _check(k.dtype in _KV_KIND, f"pool dtype {k.dtype} not supported")
    _check(int8 or k.dtype == q.dtype, "float pool dtype must match q's")
    _check(v.dtype == k.dtype and v.shape == k.shape, "k/v pools differ")
    _check(d in _KERNEL_D, f"head_dim {d} not in {_KERNEL_D}")
    _check(h % hkv == 0 and k.shape[3] == d, "head counts or head_dim")
    _check(bl == block_len, f"pool block {bl} != block_len {block_len}")
    _check(tables.dtype == torch.int32 and tables.shape[0] == b,
           "tables must be int32 [B, n_pages]")
    _check(pos0.dtype == torch.int32 and pos0.shape == (b,),
           "pos0 must be int32 [B]")
    _check(active.dtype == torch.bool and active.shape == (b,),
           "active must be bool [B]")
    tensors = [q, k, v, tables, pos0, active]
    if int8:
        _check(k_scale is not None and v_scale is not None,
               "int8 pools need k_scale and v_scale")
        _check(k_scale.dtype == torch.float32
               and k_scale.shape == k.shape[:3]
               and v_scale.shape == k.shape[:3]
               and v_scale.dtype == torch.float32,
               "scales must be float32 [n_blocks, bl, Hkv]")
        tensors += [k_scale, v_scale]
    for t in tensors:
        _check(t.device == dev, f"tensor on {t.device}, q on {dev}")
        _check(t.is_contiguous(), "inputs must be contiguous")
    lib = _library()
    gw = (h // hkv) * w
    o = torch.empty((b, hkv, gw, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, hkv, gw), dtype=torch.float32, device=dev)
    l = torch.empty((b, hkv, gw), dtype=torch.float32, device=dev)
    rc = lib.paged_attention(
        _Q_KIND[q.dtype], _KV_KIND[k.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None,
        tables.data_ptr(), pos0.data_ptr(), active.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, w, h, hkv, d, n_blocks, bl, n_pages, d**-0.5,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        # the card refuses a shared-memory request over its per-block
        # limit here (cudaFuncSetAttribute in the C entry)
        smem = lib.paged_attention_smem_bytes(gw, d, bl)
        raise RuntimeError(
            f"paged_attention kernel launch failed: CUDA error {rc} "
            f"(G*W={gw}, D={d}, block_len={bl}: {smem} B of shared memory)"
        )
    return o, m, l


def paged_block(
    q, k, v, tables, pos0, active, *, block_len, k_scale=None, v_scale=None
):
    """One layer's unnormalized paged attention:
    (o [B, Hkv, G*W, D] f32, m [B, Hkv, G*W] f32, l [B, Hkv, G*W] f32).

    q [B, W, H, D] (query w of row b at global position ``pos0[b] + w``);
    k/v one layer's pool leaves [n_blocks, block_len, Hkv, D] (int8 with
    ``k_scale``/``v_scale`` [n_blocks, block_len, Hkv] float32); tables
    [B, n_pages] int32 physical block ids; pos0 [B] int32; active [B]
    bool.  CPU tensors run :func:`paged_block_reference`; CUDA tensors
    launch the kernel (counted in ``paged_block.launches``) or raise."""
    if q.device.type == "cpu":
        return paged_block_reference(
            q, k, v, tables, pos0, active, block_len=block_len,
            k_scale=k_scale, v_scale=v_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_block: no kernel for device {q.device}")
    out = _launch_kernel(
        q, k, v, tables, pos0, active, block_len, k_scale, v_scale
    )
    paged_block.launches += 1
    return out


paged_block.launches = 0


def paged_attend(pool_l: dict, q, tables, pos0, active, layout):
    """Drop-in for ``paged._pool_attend`` on the decode hot path: fused
    attention of q [B, W, H, D] against the rows' page windows,
    normalized and regrouped to [B, W, H, D] in q's dtype.  A row with no
    visible slot keeps m == NEG_INF; the guard makes its output exactly
    0."""
    b, w, h, d = q.shape
    o, m, l = paged_block(
        q.contiguous(), pool_l["k"], pool_l["v"], tables, pos0, active,
        block_len=layout.block_len,
        k_scale=pool_l.get("ks"), v_scale=pool_l.get("vs"),
    )
    alpha = torch.exp(m - torch.clamp_min(m, NEG_INF / 2))
    l = l * alpha
    o = o * alpha[..., None]
    out = o / torch.clamp_min(l, 1e-30)[..., None]  # [B, Hkv, G*W, D]
    hkv = out.shape[1]
    out = out.reshape(b, hkv, h // hkv, w, d).permute(0, 3, 1, 2, 4)
    return out.reshape(b, w, h, d).to(q.dtype)
