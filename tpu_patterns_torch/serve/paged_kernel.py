"""Fused paged attention: the serve decode hot op.

``paged_block`` computes one layer's attention of q [B, W, H, D] against
each row's pool pages, read through the block tables with no gathered
window, and returns the unnormalized (o, m, l) triple;
``serve/paged.py::paged_attend`` combines an sp group's triples,
normalizes and regroups the heads.  On a CUDA tensor ``paged_block``
launches the hand-written kernel ``csrc/paged_attention.cu`` (built for
sm_90a at first use) or raises; on a CPU tensor it runs
:func:`paged_block_reference`, the same function in plain torch.  There
is no other path.

The kernel splits each row's pages into groups of :func:`split_pages`
pages, one thread block each, and merges the splits' partial triples in
the same launch; :func:`paged_block_split_reference` computes the same
partials and merge in plain torch, so that the split and combine math
is testable on the CPU (nothing on the serve path calls it).

Counterpart of ``tpu_patterns/serve/paged_kernel.py`` (``paged_block``,
``paged_attend``): query rows regroup g-major to [B, Hkv, G*W, D] (row r
is query ``r % W`` of group ``r // W``), causality is by global position
(query w at ``pos0 + w``), pages that are TRASH, belong to an inactive
row or lie wholly in the future are skipped, and int8 pools dequantize
inside the math (k's scale on the score, v's on the probability after
the normalizer sums).

Over sp ranks each rank holds a stripe of every block: a shard pool
[n_blocks, bl_loc, Hkv, D] with ``bl_loc = block_len / sp``, whose slot
s of page j sits at global position ``j * block_len + rank * bl_loc +
s``.  ``paged_block`` takes the rank and computes that shard's partial
triple.
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


def _masked_scores(q, k, tables, pos0, active, block_len, k_scale, rank=0):
    """The kernel's masked scores [B, Hkv, G*W, n_pages*bl] in float32
    (NEG_INF where a key is not visible) and the window gather it reads
    the pool through; ``bl`` is the pool's block, sp rank ``rank``'s
    stripe of each ``block_len``-slot block."""
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
    # each page's first key position: its block's, plus this stripe's
    first = torch.arange(n_pages, device=dev) * block_len + rank * bl
    live = (
        (tb != TRASH_BLOCK)
        & active.to(torch.bool)[:, None]
        & (first[None, :] <= pos0[:, None] + w - 1)
    )  # [B, n_pages]
    live = live.repeat_interleave(bl, dim=1)  # [B, L]
    k_pos = (first[:, None] + torch.arange(bl, device=dev)).reshape(-1)
    q_pos = pos0[:, None] + torch.arange(gw, device=dev)[None, :] % w
    visible = (k_pos[None, None, :] <= q_pos[:, :, None]) & live[:, None, :]
    return torch.where(visible[:, None], s, NEG_INF), window


def _softmax_triple(s, v_win, vs_win):
    """Unnormalized (o, m, l) of masked scores s [..., L] against v rows
    [..., L, D] (v scales [..., L] or None), the kernel's order."""
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * (m > NEG_INF / 2)[..., None]
    l = p.sum(dim=-1)
    if vs_win is not None:
        p = p * vs_win
    return p @ v_win, m, l


def paged_block_reference(
    q, k, v, tables, pos0, active, *, block_len, rank=0, k_scale=None,
    v_scale=None,
):
    """Plain-torch K1: the kernel's function by gather, in float32, with
    the kernel's masks and order of scaling.  Shapes as
    :func:`paged_block`."""
    s, window = _masked_scores(q, k, tables, pos0, active, block_len,
                               k_scale, rank)
    vs = window(v_scale)[:, :, None, :] if v_scale is not None else None
    return _softmax_triple(s, window(v), vs)


def paged_block_split_reference(
    q, k, v, tables, pos0, active, *, block_len, pages_per_split, rank=0,
    k_scale=None, v_scale=None,
):
    """Plain-torch K1 by the kernel's own algorithm: each split of
    ``pages_per_split`` pages (:func:`split_plan`) gives a partial
    (o_i, m_i, l_i) over its keys, then m = max m_i, l = sum l_i
    exp(m_i - m), o = sum o_i exp(m_i - m), guarded so that a row that
    sees nothing keeps m = NEG_INF, l = 0, o = 0.  Equal to
    :func:`paged_block_reference` up to float32 rounding."""
    s, window = _masked_scores(q, k, tables, pos0, active, block_len,
                               k_scale, rank)
    v_win = window(v)
    vs_win = window(v_scale) if v_scale is not None else None
    bl = k.shape[1]
    parts = []
    for start, stop in split_plan(tables.shape[1], pages_per_split):
        keys = slice(start * bl, stop * bl)
        vs = vs_win[:, :, None, keys] if vs_win is not None else None
        parts.append(_softmax_triple(s[..., keys], v_win[:, :, keys], vs))
    o_i, m_i, l_i = (torch.stack(x) for x in zip(*parts))
    m = m_i.amax(dim=0)
    a = torch.exp(m_i - m) * (m > NEG_INF / 2)
    return (a[..., None] * o_i).sum(dim=0), m, (a * l_i).sum(dim=0)


# K and V bytes a block stages into shared memory at once: 64 slots of a
# bf16 head row of 128 (csrc/paged_attention.cu's design note)
STAGE_BYTES = 32 * 1024
# A split holds at most this many stages, and lengthens only while the
# grid keeps WAVE_BLOCKS blocks an SM
MAX_STAGES = 4
WAVE_BLOCKS = 4


def stage_pages(block_len, row_bytes):
    """Whole pages of K and V head rows of ``row_bytes`` that fit
    ``STAGE_BYTES`` (at least one)."""
    return max(1, STAGE_BYTES // (2 * row_bytes) // block_len)


def split_pages(n_pages, block_len, b, hkv, row_bytes, sms):
    """Pages a split of the kernel takes, from shapes alone (never the
    tables or positions, whose read would sync the host): one stage
    (:func:`stage_pages`), doubled up to ``MAX_STAGES`` stages while the
    grid of b x hkv x splits blocks keeps ``WAVE_BLOCKS`` blocks on each
    of the ``sms`` SMs, halved while it would leave an SM without one."""
    def blocks(pps):
        return b * hkv * -(-n_pages // pps)

    sp = min(n_pages, stage_pages(block_len, row_bytes))
    pps = sp
    while (2 * pps <= min(n_pages, MAX_STAGES * sp)
           and blocks(2 * pps) >= WAVE_BLOCKS * sms):
        pps *= 2
    while pps > 1 and blocks(pps) < sms:
        pps = -(-pps // 2)
    return pps


def split_plan(n_pages, pages_per_split):
    """The kernel's splits as (first page, stop page), in order: split i
    takes pages [i * pps, min((i + 1) * pps, n_pages))."""
    return [(p, min(p + pages_per_split, n_pages))
            for p in range(0, n_pages, pages_per_split)]


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"paged_block: {msg}")


def _library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    from tpu_patterns_torch.kernels.build import load

    lib = load("paged_attention")
    if lib.paged_attention.argtypes is None:
        lib.paged_attention_smem_bytes.restype = ctypes.c_size_t
        lib.paged_attention_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.paged_attention.restype = ctypes.c_int
        lib.paged_attention.argtypes = (
            [ctypes.c_int] * 2 + [ctypes.c_void_p] * 13
            + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p]
        )
    return lib


_SMS: dict[int, int] = {}
# (device index, stream) -> (split counters int32, partials float32): the
# kernel leaves its counters 0, so one launch after another on a stream
# reuses them; a larger call grows them
_WORKSPACE: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _sm_count(dev: torch.device) -> int:
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def _workspace(dev, stream, n_count, n_part):
    key = (dev.index, stream)
    count, part = _WORKSPACE.get(key, (None, None))
    if count is None or count.numel() < n_count:
        count = torch.zeros(n_count, dtype=torch.int32, device=dev)
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=dev)
    _WORKSPACE[key] = (count, part)
    return count, part


def _launch_kernel(q, k, v, tables, pos0, active, block_len, rank, k_scale,
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
    _check(block_len % bl == 0 and 0 <= rank < block_len // bl,
           f"pool block {bl} is no stripe {rank} of block_len {block_len}")
    _check(tables.dtype == torch.int32 and tables.shape[0] == b
           and n_pages >= 1, "tables must be int32 [B, n_pages >= 1]")
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
    # the kernel stages head rows by 16-byte copies
    _check(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
           "k/v pools must be 16-byte aligned")
    lib = _library()
    gw = (h // hkv) * w
    row_bytes = d * k.element_size()
    pps = split_pages(n_pages, bl, b, hkv, row_bytes, _sm_count(dev))
    sp = min(pps, stage_pages(bl, row_bytes))
    splits = -(-n_pages // pps)
    stream = torch.cuda.current_stream(dev).cuda_stream
    count, part = _workspace(dev, stream, b * hkv,
                             b * hkv * splits * gw * (d + 2))
    o = torch.empty((b, hkv, gw, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, hkv, gw), dtype=torch.float32, device=dev)
    l = torch.empty((b, hkv, gw), dtype=torch.float32, device=dev)
    rc = lib.paged_attention(
        _Q_KIND[q.dtype], _KV_KIND[k.dtype],
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None,
        tables.data_ptr(), pos0.data_ptr(), active.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), part.data_ptr(),
        count.data_ptr(),
        b, w, h, hkv, d, n_blocks, bl, n_pages, pps, sp, block_len, rank,
        d**-0.5, stream,
    )
    if rc != 0:
        # the card refuses a shared-memory request over its per-block
        # limit here (cudaFuncSetAttribute in the C entry)
        smem = lib.paged_attention_smem_bytes(gw, d, _KV_KIND[k.dtype], bl,
                                              pps, sp)
        raise RuntimeError(
            f"paged_attention kernel launch failed: CUDA error {rc} "
            f"(G*W={gw}, D={d}, block_len={bl}, {pps} pages a split in "
            f"stages of {sp}: {smem} B of shared memory)"
        )
    return o, m, l


def paged_block(
    q, k, v, tables, pos0, active, *, block_len, rank=0, k_scale=None,
    v_scale=None,
):
    """One layer's unnormalized paged attention on one shard:
    (o [B, Hkv, G*W, D] f32, m [B, Hkv, G*W] f32, l [B, Hkv, G*W] f32).

    q [B, W, H, D] (query w of row b at global position ``pos0[b] + w``);
    k/v one layer's pool leaves [n_blocks, bl_loc, Hkv, D], sp rank
    ``rank``'s stripe of every ``block_len``-slot block (``bl_loc =
    block_len`` and rank 0 unsharded; int8 with ``k_scale``/``v_scale``
    [n_blocks, bl_loc, Hkv] float32); tables [B, n_pages] int32 physical
    block ids; pos0 [B] int32; active [B] bool.  CPU tensors run
    :func:`paged_block_reference`; CUDA tensors launch the kernel
    (counted in ``paged_block.launches``) or raise."""
    if q.device.type == "cpu":
        return paged_block_reference(
            q, k, v, tables, pos0, active, block_len=block_len, rank=rank,
            k_scale=k_scale, v_scale=v_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_block: no kernel for device {q.device}")
    out = _launch_kernel(
        q, k, v, tables, pos0, active, block_len, rank, k_scale, v_scale
    )
    paged_block.launches += 1
    return out


paged_block.launches = 0
