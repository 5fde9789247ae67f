"""Fused flash attention, both directions: K2, K3 and K4 on Hopper.

Counterpart of ``tpu_patterns/longctx/flash.py`` on one device:

* :func:`flash_block` (K3) — unnormalized (o f32 [Lq, H, D], m, l f32
  [H, Lq]) of q against k/v at global offsets ``q_off``/``k_off`` and
  position step ``pos_stride``;
* :func:`flash_attention` (K2) — the same, normalized, in q's dtype;
* :func:`flash_block_bwd` (K4) — f32 (dq, dk, dv) from the saved
  logsumexp and delta = rowsum(dO * O), score tiles recomputed;
* :func:`flash_attention_diff` — differentiable attention: K3 forward
  plus K4 backward under autograd; without a gradient it runs K2, as the
  reference's ``custom_vjp`` primal does.

On a CUDA tensor each wrapper launches its hand-written kernels
(``longctx/csrc/flash_attention.cu`` for K2/K3,
``longctx/csrc/flash_attention_bwd.cu`` for K4's dq and dk/dv kernels;
by dtype, the wgmma kernels with TMA loads for bfloat16, and for
float32 register-tiled FFMA kernels with cp.async staging, since a
tensor-core f32 product would be TF32; built for sm_90a at first use)
or raises; on a CPU tensor it runs its
plain-torch version (``*_reference``), which rounds at the same points
as the kernels.  There is no other path.  Each launch adds one to its
count in :data:`LAUNCHES`.

Tiles: each kernel takes its own pair from the request (block_q,
block_k) (``tuning._auto_block``; the backward's dq and dk/dv kernels
each theirs, :func:`_bwd_tiles`), and masks a ragged edge itself.  A
float32 request clamped to the lengths must still divide them (the
reference's error); a bfloat16 one need not.  The order in which the
kernels walk their tiles: :func:`bwd_schedule` (bfloat16 backward),
:func:`fwd_schedule` (float32 forward) and :func:`bwd_f32_schedule`
(float32 backward).  ``grid_mode="compact"`` keeps
the reference's validation (causal only; static zero offsets and unit
stride; Lq == Lk for the backward).  The kernels themselves walk each
q-tile's causally live k-tiles only, in ascending order, on both grid
modes, so the two modes launch the same work and give bit-identical
results, as the reference's two grids do by design.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_patterns_torch.longctx.attention import causal_mask
from tpu_patterns_torch.longctx.tuning import (
    BWD_BF16_SIDES,
    BWD_F32_SIDES,
    BWD_STREAM,
    DEFAULT_BLOCK_K,
    DEFAULT_BLOCK_Q,
    FWD_BF16_SIDES,
    FWD_F32_Q_SIDES,
    NEG_INF,
    _auto_block,
    sm_count,
    smem_budget,
)

_KIND = {torch.float32: 0, torch.bfloat16: 1}
_GRID_MODES = ("dense", "compact")

# kernel name -> launches; each wrapper adds one per kernel it launches
LAUNCHES = {
    "flash_attention": 0,  # K2
    "flash_block": 0,  # K3
    "flash_block_bwd_dq": 0,  # K4, dq
    "flash_block_bwd_dkv": 0,  # K4, dk/dv
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- the reference's tile tables ----------------------------------------------


def _causal_pair_table(nq: int, nk: int, bq: int, bk: int) -> torch.Tensor:
    """[4, n_pairs] int32: the causally live (q-tile, k-tile) pairs,
    iq-major / ik-ascending, rows (iq, ik, is_first_of_row,
    is_last_of_row).  The order in which the forward and dq kernels
    visit tiles on either grid mode."""
    rows = []
    for iq in range(nq):
        k_hi = min(nk - 1, ((iq + 1) * bq - 1) // bk)
        for ik in range(k_hi + 1):
            rows.append((iq, ik, int(ik == 0), int(ik == k_hi)))
    return torch.tensor(rows, dtype=torch.int32).reshape(-1, 4).T.contiguous()


def _causal_pair_table_kmajor(nq: int, nk: int, bq: int,
                              bk: int) -> torch.Tensor:
    """jk-major twin of :func:`_causal_pair_table`, rows (jk, iq,
    is_first_of_row, is_last_of_row) with iq ascending: the order of
    the dk/dv kernel."""
    rows = []
    for jk in range(nk):
        live = [iq for iq in range(nq) if (iq + 1) * bq - 1 >= jk * bk]
        for pos, iq in enumerate(live):
            rows.append((jk, iq, int(pos == 0), int(pos == len(live) - 1)))
    return torch.tensor(rows, dtype=torch.int32).reshape(-1, 4).T.contiguous()


# -- the bf16 backward kernels' tile walk -------------------------------------


def _live_k_tiles(causal, q_last, k_off, stride, bk, n):
    """The leading k-tiles of ``bk`` keys (``n`` in all) with a key at or
    before query position ``q_last`` (``live_k_tiles`` in the source)."""
    if not causal:
        return n
    t = 0 if q_last < k_off else (q_last - k_off) // stride // bk + 1
    return min(t, n)


def _first_q_tile(causal, k_pos, q_off, stride, bq, lq):
    """The first q-tile of ``bq`` rows (``lq`` in all) with a row at or
    after key position ``k_pos``; the tile count if none
    (``first_q_tile`` in the source)."""
    if not causal or k_pos <= q_off:
        return 0
    r = (k_pos - q_off + stride - 1) // stride  # the first row that sees it
    return r // bq if r < lq else -(-lq // bq)


def bwd_schedule(kind, lq, lk, bq, bk, causal=True, q_off=0, k_off=0,
                 pos_stride=1):
    """The walk of the bfloat16 backward kernel ``kind`` at tile (bq, bk),
    as ``flash_attention_bwd.cu`` plans it: one (block's tile, [the
    tiles it loads, in order]) per block of a head, in launch order.
    "dq": a block owns a q-tile and loads k-tiles 0 .. its last live
    one, the last q-tiles (the heaviest) first; "dkv": a block owns a
    k-tile and loads q-tiles from its first live one to the last, the
    first k-tiles (the heaviest) first.  Lengths may be ragged."""
    nq, nk = -(-lq // bq), -(-lk // bk)
    if kind == "dq":
        return [(iq, list(range(_live_k_tiles(
                    causal, q_off + (min((iq + 1) * bq, lq) - 1) * pos_stride,
                    k_off, pos_stride, bk, nk))))
                for iq in reversed(range(nq))]
    if kind == "dkv":
        return [(jk, list(range(_first_q_tile(
                    causal, k_off + jk * bk * pos_stride, q_off, pos_stride,
                    bq, lq), nq)))
                for jk in range(nk)]
    raise ValueError(f"unknown backward kernel {kind!r}")


def fwd_schedule(lq, lk, bq, bk, causal=True, q_off=0, k_off=0,
                 pos_stride=1):
    """The walk of the float32 forward kernel at tile (bq, bk) (q-units
    of bq rows, k-tiles of bk keys), as
    ``flash_attention.cu::flash_fwd_f32_kernel`` plans it: per block of
    a head, in launch order, its [(q-unit, [the k-tiles it loads, in
    order])].  Block p takes q-units n - 1 - p and p (the heavier first;
    the middle unit of an odd count alone), each with its k-tiles 0 ..
    its last live one, so a causal triangle's blocks carry equal work.
    Lengths may be ragged."""
    nq, nk = -(-lq // bq), -(-lk // bk)

    def walk(u):
        q_last = q_off + (min((u + 1) * bq, lq) - 1) * pos_stride
        return (u, list(range(_live_k_tiles(causal, q_last, k_off,
                                            pos_stride, bk, nk))))

    return [[walk(u) for u in dict.fromkeys((nq - 1 - p, p))]
            for p in range((nq + 1) // 2)]


def bwd_f32_schedule(kind, lq, lk, bq, bk, causal=True, q_off=0, k_off=0,
                     pos_stride=1):
    """The walk of the float32 backward kernel ``kind`` at its tile (bq,
    bk), as ``flash_attention_bwd.cu``'s ``flash_bwd_{dq,dkv}_f32_kernel``
    plan it: per block of a head, in launch order, its [(unit, [the
    tiles it loads, in order])].  "dq": q-units of bq rows, block p
    taking units n - 1 - p and p, each with its k-tiles 0 .. its last
    live one (the forward's walk, :func:`fwd_schedule`); "dkv": k-units
    of bk keys, block p taking units p and n - 1 - p (the first keys see
    the most rows), each with its q-tiles from its first live one to the
    last.  The heavier unit comes first; the middle unit of an odd count
    alone.  Lengths may be ragged."""
    if kind == "dq":
        return fwd_schedule(lq, lk, bq, bk, causal, q_off, k_off, pos_stride)
    if kind != "dkv":
        raise ValueError(f"unknown backward kernel {kind!r}")
    nq, nk = -(-lq // bq), -(-lk // bk)

    def walk(u):
        return (u, list(range(_first_q_tile(
            causal, k_off + u * bk * pos_stride, q_off, pos_stride, bq, lq),
            nq)))

    return [[walk(u) for u in dict.fromkeys((p, nk - 1 - p))]
            for p in range((nk + 1) // 2)]


# -- plain versions -------------------------------------------------------------


def _scale(d: int, scale: float | None) -> float:
    return float(scale) if scale is not None else d**-0.5


def _mask(lq, lk, q_off, k_off, pos_stride, device) -> torch.Tensor:
    return causal_mask(q_off + torch.arange(lq, device=device) * pos_stride,
                       k_off + torch.arange(lk, device=device) * pos_stride)


def _scores(q, k, q_off, k_off, causal, scale, pos_stride):
    """[H, Lq, Lk] f32 scores, masked to NEG_INF by global position."""
    s = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
    if causal:
        mask = _mask(q.shape[0], k.shape[0], q_off, k_off, pos_stride,
                     q.device)
        s = torch.where(mask[None], s, NEG_INF)
    return s


def flash_block_reference(q, k, v, q_off=0, k_off=0, causal=False,
                          scale=None, pos_stride=1):
    """Plain-torch K3: ``ring_attention._block_fwd_xla`` with the
    kernel's rounding point (p rounded to v's dtype before P V)."""
    scale = _scale(q.shape[-1], scale)
    s = _scores(q, k, q_off, k_off, causal, scale, pos_stride)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * (m[..., None] > NEG_INF / 2)
    l = p.sum(dim=-1)
    o = torch.einsum("hqk,khd->qhd", p.to(v.dtype).float(), v.float())
    return o, m, l


def flash_attention_reference(q, k, v, causal=False, scale=None):
    """Plain-torch K2: K3's triple normalized, in q's dtype."""
    o, _, l = flash_block_reference(q, k, v, 0, 0, causal, scale)
    l = l.transpose(0, 1)[..., None]
    return (o / torch.where(l == 0.0, 1.0, l)).to(q.dtype)


def flash_block_bwd_reference(q, k, v, do, lse, delta, q_off=0, k_off=0,
                              causal=False, scale=None, pos_stride=1):
    """Plain-torch K4: ``ring_attention._block_bwd_xla`` with the
    kernels' rounding points (P to do's dtype before P^T dO, dS to k's
    before dS K and to q's before dS^T Q)."""
    scale = _scale(q.shape[-1], scale)
    s = _scores(q, k, q_off, k_off, causal, scale, pos_stride)
    p = torch.exp(s - lse[..., None])
    dof = do.float()
    dv = torch.einsum("hqk,qhd->khd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("qhd,khd->hqk", dof, v.float())
    ds = p * (dp - delta[..., None])
    dq = scale * torch.einsum("hqk,khd->qhd", ds.to(k.dtype).float(),
                              k.float())
    dk = scale * torch.einsum("hqk,qhd->khd", ds.to(q.dtype).float(),
                              q.float())
    return dq, dk, dv


# -- validation shared by both paths ------------------------------------------


def _check_grid(grid_mode, causal, q_off, k_off, pos_stride, lq, lk,
                need_square):
    if grid_mode not in _GRID_MODES:
        raise ValueError(f"unknown grid_mode {grid_mode!r}")
    if grid_mode == "compact" and causal and not (
        q_off == 0 and k_off == 0 and pos_stride == 1
        and (lq == lk or not need_square)
    ):
        raise ValueError(
            "grid_mode='compact' needs static zero shard offsets, unit "
            "stride" + (", and Lq == Lk" if need_square else "")
            + "; ring shards must use the dense grid"
        )


def _blocks(q, k, kinds, block_q, block_k):
    lq, _, d = q.shape
    lk = k.shape[0]
    bq, bk = _auto_block(lq, lk, d, q.element_size(), kinds, block_q,
                         block_k, smem_budget(q.device), heads=q.shape[1],
                         sms=sm_count(q.device))
    # every kernel masks a ragged edge itself; a float32 request that
    # does not divide the lengths keeps the reference's error
    shown = (min(block_q, lq), min(block_k, lk))
    if q.dtype != torch.bfloat16 and (lq % shown[0] or lk % shown[1]):
        raise ValueError(
            f"block sizes {shown} must divide the sequence lengths "
            f"({lq}, {lk})"
        )
    return bq, bk


def _bwd_tiles(q, k, block_q, block_k) -> dict[str, tuple[int, int]]:
    """K4's (bq, bk) by kernel from the one request, a pair each: the
    bfloat16 kernels' dq (64 or 128, 64) and dk/dv (64, 64 or 128), the
    float32 kernels' dq (32, head_dim) or (64, 64) and dk/dv (head_dim,
    32) or (64, 64)."""
    return {n: _blocks(q, k, (n,), block_q, block_k) for n in ("dq", "dkv")}


# -- kernel launches ------------------------------------------------------------


def _library(name: str) -> ctypes.CDLL:
    """A built flash library with its C signatures declared."""
    from tpu_patterns_torch.kernels.build import load

    lib = load(name)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "flash_attention" and lib.flash_fwd.argtypes is None:
        lib.flash_fwd_smem_bytes.restype = ctypes.c_size_t
        lib.flash_fwd_smem_bytes.argtypes = [i32] * 4
        lib.flash_fwd.restype = i32
        lib.flash_fwd.argtypes = ([i32, i32] + [ptr] * 6 + [i32] * 10
                                  + [f32, ptr])
    if name == "flash_attention_bwd" and lib.flash_bwd_dq.argtypes is None:
        lib.flash_bwd_smem_bytes.restype = ctypes.c_size_t
        lib.flash_bwd_smem_bytes.argtypes = [i32] * 5
        lib.flash_bwd_dq.restype = i32
        lib.flash_bwd_dq.argtypes = ([i32] + [ptr] * 7 + [i32] * 10
                                     + [f32, ptr])
        lib.flash_bwd_dkv.restype = i32
        lib.flash_bwd_dkv.argtypes = ([i32] + [ptr] * 8 + [i32] * 10
                                      + [f32, ptr])
    return lib


def _cuda_inputs(what, q, k, v, *rest):
    """Check the kernels' input contract (q and ``rest`` [Lq, H, D], k
    and v [Lk, H, D], one dtype, contiguous, 16-B aligned); raise on what
    they do not take."""
    if (q.ndim != 3 or k.shape != v.shape or k.shape[1:] != q.shape[1:]
            or any(t.shape != q.shape for t in rest)):
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not fit [L, H, D]")
    tensors = (q, k, v, *rest)
    dev, dt = q.device, q.dtype
    if dt not in _KIND:
        raise ValueError(f"{what}: dtype {dt} not float32/bfloat16")
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{what}: inputs differ in device or dtype")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: inputs must be contiguous and "
                             "16-byte aligned")


def _raise_rc(what, rc, bq, bk, d, smem_bytes):
    """Raise on a failed launch; the card refuses a shared-memory request
    over its per-block limit at cudaFuncSetAttribute."""
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {rc} (tiles "
            f"({bq}, {bk}), D={d}: {smem_bytes()} B of shared memory)"
        )


def _check_fwd_shape(what, dtype, d, bq, bk):
    """Refuse a head_dim or tile the forward kernel of ``dtype`` does not
    take: bfloat16 head_dim 64 or 128 and tiles of 64 or 128 a side,
    float32 head_dim 64 or 128 and tiles (32 or 64, head_dim)."""
    if dtype == torch.bfloat16:
        ok = bq in FWD_BF16_SIDES and bk in FWD_BF16_SIDES
        tiles = f"tiles of {FWD_BF16_SIDES} a side"
    else:
        ok = bq in FWD_F32_Q_SIDES and bk == d
        tiles = f"tiles with block_q in {FWD_F32_Q_SIDES} and block_k = D"
    if d not in (64, 128) or not ok:
        name = str(dtype).removeprefix("torch.")
        raise ValueError(
            f"{what}: the {name} kernel takes head_dim 64 or 128 and "
            f"{tiles}, not D={d}, ({bq}, {bk})")


def _launch_fwd(q, k, v, q_off, k_off, causal, scale, bq, bk, pos_stride,
                emit_stats):
    """K2 or K3.  The kernel is chosen by dtype: bfloat16 runs the wgmma
    kernel, float32 the register-tiled FFMA one (a tensor-core f32
    product would be TF32); :func:`_check_fwd_shape` says what each
    takes.  A failed build or launch raises; neither kernel stands in
    for the other."""
    what = "flash_block" if emit_stats else "flash_attention"
    _cuda_inputs(what, q, k, v)
    lq, h, d = q.shape
    _check_fwd_shape(what, q.dtype, d, bq, bk)
    lk = k.shape[0]
    dev = q.device
    if emit_stats:
        o = torch.empty((lq, h, d), dtype=torch.float32, device=dev)
        m = torch.empty((h, lq), dtype=torch.float32, device=dev)
        l = torch.empty((h, lq), dtype=torch.float32, device=dev)
    else:
        o = torch.empty_like(q)
        m = l = None
    lib = _library("flash_attention")
    rc = lib.flash_fwd(
        _KIND[q.dtype], int(emit_stats), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), m.data_ptr() if emit_stats else None,
        l.data_ptr() if emit_stats else None, lq, lk, h, d, bq, bk,
        int(causal), int(q_off), int(k_off), int(pos_stride), scale,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_rc(what, rc, bq, bk, d, lambda: lib.flash_fwd_smem_bytes(
        q.element_size(), bq, bk, d))
    LAUNCHES[what] += 1
    return (o, m, l) if emit_stats else o


def _bwd_legal(dtype, d) -> dict[str, set[tuple[int, int]]]:
    """The (bq, bk) tiles each backward kernel of ``dtype`` takes at
    head_dim ``d`` (64 or 128): bfloat16 dq (64 or 128, 64) and dk/dv
    (64, 64 or 128); float32 dq (32, d) or (64, 64) and dk/dv (d, 32) or
    (64, 64)."""
    if dtype == torch.bfloat16:
        return {"dq": {(s, BWD_STREAM) for s in BWD_BF16_SIDES},
                "dkv": {(BWD_STREAM, s) for s in BWD_BF16_SIDES}}
    dq = {(s, 64 if s == 64 else d) for s in BWD_F32_SIDES}
    return {"dq": dq, "dkv": {(b, a) for a, b in dq}}


def _launch_bwd(q, k, v, do, lse, delta, q_off, k_off, causal, scale, tiles,
                pos_stride, kernels=("dq", "dkv")):
    """K4's two kernels in order, each at its pair of ``tiles`` (see
    :func:`_bwd_tiles`).  The kernels are chosen by dtype: bfloat16 runs
    the wgmma kernels, float32 the register-tiled FFMA ones; both take
    head_dim 64 or 128 and the tiles :func:`_bwd_legal` lists, and
    anything else raises, as does a failed build or launch; neither
    stands in for the other.  ``kernels`` names a subset to time one
    alone (the outputs of a kernel left out stay uninitialized)."""
    _cuda_inputs("flash_block_bwd", q, k, v, do)
    lq, h, d = q.shape
    legal = _bwd_legal(q.dtype, d)
    if d not in (64, 128) or any(tuple(tiles[n]) not in legal[n]
                                 for n in kernels):
        name = str(q.dtype).removeprefix("torch.")
        raise ValueError(
            f"flash_block_bwd: the {name} kernels take head_dim 64 or 128 "
            f"and tiles dq {sorted(legal['dq'])}, dk/dv "
            f"{sorted(legal['dkv'])}, not D={d}, {tiles}")
    lk = k.shape[0]
    stats = [t.contiguous().float() for t in (lse, delta)]
    for t in stats:
        if t.shape != (h, lq) or t.device != q.device:
            raise ValueError("flash_block_bwd: lse/delta must be [H, Lq] "
                             "on q's device")
    lse, delta = stats
    dq = torch.empty((lq, h, d), dtype=torch.float32, device=q.device)
    dk = torch.empty((lk, h, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    lib = _library("flash_attention_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr())
    for which, name, outs in ((0, "dq", (dq,)), (1, "dkv", (dk, dv))):
        if name not in kernels:
            continue
        bq, bk = tiles[name]
        fn = lib.flash_bwd_dq if which == 0 else lib.flash_bwd_dkv
        rc = fn(_KIND[q.dtype], *ins, *(t.data_ptr() for t in outs), lq, lk,
                h, d, bq, bk, int(causal), int(q_off), int(k_off),
                int(pos_stride), scale, stream)
        _raise_rc(f"flash_block_bwd {name}", rc, bq, bk, d,
                  lambda: lib.flash_bwd_smem_bytes(which, q.element_size(),
                                                   bq, bk, d))
        LAUNCHES[f"flash_block_bwd_{name}"] += 1
    return dq, dk, dv


def _on_cuda(what, q) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {q.device}")
    return True


# -- wrappers -----------------------------------------------------------------------


def flash_block(q, k, v, q_off: int = 0, k_off: int = 0, causal=False,
                scale=None, block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K,
                pos_stride: int = 1, grid_mode="dense"):
    """K3: the (o, m, l) partial triple (o unnormalized f32 [Lq, H, D];
    m, l f32 [H, Lq]) of q [Lq, H, D] against k, v [Lk, H, D], masked by
    global position (query i at ``q_off + i * pos_stride``, key j at
    ``k_off + j * pos_stride``) when ``causal``."""
    lq, _, d = q.shape
    scale = _scale(d, scale)
    _check_grid(grid_mode, causal, q_off, k_off, pos_stride, lq,
                k.shape[0], need_square=False)
    bq, bk = _blocks(q, k, ("fwd",), block_q, block_k)
    if not _on_cuda("flash_block", q):
        return flash_block_reference(q, k, v, q_off, k_off, causal, scale,
                                     pos_stride)
    return _launch_fwd(q, k, v, q_off, k_off, causal, scale, bq, bk,
                       pos_stride, emit_stats=True)


def flash_attention(q, k, v, causal=False, scale=None,
                    block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K,
                    grid_mode="dense"):
    """K2: fused softmax attention of q [Lq, H, D] against k, v
    [Lk, H, D], normalized, in q's dtype."""
    lq, _, d = q.shape
    scale = _scale(d, scale)
    _check_grid(grid_mode, causal, 0, 0, 1, lq, k.shape[0],
                need_square=False)
    bq, bk = _blocks(q, k, ("fwd",), block_q, block_k)
    if not _on_cuda("flash_attention", q):
        return flash_attention_reference(q, k, v, causal, scale)
    return _launch_fwd(q, k, v, 0, 0, causal, scale, bq, bk, 1,
                       emit_stats=False)


def flash_block_bwd(q, k, v, do, lse, delta, q_off: int = 0,
                    k_off: int = 0, causal=False, scale=None, block_q=512,
                    block_k=512, pos_stride: int = 1, grid_mode="dense"):
    """K4: f32 (dq, dk, dv) of one (q-shard, kv-shard) pair.  q, do
    [Lq, H, D]; k, v [Lk, H, D]; lse, delta f32 [H, Lq] (the rows'
    global logsumexp and rowsum(dO * O)).  Offsets as
    :func:`flash_block`.  One request (block_q, block_k) serves both
    kernels, each its own pair (:func:`_bwd_tiles`)."""
    lq, _, d = q.shape
    scale = _scale(d, scale)
    _check_grid(grid_mode, causal, q_off, k_off, pos_stride, lq,
                k.shape[0], need_square=True)
    tiles = _bwd_tiles(q, k, block_q, block_k)
    if not _on_cuda("flash_block_bwd", q):
        return flash_block_bwd_reference(q, k, v, do, lse, delta, q_off,
                                         k_off, causal, scale, pos_stride)
    return _launch_bwd(q, k, v, do, lse, delta, q_off, k_off, causal,
                       scale, tiles, pos_stride)


def _row_stats(o_unnorm, m, l):
    """(out, lse) from K3's triple: normalize; lse = m + log l, pinned to
    0 on wholly masked rows (their exp(NEG_INF - 0) is exactly 0)."""
    safe_l = torch.where(l == 0.0, 1.0, l)
    out = o_unnorm / safe_l.transpose(0, 1)[..., None]
    lse = torch.where(l == 0.0, 0.0, m + torch.log(safe_l))
    return out, lse


def _delta(do, out):
    """delta_i = rowsum(dO_i * O_i): [H, Lq] f32."""
    return torch.einsum("qhd,qhd->hq", do.float(), out.float())


class _FlashAttentionDiff(torch.autograd.Function):
    """K3 forward saving (q, k, v, out, lse); K4 backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k, grid_mode):
        o_un, m, l = flash_block(q, k, v, 0, 0, causal=causal, scale=scale,
                                 block_q=block_q, block_k=block_k,
                                 grid_mode=grid_mode)
        out, lse = _row_stats(o_un, m, l)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, block_q, block_k, grid_mode)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, block_q, block_k, grid_mode = ctx.args
        g = g.contiguous()
        dq, dk, dv = flash_block_bwd(
            q, k, v, g, lse, _delta(g, out), causal=causal, scale=scale,
            block_q=block_q, block_k=block_k, grid_mode=grid_mode,
        )
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None)


def flash_attention_diff(q, k, v, causal=False, scale=None,
                         block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K,
                         grid_mode="dense"):
    """Differentiable flash attention of q [Lq, H, D] against k, v
    [Lk, H, D], in q's dtype.  Under autograd (grad mode on and an input
    that requires grad) the forward is K3 and the backward K4, O(L)
    memory both ways; otherwise it is K2, the reference's primal."""
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v)
    ):
        return _FlashAttentionDiff.apply(q, k, v, causal, scale, block_q,
                                         block_k, grid_mode)
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           block_q=block_q, block_k=block_k,
                           grid_mode=grid_mode)
