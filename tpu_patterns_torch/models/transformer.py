"""Model config, parameter layout, q/k/v projections, RoPE, and the
train step over a dp x sp x tp rank mesh.

Counterpart of ``tpu_patterns/models/transformer.py``: the block's
parameters (fused MHA ``wqkv`` or split GQA ``wq``/``wkv``; the dense
MLP ``w1``/``w2`` or the top-1 mixture ``wg``/``we1``/``we2``), their
fan-in scaled init and their layout over the mesh (``param_specs``,
``shard_params``, ``gather_params``), the native-head-count projections
and rotary embeddings (the serve path), and the block forward, the
mean-square objective and the SGD train step (the flagship path).
Parameters are a dict of tensors with a leading ``[depth]`` axis on
every block leaf.

Where the reference runs one program a device inside ``shard_map``,
the mesh functions here take per-rank lists over a
``comm/mesh.py::NamedMesh`` with axes ("dp", "sp", "tp"): a sharded
parameter is a dict of per-rank lists, a batch the list of each rank's
[B/dp, L/sp, E] shard (replicated over tp).  Heads and the MLP hidden
are tp-local; attention over each sp group is the ring
(``longctx/ring_attention.py``: "kernel" the fused ring, K3 forward and
K4 backward, "dense" the plain ring); the row-parallel products are
summed over each tp group by ``comm/ring.py::library_allreduce``, whose
copies carry gradients.  Autograd runs over the whole world at once;
the objective counts each (dp, sp) shard's tokens once (tp rank 0's
replica), and each leaf's gradient is then summed over the ranks that
hold a replica of its block, the explicit counterpart of the
reference's psum transposes.  One rank (``mesh=None``) is the one-device
step on a dict and a tensor.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.utils.checkpoint

from tpu_patterns_torch.comm.mesh import NamedMesh, RankMesh
from tpu_patterns_torch.comm.ring import library_allreduce
from tpu_patterns_torch.longctx.attention import attention_reference
from tpu_patterns_torch.longctx.flash import flash_attention_diff
from tpu_patterns_torch.longctx.ring_attention import ring_attention
from tpu_patterns_torch.longctx.tuning import load_tuned_blocks
from tpu_patterns_torch.parallel.moe import (
    build_dispatch,
    build_dispatch_column,
    capacity,
    top1_route,
)
from tpu_patterns_torch.runtime import torch_dtype

MESH_AXES = ("dp", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    embed: int = 128
    heads: int = 8
    head_dim: int = 16
    mlp_mult: int = 4
    dtype: str = "float32"
    depth: int = 1
    # grouped-query attention: K/V heads (0 = heads, the MHA layout with
    # the fused wqkv parameter)
    kv_heads: int = 0
    rope: bool = False
    rope_theta: float = 10000.0
    # the top-1 mixture FFN in place of the MLP, one expert a tp rank
    # (ep = tp; n_experts = the tp size)
    moe: bool = False
    # per-expert capacity C = ceil(cf * T / n_experts); <= 0 is exact
    # routing (C = T); overflow tokens pass on the residual only
    capacity_factor: float = 0.0
    # -- the train step's fields --
    causal: bool = True
    # attention of the train step: "dense" is the reference's "xla"
    # (attention_reference; the plain ring at sp > 1), "kernel" the fused
    # flash kernels both ways (flash_attention_diff; the fused ring, K3
    # and K4, at sp > 1; the reference's "pallas")
    attn: str = "dense"
    # sequence layout over sp: "contiguous" token blocks, or "striped"
    # (shard r holds tokens r::sp; the caller feeds x already striped)
    attn_layout: str = "contiguous"
    # checkpoint each block (torch.utils.checkpoint): FLOPs for memory
    remat: bool = False
    # "full" saves nothing in a block; "dots" saves the projection and
    # MLP products and recomputes attention and the elementwise work
    remat_policy: str = "full"
    # flash tile request; None resolves from longctx/flash_tuned.json or
    # the hand-picked squares (longctx.tuning.load_tuned_blocks)
    block_q: int | None = None
    block_k: int | None = None
    # causal grid of the flash path: "dense" | "compact" (the same
    # launches and results here; see longctx/flash.py)
    attn_grid: str = "dense"

    def __post_init__(self):
        if self.kv_heads and self.heads % self.kv_heads:
            raise ValueError(
                f"heads {self.heads} must divide by kv_heads {self.kv_heads}"
            )
        torch_dtype(self.dtype)  # reject an unknown dtype at build time
        if self.attn not in ("dense", "kernel"):
            raise ValueError(f"unknown attn {self.attn!r}; want dense|kernel")
        if self.attn_layout not in ("contiguous", "striped"):
            raise ValueError(f"unknown attn_layout {self.attn_layout!r}")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; want full|dots"
            )
        if self.attn_grid not in ("dense", "compact"):
            raise ValueError(f"unknown attn_grid {self.attn_grid!r}")
        if self.block_q is None or self.block_k is None:
            bq, bk = load_tuned_blocks()
            if self.block_q is None:
                object.__setattr__(self, "block_q", bq)
            if self.block_k is None:
                object.__setattr__(self, "block_k", bk)

    @property
    def mlp_hidden(self) -> int:
        return self.embed * self.mlp_mult

    @property
    def n_kv(self) -> int:
        """K/V heads actually stored (heads for MHA)."""
        return self.kv_heads or self.heads

    @property
    def group_size(self) -> int:
        """Query heads per K/V head (1 = MHA)."""
        return self.heads // self.n_kv

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)


def _layer_specs(cfg: ModelConfig, n_experts: int = 0
                 ) -> dict[str, tuple[tuple[int, ...], tuple]]:
    """Per-layer (shape, spec) in init order: the reference's
    ``param_specs`` at depth 1 (tp splits heads, the MLP hidden and the
    experts; the gate is replicated)."""
    e, h, d, f = cfg.embed, cfg.heads, cfg.head_dim, cfg.mlp_hidden
    if cfg.kv_heads:
        specs = {
            "wq": ((e, h, d), (None, "tp", None)),
            "wkv": ((2, e, cfg.kv_heads, d), (None, None, "tp", None)),
            "wo": ((h, d, e), ("tp", None, None)),
        }
    else:
        specs = {"wqkv": ((3, e, h, d), (None, None, "tp", None)),
                 "wo": ((h, d, e), ("tp", None, None))}
    if cfg.moe:
        if n_experts < 1:
            raise ValueError("moe=True needs n_experts (= the tp size)")
        specs.update({
            "wg": ((e, n_experts), (None, None)),
            "we1": ((n_experts, e, f), ("tp", None, None)),
            "we2": ((n_experts, f, e), ("tp", None, None)),
        })
    else:
        specs.update({"w1": ((e, f), (None, "tp")),
                      "w2": ((f, e), ("tp", None))})
    return specs


def param_shapes(cfg: ModelConfig, n_experts: int = 0
                 ) -> dict[str, tuple[int, ...]]:
    """Per-layer parameter shapes (no depth axis), in init order."""
    return {k: s for k, (s, _) in _layer_specs(cfg, n_experts).items()}


def param_specs(cfg: ModelConfig, n_experts: int = 0, lead: str | None = None
                ) -> dict[str, tuple[tuple[int, ...], tuple]]:
    """Each leaf's global shape, with the leading ``[depth]`` axis, and
    its spec: the mesh axis each dimension splits over (None:
    replicated).  ``lead="pp"`` splits the leading axis over the
    pipeline stages (the reference's ``stack_specs``)."""
    return {k: ((cfg.depth, *shape), (lead, *spec))
            for k, (shape, spec) in _layer_specs(cfg, n_experts).items()}


def n_experts(mesh: NamedMesh | None, cfg: ModelConfig) -> int:
    """Experts of a ``moe`` model over ``mesh``: one a tp rank."""
    return (mesh.dim("tp") if mesh is not None else 1) if cfg.moe else 0


def init_params(
    gen: torch.Generator, cfg: ModelConfig, device: torch.device | str = "cpu",
    n_experts: int = 0,
) -> dict[str, torch.Tensor]:
    """Depth-stacked block params: each layer's leaf is a standard
    normal scaled by ``fan_in ** -0.5`` (fan-in = product of all but the
    last per-layer dim, as in the JAX package).  Drawn in float32 on the
    generator's device, then cast and moved.  ``n_experts``: the
    mixture's experts when ``cfg.moe``."""
    out = {}
    for name, shape in param_shapes(cfg, n_experts).items():
        fan_in = float(math.prod(shape[:-1])) or 1.0
        w = torch.randn((cfg.depth, *shape), generator=gen) * fan_in**-0.5
        out[name] = w.to(device=device, dtype=cfg.torch_dtype)
    return out


def _check_kv_heads_shardable(cfg: ModelConfig, mesh: NamedMesh) -> None:
    """Fail with the explanation when a tp-split axis does not divide."""
    tp = mesh.dim("tp")
    if cfg.kv_heads and cfg.kv_heads % tp:
        raise ValueError(
            f"kv_heads {cfg.kv_heads} must divide over tp={tp} "
            "(blocked head sharding)"
        )
    if cfg.heads % tp or cfg.mlp_hidden % tp:
        raise ValueError(f"heads {cfg.heads} and mlp hidden "
                         f"{cfg.mlp_hidden} must divide over tp={tp}")




def shard_params(params: dict, mesh: NamedMesh, cfg: ModelConfig,
                 lead: str | None = None) -> dict[str, list[torch.Tensor]]:
    """Global params -> per-rank lists over ``mesh`` (each rank's block,
    a copy on its device), per :func:`param_specs`."""
    _check_kv_heads_shardable(cfg, mesh)
    specs = param_specs(cfg, n_experts(mesh, cfg), lead)
    return {k: mesh.shard(v, specs[k][1]) for k, v in params.items()}


def gather_params(sharded: dict, mesh: NamedMesh, cfg: ModelConfig,
                  lead: str | None = None) -> dict[str, torch.Tensor]:
    """The inverse of :func:`shard_params`: global params on rank 0's
    device."""
    specs = param_specs(cfg, n_experts(mesh, cfg), lead)
    return {k: mesh.assemble(v, specs[k][1]) for k, v in sharded.items()}


def qkv_native(params: dict, x: torch.Tensor):
    """[B, L, *, D] projections with k/v at their native head count: Hkv
    for the split GQA parameters, H for the fused MHA ``wqkv``."""
    if "wqkv" in params:
        qkv = torch.einsum("ble,cehd->cblhd", x, params["wqkv"])
        return qkv[0], qkv[1], qkv[2]
    q = torch.einsum("ble,ehd->blhd", x, params["wq"])
    kv = torch.einsum("ble,cehd->cblhd", x, params["wkv"])
    return q, kv[0], kv[1]


def rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float, dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) for global positions [L] or [B, L], shape
    ``positions.shape + (D/2,)``; computed in float32, cast at the end."""
    if head_dim % 2:
        raise ValueError(f"rope needs an even head_dim, got {head_dim}")
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32,
                      device=positions.device)
    inv_freq = theta ** (-ar / head_dim)
    ang = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """Rotate [B, L, H, D] pairing dimension halves:
    (x1, x2) -> (x1 c - x2 s, x2 c + x1 s).  Tables are [L, D/2]
    (shared over batch) or [B, L, D/2] (per row)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def local_positions(l_local: int, cfg: ModelConfig, sp_rank: int = 0,
                    sp: int = 1, device=None) -> torch.Tensor:
    """Global positions of sp rank ``sp_rank``'s tokens: contiguous
    ``r * L_loc + i``, striped ``r + sp * i``."""
    i = torch.arange(l_local, device=device)
    if sp <= 1:
        return i
    if cfg.attn_layout == "striped":
        return sp_rank + sp * i
    return sp_rank * l_local + i


def _qkv(params: dict, x: torch.Tensor, cfg: ModelConfig,
         positions: torch.Tensor | None = None):
    """[B, L, H, D] q/k/v; RoPE (positions default to 0..L-1) on q and k
    BEFORE the GQA repeat, then each K/V head repeated over its
    ``group_size`` contiguous query heads."""
    q, k, v = qkv_native(params, x)
    if cfg.rope:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                               q.dtype)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    g = cfg.group_size
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    return q, k, v


# -- the block over a rank mesh ----------------------------------------------


@functools.lru_cache(maxsize=None)
def single_mesh(device: torch.device) -> NamedMesh:
    """The (1, 1, 1) mesh of one rank on ``device``."""
    return NamedMesh(RankMesh((device,)), MESH_AXES, (1, 1, 1))


def _tp_sum(mesh: NamedMesh, xs: list) -> list:
    """Each tp group's sum, every rank of the group a copy (the
    reference's row-parallel ``psum``; autograd runs through it)."""
    return sum_over(mesh.groups("tp"), xs)


def _attend(mesh: NamedMesh, qs, ks, vs, cfg: ModelConfig) -> list:
    """Attention of each rank's folded [L_loc, B*H_loc, D] q against its
    sp group's k/v: the ring at sp > 1 (the fused ring, K3/K4, for
    "kernel"), else one device's attention."""
    if mesh.dim("sp") == 1:
        if cfg.attn == "kernel":
            return [flash_attention_diff(q, k, v, cfg.causal, None,
                                         cfg.block_q, cfg.block_k,
                                         cfg.attn_grid)
                    for q, k, v in zip(qs, ks, vs)]
        return [attention_reference(q, k, v, causal=cfg.causal)
                for q, k, v in zip(qs, ks, vs)]
    impl = "pallas" if cfg.attn == "kernel" else "xla"
    out = [None] * mesh.size
    for g in mesh.groups("sp"):
        res = ring_attention([qs[r] for r in g], [ks[r] for r in g],
                             [vs[r] for r in g], causal=cfg.causal,
                             block_impl=impl, layout=cfg.attn_layout)
        for r, o in zip(g, res):
            out[r] = o
    return out


def _moe_ffn(mesh: NamedMesh, layers: list, ys: list,
             cfg: ModelConfig) -> list:
    """Top-1 mixture FFN, experts over tp (ep = tp): tokens are
    tp-replicated, so each tp rank takes its own expert's dispatch column
    and the combine is the tp sum; at tp = 1 one rank runs every expert.
    Routing (the argmax) is a constant in the backward; the gate weight
    carries the gradient."""
    tp = mesh.dim("tp")
    parts, gates = [], []
    for r, (p, y) in enumerate(zip(layers, ys)):
        x2 = y.reshape(-1, y.shape[-1])  # [T, E]
        cap = capacity(x2.shape[0], p["wg"].shape[-1], cfg.capacity_factor)
        onehot, weight = top1_route(x2, p["wg"])
        if tp == 1:
            dispatch = build_dispatch(onehot, cap, x2.dtype)  # [T, n, C]
            expert_in = torch.einsum("tec,td->ecd", dispatch, x2)
            hidden = torch.relu(torch.einsum("ecd,edf->ecf", expert_in,
                                             p["we1"]))
            out_e = torch.einsum("ecf,efd->ecd", hidden, p["we2"])
            parts.append(torch.einsum("tec,ecd->td", dispatch, out_e))
        else:
            if p["we1"].shape[0] != 1:
                raise ValueError(
                    f"moe over tp needs one expert a rank, got a local "
                    f"shard of {p['we1'].shape[0]} (n_experts must equal "
                    "the tp size)")
            col = build_dispatch_column(onehot, mesh.coord(r)["tp"], cap,
                                        x2.dtype)  # [T, C]
            mine = torch.einsum("tc,td->cd", col, x2)
            ye = torch.relu(mine @ p["we1"][0]) @ p["we2"][0]
            parts.append(torch.einsum("tc,cd->td", col, ye))
        gates.append(weight)
    return [(o * w[:, None]).reshape(y.shape)
            for o, w, y in zip(_tp_sum(mesh, parts), gates, ys)]


def forward_mesh(mesh: NamedMesh, layers: list, xs: list,
                 cfg: ModelConfig) -> list:
    """One transformer block over the ranks of ``mesh``: ``layers[r]``
    is rank r's block of ONE layer (no depth axis), ``xs[r]`` its
    [B_loc, L_loc, E] shard.  Attention folds batch into the head axis
    ([B, L, H, D] -> [L, B*H, D]) so one call covers every (batch, head),
    as the reference does for its kernels.  Returns each rank's output
    (tp replicas equal)."""
    sp = mesh.dim("sp")
    qkv = []
    for r, (p, x) in enumerate(zip(layers, xs)):
        pos = (local_positions(x.shape[1], cfg, mesh.coord(r)["sp"], sp,
                               x.device) if cfg.rope else None)
        qkv.append(_qkv(p, x, cfg, pos))
    b, l, h, d = qkv[0][0].shape

    def fold(a):
        # at B = 1 the reshape is a view of the projection's einsum
        # output, which need not be contiguous; the flash kernels take
        # contiguous tensors only (at B > 1 the reshape already copied)
        return a.transpose(0, 1).reshape(l, b * h, d).contiguous()

    def unfold(a):
        return a.reshape(l, b, h, d).transpose(0, 1)

    attn = _attend(mesh, *([fold(t[i]) for t in qkv] for i in range(3)),
                   cfg)
    os_ = [torch.einsum("blhd,hde->ble", unfold(a), p["wo"])
           for a, p in zip(attn, layers)]
    ys = [x + o for x, o in zip(xs, _tp_sum(mesh, os_))]
    if cfg.moe:
        ms = _moe_ffn(mesh, layers, ys, cfg)
    else:
        ms = _tp_sum(mesh, [
            torch.einsum("blf,fe->ble",
                         torch.relu(torch.einsum("ble,ef->blf", y, p["w1"])),
                         p["w2"])
            for y, p in zip(ys, layers)])
    return [y + m for y, m in zip(ys, ms)]


def forward_shard(params: dict, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """One transformer block on one device: ``params`` is ONE layer's
    dict (no depth axis), x [B, L, E]; with ``moe`` one device runs
    every expert."""
    return forward_mesh(single_mesh(x.device), [params], [x], cfg)[0]


def forward_stack(params: dict, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Every layer of the ``[depth]``-stacked ``params`` applied in
    turn: the single-device reference the decode gates and the pipeline
    hold their paths to."""
    for i in range(next(iter(params.values())).shape[0]):
        x = forward_shard({k: v[i] for k, v in params.items()}, x, cfg)
    return x


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the products with no batch dimension (the projections and
    the MLP or expert products: ``mm``, or ``bmm`` over a batch of 1, as
    torch.einsum lowers them), recompute the rest: attention's batched
    products and the elementwise work (the reference's
    ``dots_with_no_batch_dims_saveable``)."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(cfg: ModelConfig):
    """The checkpoint wrapper for ``cfg.remat_policy``: "full" saves
    nothing inside the block and re-runs its forward in the backward;
    "dots" saves what :func:`_dots_policy` picks."""
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat_policy == "dots":
        from torch.utils.checkpoint import (
            create_selective_checkpoint_contexts,
        )

        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)

    def wrap(fn):
        return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                                 **kw)

    return wrap


def _loss_ranks(mesh: NamedMesh) -> list[int]:
    """One rank a (dp, sp) shard: tp rank 0, whose output the objective
    counts (the tp replicas are equal; counting each would scale every
    gradient by tp)."""
    return [g[0] for g in mesh.groups("tp")]


def loss_mesh(mesh: NamedMesh, params: dict, xs: list, cfg: ModelConfig,
              n_global: float = 1.0) -> torch.Tensor:
    """Mean-square objective sum(z ** 2) / n_global in float32 over the
    world: ``cfg.depth`` blocks (each checkpointed under ``cfg.remat``)
    of the per-rank ``params`` (dict of per-rank lists, leaves
    ``[depth, ...]``) applied to the shards ``xs``.  A tensor on rank 0's
    device."""

    def block(layers, zs):
        return forward_mesh(mesh, layers, zs, cfg)

    body = _remat_wrap(cfg)(block) if cfg.remat else block
    zs = list(xs)
    for i in range(cfg.depth):
        zs = body([{k: v[r][i] for k, v in params.items()}
                   for r in range(mesh.size)], zs)
    home = zs[0].device
    total = None
    for r in _loss_ranks(mesh):
        part = (zs[r].float() ** 2).sum().to(home)
        total = part if total is None else total + part
    return total / n_global


def loss_shard(params: dict, x: torch.Tensor, cfg: ModelConfig,
               n_global: float = 1.0) -> torch.Tensor:
    """The one-device objective: :func:`loss_mesh` on one rank."""
    return loss_mesh(single_mesh(x.device), {k: [v] for k, v in
                                             params.items()}, [x], cfg,
                     n_global)


def reduce_groups(mesh: NamedMesh, spec, axes: tuple[str, ...]) -> list:
    """The rank groups over which a leaf split per ``spec`` sums its
    gradient: the axes of ``axes`` that ``spec`` does not split."""
    over = tuple(a for a in axes if a in mesh.axes and a not in spec)
    return mesh.groups(over) if over else [[r] for r in range(mesh.size)]


def sum_over(groups: list, xs: list) -> list:
    """Each group's sum (``comm/ring.py::library_allreduce``), every rank
    of the group a bit-identical copy."""
    out = list(xs)
    for g in groups:
        if len(g) > 1:
            for r, s in zip(g, library_allreduce([xs[r] for r in g])):
                out[r] = s
    return out


def _reduce_over(groups: list, xs: list, reduce) -> list:
    out = list(xs)
    for g in groups:
        if len(g) > 1:
            home = xs[g[0]].device
            total = reduce(torch.stack([xs[r].to(home) for r in g]))
            for r in g:
                out[r] = torch.empty_like(xs[r]).copy_(total)
    return out


def max_over(groups: list, xs: list) -> list:
    """Each group's elementwise max (the reference's ``pmax``), every
    rank of the group a copy; a group of one keeps its tensor."""
    return _reduce_over(groups, xs, lambda t: t.amax(0))


def min_over(groups: list, xs: list) -> list:
    """Each group's elementwise min (``pmin``), as :func:`max_over`."""
    return _reduce_over(groups, xs, lambda t: t.amin(0))


def unused_ok(mesh: NamedMesh, specs: dict) -> frozenset:
    """The (leaf, rank) pairs allowed to reach the objective by no path:
    at tp > 1 a tp-replicated leaf (the gate) off tp rank 0, whose rank's
    output the objective does not count (at depth 1 its gate gets no
    gradient).  Every other leaf must reach it."""
    if mesh.dim("tp") == 1:
        return frozenset()
    return frozenset((k, r) for k, (_, spec) in specs.items()
                     if "tp" not in spec for r in range(mesh.size)
                     if mesh.coord(r)["tp"] != 0)


def world_grads(loss_fn, params: dict, unused: frozenset = frozenset()
                ) -> tuple[torch.Tensor, dict]:
    """(loss, grads) of ``loss_fn(leaves)`` over the whole world: the
    per-rank lists of ``params`` become fresh leaves, and the grads come
    back in the same dict-of-lists layout, each rank's own (unsummed).
    A leaf that gets no gradient is zero if its (name, rank) is in
    ``unused`` (:func:`unused_ok`), else an error."""
    names = list(params)
    leaves = {k: [p.detach().requires_grad_(True) for p in params[k]]
              for k in names}
    loss = loss_fn(leaves)
    order = [(k, r) for k in names for r in range(len(leaves[k]))]
    flat = torch.autograd.grad(loss, [leaves[k][r] for k, r in order],
                               allow_unused=True)
    grads = {k: [None] * len(leaves[k]) for k in names}
    for (k, r), g in zip(order, flat):
        if g is None:
            if (k, r) not in unused:
                raise RuntimeError(f"leaf {k!r} of rank {r} does not reach "
                                   "the objective")
            g = torch.zeros_like(leaves[k][r])
        grads[k][r] = g
    return loss.detach(), grads


def sgd_update(params: dict, grads: dict, lr: float) -> dict:
    """``p - lr * g`` in p's dtype, rank by rank."""
    with torch.no_grad():
        return {k: [p - lr * g.to(p.dtype) for p, g in zip(params[k],
                                                           grads[k])]
                for k in params}


def make_mesh_grads(mesh: NamedMesh, cfg: ModelConfig,
                    n_global: float = 1.0):
    """``grads(params, xs) -> (loss, grads)`` over ``mesh`` (params a
    dict of per-rank lists, xs each rank's [B/dp, L/sp, E] shard): after
    autograd over the world, each leaf's gradient is summed over the
    (dp, sp) ranks holding its block (and over tp too for a
    tp-replicated leaf, the gate), so every replica holds the same
    bits."""
    _check_kv_heads_shardable(cfg, mesh)
    specs = param_specs(cfg, n_experts(mesh, cfg))
    groups = {k: reduce_groups(mesh, s, MESH_AXES)
              for k, (_, s) in specs.items()}
    unused = unused_ok(mesh, specs)

    def grads(params: dict, xs: list):
        loss, gs = world_grads(
            lambda leaves: loss_mesh(mesh, leaves, xs, cfg, n_global),
            params, unused)
        return loss, {k: sum_over(groups[k], g) for k, g in gs.items()}

    return grads


def make_train_step(mesh: NamedMesh | None, cfg: ModelConfig,
                    lr: float = 1e-3, n_global: float = 1.0):
    """``step(params, xs) -> (new_params, loss)``: forward, loss,
    backward (:func:`make_mesh_grads`) and SGD over ``mesh``, every
    replica of a leaf updating bit-identically.  ``mesh=None``: the
    one-device step on a dict of tensors and one x.  ``step.calls``
    counts the steps."""
    if mesh is None:
        return _one_device(make_train_step, cfg, lr=lr, n_global=n_global)
    grads = make_mesh_grads(mesh, cfg, n_global)

    def step(params: dict, xs: list):
        step.calls += 1
        loss, gs = grads(params, xs)
        return sgd_update(params, gs, lr), loss

    step.calls = 0
    return step


def _one_device(factory, cfg: ModelConfig, **kw):
    """The step of ``factory`` on one rank, taking a dict of tensors and
    one x (the mesh is x's device's)."""
    steps = {}

    def step(params: dict, x: torch.Tensor):
        inner = steps.get(x.device)
        if inner is None:
            inner = steps[x.device] = factory(single_mesh(x.device), cfg,
                                              **kw)
        step.calls += 1
        new, loss = inner({k: [v] for k, v in params.items()}, [x])
        return {k: v[0] for k, v in new.items()}, loss

    step.calls = 0
    return step
