"""Model config, parameter layout, q/k/v projections, RoPE and the
one-device train step.

Counterpart of ``tpu_patterns/models/transformer.py`` on one device: the
block's parameters (fused MHA ``wqkv`` or split GQA ``wq``/``wkv``),
their fan-in scaled init, the native-head-count projections and rotary
embeddings (the serve path), and the block forward, the mean-square
objective and the SGD train step (the flagship path).  Parameters are a
plain dict of tensors with a leading ``[depth]`` axis on every block
leaf.  The reference's mesh axes (dp, sp, tp) wait for the multi-rank
slice; here every axis has size 1.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.utils.checkpoint

from tpu_patterns_torch.longctx.attention import attention_reference
from tpu_patterns_torch.longctx.flash import flash_attention_diff
from tpu_patterns_torch.longctx.tuning import load_tuned_blocks
from tpu_patterns_torch.runtime import torch_dtype


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
    # the mixture FFN is not ported: a config asking for it is refused
    moe: bool = False
    # -- the train step's fields --
    causal: bool = True
    # attention of the train step: "dense" is the reference's "xla"
    # (attention_reference), "kernel" the fused flash kernels both ways
    # (longctx.flash.flash_attention_diff; the reference's "pallas")
    attn: str = "dense"
    # "striped" is an sp > 1 layout: not ported with the one-device step
    attn_layout: str = "contiguous"
    # checkpoint each block (torch.utils.checkpoint): FLOPs for memory
    remat: bool = False
    remat_policy: str = "full"  # "dots" is not ported yet
    # flash tile request; None resolves from longctx/flash_tuned.json or
    # the hand-picked squares (longctx.tuning.load_tuned_blocks)
    block_q: int | None = None
    block_k: int | None = None
    # causal grid of the flash path: "dense" | "compact" (the same
    # launches and results here; see longctx/flash.py)
    attn_grid: str = "dense"

    def __post_init__(self):
        if self.moe:
            raise NotImplementedError(
                "moe=True is not ported to tpu_patterns_torch yet "
                "(ROADMAP.md, Queue 1 step 8)"
            )
        if self.kv_heads and self.heads % self.kv_heads:
            raise ValueError(
                f"heads {self.heads} must divide by kv_heads {self.kv_heads}"
            )
        torch_dtype(self.dtype)  # reject an unknown dtype at build time
        if self.attn not in ("dense", "kernel"):
            raise ValueError(f"unknown attn {self.attn!r}; want dense|kernel")
        if self.attn_layout == "striped":
            raise NotImplementedError(
                "attn_layout='striped' is an sp > 1 layout, not ported to "
                "tpu_patterns_torch yet (ROADMAP.md, Queue 1 step 8)"
            )
        if self.attn_layout != "contiguous":
            raise ValueError(f"unknown attn_layout {self.attn_layout!r}")
        if self.remat_policy == "dots":
            raise NotImplementedError(
                "remat_policy='dots' is not ported to tpu_patterns_torch "
                "yet (ROADMAP.md, slice B)"
            )
        if self.remat_policy != "full":
            raise ValueError(
                f"unknown remat_policy {self.remat_policy!r}; want full"
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


def param_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Per-layer parameter shapes (no depth axis), in init order."""
    e, h, d, f = cfg.embed, cfg.heads, cfg.head_dim, cfg.mlp_hidden
    if cfg.kv_heads:
        shapes = {
            "wq": (e, h, d),
            "wkv": (2, e, cfg.kv_heads, d),
            "wo": (h, d, e),
        }
    else:
        shapes = {"wqkv": (3, e, h, d), "wo": (h, d, e)}
    shapes.update({"w1": (e, f), "w2": (f, e)})
    return shapes


def init_params(
    gen: torch.Generator, cfg: ModelConfig, device: torch.device | str = "cpu"
) -> dict[str, torch.Tensor]:
    """Depth-stacked block params: each layer's leaf is a standard
    normal scaled by ``fan_in ** -0.5`` (fan-in = product of all but the
    last per-layer dim, as in the JAX package).  Drawn in float32 on the
    generator's device, then cast and moved."""
    out = {}
    for name, shape in param_shapes(cfg).items():
        fan_in = float(math.prod(shape[:-1])) or 1.0
        w = torch.randn((cfg.depth, *shape), generator=gen) * fan_in**-0.5
        out[name] = w.to(device=device, dtype=cfg.torch_dtype)
    return out


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


# -- the one-device train step ---------------------------------------------------


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


def forward_shard(params: dict, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """One transformer block on one device.  ``params`` is ONE layer's
    dict (no depth axis); x [B, L, E].  Attention folds batch into the
    head axis ([B, L, H, D] -> [L, B*H, D]) so one call covers every
    (batch, head), as the reference does for its kernels."""
    q, k, v = _qkv(params, x, cfg)
    b, l, h, d = q.shape

    def fold(a):
        return a.transpose(0, 1).reshape(l, b * h, d)

    def unfold(a):
        return a.reshape(l, b, h, d).transpose(0, 1)

    if cfg.attn == "kernel":
        attn = flash_attention_diff(
            fold(q), fold(k), fold(v), cfg.causal, None, cfg.block_q,
            cfg.block_k, cfg.attn_grid,
        )
    else:
        attn = attention_reference(fold(q), fold(k), fold(v),
                                   causal=cfg.causal)
    o = torch.einsum("blhd,hde->ble", unfold(attn), params["wo"])
    y = x + o
    hidden = torch.relu(torch.einsum("ble,ef->blf", y, params["w1"]))
    return y + torch.einsum("blf,fe->ble", hidden, params["w2"])


def forward_stack(params: dict, x: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Every layer of the ``[depth]``-stacked ``params`` applied in
    turn: the single-device reference the decode gates hold the cache
    path to."""
    for i in range(next(iter(params.values())).shape[0]):
        x = forward_shard({k: v[i] for k, v in params.items()}, x, cfg)
    return x


def _checkpoint_full(fn):
    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False)


def _remat_wrap(cfg: ModelConfig):
    """The checkpoint wrapper for ``cfg.remat_policy`` (validated in
    ModelConfig): "full" saves nothing inside the block and re-runs its
    forward in the backward."""
    return {"full": _checkpoint_full}[cfg.remat_policy]


def loss_shard(params: dict, x: torch.Tensor, cfg: ModelConfig,
               n_global: float = 1.0) -> torch.Tensor:
    """Mean-square objective sum(z ** 2) / n_global in float32 of the
    ``cfg.depth`` blocks applied in order (each checkpointed under
    ``cfg.remat``)."""

    def block(layer, xb):
        return forward_shard(layer, xb, cfg)

    body = _remat_wrap(cfg)(block) if cfg.remat else block
    z = x
    for i in range(cfg.depth):
        z = body({k: p[i] for k, p in params.items()}, z)
    return (z.float() ** 2).sum() / n_global


def make_train_step(cfg: ModelConfig, lr: float = 1e-3,
                    n_global: float = 1.0):
    """``step(params, x) -> (new_params, loss)``: forward, loss,
    backward and SGD (``p - lr * g`` in p's dtype), as the reference's
    jitted step on a (1, 1, 1) mesh.  ``step.calls`` counts the steps
    taken."""

    def step(params: dict, x: torch.Tensor):
        step.calls += 1
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss = loss_shard(leaves, x, cfg, n_global)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            new = {k: p - lr * g.to(p.dtype)
                   for (k, p), g in zip(leaves.items(), grads)}
        return new, loss.detach()

    step.calls = 0
    return step
