"""Model config, parameter layout, q/k/v projections and RoPE.

Counterpart of ``tpu_patterns/models/transformer.py`` for what the
serve path runs: the block's parameters (fused MHA ``wqkv`` or split GQA
``wq``/``wkv``), their fan-in scaled init, the native-head-count
projections and rotary embeddings.  Parameters are a plain dict of
tensors with a leading ``[depth]`` axis on every block leaf.
"""

from __future__ import annotations

import dataclasses
import math

import torch

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

    def __post_init__(self):
        if self.moe:
            raise NotImplementedError(
                "moe=True is not ported to tpu_patterns_torch yet"
            )
        if self.kv_heads and self.heads % self.kv_heads:
            raise ValueError(
                f"heads {self.heads} must divide by kv_heads {self.kv_heads}"
            )
        torch_dtype(self.dtype)  # reject an unknown dtype at build time

    @property
    def mlp_hidden(self) -> int:
        return self.embed * self.mlp_mult

    @property
    def n_kv(self) -> int:
        """K/V heads actually stored (heads for MHA)."""
        return self.kv_heads or self.heads

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
