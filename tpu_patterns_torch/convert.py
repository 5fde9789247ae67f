"""Hand numpy arrays made by the JAX package to this package.

``params_from_jax`` takes the reference's ``init_lm_params`` output as
numpy (``{k: np.asarray(v)}``) and returns this package's
depth-stacked params, so both packages compute the same function on the
same weights.  ``pool_from_numpy`` does the same for one pool's leaves.
Neither imports JAX: bfloat16 arrays arrive as numpy's ``bfloat16``
extension dtype and are reinterpreted bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_patterns_torch.models.transformer import ModelConfig, param_shapes


def tensor_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    """A torch tensor with ``a``'s dtype and bits (bfloat16 included)."""
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device
        )
    return torch.from_numpy(a).to(device)


def params_from_jax(
    flat: dict[str, np.ndarray], cfg: ModelConfig, device="cpu"
) -> dict[str, torch.Tensor]:
    """The reference's LM params (block leaves stacked only when depth
    > 1, ``wemb [V, E]``) as this package's params: every block leaf
    [depth, ...], ``wemb`` unchanged, all in ``cfg.dtype``."""
    shapes = param_shapes(cfg)
    if set(flat) != set(shapes) | {"wemb"}:
        raise ValueError(
            f"param keys {sorted(flat)} do not match the config's "
            f"{sorted(shapes) + ['wemb']}"
        )
    out = {}
    for k, a in flat.items():
        t = tensor_from_numpy(a, device)
        if k != "wemb":
            if t.ndim == len(shapes[k]):
                t = t[None]
            if tuple(t.shape) != (cfg.depth, *shapes[k]):
                raise ValueError(f"{k}: shape {tuple(t.shape)} does not fit")
        out[k] = t.to(cfg.torch_dtype)
    return out


def pool_from_numpy(
    pool: dict[str, np.ndarray], device="cpu"
) -> dict[str, torch.Tensor]:
    """Pool leaves (k/v and, for int8, ks/vs) as tensors, bits kept."""
    return {n: tensor_from_numpy(a, device) for n, a in pool.items()}
