"""Hand numpy arrays made by the JAX package to this package.

``params_from_jax`` takes the reference's ``init_lm_params`` output as
numpy (``{k: np.asarray(v)}``) and returns this package's
depth-stacked params, so both packages compute the same function on the
same weights; ``block_params_from_jax`` does the same for the train
step's block params (``init_params``: no ``wemb``; the mixture's
``wg``/``we1``/``we2`` included), and ``stack_params_from_jax`` for the
pipelined stack (``init_stack_params``: a leading stage axis).  Sharding
the global params over a mesh is ``transformer.shard_params``'s.  ``pool_from_numpy``
does the same for one pool's leaves, and ``fill_from_numpy`` for the
reference's ``verify.fill_randomly`` buffer.  None imports JAX: bfloat16
arrays arrive as numpy's ``bfloat16`` extension dtype and are
reinterpreted bit for bit.  ``params_to_numpy`` goes back: this package's params (or
grads) in the reference's layout, as float32 numpy.
"""

from __future__ import annotations

import dataclasses

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


def _stack_block(k: str, a: np.ndarray, shape: tuple, cfg: ModelConfig,
                 device) -> torch.Tensor:
    """One block leaf, stacked [depth, ...] (the reference stacks only
    when depth > 1), in ``cfg.dtype``."""
    t = tensor_from_numpy(a, device)
    if t.ndim == len(shape):
        t = t[None]
    if tuple(t.shape) != (cfg.depth, *shape):
        raise ValueError(f"{k}: shape {tuple(t.shape)} does not fit")
    return t.to(cfg.torch_dtype)


def _check_keys(flat, want: set) -> None:
    if set(flat) != want:
        raise ValueError(
            f"param keys {sorted(flat)} do not match the config's "
            f"{sorted(want)}"
        )


def params_from_jax(
    flat: dict[str, np.ndarray], cfg: ModelConfig, device="cpu"
) -> dict[str, torch.Tensor]:
    """The reference's LM params (block leaves stacked only when depth
    > 1, ``wemb [V, E]``; a ``moe`` model's expert count is its gate's
    width) as this package's params: every block leaf [depth, ...],
    ``wemb`` unchanged, all in ``cfg.dtype``."""
    n_exp = np.shape(flat["wg"])[-1] if cfg.moe and "wg" in flat else 0
    shapes = param_shapes(cfg, n_exp)
    _check_keys(flat, set(shapes) | {"wemb"})
    return {
        k: (tensor_from_numpy(a, device).to(cfg.torch_dtype) if k == "wemb"
            else _stack_block(k, a, shapes[k], cfg, device))
        for k, a in flat.items()
    }


def block_params_from_jax(
    flat: dict[str, np.ndarray], cfg: ModelConfig, device="cpu"
) -> dict[str, torch.Tensor]:
    """The reference's ``init_params`` block params (unstacked at depth
    1, ``[depth, ...]`` above) as this package's depth-stacked params;
    a ``moe`` model's expert count is its gate's width."""
    n_exp = np.shape(flat["wg"])[-1] if cfg.moe and "wg" in flat else 0
    shapes = param_shapes(cfg, n_exp)
    _check_keys(flat, set(shapes))
    return {k: _stack_block(k, a, shapes[k], cfg, device)
            for k, a in flat.items()}


def stack_params_from_jax(
    flat: dict[str, np.ndarray], cfg: ModelConfig, device="cpu"
) -> dict[str, torch.Tensor]:
    """The reference's ``init_stack_params`` (every leaf ``[n_stages,
    ...]``, one block a stage) as this package's stack: the params of
    ``cfg`` at depth n_stages (``pipeline_step.init_stack_params``)."""
    n_stages = int(np.shape(next(iter(flat.values())))[0])
    return block_params_from_jax(
        flat, dataclasses.replace(cfg, depth=n_stages), device)


def params_to_numpy(
    params: dict[str, torch.Tensor], cfg: ModelConfig
) -> dict[str, np.ndarray]:
    """This package's block params or grads in the reference's layout
    (the depth axis dropped at depth 1), as float32 numpy (bfloat16
    widens exactly)."""
    return {
        k: (t[0] if cfg.depth == 1 and k != "wemb" else t)
        .detach().float().cpu().numpy()
        for k, t in params.items()
    }


def pool_from_numpy(
    pool: dict[str, np.ndarray], device="cpu"
) -> dict[str, torch.Tensor]:
    """Pool leaves (k/v and, for int8, ks/vs) as tensors, bits kept."""
    return {n: tensor_from_numpy(a, device) for n, a in pool.items()}


def fill_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    """The reference's ``verify.fill_randomly`` output (as numpy) as this
    package's put input, dtype and bits kept, so both packages copy and
    check the same buffer."""
    return tensor_from_numpy(a, device)
