"""A small functional optimizer: optax's ``sgd`` and ``adam`` update
rules over trees of tensors.

The JAX package's ZeRO step (``tpu_patterns/parallel/zero.py``) takes
any optax ``GradientTransformation``; its tests and its model's ZeRO
train step use ``optax.sgd`` and ``optax.adam``.  optax is a JAX
library, so the port keeps these two rules as optax defines them:

* ``sgd(lr)``: ``updates = -lr * g``, no state;
* ``adam(lr, b1, b2, eps)``: ``mu = (1 - b1) g + b1 mu``,
  ``nu = (1 - b2) g^2 + b2 nu``, ``count += 1``, bias-corrected
  ``mu_hat = mu / (1 - b1^count)`` and ``nu_hat``, then
  ``updates = -lr * mu_hat / (sqrt(nu_hat) + eps)``;

each an :class:`Optimizer` with ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``, and
:func:`apply_updates` (``p + u`` in ``p``'s dtype).  A tree is a tensor,
or a dict, list or tuple of trees (``torch.utils._pytree``'s
containers); the rules are elementwise, so they run on any slice of a
parameter, which is what ZeRO relies on.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure), in ``tree``'s structure."""
    leaves, spec = _pytree.tree_flatten(tree)
    others = [_pytree.tree_flatten(t)[0] for t in rest]
    return _pytree.tree_unflatten(
        [fn(*xs) for xs in zip(leaves, *others)], spec)


def tree_leaves(tree: Any) -> list:
    return _pytree.tree_flatten(tree)[0]


class Optimizer(NamedTuple):
    """optax's ``GradientTransformation``: two pure functions."""

    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count and the moments."""

    count: torch.Tensor
    mu: Any
    nu: Any


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        zeros = tree_map(torch.zeros_like, params)
        first = tree_leaves(params)
        dev = first[0].device if first else None
        return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                         zeros, tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * g * g + b2 * v, grads,
                      state.nu)
        count = state.count + 1
        # float32 on the count's device, as optax's decay ** count
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        updates = tree_map(
            lambda m, v: -lr * ((m / c1.to(m.dtype))
                                / (torch.sqrt(v / c2.to(v.dtype)) + eps)),
            mu, nu)
        return updates, AdamState(count, mu, nu)

    return Optimizer(init, update)


def apply_updates(params: Any, updates: Any) -> Any:
    """``p + u`` leaf by leaf, in ``p``'s dtype (optax's rule)."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
