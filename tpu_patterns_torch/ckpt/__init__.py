"""Atomic checkpoint / resume for trees of torch tensors, in the JAX
package's on-disk format (``ckpt/checkpoint.py``)."""

from tpu_patterns_torch.ckpt.checkpoint import (
    AsyncSaver,
    Sharded,
    available_steps,
    describe,
    latest_step,
    read_extra,
    restore,
    save,
)

__all__ = [
    "AsyncSaver", "available_steps", "describe", "latest_step",
    "read_extra", "restore", "save", "Sharded",
]
