"""Parallelism-strategy layer: collective matmul (tp overlap), pipeline
(pp), expert (ep) and sharded-optimizer (ZeRO) patterns over a rank mesh
(counterpart of ``tpu_patterns/parallel``).

  overlap.py   all-gather and reduce-scatter matmuls cut into ring hops
  pipeline.py  GPipe and 1F1B over the activation ring
  moe.py       top-1 expert dispatch over the all-to-all
  optim.py     optax's sgd and adam rules over trees of tensors
  zero.py      the reduce-scatter / update / all-gather optimizer step

Each function takes and returns per-rank lists (``comm/mesh.py``),
built from ``comm/ring.py``'s ring shift and library collectives.
"""

from tpu_patterns_torch.parallel.moe import moe_apply, top1_route
from tpu_patterns_torch.parallel.overlap import (
    allgather_matmul,
    matmul_reducescatter,
)
from tpu_patterns_torch.parallel.pipeline import pipeline_apply
from tpu_patterns_torch.parallel.zero import zero_apply, zero_init

__all__ = [
    "allgather_matmul", "matmul_reducescatter", "moe_apply",
    "pipeline_apply", "top1_route", "zero_apply", "zero_init",
]
