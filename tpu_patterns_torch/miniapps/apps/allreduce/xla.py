"""allreduce/xla: the plain variant (the JAX package's XLA build).

The accumulate step is plain elementwise ``+`` in torch, where the
tensors lie.  Supports all three algorithms, the library contrast
(psum) included, and float32, int32 and bfloat16.
"""

from __future__ import annotations

from tpu_patterns_torch.core.results import Record, ResultWriter
from tpu_patterns_torch.miniapps.apps import allreduce as core
from tpu_patterns_torch.miniapps.framework import VariantSpec


def run(
    mesh=None, dtype: str = "float32", writer: ResultWriter | None = None,
    **overrides,
) -> Record:
    if mesh is None:
        from tpu_patterns_torch.miniapps.framework import default_mesh

        mesh = default_mesh()
    cfg = core.AllreduceConfig(dtype=dtype, **overrides)
    return core.run_allreduce(mesh, cfg, writer, op=None, variant="xla")


VARIANT = VariantSpec(
    app="allreduce",
    variant="xla",
    dtypes=("float32", "int32", "bfloat16"),
    run=run,
    axes={"algorithm": core.ALGORITHMS, "mem_kind": tuple(core.MEM_KINDS)},
)
