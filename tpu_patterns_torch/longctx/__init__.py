"""Long-context layer: the dense twins, the flash kernels' tile model,
the fused flash kernels (forward, and dq/dk/dv backward), and the two
sequence-parallel strategies over a rank mesh:

* ``ring_attention`` — k/v rotation on the ring primitive (the
  manual-ring lineage);
* ``ulysses_attention`` — head/sequence all-to-all re-sharding (the
  library-collective lineage).
"""

from tpu_patterns_torch.longctx.attention import (
    attention_reference,
    block_attention,
    combine_blocks,
    empty_state,
    finalize,
)
from tpu_patterns_torch.longctx.ring_attention import ring_attention
from tpu_patterns_torch.longctx.ulysses import ulysses_attention

__all__ = [
    "attention_reference",
    "block_attention",
    "combine_blocks",
    "empty_state",
    "finalize",
    "flash_attention",
    "flash_attention_diff",
    "flash_block",
    "ring_attention",
    "ulysses_attention",
]

_FLASH = {"flash_attention", "flash_attention_diff", "flash_block"}


def __getattr__(name):
    # lazy, as the reference's: the plain strategies need no kernel module
    if name in _FLASH:
        from tpu_patterns_torch.longctx import flash

        return getattr(flash, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
