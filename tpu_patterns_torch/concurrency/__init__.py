"""The concurrency suite on one CUDA card (the JAX package's
``tpu_patterns/concurrency``).

Answers the reference suite's question -- "does submitting independent
device commands concurrently beat serial?" -- in CUDA terms: do
commands on their own streams beat the same commands queued in order on
one, and does one kernel overlap on-device copies with compute?  The
compute command is the busy-wait kernel K6 (``csrc/busy_wait.cu``), the
``pallas`` backend's group the copy-and-compute kernel K7
(``csrc/dma_compute.cu``).
"""

from tpu_patterns_torch.concurrency.kernels import busy_wait, busy_wait_plain  # noqa: F401
from tpu_patterns_torch.concurrency.commands import (  # noqa: F401
    Command,
    MemKind,
    parse_command,
    parse_group,
)
from tpu_patterns_torch.concurrency.backends import BACKENDS, get_backend  # noqa: F401
from tpu_patterns_torch.concurrency.harness import (  # noqa: F401
    ConcurrencyConfig,
    run_concurrency,
)
