"""Communication patterns (counterpart of ``tpu_patterns/comm``): the
one-sided puts, the ring, the pair exchange and the hierarchical
allreduce over a rank mesh.

  dtypes.py     config dtype names -> torch dtypes, itemsize, modulus
  verify.py     shuffled-iota fill and the exact wrapped checksum
  mesh.py       the rank mesh: p ranks in one process over the cards
  ring.py       ring shift, naive and bandwidth-optimal ring allreduce,
                the library contrast
  onesided.py   the four local put kernels' wrappers and the ring put's
                (K9), their plain versions and ``run_onesided``
                (csrc/local_put.cu, csrc/ring_put.cu: the kernels)
  p2p.py        the two-sided pair exchange (ppermute's semantics),
                ``run_p2p``
  hierarchical.py  flat and hierarchical (inner, then outer tier)
                allreduce, ``run_hierarchical``
"""

from tpu_patterns_torch.comm.dtypes import DTYPES, get_dtype  # noqa: F401
from tpu_patterns_torch.comm.verify import (  # noqa: F401
    checksum_device,
    expected_checksum,
    fill_randomly,
)
from tpu_patterns_torch.comm.onesided import (  # noqa: F401
    OneSidedConfig,
    local_put,
    local_put_multi,
    local_put_streamed,
    ring_put,
    run_onesided,
)
