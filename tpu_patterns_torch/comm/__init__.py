"""Communication patterns (counterpart of ``tpu_patterns/comm``); so far
the one-device one-sided put and what it needs.

  dtypes.py     config dtype names -> torch dtypes, itemsize, modulus
  verify.py     shuffled-iota fill and the exact wrapped checksum
  onesided.py   the four put kernels' wrappers, their plain versions and
                ``run_onesided`` (csrc/local_put.cu: the kernels)
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
    run_onesided,
)
