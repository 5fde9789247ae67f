"""Topology discovery & placement (counterpart of ``tpu_patterns/topo``).

  topology.py   devices, coordinates, planes, ``discover``
  native.py     the C++ planes/neighbors core (csrc/topo.cc, g++)
  placement.py  compact / spread / plan orderings and the rank mesh
                they place (``make_mesh``)
  bootstrap.py  the launcher's environment contract, torch.distributed
"""

from tpu_patterns_torch.topo.topology import (  # noqa: F401
    DeviceInfo,
    Topology,
    discover,
)
from tpu_patterns_torch.topo.placement import (  # noqa: F401
    Mechanism,
    PlacementMode,
    make_mesh,
    order_devices,
    select_devices,
)
from tpu_patterns_torch.topo.bootstrap import (  # noqa: F401
    bootstrap,
    process_info,
)
