"""The vehicle link: the C++ host runtime's binding (``native``), the
MAVLink dialect table (``mav_msgs``), the vehicle input adapter
(``mav_input``) and tlog replay (``tlog_replay``).  Importing builds
nothing; the host runtime is compiled at first use."""

from avoid_mpc_torch.runtime.mav_input import MavVehicleInput, VehicleSnapshot  # noqa: F401
from avoid_mpc_torch.runtime.native import (  # noqa: F401
    FrameRing,
    HostKDTree,
    MavConnection,
    MavlinkCodec,
    Scheduler,
    native_available,
)
