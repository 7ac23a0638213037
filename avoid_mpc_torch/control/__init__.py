from avoid_mpc_torch.control.geometric import (  # noqa: F401
    CMD_ACCELERATION,
    CMD_ANGULAR,
    CMD_POSITION,
    CMD_QUAT,
    ControllerOutput,
    ControllerParams,
    ThrustModelState,
    acc2quaternion,
    estimate_thrust_model,
    geometric_controller,
    thrust_model_init,
)
from avoid_mpc_torch.control.bfctrl import (  # noqa: F401
    BfctrlParams,
    BfctrlState,
    STATUS_CMD,
    STATUS_NOODOM,
    STATUS_TAKEOFF,
    STATUS_WAITINGCMD,
    bfctrl_init,
    bfctrl_step,
)
