from avoid_mpc_torch.models.quadrotor import (  # noqa: F401
    DynamicsParams,
    quad_dynamics,
    rk4_step,
    rollout,
)
from avoid_mpc_torch.models.costs import (  # noqa: F401
    CostParams,
    control_cost,
    collision_cost,
    path_gap_cost,
    goal_cost,
    trajectory_cost,
)
