from avoid_mpc_torch.sim.plant import (  # noqa: F401
    SixDofParams,
    SixDofRotorState,
    SixDofState,
    sixdof_init,
    sixdof_rotor_init,
    sixdof_step,
    sixdof_step_rotor,
)
from avoid_mpc_torch.sim.rotor import (  # noqa: F401
    RotorParams,
    RotorState,
    mix_quadx,
    rotor_init,
    rotor_step,
)
from avoid_mpc_torch.sim.sensors import (  # noqa: F401
    LidarScan,
    ObstacleField,
    lidar_scan,
    render_depth,
    imu_measure,
)
from avoid_mpc_torch.sim.scenarios import (  # noqa: F401
    ScenarioConfig,
    random_forest,
    random_start_states,
)
from avoid_mpc_torch.sim.world import (  # noqa: F401
    MISSION_TASK,
    WorldDiag,
    WorldState,
    build_world,
    field_clearance,
    rollout_world,
    world_init,
    world_step,
)
