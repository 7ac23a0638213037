"""Problem shape and weights for the PyTorch port.

The port's own copy of the solver-facing part of ``avoid_mpc_tpu/config.py``
(state layout, ``MPCWeights``, ``MPCConfig`` with the same defaults).  The
YAML loader, ``MPCConfig``'s engine and task fields and the perception,
task and engine configs come with the engine slice.  Kept as a copy, not an import, so that the port never loads the JAX
package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# State layout: [px, py, pz, yaw, vx, vy, vz, ax, ay, az]
STATE_DIM = 10
# Control layout: [ax_cmd, ay_cmd, az_cmd, yaw_dot]
CONTROL_DIM = 4
GRAVITY = 9.81


@dataclasses.dataclass(frozen=True)
class MPCWeights:
    """Cost weights in the reference weights-vector layout."""

    q_goal: tuple[float, ...]  # 10: terminal goal quadratic
    q_path: tuple[float, ...]  # 10: yaw-rotated path-gap quadratic
    q_u: tuple[float, ...]  # 4: control quadratic (about hover [0,0,g,0])
    collide_lambda: float  # soft collision cost multiplier
    # Omnidirectional (velocity-ungated) barrier weight; 0.0 = the reference
    # objective.  Not part of the 25-weight vector.
    collide_lambda_omni: float = 0.0

    def as_vector(self) -> np.ndarray:
        """25-vector in reference ordering (goal, path, u, lambda)."""
        return np.asarray(
            list(self.q_goal) + list(self.q_path) + list(self.q_u) + [self.collide_lambda],
            dtype=np.float64,
        )


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Problem shape, weights, bounds, dynamics and solver knobs."""

    # Horizon (reference mpc_parameters.yaml: mpc_T=1.0, mpc_dt=0.033 => N=30)
    mpc_T: float = 1.0
    mpc_dt: float = 0.033
    # Obstacle points per horizon stage
    nearest_point_count: int = 3
    use_drag_coefficient: bool = False
    drag_coefficient: float = 0.033

    weights: MPCWeights = dataclasses.field(
        default_factory=lambda: MPCWeights(
            q_goal=(50.0, 50.0, 100.0, 100.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0),
            q_path=(0.0, 10.0, 50.0, 100.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0),
            q_u=(0.3, 0.3, 0.5, 1.0),
            collide_lambda=1.2,
        )
    )

    # First-order actuator-lag inverse time constants: a_dot = (u - a) * tau
    tau: tuple[float, float, float, float] = (6.09837416, 6.21675029, 15.79816293, 0.0)
    gain: tuple[float, float, float, float] = (0.999999, 0.999999, 0.999999, 1.0)

    # Control box: [-a_max_xy, a_max_xy]^2 x [a_min_z, a_max_z] x [-a_max_yaw_dot, ...]
    a_min_z: float = 5.0
    a_max_z: float = 15.0
    a_max_xy: float = 10.0
    a_max_yaw_dot: float = 10.0

    drone_radius: float = 0.5
    # Speed-scaled collision margin: effective radius r + margin_v * ||v_ref||
    margin_v: float = 0.0

    # --- solver knobs ---
    sqp_iters: int = 10
    sqp_iters_fast: int = 6
    line_search_alphas: int = 8
    reg_init: float = 1e-6
    reg_min: float = 1e-9
    reg_max: float = 1e6
    boxqp_iters: int = 4

    @property
    def horizon_steps(self) -> int:
        """N = T / dt."""
        return int(round(self.mpc_T / self.mpc_dt))

    @property
    def u_lower(self) -> np.ndarray:
        return np.array([-self.a_max_xy, -self.a_max_xy, self.a_min_z, -self.a_max_yaw_dot])

    @property
    def u_upper(self) -> np.ndarray:
        return np.array([self.a_max_xy, self.a_max_xy, self.a_max_z, self.a_max_yaw_dot])

    @property
    def u_hover(self) -> np.ndarray:
        """Control cost reference point [0, 0, g, 0]."""
        return np.array([0.0, 0.0, GRAVITY, 0.0])
