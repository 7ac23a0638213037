"""Frozen copy of ``avoid_mpc_torch/config.py`` at commit 4c4571f, the
benchmark's plain reference; it imports nothing of the program.

Configuration for the PyTorch port: problem shape, weights, perception
and task (state layout, ``MPCWeights``, ``MPCConfig``,
``PerceptionConfig``, ``TaskConfig``, ``LidarConfig``, ``EngineConfig``
with the port's defaults).  The port's YAML loader is left out: the
benchmark builds its configurations from ``benchmark/configs/*.json``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# State layout: [px, py, pz, yaw, vx, vy, vz, ax, ay, az]
STATE_DIM = 10
# Control layout: [ax_cmd, ay_cmd, az_cmd, yaw_dot]
CONTROL_DIM = 4
OBSTACLE_DIM = 3
GRAVITY = 9.81
# weights vector layout: 10 goal + 10 path + 4 control + 1 collide_lambda
WEIGHTS_DIM = 2 * STATE_DIM + CONTROL_DIM + 1


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

    @staticmethod
    def from_vector(w) -> "MPCWeights":
        """The weights of a 25-vector in reference ordering (the inverse of
        :meth:`as_vector`); the omnidirectional weight stays 0."""
        w = np.asarray(w, dtype=np.float64)
        if w.shape != (WEIGHTS_DIM,):
            raise ValueError(f"MPCWeights.from_vector: want a ({WEIGHTS_DIM},) vector, got shape {w.shape}")
        return MPCWeights(
            q_goal=tuple(float(x) for x in w[:STATE_DIM]),
            q_path=tuple(float(x) for x in w[STATE_DIM:2 * STATE_DIM]),
            q_u=tuple(float(x) for x in w[2 * STATE_DIM:2 * STATE_DIM + CONTROL_DIM]),
            collide_lambda=float(w[-1]),
        )


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Problem shape, weights, bounds, dynamics and solver knobs."""

    # Horizon (reference mpc_parameters.yaml: mpc_T=1.0, mpc_dt=0.033 => N=30)
    mpc_T: float = 1.0
    mpc_dt: float = 0.033
    # Outer re-association iterations per control tick
    mpc_max_iter: int = 3
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
    safety_distance: float = 0.2
    speed: float = 10.0
    # Speed-scaled collision margin: effective radius r + margin_v * ||v_ref||
    margin_v: float = 0.0
    # Time-to-collision slow-down trigger (s); <= 0 disables it
    ttc_threshold: float = 0.0

    # Latency-compensation lookahead seed (s)
    decay: float = 0.015
    # Control loop period
    con_dt: float = 0.033

    # Slow-down PD fallback gains
    slow_down_kp: float = 0.3
    slow_down_kd: float = 0.3

    # --- solver knobs ---
    sqp_iters: int = 10
    sqp_iters_fast: int = 6
    # Culled obstacle association: points within assoc_radius (L-inf) of the
    # horizon path's bounding box, at most assoc_m_max of them (a denser tube
    # is rescued by brute force); assoc_radius <= 0 disables the cull.
    assoc_radius: float = 2.5
    assoc_m_max: int = 8192
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


@dataclasses.dataclass(frozen=True)
class PerceptionConfig:
    """Depth camera and rolling-map parameters."""

    fx: float = 320.0
    fy: float = 320.0
    cx: float = 320.0
    cy: float = 240.0
    width: int = 640
    height: int = 480
    resize_scale: int = 10
    pixel_to_meter: float = 1.0
    depth_max: float = 100.0
    depth_min: float = 0.1
    # Body-to-camera extrinsics, row-major 4x4
    T_b_c: tuple[tuple[float, ...], ...] = (
        (0.0, 0.0, 1.0, 0.05),
        (-1.0, 0.0, 0.0, 0.0),
        (0.0, -1.0, 0.0, 0.01),
        (0.0, 0.0, 0.0, 1.0),
    )
    keyframe_dist_threshold: float = 0.1
    keyframe_count_threshold: int = 10
    max_frame_count: int = 100
    # Simulated depth sensor noise
    depth_std_dev: float = 0.02

    @property
    def Tbc(self) -> np.ndarray:
        return np.asarray(self.T_b_c, dtype=np.float64)

    @property
    def grid_width(self) -> int:
        return self.width // self.resize_scale

    @property
    def grid_height(self) -> int:
        return self.height // self.resize_scale

    @property
    def points_per_frame(self) -> int:
        return self.grid_width * self.grid_height


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """Mission parameters."""

    task: str = "forward"  # "forward" | "global_goal"
    height: float = 1.5
    goal_x: float = 500.0
    use_odom_est: bool = True
    only_trust_vel: bool = False


@dataclasses.dataclass(frozen=True)
class LidarConfig:
    """Rotating-lidar sensor parameters (Velodyne VLP-16 defaults; angles in
    degrees, z-up local frame)."""

    number_of_channels: int = 16
    range: float = 100.0  # meters
    points_per_second: int = 100000
    rotations_per_second: int = 10
    horizontal_fov_start: float = 0.0
    horizontal_fov_end: float = 359.0
    vertical_fov_upper: float = -15.0
    vertical_fov_lower: float = -45.0
    update_frequency: float = 10.0  # Hz
    rel_position: tuple[float, float, float] = (0.0, 0.0, 1.0)
    range_std_dev: float = 0.0  # per-point range noise

    @property
    def points_per_scan(self) -> int:
        return int(self.points_per_second / self.update_frequency)

    @property
    def points_per_channel(self) -> int:
        return self.points_per_scan // self.number_of_channels


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level bundle: MPC + perception + task + lidar."""

    mpc: MPCConfig = dataclasses.field(default_factory=MPCConfig)
    perception: PerceptionConfig = dataclasses.field(default_factory=PerceptionConfig)
    task: TaskConfig = dataclasses.field(default_factory=TaskConfig)
    lidar: LidarConfig = dataclasses.field(default_factory=LidarConfig)
