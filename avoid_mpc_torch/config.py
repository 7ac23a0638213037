"""Configuration for the PyTorch port: problem shape, weights, perception,
task and the YAML loader.

The port's own copy of ``avoid_mpc_tpu/config.py`` (state layout,
``MPCWeights``, ``MPCConfig``, ``PerceptionConfig``, ``TaskConfig``,
``LidarConfig``, ``EngineConfig`` with the same defaults, and
:func:`load_config`, which reads the reference's flat YAML key space, so
``configs/default.yaml`` and a reference ``mpc_parameters.yaml`` drop in
unchanged).  Kept as a copy, not an import, so that the port never loads
the JAX package.  PyYAML is imported inside :func:`load_config` only.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

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


def _pick(d: dict[str, Any], *names: str, default: Any = None) -> Any:
    for n in names:
        if n in d:
            return d[n]
    return default


_STATE_NAMES = ["p_x", "p_y", "p_z", "yaw", "v_x", "v_y", "v_z", "a_x", "a_y", "a_z"]


def load_config(path: str | None = None) -> EngineConfig:
    """An :class:`EngineConfig` from YAML in the reference's flat key space
    (goal_p_x, tau_a_x, ...; an optional nested ``lidar`` block).  ``path``
    defaults to ``configs/default.yaml`` of the checkout."""
    import yaml  # only here: nothing on the kernels' path needs PyYAML

    if path is None:
        path = os.path.join(os.path.dirname(__file__), "..", "configs", "default.yaml")
    with open(path) as f:
        d = yaml.safe_load(f)

    defaults = MPCConfig()
    dw = defaults.weights
    weights = MPCWeights(
        q_goal=tuple(float(_pick(d, f"goal_{n}", default=g)) for n, g in zip(_STATE_NAMES, dw.q_goal)),
        q_path=tuple(float(_pick(d, f"path_{n}", default=g)) for n, g in zip(_STATE_NAMES, dw.q_path)),
        q_u=tuple(float(_pick(d, f"u_{n}", default=g))
                  for n, g in zip(["a_x", "a_y", "a_z", "yaw_dot"], dw.q_u)),
        collide_lambda=float(_pick(d, "collide_lambda", default=dw.collide_lambda)),
        collide_lambda_omni=float(_pick(d, "collide_lambda_omni", default=dw.collide_lambda_omni)),
    )

    def mpc_f(key, field):
        return float(_pick(d, key, default=getattr(defaults, field)))

    mpc = MPCConfig(
        mpc_T=mpc_f("mpc_T", "mpc_T"),
        mpc_dt=mpc_f("mpc_dt", "mpc_dt"),
        mpc_max_iter=int(_pick(d, "mpc_max_iter", default=defaults.mpc_max_iter)),
        nearest_point_count=int(_pick(d, "nearest_point_num", default=defaults.nearest_point_count)),
        use_drag_coefficient=bool(int(_pick(d, "use_drag_coefficient", default=0))),
        weights=weights,
        tau=tuple(float(_pick(d, k, default=v)) for k, v in zip(
            ["tau_a_x", "tau_a_y", "tau_a_z", "tau_yaw_dot"], defaults.tau)),
        gain=tuple(float(_pick(d, k, default=v)) for k, v in zip(
            ["gain_a_x", "gain_a_y", "gain_a_z", "gain_yaw_dot"], defaults.gain)),
        **{name: mpc_f(name, name) for name in (
            "a_min_z", "a_max_z", "a_max_xy", "a_max_yaw_dot", "drone_radius", "safety_distance", "speed",
            "margin_v", "ttc_threshold", "decay", "slow_down_kp", "slow_down_kd")},
    )
    pdef = PerceptionConfig()
    perception = PerceptionConfig(
        fx=float(_pick(d, "fx", default=pdef.fx)),
        fy=float(_pick(d, "fy", default=pdef.fy)),
        cx=float(_pick(d, "cx", default=pdef.cx)),
        cy=float(_pick(d, "cy", default=pdef.cy)),
        resize_scale=int(_pick(d, "resize_scale", default=pdef.resize_scale)),
        pixel_to_meter=float(_pick(d, "pixel2meter", default=pdef.pixel_to_meter)),
        depth_max=float(_pick(d, "depth_max", default=pdef.depth_max)),
        depth_min=float(_pick(d, "depth_min", default=pdef.depth_min)),
        T_b_c=tuple(tuple(float(v) for v in row) for row in _pick(d, "T_b_c", default=pdef.T_b_c)),
        keyframe_dist_threshold=float(_pick(d, "keyframe_th_dist", default=pdef.keyframe_dist_threshold)),
        keyframe_count_threshold=int(_pick(d, "keyframe_th_count", default=pdef.keyframe_count_threshold)),
        max_frame_count=int(_pick(d, "max_frame_count", default=pdef.max_frame_count)),
    )
    tdef = TaskConfig()
    task = TaskConfig(
        task=str(_pick(d, "task", default=tdef.task)),
        height=float(_pick(d, "height", default=tdef.height)),
        goal_x=float(_pick(d, "goal_x", default=tdef.goal_x)),
        use_odom_est=bool(_pick(d, "use_odom_est", default=tdef.use_odom_est)),
        only_trust_vel=bool(_pick(d, "only_trust_vel", default=tdef.only_trust_vel)),
    )
    ldef = LidarConfig()
    lb = d.get("lidar", {}) or {}

    def lidar_v(cast, camel, snake):
        return cast(_pick(lb, camel, snake, default=getattr(ldef, snake)))

    lidar = LidarConfig(
        number_of_channels=lidar_v(int, "NumberOfChannels", "number_of_channels"),
        range=lidar_v(float, "Range", "range"),
        points_per_second=lidar_v(int, "PointsPerSecond", "points_per_second"),
        rotations_per_second=lidar_v(int, "RotationsPerSecond", "rotations_per_second"),
        horizontal_fov_start=lidar_v(float, "HorizontalFOVStart", "horizontal_fov_start"),
        horizontal_fov_end=lidar_v(float, "HorizontalFOVEnd", "horizontal_fov_end"),
        vertical_fov_upper=lidar_v(float, "VerticalFOVUpper", "vertical_fov_upper"),
        vertical_fov_lower=lidar_v(float, "VerticalFOVLower", "vertical_fov_lower"),
        update_frequency=lidar_v(float, "UpdateFrequency", "update_frequency"),
        rel_position=tuple(float(v) for v in _pick(lb, "rel_position", default=ldef.rel_position)),
        range_std_dev=float(_pick(lb, "range_std_dev", default=ldef.range_std_dev)),
    )
    return EngineConfig(mpc=mpc, perception=perception, task=task, lidar=lidar)
