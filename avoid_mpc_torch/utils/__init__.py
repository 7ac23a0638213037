from avoid_mpc_torch.utils import quaternion  # noqa: F401
