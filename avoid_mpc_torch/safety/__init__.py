from avoid_mpc_torch.safety.geofence import (  # noqa: F401
    CubeGeofence,
    SphereGeofence,
    geofence_check,
    nearest_fence_distance,
)
