from avoid_mpc_torch.mapping.rolling_map import (  # noqa: F401
    MapShape,
    RollingMap,
    map_add_frame,
    map_init,
    map_keyframe_update,
    map_nearest_distance,
    map_nonempty,
    map_query,
    map_query_culled,
)
