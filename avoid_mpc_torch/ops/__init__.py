from avoid_mpc_torch.ops.knn import (  # noqa: F401
    knn,
    knn_chunked,
    knn_culled,
    cull_by_bbox,
    nearest_distance,
    FAR_SENTINEL,
)
from avoid_mpc_torch.ops.depth import (  # noqa: F401
    CameraModel,
    depth_to_points,
    edge_cloud,
    process_depth_frame,
)
