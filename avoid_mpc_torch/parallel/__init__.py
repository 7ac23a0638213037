from avoid_mpc_torch.parallel.mesh import (  # noqa: F401
    knn_sharded_points,
    make_mesh,
    shard_solve,
    sharded_metrics,
)
