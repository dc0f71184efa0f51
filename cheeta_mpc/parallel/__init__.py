from cheeta_mpc.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_batch,
    sharded_batch_solver,
)
