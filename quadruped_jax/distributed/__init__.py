from quadruped_jax.distributed.mesh import (  # noqa: F401
    make_mesh,
    batch_sharding,
    replicated_sharding,
    shard_batch,
)
from quadruped_jax.distributed.runtime import (  # noqa: F401
    initialize_from_env,
    global_mesh,
    host_local_to_global,
    global_to_host_local,
)
from quadruped_jax.distributed.solver_sp import solve_cone_sp  # noqa: F401
