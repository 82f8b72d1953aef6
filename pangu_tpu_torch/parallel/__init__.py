"""Data and spatial parallelism across processes (port of
``pangu_tpu/parallel``): the runtime and mesh policy, ZeRO sharding of the
optimizer state, and the lat x lon slabs of the token grid."""

from pangu_tpu_torch.parallel.mesh import (  # noqa: F401
    activate_mesh,
    distributed_init,
    is_main,
    make_mesh,
    resolve_mesh,
)
from pangu_tpu_torch.parallel.sharding import (  # noqa: F401
    replicate_constraint,
    shard_batch,
    shard_params,
    spatial_reduce,
    zero_bytes_per_device,
    zero_constraint,
    zero_shard_opt_state,
)
