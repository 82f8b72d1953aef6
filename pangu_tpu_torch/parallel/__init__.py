"""Data parallelism across processes (port of ``pangu_tpu/parallel``): the
runtime and mesh policy, and ZeRO sharding of the optimizer state."""

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
    zero_bytes_per_device,
    zero_constraint,
    zero_shard_opt_state,
)
