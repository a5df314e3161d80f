"""Device-mesh parallelism over ``torch.distributed``: one process per
GPU, a ("dp", "tp") ``DeviceMesh``, batch-split predictors that run no
collective and bin-split ones that finish in collectives over tp."""

from .mesh import (BATCH_AXIS, TABLE_AXIS, batch_sharding,
                   initialize_multihost, make_mesh, replicated_sharding,
                   shard_params)
from .shard import make_sharded_predict, shard_table_data

__all__ = ["initialize_multihost", "make_mesh", "batch_sharding",
           "replicated_sharding", "shard_params", "make_sharded_predict",
           "shard_table_data", "BATCH_AXIS", "TABLE_AXIS"]
