"""Device-mesh utilities: sharding batch axes across devices."""
from mind_the_gaps_tpu.parallel.mesh import (
    default_mesh,
    shard_batch,
    pad_to_multiple,
)

__all__ = ["default_mesh", "shard_batch", "pad_to_multiple"]
