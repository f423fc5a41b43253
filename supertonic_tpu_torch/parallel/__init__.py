from .batcher import ContinuousBatcher
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    batch_sharding,
    initialize_distributed,
    make_mesh,
    pad_batch_to_multiple,
    param_pspecs,
    shard_batch,
    shard_params,
)

__all__ = [
    "ContinuousBatcher",
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "batch_sharding",
    "initialize_distributed",
    "make_mesh",
    "pad_batch_to_multiple",
    "param_pspecs",
    "shard_batch",
    "shard_params",
]
