"""Multi-device: the process group, the ``(data, model)`` mesh, the
placement of the workload on it and its collectives (counterpart of
``diffmm_tpu/parallel``, which leaves the collectives to XLA)."""

from diffmm_tpu_torch.parallel.collectives import (
    AllReduceSum,
    all_reduce_grads,
    placed_all_reduce,
)
from diffmm_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    init_distributed,
    make_mesh,
    single_device_mesh,
)
from diffmm_tpu_torch.parallel.sharding import (
    Shard,
    catalog_spec,
    check_batch_divisibility,
    data_shard,
    denoise_param_shardings,
    edge_shard,
    gcn_param_shardings,
    shard_batch,
    shard_blocks,
    shard_device_data,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "AllReduceSum",
    "Shard",
    "all_reduce_grads",
    "catalog_spec",
    "check_batch_divisibility",
    "data_shard",
    "denoise_param_shardings",
    "edge_shard",
    "gcn_param_shardings",
    "init_distributed",
    "make_mesh",
    "placed_all_reduce",
    "shard_batch",
    "shard_blocks",
    "shard_device_data",
    "single_device_mesh",
]
