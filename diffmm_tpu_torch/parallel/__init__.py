"""Multi-device: the process group, the ``(data, model)`` mesh, the
placement of the workload on it and its collectives (counterpart of
``diffmm_tpu/parallel``, which leaves the collectives to XLA)."""

from diffmm_tpu_torch.parallel.collectives import (
    AllGatherRows,
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
    Split,
    catalog_range,
    catalog_spec,
    check_batch_divisibility,
    data_shard,
    denoise_param_shardings,
    edge_shard,
    gather_params,
    gcn_param_shardings,
    make_split,
    place_adam_state,
    shard_batch,
    shard_blocks,
    shard_device_data,
    shard_params,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "AllGatherRows",
    "AllReduceSum",
    "Shard",
    "Split",
    "all_reduce_grads",
    "catalog_range",
    "catalog_spec",
    "check_batch_divisibility",
    "data_shard",
    "denoise_param_shardings",
    "edge_shard",
    "gather_params",
    "gcn_param_shardings",
    "init_distributed",
    "make_mesh",
    "make_split",
    "place_adam_state",
    "placed_all_reduce",
    "shard_batch",
    "shard_blocks",
    "shard_device_data",
    "shard_params",
    "single_device_mesh",
]
