from cst_captioning_tpu_torch.train.schedule import (
    Optimizer,
    global_norm,
    make_lr_schedule,
    make_optimizer,
)
from cst_captioning_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    guarded_apply_gradients,
)
from cst_captioning_tpu_torch.train.mesh import (
    DataMesh,
    batch_sharding,
    make_mesh,
    replicate,
    shard_batch,
)
from cst_captioning_tpu_torch.train.steps import (
    make_parallel_xe_step,
    make_xe_step,
    xe_row_weights,
)

__all__ = [
    "DataMesh",
    "Optimizer",
    "TrainState",
    "batch_sharding",
    "create_train_state",
    "global_norm",
    "guarded_apply_gradients",
    "make_lr_schedule",
    "make_mesh",
    "make_optimizer",
    "make_parallel_xe_step",
    "make_xe_step",
    "replicate",
    "shard_batch",
    "xe_row_weights",
]
