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
from cst_captioning_tpu_torch.train.steps import make_xe_step, xe_row_weights

__all__ = [
    "Optimizer",
    "TrainState",
    "create_train_state",
    "global_norm",
    "guarded_apply_gradients",
    "make_lr_schedule",
    "make_optimizer",
    "make_xe_step",
    "xe_row_weights",
]
