from cst_captioning_tpu_torch.rl.rewards import RewardComputer, scb_baseline
from cst_captioning_tpu_torch.rl.scst import (
    SCSTTrainer,
    make_rl_decode,
    make_rl_update,
)

__all__ = [
    "RewardComputer",
    "SCSTTrainer",
    "make_rl_decode",
    "make_rl_update",
    "scb_baseline",
]
