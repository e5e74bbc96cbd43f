from cst_captioning_tpu_torch.rl.rewards import RewardComputer, scb_baseline
from cst_captioning_tpu_torch.rl.scst import (
    SCSTTrainer,
    make_rl_decode,
    make_rl_update,
    rollout_seed,
)

__all__ = [
    "RewardComputer",
    "SCSTTrainer",
    "make_rl_decode",
    "make_rl_update",
    "rollout_seed",
    "scb_baseline",
]
