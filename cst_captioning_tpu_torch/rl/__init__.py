from cst_captioning_tpu_torch.rl.async_scst import (
    AsyncSCSTTrainer,
    RolloutRing,
    make_actor_decode,
    request_actor_preempt,
    request_actor_rejoin,
)
from cst_captioning_tpu_torch.rl.online import OnlineSCSTTrainer
from cst_captioning_tpu_torch.rl.rewards import RewardComputer, scb_baseline
from cst_captioning_tpu_torch.rl.scst import (
    SCSTTrainer,
    make_parallel_rl_decode,
    make_parallel_rl_update,
    make_rl_decode,
    make_rl_update,
    rollout_seed,
)

__all__ = [
    "AsyncSCSTTrainer",
    "OnlineSCSTTrainer",
    "RewardComputer",
    "RolloutRing",
    "SCSTTrainer",
    "make_actor_decode",
    "make_parallel_rl_decode",
    "make_parallel_rl_update",
    "make_rl_decode",
    "make_rl_update",
    "request_actor_preempt",
    "request_actor_rejoin",
    "rollout_seed",
    "scb_baseline",
]
