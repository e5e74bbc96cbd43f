from cst_captioning_tpu_torch.decoding.common import (
    apply_min_len,
    counter_gumbel_noise,
    decode_depth,
    forbid_special,
    lane_carry,
    lane_decode_step,
    mask_from_tokens,
    npad_best_lane_index,
    rollout_noise,
    row_logprobs,
    scan_until_finished,
    selected_logprob,
    step_outputs,
)
from cst_captioning_tpu_torch.decoding.sample import sample_decode

__all__ = [
    "apply_min_len",
    "counter_gumbel_noise",
    "decode_depth",
    "forbid_special",
    "lane_carry",
    "lane_decode_step",
    "mask_from_tokens",
    "npad_best_lane_index",
    "rollout_noise",
    "row_logprobs",
    "sample_decode",
    "scan_until_finished",
    "selected_logprob",
    "step_outputs",
]
