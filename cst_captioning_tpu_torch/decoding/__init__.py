from cst_captioning_tpu_torch.decoding.beam import beam_search
from cst_captioning_tpu_torch.decoding.common import (
    apply_min_len,
    counter_gumbel_noise,
    decode_depth,
    forbid_special,
    lane_carry,
    lane_decode_step,
    mask_from_tokens,
    npad_best_lane,
    npad_best_lane_index,
    rollout_noise,
    row_logprobs,
    scan_until_finished,
    selected_logprob,
    step_outputs,
)
from cst_captioning_tpu_torch.decoding.fused import fused_decode, npad_decode
from cst_captioning_tpu_torch.decoding.greedy import greedy_decode
from cst_captioning_tpu_torch.decoding.sample import sample_decode

__all__ = [
    "apply_min_len",
    "beam_search",
    "counter_gumbel_noise",
    "decode_depth",
    "forbid_special",
    "fused_decode",
    "greedy_decode",
    "lane_carry",
    "lane_decode_step",
    "mask_from_tokens",
    "npad_best_lane",
    "npad_best_lane_index",
    "npad_decode",
    "rollout_noise",
    "row_logprobs",
    "sample_decode",
    "scan_until_finished",
    "selected_logprob",
    "step_outputs",
]
