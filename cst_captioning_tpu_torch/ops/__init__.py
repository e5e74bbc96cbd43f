from cst_captioning_tpu_torch.ops import decode_stride as _decode_stride
from cst_captioning_tpu_torch.ops.beam_step import (
    beam_step_plain,
    fused_beam_step,
    fused_beam_step_,
)
from cst_captioning_tpu_torch.ops.attention import (
    additive_attention_plain,
    fused_additive_attention,
)
from cst_captioning_tpu_torch.ops.decode_step import (
    decode_step_plain,
    fused_decode_step,
    fused_decode_step_,
)
from cst_captioning_tpu_torch.ops.decode_stride import (
    decode_stride_plain,
    fused_decode_stride,
    fused_decode_stride_paged,
    gather_pages,
    stride_weights,
)


def reset_launches() -> None:
    """Set every kernel wrapper's launch counts to 0."""
    _decode_stride.reset_launches()
    fused_additive_attention.launches = 0
    for fn in (fused_decode_step, fused_beam_step):
        fn.launches = fn.launches_bf16 = 0


__all__ = [
    "additive_attention_plain",
    "beam_step_plain",
    "decode_step_plain",
    "decode_stride_plain",
    "fused_additive_attention",
    "fused_beam_step",
    "fused_beam_step_",
    "fused_decode_step",
    "fused_decode_step_",
    "fused_decode_stride",
    "fused_decode_stride_paged",
    "gather_pages",
    "reset_launches",
    "stride_weights",
]
