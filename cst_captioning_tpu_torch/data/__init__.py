from cst_captioning_tpu_torch.data.batcher import Batch, Batcher, encode_label_row
from cst_captioning_tpu_torch.data.vocab import SPECIAL_TOKENS, Vocab

__all__ = ["Batch", "Batcher", "SPECIAL_TOKENS", "Vocab", "encode_label_row"]
