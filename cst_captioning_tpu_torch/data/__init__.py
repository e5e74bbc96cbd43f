from cst_captioning_tpu_torch.data.batcher import Batch, encode_label_row
from cst_captioning_tpu_torch.data.vocab import SPECIAL_TOKENS, Vocab

__all__ = ["Batch", "SPECIAL_TOKENS", "Vocab", "encode_label_row"]
