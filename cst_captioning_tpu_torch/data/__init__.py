from cst_captioning_tpu_torch.data.batcher import Batch, Batcher, encode_label_row
from cst_captioning_tpu_torch.data.dataset import (
    CaptionDataset,
    FeatureStore,
    VideoRecord,
    convert_h5_features,
    write_features,
)
from cst_captioning_tpu_torch.data.importers import import_msrvtt, import_msvd
from cst_captioning_tpu_torch.data.prefetch import prefetch_to_device
from cst_captioning_tpu_torch.data.preprocess import (
    build_info_json,
    build_vocab,
    compute_cider_df,
    compute_consensus_weights,
    tokenize_captions,
)
from cst_captioning_tpu_torch.data.synthetic import make_synthetic_dataset
from cst_captioning_tpu_torch.data.vocab import SPECIAL_TOKENS, Vocab

__all__ = [
    "Batch",
    "Batcher",
    "CaptionDataset",
    "FeatureStore",
    "SPECIAL_TOKENS",
    "VideoRecord",
    "Vocab",
    "build_info_json",
    "build_vocab",
    "compute_cider_df",
    "compute_consensus_weights",
    "convert_h5_features",
    "encode_label_row",
    "import_msrvtt",
    "import_msvd",
    "make_synthetic_dataset",
    "prefetch_to_device",
    "tokenize_captions",
    "write_features",
]
