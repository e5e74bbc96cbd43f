"""Caption metrics, the port's copies of the JAX package's ``metrics/``:
the PTB-style tokenizer, BLEU, ROUGE-L, METEOR (approximate), CIDEr,
CIDEr-D with a pluggable document frequency (the consensus reward reads
``precook`` and ``CorpusDF``), and the :class:`CaptionScorer` table with
CIDEr-D through the native library."""

from cst_captioning_tpu_torch.metrics.bleu import Bleu
from cst_captioning_tpu_torch.metrics.cider import Cider, CiderD, CorpusDF
from cst_captioning_tpu_torch.metrics.meteor import MeteorApprox
from cst_captioning_tpu_torch.metrics.ngram import ngram_counts, precook
from cst_captioning_tpu_torch.metrics.rouge import RougeL
from cst_captioning_tpu_torch.metrics.scorer import CaptionScorer, score_captions
from cst_captioning_tpu_torch.metrics.tokenizer import (
    ptb_tokenize,
    ptb_tokenize_corpus,
)

__all__ = [
    "Bleu",
    "CaptionScorer",
    "Cider",
    "CiderD",
    "CorpusDF",
    "MeteorApprox",
    "RougeL",
    "ngram_counts",
    "precook",
    "ptb_tokenize",
    "ptb_tokenize_corpus",
    "score_captions",
]
