"""N-gram counting and CIDEr document frequency: the port's copies of
``precook`` (``cst_captioning_tpu/metrics/ngram.py``) and ``CorpusDF``
(``metrics/cider.py``), which the consensus reward reads."""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, Sequence, Tuple

NGram = Tuple[str, ...]


def precook(tokens: Sequence[str], max_n: int = 4) -> Counter:
    """Counter over all n-grams of orders 1..max_n (the cider 'precook')."""
    counts: Counter = Counter()
    toks = tuple(tokens)
    L = len(toks)
    for n in range(1, max_n + 1):
        for i in range(L - n + 1):
            counts[toks[i : i + n]] += 1
    return counts


class CorpusDF:
    """Document frequency over a caption corpus: ``df[ngram]`` = number of
    videos in whose reference pool the n-gram appears; ``num_docs`` =
    number of videos."""

    def __init__(self, df: Dict[NGram, float], num_docs: int):
        self.df = df
        self.num_docs = num_docs

    @classmethod
    def from_refs(cls, refs_per_doc: Sequence[Sequence[Sequence[str]]],
                  max_n: int = 4) -> "CorpusDF":
        """Build df from an iterable of per-video reference token lists."""
        df: Dict[NGram, float] = defaultdict(float)
        ndoc = 0
        for refs in refs_per_doc:
            ndoc += 1
            seen = set()
            for ref in refs:
                seen.update(precook(ref, max_n).keys())
            for g in seen:
                df[g] += 1.0
        return cls(dict(df), ndoc)
