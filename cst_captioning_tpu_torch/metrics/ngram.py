"""N-gram counting shared by BLEU and CIDEr (the port's copy of the JAX
package's ``metrics/ngram.py``; ``precook`` is the cider package's)."""

from __future__ import annotations

from collections import Counter
from typing import Sequence, Tuple

NGram = Tuple[str, ...]


def ngram_counts(tokens: Sequence[str], n: int) -> Counter:
    """Counter of n-grams of a single order ``n``."""
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def precook(tokens: Sequence[str], max_n: int = 4) -> Counter:
    """Counter over all n-grams of orders 1..max_n (the cider 'precook')."""
    counts: Counter = Counter()
    toks = tuple(tokens)
    L = len(toks)
    for n in range(1, max_n + 1):
        for i in range(L - n + 1):
            counts[toks[i : i + n]] += 1
    return counts
