"""ROUGE-L (the port's copy of the JAX package's ``metrics/rouge.py``):
the LCS F-measure with beta 1.2, taking the max precision and the max
recall over an instance's references (the coco-caption convention)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    """Classic O(len(a)*len(b)) LCS length with a rolling row."""
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


class RougeL:
    method = "ROUGE_L"

    def __init__(self, beta: float = 1.2):
        self.beta = beta

    def sentence_score(
        self, hyp: Sequence[str], refs: Sequence[Sequence[str]]
    ) -> float:
        if not len(hyp):
            return 0.0
        precs: List[float] = []
        recs: List[float] = []
        for ref in refs:
            lcs = _lcs_len(hyp, ref)
            precs.append(lcs / len(hyp))
            recs.append(lcs / len(ref) if len(ref) else 0.0)
        p, r = max(precs), max(recs)
        if p == 0.0 or r == 0.0:
            return 0.0
        b2 = self.beta**2
        return (1 + b2) * p * r / (r + b2 * p)

    def compute_score(
        self,
        gts: Dict[str, Sequence[Sequence[str]]],
        res: Dict[str, Sequence[Sequence[str]]],
    ) -> Tuple[float, np.ndarray]:
        ids = list(res.keys())
        scores = np.array([self.sentence_score(res[i][0], gts[i]) for i in ids])
        return float(np.mean(scores)) if len(scores) else 0.0, scores
