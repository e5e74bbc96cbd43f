"""BLEU-1..4, corpus and per sentence (the port's copy of the JAX
package's ``metrics/bleu.py``): clipped n-gram precision against the max
count over the references, the "closest" reference length for the brevity
penalty, the geometric mean over orders. Per-sentence scores (the BLEU4
term of the consensus reward) use +1 smoothing on orders above 1."""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

import numpy as np

from cst_captioning_tpu_torch.metrics.ngram import ngram_counts


def _closest_ref_len(hyp_len: int, ref_lens: Sequence[int]) -> int:
    return min(ref_lens, key=lambda rl: (abs(rl - hyp_len), rl))


def _clipped_matches(
    hyp: Sequence[str], refs: Sequence[Sequence[str]], n: int
) -> Tuple[int, int]:
    """(clipped match count, total hyp n-gram count) for one order."""
    hyp_counts = ngram_counts(hyp, n)
    total = sum(hyp_counts.values())
    if not total:
        return 0, 0
    max_ref: Counter = Counter()
    for ref in refs:
        for g, c in ngram_counts(ref, n).items():
            if c > max_ref[g]:
                max_ref[g] = c
    matched = sum(min(c, max_ref[g]) for g, c in hyp_counts.items())
    return matched, total


class Bleu:
    """BLEU with up to ``max_n`` orders; compute_score mirrors the reference."""

    def __init__(self, max_n: int = 4):
        self.max_n = max_n

    @property
    def method(self) -> List[str]:
        return [f"Bleu_{n}" for n in range(1, self.max_n + 1)]

    def sentence_bleu(
        self, hyp: Sequence[str], refs: Sequence[Sequence[str]]
    ) -> np.ndarray:
        """Smoothed per-sentence BLEU-1..max_n (the reward-side entry point)."""
        scores = np.zeros(self.max_n)
        if not len(hyp):
            return scores
        bp = self._brevity(len(hyp), [len(r) for r in refs])
        log_p = 0.0
        for n in range(1, self.max_n + 1):
            matched, total = _clipped_matches(hyp, refs, n)
            if n == 1:
                p = matched / total if total else 0.0
            else:  # +1 smoothing beyond unigrams
                p = (matched + 1.0) / (total + 1.0) if total else 0.0
            if p == 0.0:
                break  # zero precision zeroes this and all higher orders
            log_p += np.log(p)
            scores[n - 1] = bp * np.exp(log_p / n)
        return scores

    @staticmethod
    def _brevity(hyp_len: int, ref_lens: Sequence[int]) -> float:
        r = _closest_ref_len(hyp_len, ref_lens)
        return 1.0 if hyp_len >= r else float(np.exp(1.0 - r / hyp_len))

    def compute_score(
        self,
        gts: Dict[str, Sequence[Sequence[str]]],
        res: Dict[str, Sequence[Sequence[str]]],
    ) -> Tuple[List[float], List[np.ndarray]]:
        """Corpus BLEU list + per-sentence score arrays, coco-caption style."""
        ids = list(res.keys())
        matched = np.zeros(self.max_n)
        total = np.zeros(self.max_n)
        hyp_len_sum = 0
        ref_len_sum = 0
        per_sentence: List[np.ndarray] = []
        for i in ids:
            hyp = res[i][0]
            refs = gts[i]
            hyp_len_sum += len(hyp)
            ref_len_sum += _closest_ref_len(len(hyp), [len(r) for r in refs])
            for n in range(1, self.max_n + 1):
                m, t = _clipped_matches(hyp, refs, n)
                matched[n - 1] += m
                total[n - 1] += t
            per_sentence.append(self.sentence_bleu(hyp, refs))
        bp = (
            1.0
            if hyp_len_sum >= ref_len_sum
            else float(np.exp(1.0 - ref_len_sum / max(1, hyp_len_sum)))
        )
        corpus: List[float] = []
        log_p = 0.0
        dead = False
        for n in range(self.max_n):
            p = matched[n] / total[n] if total[n] else 0.0
            if p == 0.0:
                dead = True
            if dead:
                corpus.append(0.0)
            else:
                log_p += np.log(p)
                corpus.append(float(bp * np.exp(log_p / (n + 1))))
        # transpose per-sentence to a list of arrays per order, like coco bleu
        per_order = [np.array([s[n] for s in per_sentence]) for n in range(self.max_n)]
        return corpus, per_order
