"""METEOR, approximate (the port's copy of the JAX package's
``metrics/meteor.py``): the METEOR 1.5 scoring formula (Denkowski & Lavie
2014) with the exact and stem matcher stages only; the synonym and
paraphrase stages need tables this repository does not have. Reported as
``METEOR_approx`` so it is never taken for the jar's number. Parameters
are METEOR 1.5's English defaults: alpha 0.85, beta 0.2, gamma 0.6."""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

_VOWELS = "aeiou"


def _porter_stem(word: str) -> str:
    """Compact Porter stemmer (1980 algorithm, steps 1a/1b/1c/2-5 abridged).

    Adequate for METEOR's stem-stage matching on caption vocabulary; not a
    full linguistic stemmer.
    """
    w = word
    if len(w) <= 2:
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]
    # step 1b (simplified): -ed / -ing with a vowel in the stem
    for suf in ("ing", "ed"):
        if w.endswith(suf):
            stem = w[: -len(suf)]
            if any(c in _VOWELS for c in stem):
                w = stem
                if w.endswith(("at", "bl", "iz")):
                    w += "e"
                elif len(w) >= 2 and w[-1] == w[-2] and w[-1] not in "lsz":
                    w = w[:-1]
            break
    # step 1c
    if w.endswith("y") and any(c in _VOWELS for c in w[:-1]):
        w = w[:-1] + "i"
    return w


def _align(hyp: Sequence[str], ref: Sequence[str]) -> Tuple[int, int]:
    """Greedy two-stage alignment: exact first, then stem matches.

    Returns (num matches, num chunks). Chunks = maximal runs of matched hyp
    positions mapped to contiguous increasing ref positions.
    """
    ref_used = [False] * len(ref)
    match_to: List[int] = [-1] * len(hyp)  # hyp idx -> ref idx
    # stage 1: exact
    for i, h in enumerate(hyp):
        for j, r in enumerate(ref):
            if not ref_used[j] and h == r:
                ref_used[j] = True
                match_to[i] = j
                break
    # stage 2: stem
    ref_stems = [_porter_stem(r) for r in ref]
    for i, h in enumerate(hyp):
        if match_to[i] >= 0:
            continue
        hs = _porter_stem(h)
        for j in range(len(ref)):
            if not ref_used[j] and hs == ref_stems[j]:
                ref_used[j] = True
                match_to[i] = j
                break
    matches = sum(1 for m in match_to if m >= 0)
    # chunk counting over the matched subsequence
    chunks = 0
    prev_ref = None
    for i in range(len(hyp)):
        j = match_to[i]
        if j < 0:
            prev_ref = None
            continue
        if prev_ref is None or j != prev_ref + 1:
            chunks += 1
        prev_ref = j
    return matches, chunks


class MeteorApprox:
    method = "METEOR_approx"

    def __init__(self, alpha: float = 0.85, beta: float = 0.2, gamma: float = 0.6):
        self.alpha, self.beta, self.gamma = alpha, beta, gamma

    def sentence_score(
        self, hyp: Sequence[str], refs: Sequence[Sequence[str]]
    ) -> float:
        """Max METEOR over the reference pool (the jar's multi-ref behavior)."""
        best = 0.0
        for ref in refs:
            if not len(hyp) or not len(ref):
                continue
            m, chunks = _align(hyp, ref)
            if m == 0:
                continue
            p = m / len(hyp)
            r = m / len(ref)
            f = p * r / (self.alpha * p + (1 - self.alpha) * r)
            frag = chunks / m
            penalty = self.gamma * (frag**3)  # beta exponent = 3 in 1.5
            best = max(best, f * (1 - penalty))
        return best

    def compute_score(
        self,
        gts: Dict[str, Sequence[Sequence[str]]],
        res: Dict[str, Sequence[Sequence[str]]],
    ) -> Tuple[float, np.ndarray]:
        ids = list(res.keys())
        scores = np.array([self.sentence_score(res[i][0], gts[i]) for i in ids])
        return float(np.mean(scores)) if len(scores) else 0.0, scores
