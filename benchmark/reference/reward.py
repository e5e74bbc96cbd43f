"""The consensus reward in plain Python, on token ids: CIDEr-D (tf-idf
n-gram cosine for n = 1..4, the hypothesis' weights clipped to the
reference's, a Gaussian length penalty of sigma 6, the mean over n and
over the clip's references, times 10) with the document frequency over
the pool's clips, plus a weight times smoothed sentence BLEU-4 (clipped
precision against the references' largest counts, +1 smoothing above
unigrams, the brevity penalty against the closest reference length)
times a scale, as the CST paper's reward (Phan et al., arXiv:1712.09532,
section 3) and the coco-caption definitions give them. A hypothesis is
its tokens up to the first EOS or PAD, BOS skipped."""

from __future__ import annotations

import math
from collections import Counter, defaultdict

PAD_ID, BOS_ID, EOS_ID = 0, 1, 2
MAX_N = 4
SIGMA = 6.0


def grams(toks, n_max: int = MAX_N) -> Counter:
    out = Counter()
    for n in range(1, n_max + 1):
        for i in range(len(toks) - n + 1):
            out[tuple(toks[i:i + n])] += 1
    return out


def hypothesis(row) -> list[int]:
    out = []
    for t in row:
        t = int(t)
        if t in (EOS_ID, PAD_ID):
            break
        if t != BOS_ID:
            out.append(t)
    return out


class ConsensusReward:
    """``refs``: clip id -> its reference captions as id lists (the
    pool's ``caption_ids``, every clip of the split)."""

    def __init__(self, refs: dict, cider_weight: float, bleu_weight: float,
                 bleu_scale: float):
        self.refs = refs
        df = defaultdict(float)
        for caps in refs.values():
            seen = set()
            for c in caps:
                seen.update(grams(c))
            for g in seen:
                df[g] += 1.0
        self.df = df
        self.log_n = math.log(max(float(len(refs)), math.e))
        self.wc, self.wb, self.scale = cider_weight, bleu_weight, bleu_scale
        self._cache = {}

    def _vec(self, counts: Counter):
        vec = [dict() for _ in range(MAX_N)]
        norm = [0.0] * MAX_N
        length = 0
        for g, tf in counts.items():
            n = len(g) - 1
            w = tf * (self.log_n - math.log(max(1.0, self.df.get(g, 0.0))))
            vec[n][g] = w
            norm[n] += w * w
            if n == 0:
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def _stats(self, clip):
        st = self._cache.get(clip)
        if st is None:
            caps = self.refs[clip]
            vecs = [self._vec(grams(c)) for c in caps]
            maxc = Counter()
            for c in caps:
                for g, tf in grams(c).items():
                    maxc[g] = max(maxc[g], tf)
            st = self._cache[clip] = (vecs, maxc, [len(c) for c in caps])
        return st

    def cider_d(self, hyp: list[int], clip) -> float:
        vecs, _, _ = self._stats(clip)
        hv, hn, hl = self._vec(grams(hyp))
        total = [0.0] * MAX_N
        for rv, rn, rl in vecs:
            pen = math.exp(-((hl - rl) ** 2) / (2.0 * SIGMA ** 2))
            for n in range(MAX_N):
                den = hn[n] * rn[n]
                if den <= 0:
                    continue
                ref = rv[n]
                dot = 0.0
                for g, w in hv[n].items():
                    r = ref.get(g)
                    if r is not None:
                        dot += min(w, r) * r
                total[n] += pen * dot / den
        return sum(t / max(1, len(vecs)) for t in total) / MAX_N * 10.0

    def bleu4(self, hyp: list[int], clip) -> float:
        if not hyp:
            return 0.0
        _, maxc, lens = self._stats(clip)
        h = len(hyp)
        r = min(lens, key=lambda x: (abs(x - h), x))
        bp = 1.0 if h >= r else math.exp(1.0 - r / h)
        counts = grams(hyp)
        log_p, score = 0.0, 0.0
        for n in range(1, MAX_N + 1):
            matched = total = 0
            for g, tf in counts.items():
                if len(g) == n:
                    total += tf
                    matched += min(tf, maxc.get(g, 0))
            if n == 1:
                p = matched / total if total else 0.0
            else:
                p = (matched + 1.0) / (total + 1.0) if total else 0.0
            if p == 0.0:
                return 0.0
            log_p += math.log(p)
            score = bp * math.exp(log_p / n)
        return score

    def __call__(self, clips, rows) -> list[float]:
        """Rewards of ``rows`` (token rows) whose clips cycle through
        ``clips``."""
        out = []
        for i, row in enumerate(rows):
            clip = clips[i % len(clips)]
            hyp = hypothesis(row)
            r = self.wc * self.cider_d(hyp, clip)
            if self.wb:
                r += self.wb * self.bleu4(hyp, clip) * self.scale
            out.append(r)
        return out
