"""CIDEr and CIDEr-D with a pluggable document frequency (the port's copy
of the JAX package's ``metrics/cider.py``; Vedantam et al., CVPR 2015):

- tf-idf vectors over n-grams n = 1..4, idf from a document-frequency
  table;
- CIDEr: the cosine similarity averaged over references and orders, x10;
- CIDEr-D: hypothesis weights clipped to the reference's, times a
  Gaussian length penalty exp(-(l_h - l_r)^2 / (2 sigma^2)), sigma 6, x10.

``df="corpus"`` computes the df from the references being scored (eval);
a :class:`CorpusDF` over the train split is what the RL reward uses.
"""

from __future__ import annotations

import io
import math
import pickle
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from cst_captioning_tpu_torch.metrics.ngram import NGram, precook


class CorpusDF:
    """Precomputed document frequency over a caption corpus.

    ``df[ngram]`` = number of *videos* (documents) in whose reference pool the
    n-gram appears at least once; ``num_docs`` = number of videos (the RL
    reward's df is built over the train split).
    """

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

    def save(self, path: str) -> None:
        """Write the port's npz: ``grams`` (each n-gram's words joined by
        a space), ``counts`` and ``num_docs``; no pickle."""
        grams = list(self.df)
        with open(path, "wb") as f:
            np.savez(f, grams=np.array([" ".join(g) for g in grams], dtype=str),
                     counts=np.array([self.df[g] for g in grams], np.float64),
                     num_docs=np.int64(self.num_docs))

    @classmethod
    def load(cls, path: str) -> "CorpusDF":
        """Read the port's npz or the JAX package's ``CorpusDF.save`` file
        (a pickle of ``{"df": {n-gram tuple: count}, "num_docs": n}``,
        read with an unpickler that builds no objects but plain
        containers, strings and numbers)."""
        with open(path, "rb") as f:
            blob = f.read()
        if blob[:2] == b"PK":
            with np.load(io.BytesIO(blob), allow_pickle=False) as z:
                df = {tuple(str(g).split(" ")): float(c)
                      for g, c in zip(z["grams"], z["counts"])}
                return cls(df, int(z["num_docs"]))
        d = _PlainUnpickler(io.BytesIO(blob)).load()
        return cls({tuple(g): float(c) for g, c in d["df"].items()},
                   int(d["num_docs"]))


class _PlainUnpickler(pickle.Unpickler):
    """Refuses every global, so only builtin containers, strings and
    numbers come out."""

    def find_class(self, module, name):
        raise pickle.UnpicklingError(
            f"CorpusDF file refers to {module}.{name}; only plain data is "
            "read")


def _counts_to_vec(
    counts: Counter, df: Dict[NGram, float], log_ndoc: float, max_n: int
) -> Tuple[List[Dict[NGram, float]], np.ndarray, int]:
    """tf-idf vector per n-gram order, its L2 norms, and the unigram length."""
    vec: List[Dict[NGram, float]] = [dict() for _ in range(max_n)]
    norm = np.zeros(max_n)
    length = 0
    for ngram, tf in counts.items():
        n_idx = len(ngram) - 1
        idf = log_ndoc - math.log(max(1.0, df.get(ngram, 0.0)))
        w = float(tf) * idf
        vec[n_idx][ngram] = w
        norm[n_idx] += w * w
        if n_idx == 0:
            length += tf
    return vec, np.sqrt(norm), length


class _CiderBase:
    """Shared machinery for CIDEr and CIDEr-D."""

    def __init__(self, df: "CorpusDF | str" = "corpus", max_n: int = 4,
                 sigma: float = 6.0):
        self.max_n = max_n
        self.sigma = sigma
        self._df_source = df

    # -- subclass hooks -------------------------------------------------------
    def _pair_sim(self, hvec, rvec, hnorm, rnorm, hlen, rlen) -> np.ndarray:
        raise NotImplementedError

    # -- public API (compute_score mirrors the reference scorers) -------------
    def compute_score(
        self,
        gts: Dict[str, Sequence[Sequence[str]]],
        res: Dict[str, Sequence[Sequence[str]]],
    ) -> Tuple[float, np.ndarray]:
        """Score hypotheses against reference pools.

        gts: {id: [ref tokens, ...]}; res: {id: [hyp tokens]} (one hyp per id,
        as in the reference's scorers). Returns (corpus mean, per-id array) —
        the per-id array is the RL reward vector.
        """
        ids = list(res.keys())
        assert all(i in gts for i in ids), "every hypothesis needs references"

        if isinstance(self._df_source, CorpusDF):
            df, ndoc = self._df_source.df, self._df_source.num_docs
        else:  # "corpus": df over the refs being scored, like eval-mode cider
            df_obj = CorpusDF.from_refs([gts[i] for i in ids], self.max_n)
            df, ndoc = df_obj.df, df_obj.num_docs
        # The reference clips num_docs to >= e so idf stays >= 0 on tiny sets.
        log_ndoc = math.log(max(float(ndoc), math.e))

        scores = np.zeros(len(ids))
        for k, i in enumerate(ids):
            hyps = res[i]
            assert len(hyps) == 1, "one hypothesis per id"
            hvec, hnorm, hlen = _counts_to_vec(
                precook(hyps[0], self.max_n), df, log_ndoc, self.max_n
            )
            per_ref = np.zeros(self.max_n)
            for ref in gts[i]:
                rvec, rnorm, rlen = _counts_to_vec(
                    precook(ref, self.max_n), df, log_ndoc, self.max_n
                )
                per_ref += self._pair_sim(hvec, rvec, hnorm, rnorm, hlen, rlen)
            per_ref /= max(1, len(gts[i]))
            scores[k] = float(np.mean(per_ref)) * 10.0
        return float(np.mean(scores)) if len(scores) else 0.0, scores


class Cider(_CiderBase):
    """Plain CIDEr: average tf-idf cosine over n-gram orders."""

    method = "CIDEr"

    def _pair_sim(self, hvec, rvec, hnorm, rnorm, hlen, rlen) -> np.ndarray:
        val = np.zeros(self.max_n)
        for n_idx in range(self.max_n):
            dot = 0.0
            hv, rv = hvec[n_idx], rvec[n_idx]
            small = hv if len(hv) <= len(rv) else rv
            other = rv if small is hv else hv
            for g, w in small.items():
                ow = other.get(g)
                if ow is not None:
                    dot += w * ow
            denom = hnorm[n_idx] * rnorm[n_idx]
            if denom > 0:
                val[n_idx] = dot / denom
        return val


class CiderD(_CiderBase):
    """CIDEr-D: clipped counts + gaussian length penalty (the RL reward)."""

    method = "CIDEr-D"

    def _pair_sim(self, hvec, rvec, hnorm, rnorm, hlen, rlen) -> np.ndarray:
        val = np.zeros(self.max_n)
        for n_idx in range(self.max_n):
            dot = 0.0
            for g, hw in hvec[n_idx].items():
                rw = rvec[n_idx].get(g)
                if rw is not None:
                    # clip hypothesis tf-idf weight to the reference's
                    dot += min(hw, rw) * rw
            denom = hnorm[n_idx] * rnorm[n_idx]
            if denom > 0:
                val[n_idx] = dot / denom
        delta = float(hlen - rlen)
        val *= math.exp(-(delta**2) / (2.0 * self.sigma**2))
        return val
