"""Consensus reward (host side, cached), the JAX package's
``rl/rewards.py``.

A sampled caption is scored against its video's full pool of ground-truth
captions (the "consensus" of CST): CIDEr-D with a precomputed document
frequency, optionally mixed with sentence BLEU-4 (``w_c * CIDErD + w_b *
BLEU4 * scale``). All reference-side work (tf-idf vectors, norms, lengths,
max-clipped BLEU counts) is done once at construction, so a step only
counts the hypotheses' n-grams. Two scorers give the same float32 numbers
as the JAX package's: the native one (``creward.cpp``, built at first use
by ``rl/native.py``) and the Python one. ``use_native=True`` (the default)
raises if the library cannot be built; it never switches to Python.
"""

from __future__ import annotations

import ctypes
import math
import os
from collections import Counter
from typing import Mapping, Sequence

import numpy as np

from cst_captioning_tpu_torch.config import (
    BOS_ID,
    EOS_ID,
    NUM_SPECIAL_TOKENS,
    PAD_ID,
    UNK_ID,
)
from cst_captioning_tpu_torch.data.vocab import Vocab
from cst_captioning_tpu_torch.metrics import CorpusDF, precook
from cst_captioning_tpu_torch.rl.native import load_creward

_MAX_N = 4
_SIGMA = 6.0


class _RefStats:
    """Cached per-video reference statistics for CIDEr-D and BLEU-4."""

    __slots__ = ("cider_vecs", "bleu_max_counts", "ref_lens")

    def __init__(self, refs: list[list[str]], df: dict, log_ndoc: float):
        # CIDEr-D: per ref, (vec per n, norm per n, unigram length)
        self.cider_vecs = []
        for ref in refs:
            counts = precook(ref, _MAX_N)
            vec = [dict() for _ in range(_MAX_N)]
            norm = np.zeros(_MAX_N)
            length = 0
            for gram, tf in counts.items():
                n_idx = len(gram) - 1
                idf = log_ndoc - math.log(max(1.0, df.get(gram, 0.0)))
                w = float(tf) * idf
                vec[n_idx][gram] = w
                norm[n_idx] += w * w
                if n_idx == 0:
                    length += tf
            self.cider_vecs.append((vec, np.sqrt(norm), length))
        # BLEU: per n, elementwise-max reference counts; plus ref lengths
        self.bleu_max_counts = [Counter() for _ in range(_MAX_N)]
        self.ref_lens = [len(r) for r in refs]
        for ref in refs:
            counts = precook(ref, _MAX_N)
            for gram, tf in counts.items():
                n_idx = len(gram) - 1
                if tf > self.bleu_max_counts[n_idx][gram]:
                    self.bleu_max_counts[n_idx][gram] = tf


def _cider_d_score(hyp_counts: Counter, stats: _RefStats, df: dict,
                   log_ndoc: float) -> float:
    """CIDEr-D of one hypothesis vs a cached reference pool (×10 scale)."""
    hvec = [dict() for _ in range(_MAX_N)]
    hnorm = np.zeros(_MAX_N)
    hlen = 0
    for gram, tf in hyp_counts.items():
        n_idx = len(gram) - 1
        idf = log_ndoc - math.log(max(1.0, df.get(gram, 0.0)))
        w = float(tf) * idf
        hvec[n_idx][gram] = w
        hnorm[n_idx] += w * w
        if n_idx == 0:
            hlen += tf
    hnorm = np.sqrt(hnorm)

    per_ref = np.zeros(_MAX_N)
    for rvec, rnorm, rlen in stats.cider_vecs:
        val = np.zeros(_MAX_N)
        for n_idx in range(_MAX_N):
            rv = rvec[n_idx]
            dot = 0.0
            for gram, hw in hvec[n_idx].items():
                rw = rv.get(gram)
                if rw is not None:
                    dot += min(hw, rw) * rw
            denom = hnorm[n_idx] * rnorm[n_idx]
            if denom > 0:
                val[n_idx] = dot / denom
        delta = float(hlen - rlen)
        per_ref += val * math.exp(-(delta**2) / (2.0 * _SIGMA**2))
    per_ref /= max(1, len(stats.cider_vecs))
    return float(np.mean(per_ref)) * 10.0


def _closest_ref_len(hyp_len: int, ref_lens: Sequence[int]) -> int:
    return min(ref_lens, key=lambda r: (abs(r - hyp_len), r))


def _bleu4_score(hyp: list[str], hyp_counts: Counter, stats: _RefStats) -> float:
    """Smoothed sentence BLEU-4 vs cached max-clipped ref counts.

    Mirrors metrics.bleu.Bleu.sentence_bleu: +1 smoothing above unigrams,
    brevity penalty against the closest reference length.
    """
    if not hyp:
        return 0.0
    hyp_len = len(hyp)
    r = _closest_ref_len(hyp_len, stats.ref_lens)
    bp = 1.0 if hyp_len >= r else math.exp(1.0 - r / hyp_len)
    log_p = 0.0
    score = 0.0
    for n in range(1, _MAX_N + 1):
        matched, total = 0, 0
        maxc = stats.bleu_max_counts[n - 1]
        for gram, tf in hyp_counts.items():
            if len(gram) == n:
                total += tf
                m = maxc.get(gram)
                if m:
                    matched += min(tf, m)
        if n == 1:
            p = matched / total if total else 0.0
        else:
            p = (matched + 1.0) / (total + 1.0) if total else 0.0
        if p == 0.0:
            # only reachable at n=1 (higher orders are +1-smoothed): a
            # hypothesis with zero unigram matches scores 0
            return 0.0
        log_p += math.log(p)
        score = bp * math.exp(log_p / n)
    return score


class RewardComputer:
    def __init__(
        self,
        vocab: Vocab,
        gts_pool: Mapping[str, Sequence[str]],   # video_id -> tokenized GT strings
        df: CorpusDF | None = None,
        cider_weight: float = 1.0,
        bleu_weight: float = 0.0,
        bleu_scale: float = 10.0,
        num_threads: int = 0,
        use_native: bool = True,
    ):
        self.vocab = vocab
        refs = {vid: [c.split() for c in caps] for vid, caps in gts_pool.items()}
        if df is None:
            df = CorpusDF.from_refs(list(refs.values()))
        self.df = df.df
        # same tiny-corpus clamp as metrics.cider (idf stays >= 0)
        self.log_ndoc = math.log(max(float(df.num_docs), math.e))
        self.cider_weight = cider_weight
        self.bleu_weight = bleu_weight
        # BLEU4 is in [0,1] vs CIDEr's x10 scale; bleu_scale (config
        # rl.reward_bleu4_scale) maps it onto the mixing scale
        self.bleu_scale = bleu_scale
        # 0 = all cores: the reward is the host hot path of the RL phase
        self.num_threads = num_threads if num_threads > 0 else (os.cpu_count() or 1)
        self._native = None
        if use_native:
            self._init_native(refs)
        else:
            self.stats = {
                vid: _RefStats(r, self.df, self.log_ndoc) for vid, r in refs.items()
            }

    # ---- native path --------------------------------------------------------

    def _init_native(self, refs: Mapping[str, list[list[str]]]) -> None:
        """Intern words, preload df + reference pools into the C++ kernel.

        Scoring stays in *string space*: the intern table covers reference
        words (incl. OOV words absent from the model vocab) plus all vocab
        words, so id-space grams are bijective with word-tuple grams.
        """
        lib = load_creward()

        intern: dict[str, int] = {}

        def iid(word: str) -> int:
            i = intern.get(word)
            if i is None:
                i = len(intern) + NUM_SPECIAL_TOKENS
                intern[word] = i
            return i

        handle = lib.crw_create(
            ctypes.c_double(self.log_ndoc), ctypes.c_double(_SIGMA),
            PAD_ID, BOS_ID, EOS_ID,
        )

        # df table -> flat arrays of interned grams
        gram_tokens: list[int] = []
        gram_lens: list[int] = []
        gram_counts: list[float] = []
        for gram, count in self.df.items():
            gram_tokens.extend(iid(w) for w in gram)
            gram_lens.append(len(gram))
            gram_counts.append(float(count))
        if gram_lens:
            gt = np.asarray(gram_tokens, np.int32)
            gl = np.asarray(gram_lens, np.int32)
            gc = np.asarray(gram_counts, np.float64)
            lib.crw_set_df(
                handle,
                gt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                gl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                gc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ctypes.c_int64(len(gram_lens)),
            )

        # reference pools
        self._video_index: dict[str, int] = {}
        for vid, pool in refs.items():
            toks = np.asarray(
                [iid(w) for ref in pool for w in ref], np.int32
            )
            lens = np.asarray([len(ref) for ref in pool], np.int32)
            idx = lib.crw_add_video(
                handle,
                toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ctypes.c_int32(len(pool)),
            )
            self._video_index[vid] = int(idx)

        # vocab-id -> intern-id lookup (specials map to themselves, so the
        # kernel's EOS/PAD/BOS handling sees the standard ids)
        lut = np.arange(len(self.vocab), dtype=np.int32)
        for i, word in enumerate(self.vocab.words):
            if i >= NUM_SPECIAL_TOKENS:
                lut[i] = iid(word)
        # UNK decodes to the literal "<unk>" word string in the Python path
        lut[UNK_ID] = iid("<unk>")
        self._lut = lut
        self._lib = lib
        self._handle = handle
        self._native = True

    def __del__(self):
        if getattr(self, "_native", None) and getattr(self, "_handle", None):
            self._lib.crw_free(self._handle)

    # ---- scoring ------------------------------------------------------------

    def __call__(
        self, video_ids: Sequence[str], token_rows: np.ndarray
    ) -> np.ndarray:
        """Score decoded rows against their videos' consensus pools.

        ``token_rows``: [N, T] int array (N = any multiple of len(video_ids);
        rollout-major layouts flatten to rows with ``video_ids`` cycling).
        Returns rewards [N] in CIDEr units (×10 scale, like the reference).
        """
        token_rows = np.ascontiguousarray(token_rows, dtype=np.int32)
        n = len(token_rows)
        nv = len(video_ids)
        if self._native:
            return self._score_native(video_ids, token_rows, n, nv)
        rewards = np.zeros(n, np.float32)
        for i in range(n):
            stats = self.stats[video_ids[i % nv]]
            hyp = self.vocab.decode(token_rows[i]).split()
            counts = precook(hyp, _MAX_N)
            r = self.cider_weight * _cider_d_score(
                counts, stats, self.df, self.log_ndoc
            )
            if self.bleu_weight != 0.0:
                r += (
                    self.bleu_weight * _bleu4_score(hyp, counts, stats)
                    * self.bleu_scale
                )
            rewards[i] = r
        return rewards

    def _score_native(self, video_ids, token_rows, n, nv) -> np.ndarray:
        # ids outside the vocab (model vocab_size > len(vocab)) intern as
        # '<unk>', matching Vocab.decode on the Python path
        in_range = (token_rows >= 0) & (token_rows < len(self._lut))
        interned = np.ascontiguousarray(
            self._lut[np.where(in_range, token_rows, UNK_ID)]
        )
        vidx = np.asarray(
            [self._video_index[video_ids[i % nv]] for i in range(n)], np.int32
        )
        out = np.zeros(n, np.float32)
        self._lib.crw_score(
            self._handle,
            vidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            interned.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_int64(n),
            ctypes.c_int32(token_rows.shape[1]),
            ctypes.c_double(self.cider_weight),
            # the kernel mixes bw*BLEU4*10 (its fixed x10 convention); fold
            # the configurable scale into the weight so bw_eff*10 == w_b*scale
            ctypes.c_double(self.bleu_weight * self.bleu_scale / 10.0),
            ctypes.c_int32(self.num_threads),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out


def scb_baseline(rewards_kb: np.ndarray) -> np.ndarray:
    """Self-consensus baseline (CST_MS_SCB, paper §3.4).

    ``rewards_kb``: [K, B] rollout rewards. Baseline for rollout k is the mean
    reward of the OTHER K-1 rollouts of the same video; K=1 degrades to 0.
    """
    K = rewards_kb.shape[0]
    if K < 2:
        return np.zeros_like(rewards_kb)
    total = rewards_kb.sum(axis=0, keepdims=True)
    return (total - rewards_kb) / (K - 1)
