"""CIDEr-D through the native merge-join library for the eval scorer
(the port's copy of the JAX package's ``metrics/native_cider.py``).

The consensus reward's library (``rl/creward.cpp``, built by
``rl/native.py``) scores CIDEr-D; this adapter lets
:class:`metrics.scorer.CaptionScorer` score its CIDEr-D column through it:

- scoring stays in string space: reference and hypothesis words are
  interned into a private id table above the special tokens;
- the reference pools and the df are loaded into the library once per
  pool, so repeated scoring of one split runs at merge-join speed;
- ``df="corpus"`` reproduces the Python scorer's eval semantics (df over
  the pools of the ids being scored); a :class:`CorpusDF` goes in as is.

The library returns float32 scores, within about 1e-7 relative of the
float64 Python scorer. A library that cannot be built raises;
:meth:`NativeCiderD.compute_score` returns None for hypotheses whose ids
differ from the pool's, and the caller then scores them in Python.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cst_captioning_tpu_torch.config import (
    BOS_ID,
    EOS_ID,
    NUM_SPECIAL_TOKENS,
    PAD_ID,
)
from cst_captioning_tpu_torch.metrics.cider import CorpusDF
from cst_captioning_tpu_torch.rl.native import load_creward

_SIGMA = 6.0  # CIDEr-D length-penalty sigma (matches metrics.cider / kernel)


class NativeCiderD:
    """Kernel-backed ``CiderD.compute_score`` for one fixed reference pool."""

    def __init__(self, gts: Dict[str, Sequence[Sequence[str]]],
                 df: "CorpusDF | str"):
        lib = load_creward()    # raises if the library cannot be built
        self._lib = lib
        self._gts = gts
        self._intern: dict[str, int] = {}

        ids = list(gts.keys())
        if isinstance(df, CorpusDF):
            table, ndoc = df.df, df.num_docs
        else:  # "corpus": df over the pools being scored (eval mode)
            df_obj = CorpusDF.from_refs([gts[i] for i in ids])
            table, ndoc = df_obj.df, df_obj.num_docs
        log_ndoc = math.log(max(float(ndoc), math.e))

        self._handle = lib.crw_create(
            ctypes.c_double(log_ndoc), ctypes.c_double(_SIGMA),
            PAD_ID, BOS_ID, EOS_ID,
        )
        gram_tokens: list[int] = []
        gram_lens: list[int] = []
        gram_counts: list[float] = []
        for gram, count in table.items():
            gram_tokens.extend(self._iid(w) for w in gram)
            gram_lens.append(len(gram))
            gram_counts.append(float(count))
        if gram_lens:
            gt = np.asarray(gram_tokens, np.int32)
            gl = np.asarray(gram_lens, np.int32)
            gc = np.asarray(gram_counts, np.float64)
            lib.crw_set_df(
                self._handle,
                gt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                gl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                gc.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                ctypes.c_int64(len(gram_lens)),
            )
        self._video_index: dict[str, int] = {}
        for vid, pool in gts.items():
            toks = np.asarray(
                [self._iid(w) for ref in pool for w in ref], np.int32
            )
            lens = np.asarray([len(ref) for ref in pool], np.int32)
            idx = lib.crw_add_video(
                self._handle,
                toks.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ctypes.c_int32(len(pool)),
            )
            self._video_index[vid] = int(idx)

    def _iid(self, word: str) -> int:
        i = self._intern.get(word)
        if i is None:
            i = len(self._intern) + NUM_SPECIAL_TOKENS
            self._intern[word] = i
        return i

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.crw_free(self._handle)

    def covers(self, gts: Dict[str, Sequence[Sequence[str]]]) -> bool:
        """True when this instance was prepared for exactly this pool."""
        return self._gts == gts

    def compute_score(
        self, res: Dict[str, Sequence[Sequence[str]]]
    ) -> Optional[Tuple[float, np.ndarray]]:
        """(corpus mean, per-id array) in res-key order, the Python
        ``CiderD.compute_score`` contract; None when ``res`` ids do not
        match the prepared pool (df="corpus" depends on the id set; the
        caller scores in Python). The library computes in double and
        returns float32 (``creward.cpp``'s ``out[i] = (float)r``)."""
        ids = list(res.keys())
        if set(ids) != set(self._video_index):
            return None
        hyps: List[List[str]] = []
        for i in ids:
            if len(res[i]) != 1:
                raise ValueError(f"{i!r}: one hypothesis per id")
            hyps.append(list(res[i][0]))
        width = max((len(h) for h in hyps), default=0) or 1
        rows = np.full((len(ids), width), PAD_ID, np.int32)
        for r, hyp in enumerate(hyps):
            rows[r, : len(hyp)] = [self._iid(w) for w in hyp]
        vidx = np.asarray([self._video_index[i] for i in ids], np.int32)
        out = np.zeros(len(ids), np.float32)
        self._lib.crw_score(
            self._handle,
            vidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            np.ascontiguousarray(rows).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)
            ),
            ctypes.c_int64(len(ids)),
            ctypes.c_int32(width),
            ctypes.c_double(1.0),   # pure CIDEr-D
            ctypes.c_double(0.0),   # no BLEU term
            ctypes.c_int32(os.cpu_count() or 1),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        scores = out.astype(np.float64)
        return (float(np.mean(scores)) if len(scores) else 0.0), scores
