"""The COCO-style metric table in one call (the port's copy of the JAX
package's ``metrics/scorer.py``): {id: [caption strings]} hypotheses
against reference pools, for validation-time CIDEr-D and the final eval
table."""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np

from cst_captioning_tpu_torch.metrics.bleu import Bleu
from cst_captioning_tpu_torch.metrics.cider import Cider, CiderD, CorpusDF
from cst_captioning_tpu_torch.metrics.meteor import MeteorApprox
from cst_captioning_tpu_torch.metrics.rouge import RougeL
from cst_captioning_tpu_torch.metrics.tokenizer import ptb_tokenize


class CaptionScorer:
    """Scores {id: [caption strings]} hypotheses against reference pools.

    ``metrics`` selects the scorers that run. ``use_native`` scores CIDEr-D
    through the native library (``metrics/native_cider.py``; a library
    that cannot be built raises), keeping the prepared reference pool
    across calls; the Python scorer takes over only when the hypotheses'
    ids differ from the pool's, as in the JAX package.
    """

    KNOWN = ("Bleu", "ROUGE_L", "METEOR_approx", "CIDEr", "CIDEr-D")

    def __init__(
        self,
        metrics: Sequence[str] = KNOWN,
        cider_df: "CorpusDF | str" = "corpus",
        pre_tokenized: bool = False,
        use_native: bool = True,
    ):
        unknown = [m for m in metrics if m not in self.KNOWN]
        if unknown:
            # a misspelled selector silently producing a partial table
            # would fake a metric regression (or hide one) downstream
            raise ValueError(
                f"unknown metric selector(s) {unknown}; known: {list(self.KNOWN)}"
            )
        self.metrics = tuple(metrics)
        self.cider_df = cider_df
        self.pre_tokenized = pre_tokenized
        self.use_native = use_native
        self._native_cider = None

    def _tok(self, table: Mapping[str, Sequence]) -> Dict[str, List[List[str]]]:
        if self.pre_tokenized:
            return {k: [list(c) for c in v] for k, v in table.items()}
        return {k: [ptb_tokenize(c) for c in v] for k, v in table.items()}

    def score(
        self,
        gts: Mapping[str, Sequence],
        res: Mapping[str, Sequence],
    ) -> Dict[str, float]:
        """Returns the metric table; per-id scores via score_with_details."""
        table, _ = self.score_with_details(gts, res)
        return table

    def score_with_details(
        self,
        gts: Mapping[str, Sequence],
        res: Mapping[str, Sequence],
    ):
        gts_t = self._tok(gts)
        res_t = self._tok(res)
        table: Dict[str, float] = {}
        per_id: Dict[str, np.ndarray] = {}
        if "Bleu" in self.metrics:
            corpus, per_order = Bleu(4).compute_score(gts_t, res_t)
            for n in range(4):
                table[f"Bleu_{n+1}"] = corpus[n]
                per_id[f"Bleu_{n+1}"] = per_order[n]
        if "ROUGE_L" in self.metrics:
            table["ROUGE_L"], per_id["ROUGE_L"] = RougeL().compute_score(gts_t, res_t)
        if "METEOR_approx" in self.metrics:
            table["METEOR_approx"], per_id["METEOR_approx"] = MeteorApprox().compute_score(
                gts_t, res_t
            )
        if "CIDEr" in self.metrics:
            table["CIDEr"], per_id["CIDEr"] = Cider(df="corpus").compute_score(
                gts_t, res_t
            )
        if "CIDEr-D" in self.metrics:
            scored = None
            if self.use_native:
                nc = self._native_cider
                if nc is None or not nc.covers(gts_t):
                    from cst_captioning_tpu_torch.metrics.native_cider import (
                        NativeCiderD,
                    )

                    nc = NativeCiderD(gts_t, self.cider_df)
                    self._native_cider = nc
                scored = nc.compute_score(res_t)  # None on id mismatch
            if scored is None:
                scored = CiderD(df=self.cider_df).compute_score(gts_t, res_t)
            table["CIDEr-D"], per_id["CIDEr-D"] = scored
        return table, per_id


def score_captions(
    gts: Mapping[str, Sequence],
    res: Mapping[str, Sequence],
    **kwargs,
) -> Dict[str, float]:
    """One-shot convenience wrapper."""
    return CaptionScorer(**kwargs).score(gts, res)
