"""Preprocessing: vocab, tokenization, WXE consensus weights and the
CIDEr-D document frequency (the JAX package's ``data/preprocess.py``).

- :func:`build_vocab`: a frequency-thresholded word table;
- :func:`tokenize_captions`: PTB-style tokens through the metrics
  tokenizer, so preprocessing and scoring split words alike;
- :func:`compute_consensus_weights`: each caption's CIDEr-D against the
  other references of its clip, the WXE loss weights;
- :func:`compute_cider_df`: train-split document frequencies for the RL
  reward (``CorpusDF.save`` writes them);
- :func:`build_info_json`: the dataset's ``info.json``.
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Mapping, Sequence

import numpy as np

from cst_captioning_tpu_torch.data.vocab import Vocab
from cst_captioning_tpu_torch.metrics.cider import CiderD, CorpusDF
from cst_captioning_tpu_torch.metrics.tokenizer import ptb_tokenize_corpus


def tokenize_captions(raw: Mapping[str, Sequence[str]]
                      ) -> dict[str, list[list[str]]]:
    """{video_id: [raw sentence, ...]} -> {video_id: [[token, ...], ...]}."""
    return ptb_tokenize_corpus(dict(raw))


def build_vocab(tokenized: Mapping[str, Sequence[Sequence[str]]],
                min_count: int = 1) -> Vocab:
    """Words seen at least ``min_count`` times, sorted (rarer ones become
    <unk>)."""
    counts: Counter = Counter()
    for caps in tokenized.values():
        for toks in caps:
            counts.update(toks)
    words = sorted(w for w, c in counts.items() if c >= min_count)
    return Vocab.from_corpus_words(words)


def compute_consensus_weights(
    tokenized: Mapping[str, Sequence[Sequence[str]]],
    df: CorpusDF | None = None,
    normalize: str = "mean1",
) -> dict[str, np.ndarray]:
    """Per-caption consensus: CIDEr-D of the caption against its sibling
    references, /10. ``normalize="mean1"`` rescales each clip's weights to
    mean 1 (WXE then keeps XE's loss scale); ``"none"`` keeps them. With
    ``df=None`` the df is built over all of ``tokenized``, one document a
    clip."""
    if df is None:
        df = compute_cider_df(tokenized)
    scorer = CiderD(df=df)
    out: dict[str, np.ndarray] = {}
    for vid, caps in tokenized.items():
        caps = [list(c) for c in caps]
        if len(caps) < 2:
            out[vid] = np.ones((len(caps),), dtype=np.float32)
            continue
        gts, res = {}, {}
        for i, cap in enumerate(caps):
            key = f"{vid}#{i}"
            res[key] = [cap]
            gts[key] = [c for j, c in enumerate(caps) if j != i]
        _, per_cap = scorer.compute_score(gts, res)
        w = np.asarray(per_cap, dtype=np.float32) / 10.0
        if normalize == "mean1":
            mean = float(w.mean())
            w = w / mean if mean > 1e-8 else np.ones_like(w)
        out[vid] = w
    return out


def compute_cider_df(tokenized: Mapping[str, Sequence[Sequence[str]]],
                     max_n: int = 4) -> CorpusDF:
    """Document frequencies, one document a clip's reference pool."""
    return CorpusDF.from_refs(list(tokenized.values()), max_n=max_n)


def build_info_json(out_path: str, raw_captions: Mapping[str, Sequence[str]],
                    splits: Mapping[str, str], min_count: int = 1) -> Vocab:
    """Tokenize, build the vocab and write ``info.json``; returns the
    vocab."""
    tokenized = tokenize_captions(raw_captions)
    vocab = build_vocab(tokenized, min_count=min_count)
    videos = []
    for vid, caps in tokenized.items():
        videos.append({
            "id": vid,
            "split": splits.get(vid, "train"),
            "captions": [" ".join(t) for t in caps],
            "caption_ids": [vocab.encode(t) for t in caps],
        })
    with open(out_path, "w") as f:
        json.dump({"vocab": vocab.words, "videos": videos}, f)
    return vocab
