"""The port's caption metrics (cst_captioning_tpu_torch/metrics/) against
the JAX package's on a seeded corpus: the PTB tokenizer, BLEU, ROUGE-L,
METEOR_approx, CIDEr, CIDEr-D (Python, and native against the JAX native
scorer) and the whole CaptionScorer table. Both sides run the same host
arithmetic in float64, so every float must be equal; the native CIDEr-D
is float32 on both sides and equal too."""

import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu import metrics as jm
from cst_captioning_tpu_torch import metrics as tm
from cst_captioning_tpu_torch.metrics.native_cider import NativeCiderD

torch.set_num_threads(1)

WORDS = ["a", "man", "woman", "is", "playing", "guitar", "dog", "runs",
         "in", "the", "park", "cooking", "food", "kitchen", "talking",
         "people", "dancing", "stage", "car", "driving"]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)

    def caption():
        words = rng.choice(WORDS, rng.integers(3, 10))
        text = " ".join(words)
        # punctuation, case and contractions for the tokenizer
        if rng.random() < 0.3:
            text = text.capitalize() + "."
        if rng.random() < 0.2:
            text = text.replace(" is ", " isn't ", 1) + ", it's (here)!"
        return text

    gts = {f"v{i}": [caption() for _ in range(5)] for i in range(12)}
    res = {v: [caption()] for v in gts}
    res["v3"] = [gts["v3"][0]]                     # one exact match
    res["v5"] = [""]                               # an empty caption
    return gts, res


def _tok(table):
    return {k: [jm.ptb_tokenize(c) for c in v] for k, v in table.items()}


def test_tokenizer_matches_jax(corpus):
    gts, res = corpus
    for caps in list(gts.values()) + list(res.values()):
        for c in caps:
            assert tm.ptb_tokenize(c) == jm.ptb_tokenize(c)
            assert tm.ptb_tokenize(c, keep_punct=True) == \
                jm.ptb_tokenize(c, keep_punct=True)
    assert tm.ptb_tokenize_corpus(gts) == jm.ptb_tokenize_corpus(gts)


@pytest.mark.parametrize("name", ["Bleu", "RougeL", "MeteorApprox", "Cider",
                                  "CiderD"])
def test_scorer_matches_jax(corpus, name):
    gts, res = map(_tok, corpus)
    want = getattr(jm, name)().compute_score(gts, res)
    got = getattr(tm, name)().compute_score(gts, res)
    assert got[0] == want[0]
    if name == "Bleu":
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)
        assert got[0][0] > 0
    else:
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0] > 0


def test_cider_d_with_corpus_df_matches_jax(corpus):
    gts, res = map(_tok, corpus)
    jdf = jm.CorpusDF.from_refs(list(gts.values()))
    tdf = tm.CorpusDF.from_refs(list(gts.values()))
    assert tdf.df == jdf.df and tdf.num_docs == jdf.num_docs
    want = jm.CiderD(df=jdf).compute_score(gts, res)
    got = tm.CiderD(df=tdf).compute_score(gts, res)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


def test_native_cider_d_matches_jax_native(corpus):
    from cst_captioning_tpu.metrics.native_cider import (
        NativeCiderD as JaxNativeCiderD,
    )

    gts, res = map(_tok, corpus)
    jn = JaxNativeCiderD.build(gts, "corpus")
    assert jn is not None
    want = jn.compute_score(res)
    tn = NativeCiderD(gts, "corpus")
    got = tn.compute_score(res)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    # the float32 library against the float64 Python scorer
    py = tm.CiderD().compute_score(gts, res)
    np.testing.assert_allclose(got[1], py[1], rtol=1e-6, atol=1e-6)
    # another id set: None, and the caller scores in Python
    assert tn.compute_score({"v0": res["v0"]}) is None


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("pre_tokenized", [False, True])
def test_caption_scorer_table_matches_jax(corpus, native, pre_tokenized):
    gts, res = corpus
    if pre_tokenized:
        gts, res = _tok(gts), _tok(res)
    kw = dict(pre_tokenized=pre_tokenized, use_native=native)
    want = jm.CaptionScorer(**kw).score(gts, res)
    scorer = tm.CaptionScorer(**kw)
    got = scorer.score(gts, res)
    assert got == want
    assert sorted(got) == ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "CIDEr",
                           "CIDEr-D", "METEOR_approx", "ROUGE_L"]
    # the prepared native pool is kept for the next call on the same pool;
    # a subset of ids scores in Python, as the JAX scorer does
    assert scorer.score(gts, res) == got
    sub = {k: res[k] for k in list(res)[:4]}
    assert scorer.score(gts, sub) == jm.CaptionScorer(**kw).score(gts, sub)
    assert tm.score_captions(gts, res, **kw) == want


def test_unknown_selector_raises():
    with pytest.raises(ValueError, match="unknown metric"):
        tm.CaptionScorer(metrics=("BLEU",))
