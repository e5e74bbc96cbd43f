"""PTB-style caption tokenizer (the port's copy of the JAX package's
``metrics/tokenizer.py``): split on whitespace, separate punctuation into
its own tokens, split contractions, lowercase, then drop the
coco-caption PTBTokenizer wrapper's punctuation list. The one tokenizer
of the vocab, the reward and the eval, so CIDEr-D stays self-consistent."""

from __future__ import annotations

import re
from typing import Dict, Iterable, List

# The punctuation list removed by coco-caption's PTBTokenizer wrapper after
# tokenization (its PUNCTUATIONS constant, reproduced by spec not by copy).
_PUNCTUATIONS = frozenset(
    {
        "''", "'", "``", "`", "(", ")", "[", "]", "{", "}",
        ".", "?", "!", ",", ":", "-", "--", "...", ";",
    }
)

# Contractions and possessives the PTB tokenizer splits off the preceding word.
_CONTRACTION_RE = re.compile(r"(?i)(n't|'s|'re|'ve|'ll|'d|'m)$")

# One token = a run of word chars (incl. digits, unicode letters), or a single
# non-space non-word char (punctuation split into its own token).
_TOKEN_RE = re.compile(r"[\w]+|[^\w\s]", re.UNICODE)


def _split_contractions(word: str) -> List[str]:
    """Split PTB contractions off a word: "don't" -> ["do", "n't"]."""
    m = _CONTRACTION_RE.search(word)
    if m and m.start() > 0:
        return [word[: m.start()], m.group(0)]
    return [word]


def ptb_tokenize(sentence: str, *, keep_punct: bool = False) -> List[str]:
    """Tokenize one caption PTB-style and lowercase it.

    Punctuation tokens are dropped (matching the reference eval pipeline)
    unless ``keep_punct`` is True.
    """
    raw = _TOKEN_RE.findall(sentence.replace("\n", " "))
    out: List[str] = []
    # Re-attach apostrophes to following letters so "don ' t" patterns from the
    # naive split become PTB contractions, then split them properly.
    merged: List[str] = []
    i = 0
    while i < len(raw):
        tok = raw[i]
        if (
            tok == "'"
            and merged
            and i + 1 < len(raw)
            and re.fullmatch(r"[A-Za-z]+", raw[i + 1])
        ):
            # word ' suffix  -> word'suffix, handled by contraction splitter
            merged[-1] = merged[-1] + "'" + raw[i + 1]
            i += 2
            continue
        merged.append(tok)
        i += 1
    for tok in merged:
        for piece in _split_contractions(tok):
            piece = piece.lower()
            if not keep_punct and piece in _PUNCTUATIONS:
                continue
            if piece:
                out.append(piece)
    return out


def ptb_tokenize_corpus(
    corpus: Dict[str, Iterable[str]], *, keep_punct: bool = False
) -> Dict[str, List[List[str]]]:
    """Tokenize a {video_id: [caption, ...]} mapping.

    Mirrors the reference's PTBTokenizer.tokenize() batch interface, returning
    token lists rather than joined strings (callers join if they need strings).
    """
    return {
        vid: [ptb_tokenize(c, keep_punct=keep_punct) for c in caps]
        for vid, caps in corpus.items()
    }
