"""Vocabulary: word <-> id mapping with the fixed special tokens
(PAD=0, BOS=1, EOS=2, UNK=3)."""

from __future__ import annotations

from typing import Iterable, Sequence

from cst_captioning_tpu_torch.config import BOS_ID, EOS_ID, PAD_ID, UNK_ID

SPECIAL_TOKENS = ("<pad>", "<bos>", "<eos>", "<unk>")


class Vocab:
    def __init__(self, words: Sequence[str]):
        """``words`` is the full id->word table including the 4 specials."""
        if tuple(words[:4]) != SPECIAL_TOKENS:
            raise ValueError(
                f"vocab must start with {SPECIAL_TOKENS}, got {tuple(words[:4])}"
            )
        self._words = list(words)
        self._ids = {w: i for i, w in enumerate(self._words)}
        if len(self._ids) != len(self._words):
            raise ValueError("duplicate words in vocab")

    @classmethod
    def from_corpus_words(cls, words: Iterable[str]) -> "Vocab":
        return cls(list(SPECIAL_TOKENS) + list(words))

    def __len__(self) -> int:
        return len(self._words)

    @property
    def words(self) -> list[str]:
        return list(self._words)

    def encode(self, tokens: Sequence[str]) -> list[int]:
        return [self._ids.get(t, UNK_ID) for t in tokens]

    def decode(self, ids: Sequence[int], stop_at_eos: bool = True) -> str:
        """ids -> sentence, dropping PAD/BOS and stopping at EOS."""
        out = []
        for i in ids:
            i = int(i)
            if i == EOS_ID and stop_at_eos:
                break
            if i in (PAD_ID, BOS_ID, EOS_ID):
                continue
            out.append(self._words[i] if 0 <= i < len(self._words) else "<unk>")
        return " ".join(out)
