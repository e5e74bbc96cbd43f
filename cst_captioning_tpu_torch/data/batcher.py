"""Fixed-shape batches (the JAX package's ``data/batcher.py``): the
:class:`Batch` record and :func:`encode_label_row`. The dataset-backed
``Batcher`` comes with the data slice."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cst_captioning_tpu_torch.config import EOS_ID, PAD_ID


@dataclass
class Batch:
    feats: dict[str, np.ndarray]       # name -> [B, F, D] float32
    feat_masks: dict[str, np.ndarray]  # name -> [B, F]    float32
    labels: np.ndarray                 # [B, T] int32: word ids + EOS, then PAD
    mask: np.ndarray                   # [B, T] float32: 1 on real tokens incl. EOS
    weights: np.ndarray                # [B]    float32: WXE consensus weights
    valid: np.ndarray                  # [B]    bool: False on wrap-padding rows
    video_ids: list[str]

    @property
    def size(self) -> int:
        return int(self.valid.sum())


def encode_label_row(caption_ids: list[int],
                     max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """ids (no specials) -> (labels [T], mask [T]) with EOS and PAD=0."""
    row = np.full((max_len,), PAD_ID, dtype=np.int32)
    m = np.zeros((max_len,), dtype=np.float32)
    toks = caption_ids[: max_len - 1]          # reserve one slot for EOS
    row[: len(toks)] = toks
    row[len(toks)] = EOS_ID
    m[: len(toks) + 1] = 1.0
    return row, m
