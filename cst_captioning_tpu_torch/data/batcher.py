"""Fixed-shape batches (the JAX package's ``data/batcher.py``): the
:class:`Batch` record, :func:`encode_label_row` and the dataset-backed
:class:`Batcher`.

Every batch has the static ``(batch_size, max_len)`` /
``(batch_size, max_frames, dim)`` shape. ``mode="caption"`` (XE) gives one
row per (video, caption) pair, ``seq_per_vid`` captions drawn per video per
epoch; ``mode="video"`` (RL decode, eval) one row per video. A short last
batch wraps around to full size, its extra rows marked invalid. The
shuffle is keyed by ``(seed, epoch_index)`` (and the rollback ``salt``
when set), not by a running stream, so a resumed run that sets
``epoch_index`` replays the same order.

The dataset is any object with ``CaptionDataset``'s interface: ``records``
(each with ``video_id``, ``caption_ids`` and ``weights``), ``stores``
(name -> object with ``.dim``), ``max_frames`` and ``features_for(vid)``
-> {name: (feats [max_frames, dim], mask [max_frames])}.
"""

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


class Batcher:
    def __init__(
        self,
        dataset,
        batch_size: int,
        max_len: int,
        mode: str = "caption",
        seq_per_vid: int = 1,
        seed: int = 0,
        drop_last: bool = False,
        host_shard: tuple[int, int] = (0, 1),
    ):
        if mode not in ("caption", "video"):
            raise ValueError(f"unknown mode {mode!r}")
        self.ds = dataset
        self.batch_size = batch_size
        self.max_len = max_len
        self.mode = mode
        self.seq_per_vid = seq_per_vid
        self.seed = seed
        self.epoch_index = 0  # set from the checkpoint epoch on resume
        # divergence-rollback salt: 0 keeps the (seed, epoch) keying; a
        # rollback bumps it so replayed epochs draw a fresh order
        self.salt = 0
        self.drop_last = drop_last
        # multi-host feeding: every process forms the same global batch
        # order and collates only its own contiguous slice of each batch;
        # batch_size stays global
        idx, count = host_shard
        if batch_size % count:
            raise ValueError(
                f"global batch_size {batch_size} must be divisible by "
                f"host_shard count {count}"
            )
        if not 0 <= idx < count:
            raise ValueError(f"host_shard index {idx} not in [0, {count})")
        self.host_shard = (idx, count)
        self.local_batch_size = batch_size // count

    def _items(self, rng: np.random.Generator | None) -> list[tuple[int, int]]:
        """List of (record_idx, caption_idx) rows for one epoch."""
        items: list[tuple[int, int]] = []
        for ri, rec in enumerate(self.ds.records):
            ncap = max(len(rec.caption_ids), 1)
            if self.mode == "video":
                items.append((ri, 0))
            else:
                k = min(self.seq_per_vid, ncap)
                caps = (rng.choice(ncap, size=k, replace=False)
                        if rng is not None else range(k))
                items.extend((ri, int(ci)) for ci in caps)
        if rng is not None:
            rng.shuffle(items)
        return items

    def __iter__(self):
        return self.epoch(shuffle=self.mode == "caption")

    def epoch(self, shuffle: bool = True):
        # the order depends only on (seed, epoch_index); unshuffled epochs
        # (eval) consume no epoch index
        rng = None
        if shuffle:
            key = ((self.seed, self.epoch_index) if not self.salt
                   else (self.seed, self.salt, self.epoch_index))
            rng = np.random.default_rng(key)
            self.epoch_index += 1
        items = self._items(rng)
        bs = self.batch_size
        idx, count = self.host_shard
        lb = self.local_batch_size
        for start in range(0, len(items), bs):
            chunk = items[start : start + bs]
            if len(chunk) < bs:
                if self.drop_last:
                    return
                pad = [chunk[i % len(chunk)] for i in range(bs - len(chunk))]
                valid = np.array([True] * len(chunk) + [False] * len(pad))
                chunk = chunk + pad
            else:
                valid = np.ones((bs,), dtype=bool)
            if count > 1:
                chunk = chunk[idx * lb : (idx + 1) * lb]
                valid = valid[idx * lb : (idx + 1) * lb]
            yield self._collate(chunk, valid)

    def _collate(self, items: list[tuple[int, int]], valid: np.ndarray) -> Batch:
        bs, T = self.local_batch_size, self.max_len
        names = list(self.ds.stores)
        F = self.ds.max_frames
        feats = {n: np.zeros((bs, F, self.ds.stores[n].dim), np.float32)
                 for n in names}
        fmasks = {n: np.zeros((bs, F), np.float32) for n in names}
        labels = np.full((bs, T), PAD_ID, dtype=np.int32)
        mask = np.zeros((bs, T), dtype=np.float32)
        weights = np.ones((bs,), dtype=np.float32)
        video_ids = []
        # wrap padding and seq_per_vid > 1 repeat videos: read each once
        feat_cache: dict[str, dict] = {}
        for b, (ri, ci) in enumerate(items):
            rec = self.ds.records[ri]
            video_ids.append(rec.video_id)
            if rec.video_id not in feat_cache:
                feat_cache[rec.video_id] = self.ds.features_for(rec.video_id)
            for n, (f, fm) in feat_cache[rec.video_id].items():
                feats[n][b] = f
                fmasks[n][b] = fm
            if rec.caption_ids:
                ci = min(ci, len(rec.caption_ids) - 1)
                labels[b], mask[b] = encode_label_row(rec.caption_ids[ci], T)
                if rec.weights:
                    weights[b] = rec.weights[ci]
        return Batch(feats=feats, feat_masks=fmasks, labels=labels, mask=mask,
                     weights=weights, valid=valid, video_ids=video_ids)

    def num_batches(self) -> int:
        n = len(self._items(None))
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)
