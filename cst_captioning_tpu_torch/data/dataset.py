"""Caption dataset: the port's feature files and ``info.json`` (the JAX
package's ``data/dataset.py``).

The port's feature format, one pair of files per modality:

- ``<modality>.npy``: every clip's frames, ``[total_frames, dim]``
  float32, read memory-mapped (``np.load(mmap_mode="r")``);
- ``<modality>.index.json`` beside it: ``{"format", "dim", "videos":
  [[video_id, start, n_frames], ...]}``, the clip's rows being
  ``start:start + n_frames``.

It needs numpy only; :func:`convert_h5_features` turns a JAX-era h5 file
(one dataset per video id, ``[n_frames, dim]``) into it and imports
``h5py`` inside the function. ``info.json`` and the WXE weights npz are
the JAX package's. Features are padded, or subsampled uniformly past
``max_frames``, with a frame mask, so every batch has static shapes.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np

from cst_captioning_tpu_torch.data.vocab import Vocab

FORMAT = "cst-features-v1"


def index_path(path: str) -> str:
    """The index file beside a ``<modality>.npy`` feature file."""
    stem = path[:-4] if path.endswith(".npy") else path
    return stem + ".index.json"


def write_features(path: str, clips: Iterable[tuple[str, np.ndarray]],
                   total_frames: int) -> str:
    """Stream ``(video_id, [n_frames, dim] array)`` pairs, ``total_frames``
    rows in all, into one modality's memory-mapped feature file and write
    its index; returns ``path``."""
    out = None
    videos, start, dim = [], 0, None
    for vid, arr in clips:
        arr = np.asarray(arr, np.float32)
        if arr.ndim == 1:
            arr = arr[None, :]
        if out is None:
            dim = int(arr.shape[1])
            out = np.lib.format.open_memmap(
                path, mode="w+", dtype=np.float32,
                shape=(total_frames, dim))
        if arr.shape[1] != dim:
            raise ValueError(f"{vid}: dim {arr.shape[1]} != {dim}")
        n = int(arr.shape[0])
        out[start:start + n] = arr
        videos.append([str(vid), start, n])
        start += n
    if out is None:
        raise ValueError(f"no clips to write to {path}")
    if start != total_frames:
        raise ValueError(f"{path}: wrote {start} frames, declared "
                         f"{total_frames}")
    out.flush()
    del out
    with open(index_path(path), "w") as f:
        json.dump({"format": FORMAT, "dim": dim, "videos": videos}, f)
    return path


def convert_h5_features(h5_path: str, out_path: str) -> str:
    """A JAX-era h5 feature file -> the port's format at ``out_path``
    (``<modality>.npy``). Needs ``h5py``, imported here only."""
    import h5py

    with h5py.File(h5_path, "r") as h5:
        keys = list(h5.keys())
        total = 0
        for k in keys:
            shape = h5[k].shape
            total += 1 if len(shape) == 1 else shape[0]
        return write_features(
            out_path, ((k, np.asarray(h5[k], np.float32)) for k in keys),
            total_frames=total)


@dataclass
class VideoRecord:
    video_id: str
    split: str
    # tokenized captions as id lists (no BOS/EOS; added at batch time)
    caption_ids: list[list[int]] = field(default_factory=list)
    # raw tokenized caption strings (reward and eval reference pools)
    captions: list[str] = field(default_factory=list)
    # per-caption consensus weights (WXE), parallel to caption_ids
    weights: list[float] = field(default_factory=list)


class FeatureStore:
    """One modality's memory-mapped frames, padded to ``max_frames``."""

    def __init__(self, path: str, max_frames: int, dim: int | None = None):
        self.path = path
        self.max_frames = max_frames
        with open(index_path(path)) as f:
            index = json.load(f)
        if index.get("format") != FORMAT:
            raise ValueError(f"{index_path(path)}: not a {FORMAT} index")
        self._frames = np.load(path, mmap_mode="r")
        self._index = {vid: (int(s), int(n)) for vid, s, n in index["videos"]}
        self.dim = int(dim if dim is not None else self._frames.shape[1])

    def keys(self):
        return list(self._index)

    def get(self, video_id: str) -> tuple[np.ndarray, np.ndarray]:
        """-> (feats [max_frames, dim] float32, mask [max_frames] float32)."""
        start, n_raw = self._index[video_id]
        raw = self._frames[start:start + n_raw]
        n = min(n_raw, self.max_frames)
        if n_raw > self.max_frames:
            # a uniform subsample keeps the whole clip covered
            idx = np.linspace(0, n_raw - 1,
                              self.max_frames).round().astype(int)
            raw = raw[idx]
            n = self.max_frames
        feats = np.zeros((self.max_frames, self.dim), dtype=np.float32)
        feats[:n] = raw[:n]
        mask = np.zeros((self.max_frames,), dtype=np.float32)
        mask[:n] = 1.0
        return feats, mask

    def close(self):
        self._frames = None


class CaptionDataset:
    """The clips of one split with their features, captions and reward
    pools."""

    def __init__(self, info_json: str, feature_files: dict[str, str],
                 split: str, max_frames: int = 60,
                 consensus_weights: str = "", cache_features: bool = False):
        with open(info_json) as f:
            info = json.load(f)
        self.vocab = Vocab(info["vocab"])
        self.split = split
        self.records: list[VideoRecord] = []
        for v in info["videos"]:
            if v["split"] != split:
                continue
            if not v["caption_ids"]:
                raise ValueError(
                    f"video {v['id']!r} has no captions; every record needs "
                    "at least one (empty rows would produce all-PAD label "
                    "rows)")
            self.records.append(VideoRecord(
                video_id=v["id"], split=v["split"],
                caption_ids=[list(map(int, c)) for c in v["caption_ids"]],
                captions=[str(c) for c in v["captions"]]))
        if not self.records:
            raise ValueError(f"no videos for split {split!r} in {info_json}")
        self.stores = {name: FeatureStore(path, max_frames=max_frames)
                       for name, path in feature_files.items()}
        self.max_frames = max_frames
        self._gts_pool: dict[str, list[str]] | None = None
        # opt-in host-memory cache (DataConfig.cache_features)
        self._feat_cache: dict[str, dict] | None = (
            {} if cache_features else None)
        if consensus_weights:
            if not os.path.exists(consensus_weights):
                raise FileNotFoundError(
                    f"consensus_weights file not found: {consensus_weights}")
            self._load_weights(consensus_weights)
        else:
            for r in self.records:
                r.weights = [1.0] * len(r.caption_ids)

    def _load_weights(self, path: str):
        """npz: one array per video id, parallel to its caption list."""
        with np.load(path, allow_pickle=False) as data:
            for r in self.records:
                if r.video_id in data:
                    w = np.asarray(data[r.video_id], dtype=np.float32)
                    if len(w) != len(r.caption_ids):
                        raise ValueError(
                            f"weights/captions length mismatch for "
                            f"{r.video_id}")
                    r.weights = [float(x) for x in w]
                else:
                    r.weights = [1.0] * len(r.caption_ids)

    def __len__(self) -> int:
        return len(self.records)

    def features_for(self, video_id: str
                     ) -> dict[str, tuple[np.ndarray, np.ndarray]]:
        if self._feat_cache is not None:
            hit = self._feat_cache.get(video_id)
            if hit is None:
                hit = {name: store.get(video_id)
                       for name, store in self.stores.items()}
                for f, m in hit.values():
                    # handed out on every hit: an in-place write raises
                    f.flags.writeable = False
                    m.flags.writeable = False
                self._feat_cache[video_id] = hit
            return hit
        return {name: store.get(video_id)
                for name, store in self.stores.items()}

    def gts_pool(self) -> dict[str, list[str]]:
        """video_id -> the tokenized reference strings (read-only, cached)."""
        if self._gts_pool is None:
            self._gts_pool = {r.video_id: list(r.captions)
                              for r in self.records}
        return self._gts_pool

    def close(self):
        for s in self.stores.values():
            s.close()
