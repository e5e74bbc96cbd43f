"""The cells' batches, worked out again from the pool's files: which
clips (and which of their captions) each batch holds, and their padded
features, masks and label rows.

The order is the port's documented one (``data/batcher.py``): a shuffled
epoch draws ``np.random.default_rng((seed, epoch))``; per clip in file
order, in caption mode, ``seq_per_vid`` captions without replacement,
then one shuffle of all rows; cut into batches, a short last batch
wrapped to full size.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

PAD_ID, EOS_ID = 0, 2


class Pool:
    """The pool's clips of one split, read from its files."""

    def __init__(self, root: Path, split: str, max_frames: int):
        info = json.loads((Path(root) / "info.json").read_text())
        self.videos = [v for v in info["videos"] if v["split"] == split]
        self.max_frames = max_frames
        self.frames, self.index = {}, {}
        for p in sorted(Path(root).glob("*.index.json")):
            name = p.name[:-len(".index.json")]
            idx = json.loads(p.read_text())
            self.frames[name] = np.load(Path(root) / f"{name}.npy",
                                        mmap_mode="r")
            self.index[name] = {v: (s, n) for v, s, n in idx["videos"]}

    def refs(self) -> dict:
        return {v["id"]: [list(c) for c in v["caption_ids"]]
                for v in self.videos}

    def epoch_rows(self, batch: int, seed: int, epoch: int, mode: str,
                   seq_per_vid: int = 1):
        """-> [[(clip index, caption index), ...] per batch]."""
        rng = np.random.default_rng((seed, epoch))
        items = []
        for ri, v in enumerate(self.videos):
            if mode == "video":
                items.append((ri, 0))
            else:
                ncap = max(len(v["caption_ids"]), 1)
                k = min(seq_per_vid, ncap)
                caps = rng.choice(ncap, size=k, replace=False)
                items.extend((ri, int(c)) for c in caps)
        rng.shuffle(items)
        out = []
        for s in range(0, len(items), batch):
            chunk = items[s:s + batch]
            chunk = chunk + [chunk[i % len(chunk)]
                             for i in range(batch - len(chunk))]
            out.append(chunk)
        return out

    def batches(self, n: int, batch: int, seed: int, mode: str,
                seq_per_vid: int = 1):
        """The first ``n`` batches of the shuffled epochs 0, 1, ..."""
        out, epoch = [], 0
        while len(out) < n:
            out += self.epoch_rows(batch, seed, epoch, mode, seq_per_vid)
            epoch += 1
        return out[:n]

    def collate(self, rows, max_len: int):
        """-> (feats {name: [B, F, D]}, masks {name: [B, F]}, labels
        [B, T] int64, clip ids)."""
        F = self.max_frames
        feats, masks = {}, {}
        for name, arr in self.frames.items():
            f = np.zeros((len(rows), F, arr.shape[1]), np.float32)
            m = np.zeros((len(rows), F), np.float32)
            for b, (ri, _) in enumerate(rows):
                s, n = self.index[name][self.videos[ri]["id"]]
                raw = np.asarray(arr[s:s + n])
                if n > F:
                    raw = raw[np.linspace(0, n - 1, F).round().astype(int)]
                    n = F
                f[b, :n] = raw[:n]
                m[b, :n] = 1.0
            feats[name], masks[name] = f, m
        labels = np.full((len(rows), max_len), PAD_ID, np.int64)
        for b, (ri, ci) in enumerate(rows):
            caps = self.videos[ri]["caption_ids"]
            toks = caps[min(ci, len(caps) - 1)][:max_len - 1]
            labels[b, :len(toks)] = toks
            labels[b, len(toks)] = EOS_ID
        return feats, masks, labels, [self.videos[ri]["id"] for ri, _ in rows]
