"""The cells' clip pools: a seeded synthetic corpus in the port's feature
format, written once a checkout.

A harness copy of the port's ``data/synthetic.py`` generator (each clip a
topic; its frames the topic's signature plus Gaussian noise; its
captions words of the topic's pool), with caption lengths drawn from a
heavy-tailed (log-normal) distribution up to ``max_len - 1`` words. The
pool depends on its parameters alone, not on the run's seed: the seed
orders it and draws the weights, so every seed gets the same work in
another order. It is written under ``benchmark/_data/<key>/`` (a fixed
path inside the checkout, keyed by a digest of the parameters) and read
memory-mapped, so only a checkout's first run writes it.

Files: ``info.json`` (``{"vocab", "videos"}``, the port's schema) and, a
modality each, ``<name>.npy`` ``[total_frames, dim]`` float32 with its
``<name>.index.json`` (``{"format": "cst-features-v1", "dim", "videos":
[[id, start, n_frames], ...]}``).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np

DATA_DIR = Path(__file__).resolve().parent / "_data"
FORMAT = "cst-features-v1"
SPECIALS = ("<pad>", "<bos>", "<eos>", "<unk>")
GEN_SEED = 20171209      # the pool's own seed (arXiv:1712.09532)
CHUNK = 64               # clips generated at a time


def pool_params(model: dict, data: dict, clips: int, split: str) -> dict:
    """The generator's parameters for a configuration's pool."""
    return {
        "vocab_size": int(model["vocab_size"]),
        "modalities": [[str(n), int(d)] for n, d in model["modalities"]],
        "max_frames": int(model["max_frames"]),
        "max_len": int(model["max_len"]),
        "clips": int(clips),
        "split": split,
        "captions_per_clip": int(data["captions_per_clip"]),
        "num_topics": int(data["num_topics"]),
        "caption_median": float(data["caption_median"]),
        "caption_sigma": float(data["caption_sigma"]),
        "feature_noise": float(data["feature_noise"]),
    }


def _key(params: dict) -> str:
    blob = json.dumps(params, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def caption_lengths(rng: np.random.Generator, n: int, median: float,
                    sigma: float, max_words: int) -> np.ndarray:
    """Heavy-tailed caption lengths: log-normal, clipped to
    ``[3, max_words]``."""
    raw = np.exp(rng.normal(np.log(median), sigma, size=n))
    return np.clip(np.rint(raw), 3, max_words).astype(np.int64)


def _write(out: Path, p: dict) -> None:
    rng = np.random.default_rng(GEN_SEED)
    n_words = p["vocab_size"] - len(SPECIALS)
    words = [f"w{i:04d}" for i in range(n_words)]
    pools = np.array_split(np.arange(n_words), p["num_topics"])
    sigs = {n: rng.normal(size=(p["num_topics"], d)).astype(np.float32)
            for n, d in p["modalities"]}
    C, K, F = p["clips"], p["captions_per_clip"], p["max_frames"]
    topics = rng.integers(p["num_topics"], size=C)
    n_frames = rng.integers(max(2, F // 2), F + 1, size=C)
    lens = caption_lengths(rng, C * K, p["caption_median"],
                           p["caption_sigma"], p["max_len"] - 1)
    videos = []
    for c in range(C):
        pool = pools[topics[c]]
        caps, ids = [], []
        for k in range(K):
            w = rng.choice(pool, size=int(lens[c * K + k]), replace=True)
            caps.append(" ".join(words[i] for i in w))
            ids.append([int(i) + len(SPECIALS) for i in w])
        videos.append({"id": f"clip{c:05d}", "split": p["split"],
                       "topic": int(topics[c]), "captions": caps,
                       "caption_ids": ids})
    starts = np.concatenate([[0], np.cumsum(n_frames)[:-1]])
    total = int(n_frames.sum())
    for name, dim in p["modalities"]:
        arr = np.lib.format.open_memmap(str(out / f"{name}.npy"), mode="w+",
                                        dtype=np.float32, shape=(total, dim))
        for c0 in range(0, C, CHUNK):
            c1 = min(C, c0 + CHUNK)
            rows = int(n_frames[c0:c1].sum())
            noise = p["feature_noise"] * rng.standard_normal(
                (rows, dim), dtype=np.float32)
            topic_rows = np.repeat(topics[c0:c1], n_frames[c0:c1])
            s = int(starts[c0])
            arr[s:s + rows] = sigs[name][topic_rows] + noise
        arr.flush()
        del arr
        index = {"format": FORMAT, "dim": dim,
                 "videos": [[videos[c]["id"], int(starts[c]),
                             int(n_frames[c])] for c in range(C)]}
        (out / f"{name}.index.json").write_text(json.dumps(index))
    info = {"vocab": list(SPECIALS) + words, "videos": videos}
    (out / "info.json").write_text(json.dumps(info))


def ensure_pool(params: dict) -> Path:
    """The pool's directory, written first if this checkout lacks it."""
    out = DATA_DIR / f"pool-{_key(params)}"
    if (out / "info.json").exists():
        return out
    DATA_DIR.mkdir(parents=True, exist_ok=True)
    tmp = DATA_DIR / f".tmp-{_key(params)}-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir()
    try:
        _write(tmp, params)
        (tmp / "params.json").write_text(json.dumps(params, indent=1))
        os.replace(tmp, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def feature_files(pool: Path, model: dict) -> dict[str, str]:
    return {str(n): str(pool / f"{n}.npy") for n, _ in model["modalities"]}
