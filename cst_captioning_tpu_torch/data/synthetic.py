"""Seeded synthetic corpus in the port's feature format (the JAX
package's ``data/synthetic.py``).

The same arguments give the same corpus as the JAX generator: the same
``np.random.default_rng(seed)`` draws in the same order, so ``info.json``
is equal and every clip's frames equal the JAX h5's. Captions are
topic-conditioned (each clip draws a topic; its features are the topic's
signature plus Gaussian noise, its captions come from the topic's word
pool), so features predict captions. Caption styles:

- ``"pool"``: each caption an i.i.d. word sequence from the topic pool;
- ``"template"``: each topic owns a few phrases, and each caption is one
  of them with word-level replacement noise, a consensus that carries
  over to held-out clips of the same topic.
"""

from __future__ import annotations

import json
import os

import numpy as np

from cst_captioning_tpu_torch.data.dataset import write_features
from cst_captioning_tpu_torch.data.vocab import Vocab


def make_synthetic_dataset(
    out_dir: str,
    num_videos: int = 24,
    num_topics: int = 4,
    vocab_words: int = 40,
    captions_per_video: int = 5,
    caption_len: tuple[int, int] = (4, 9),
    modalities: dict[str, int] | None = None,
    max_frames: int = 8,
    splits: tuple[float, float] = (0.75, 0.125),   # train, val (rest test)
    seed: int = 0,
    caption_style: str = "pool",
    templates_per_topic: int = 4,
    template_noise: float = 0.25,    # per-word replacement probability
    feature_noise: float = 0.3,      # per-frame Gaussian amplitude
) -> dict[str, str]:
    """Writes the feature files and ``info.json`` under ``out_dir``;
    returns ``{"info_json": ..., "<modality>": <.npy path>, ...}``."""
    modalities = modalities or {"resnet": 64}
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)

    if caption_style not in ("pool", "template"):
        raise ValueError(f"unknown caption_style {caption_style!r}")
    words = [f"w{i:03d}" for i in range(vocab_words)]
    vocab = Vocab.from_corpus_words(words)
    pools = np.array_split(np.arange(vocab_words), num_topics)
    topic_templates: list[list[np.ndarray]] = []
    if caption_style == "template":
        for t in range(num_topics):
            topic_templates.append([
                rng.choice(pools[t],
                           size=int(rng.integers(caption_len[0],
                                                 caption_len[1])),
                           replace=True)
                for _ in range(templates_per_topic)
            ])

    sigs = {name: rng.normal(size=(num_topics, dim)).astype(np.float32)
            for name, dim in modalities.items()}

    videos = []
    feat_arrays: dict[str, list[tuple[str, np.ndarray]]] = {
        m: [] for m in modalities}
    n_train = int(num_videos * splits[0])
    n_val = int(num_videos * splits[1])
    for vi in range(num_videos):
        vid = f"video{vi}"
        split = ("train" if vi < n_train
                 else ("val" if vi < n_train + n_val else "test"))
        topic = int(rng.integers(num_topics))
        caps_ids, caps_raw = [], []
        for _ in range(captions_per_video):
            pool = pools[topic]
            if caption_style == "template":
                base = topic_templates[topic][
                    int(rng.integers(templates_per_topic))]
                noise = rng.random(base.size) < template_noise
                word_ids = np.where(
                    noise, rng.choice(pool, size=base.size, replace=True),
                    base)
            else:
                L = int(rng.integers(caption_len[0], caption_len[1]))
                word_ids = rng.choice(pool, size=L, replace=True)
            toks = [words[w] for w in word_ids]
            caps_raw.append(" ".join(toks))
            caps_ids.append(vocab.encode(toks))
        videos.append({"id": vid, "split": split, "topic": topic,
                       "captions": caps_raw, "caption_ids": caps_ids})
        n_frames = int(rng.integers(max(2, max_frames // 2), max_frames + 1))
        for name, dim in modalities.items():
            noise = feature_noise * rng.normal(
                size=(n_frames, dim)).astype(np.float32)
            feat_arrays[name].append((vid, sigs[name][topic][None, :] + noise))

    paths: dict[str, str] = {}
    for name in modalities:
        clips = feat_arrays.pop(name)
        paths[name] = write_features(
            os.path.join(out_dir, f"{name}.npy"), clips,
            total_frames=sum(a.shape[0] for _, a in clips))
        del clips

    info = {"vocab": vocab.words, "videos": videos}
    info_path = os.path.join(out_dir, "info.json")
    with open(info_path, "w") as f:
        json.dump(info, f)
    paths["info_json"] = info_path
    return paths
