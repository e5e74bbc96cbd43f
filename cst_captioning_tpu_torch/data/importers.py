"""Importers: the standard MSR-VTT and MSVD distributions -> the port's
dataset files (the JAX package's ``data/importers.py``).

MSR-VTT's ``videodatainfo.json`` (the 2016 challenge distribution):

    {"videos":    [{"video_id": "video0", "split": "train", ...}, ...],
     "sentences": [{"video_id": "video0", "caption": "a man is ...", ...}, ...]}

with splits ``train`` / ``validate`` / ``test`` (``validate`` becomes
``val``).

MSVD has no split field. Its caption CSV (``video_corpus.csv``, columns
``VideoID, Start, End, ..., Language, Description``, one row per
annotation) names a clip ``{VideoID}_{Start}_{End}`` and only English rows
are captions; a plain-text variant (``<clip_id> <caption>`` a line) is
accepted too. ``youtube_mapping.txt`` (``<clip_id> vid<N>`` a line), when
given, fixes the clip order; the conventional split is then the first
1200 clips train, the next 100 val and the remaining 670 test.

Features come from a directory of ``<video_id>.npy`` arrays (numpy only)
or an h5 file keyed by video id (``h5py``, imported inside
:func:`pack_features` only) and are written in the port's format:
``<modality>.npy`` plus ``<modality>.index.json``
(``data.dataset.write_features``). The CIDEr df is the port's npz
(``CorpusDF.save``), the WXE weights an npz of one array a video.
"""

from __future__ import annotations

import csv
import json
import os
import re
from typing import Iterator, Mapping

import numpy as np

from cst_captioning_tpu_torch.data.dataset import write_features
from cst_captioning_tpu_torch.data.preprocess import (
    build_vocab,
    compute_cider_df,
    compute_consensus_weights,
    tokenize_captions,
)

_SPLIT_MAP = {"train": "train", "validate": "val", "val": "val", "test": "test"}

# the conventional MSVD captioning split (1200 / 100 / 670 of 1970 clips)
MSVD_NUM_TRAIN = 1200
MSVD_NUM_VAL = 100


def parse_msrvtt_info(videodatainfo: str | Mapping) -> tuple[dict, dict]:
    """``videodatainfo.json`` (a path or the loaded dict) -> (raw captions
    {vid: [sentence, ...]}, splits {vid: split})."""
    if isinstance(videodatainfo, str):
        with open(videodatainfo) as f:
            videodatainfo = json.load(f)
    splits: dict[str, str] = {}
    for v in videodatainfo["videos"]:
        vid = str(v["video_id"])
        split = _SPLIT_MAP.get(str(v.get("split", "train")).lower())
        if split is None:
            raise ValueError(f"unknown MSR-VTT split {v['split']!r} for {vid}")
        splits[vid] = split
    raw: dict[str, list[str]] = {vid: [] for vid in splits}
    for s in videodatainfo["sentences"]:
        vid = str(s["video_id"])
        if vid not in raw:
            raise ValueError(f"sentence references unknown video {vid!r}")
        raw[vid].append(str(s["caption"]))
    empty = [vid for vid, caps in raw.items() if not caps]
    if empty:
        raise ValueError(f"videos without captions: {empty[:5]}...")
    return raw, splits


def _parse_msvd_csv(path: str) -> dict[str, list[str]]:
    """The MSVD corpus CSV -> {clip_id: [sentence, ...]}; column names match
    case-insensitively, non-English and empty descriptions are skipped."""
    raw: dict[str, list[str]] = {}
    with open(path, newline="", encoding="utf-8", errors="replace") as f:
        reader = csv.DictReader(f)
        if reader.fieldnames is None:
            raise ValueError(f"{path}: empty csv")
        cols = {c.strip().lower(): c for c in reader.fieldnames}
        missing = [c for c in ("videoid", "start", "end", "description")
                   if c not in cols]
        if missing:
            raise ValueError(
                f"{path}: not an MSVD corpus csv (missing columns {missing}; "
                f"found {reader.fieldnames})"
            )
        lang_col = cols.get("language")
        for row in reader:
            if lang_col and row[lang_col].strip().lower() != "english":
                continue
            sent = (row[cols["description"]] or "").strip()
            if not sent:
                continue
            clip = (f"{row[cols['videoid']].strip()}_"
                    f"{row[cols['start']].strip()}_{row[cols['end']].strip()}")
            raw.setdefault(clip, []).append(sent)
    return raw


def _parse_msvd_txt(path: str) -> dict[str, list[str]]:
    """``<clip_id> <caption>`` a line -> {clip_id: [sentence, ...]}."""
    raw: dict[str, list[str]] = {}
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            clip, _, sent = line.strip().partition(" ")
            if sent.strip():
                raw.setdefault(clip, []).append(sent.strip())
    return raw


def parse_msvd_mapping(path: str) -> list[str]:
    """``youtube_mapping.txt`` -> clip ids in canonical order (by N)."""
    indexed: list[tuple[int, str]] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            clip, _, tag = line.rpartition(" ")
            m = re.fullmatch(r"vid(\d+)", tag.strip())
            if not clip or m is None:
                raise ValueError(
                    f"{path}: expected '<clip_id> vid<N>' lines, got {line!r}"
                )
            indexed.append((int(m.group(1)), clip.strip()))
    indexed.sort()
    return [clip for _, clip in indexed]


def parse_msvd_corpus(corpus: str | Mapping, mapping: str | None = None,
                      n_train: int = MSVD_NUM_TRAIN,
                      n_val: int = MSVD_NUM_VAL) -> tuple[dict, dict]:
    """The caption file (CSV or text) or a loaded {clip_id: [sentence,
    ...]} -> (raw captions, splits). With ``mapping`` the clips take its
    order and clips outside it are dropped; without it they sort by id.
    The first ``n_train`` clips are train, the next ``n_val`` val, the
    rest test."""
    if isinstance(corpus, Mapping):
        raw = {str(k): [str(s) for s in v] for k, v in corpus.items()}
    elif corpus.endswith(".csv"):
        raw = _parse_msvd_csv(corpus)
    else:
        raw = _parse_msvd_txt(corpus)
    if not raw:
        raise ValueError("MSVD corpus contains no captions")
    if mapping is not None:
        order = parse_msvd_mapping(mapping)
        missing = [c for c in order if c not in raw or not raw[c]]
        if missing:
            raise ValueError(f"mapped clips without captions: {missing[:5]}...")
    else:
        order = sorted(raw)
    raw = {clip: raw[clip] for clip in order}
    if len(order) <= n_train:
        raise ValueError(
            f"only {len(order)} clips for n_train={n_train}, n_val={n_val}; "
            "pass split sizes matching the corpus"
        )
    splits = {clip: ("train" if i < n_train else
                     "val" if i < n_train + n_val else "test")
              for i, clip in enumerate(order)}
    return raw, splits


def _as_frames(vid: str, arr: np.ndarray) -> np.ndarray:
    """-> [n_frames, dim] float32; a 1-D row is one frame."""
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        return arr
    if arr.ndim == 1:
        return arr[None, :]
    raise ValueError(
        f"feature for {vid!r} has shape {arr.shape}; expected "
        "[n_frames, dim] or [dim] (strip any leading batch dimension)"
    )


def pack_features(source: str, out_path: str, video_ids: list[str]) -> str:
    """One modality's features for ``video_ids`` -> the port's feature file
    ``out_path`` (``<modality>.npy``, with its index). ``source``: a
    directory of ``<video_id>.npy`` arrays, or an h5 file keyed by video id
    (other keys are left out)."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    if os.path.isdir(source):
        paths = [os.path.join(source, f"{vid}.npy") for vid in video_ids]
        for path in paths:
            if not os.path.exists(path):
                raise FileNotFoundError(f"missing feature file {path}")
        # the frame count first (headers only), then one streaming pass
        total = sum(1 if len(s) == 1 else s[0] for s in
                    (np.load(p, mmap_mode="r").shape for p in paths))

        def clips() -> Iterator[tuple[str, np.ndarray]]:
            for vid, path in zip(video_ids, paths):
                yield vid, _as_frames(vid, np.load(path))

        return write_features(out_path, clips(), total)
    import h5py

    with h5py.File(source, "r") as src:
        for vid in video_ids:
            if vid not in src:
                raise KeyError(f"{source} has no key {vid!r}")
        total = sum(1 if len(src[v].shape) == 1 else src[v].shape[0]
                    for v in video_ids)
        return write_features(
            out_path,
            ((vid, _as_frames(vid, src[vid][()])) for vid in video_ids),
            total)


def _write_dataset(out_dir: str, raw: Mapping[str, list[str]],
                   splits: Mapping[str, str],
                   features: Mapping[str, str] | None, min_word_count: int,
                   write_consensus_weights: bool,
                   write_cider_df: bool) -> dict[str, str]:
    """Tokenized corpus and splits -> ``info.json``, the feature files, the
    WXE weights and the CIDEr df under ``out_dir``. The vocab, the df and
    the weights come from the train split only."""
    os.makedirs(out_dir, exist_ok=True)
    tokenized = tokenize_captions(raw)
    train_tok = {v: t for v, t in tokenized.items() if splits[v] == "train"}
    if not train_tok:
        raise ValueError("no train-split videos — cannot build a vocab")
    vocab = build_vocab(train_tok, min_count=min_word_count)
    videos = [{"id": vid, "split": splits[vid],
               "captions": [" ".join(t) for t in caps],
               "caption_ids": [vocab.encode(t) for t in caps]}
              for vid, caps in tokenized.items()]
    info_path = os.path.join(out_dir, "info.json")
    with open(info_path, "w") as f:
        json.dump({"vocab": vocab.words, "videos": videos}, f)
    out = {"info_json": info_path}
    if write_cider_df:
        df_path = os.path.join(out_dir, "cider_df.npz")
        compute_cider_df(train_tok).save(df_path)
        out["cider_df"] = df_path
    if write_consensus_weights:
        w_path = os.path.join(out_dir, "consensus_weights.npz")
        np.savez(w_path, **compute_consensus_weights(train_tok))
        out["consensus_weights"] = w_path
    vids = [v["id"] for v in videos]
    if features:
        out["feature_files"] = {
            name: pack_features(source, os.path.join(out_dir, f"{name}.npy"),
                                vids)
            for name, source in features.items()}
    return out


def import_msrvtt(videodatainfo: str | Mapping, out_dir: str,
                  features: Mapping[str, str] | None = None,
                  min_word_count: int = 2,
                  write_consensus_weights: bool = True,
                  write_cider_df: bool = True) -> dict[str, str]:
    """An MSR-VTT distribution -> ``info.json``, ``<modality>.npy`` (and
    its index) for each of ``features``, ``consensus_weights.npz`` and
    ``cider_df.npz`` under ``out_dir``. Returns the path map keyed as
    ``DataConfig`` takes it (``DataConfig(**paths)``): ``info_json``,
    ``consensus_weights``, ``cider_df`` and ``feature_files`` {modality:
    path}, each present when written."""
    raw, splits = parse_msrvtt_info(videodatainfo)
    return _write_dataset(out_dir, raw, splits, features, min_word_count,
                          write_consensus_weights, write_cider_df)


def import_msvd(corpus: str | Mapping, out_dir: str,
                mapping: str | None = None,
                features: Mapping[str, str] | None = None,
                n_train: int = MSVD_NUM_TRAIN, n_val: int = MSVD_NUM_VAL,
                min_word_count: int = 2, write_consensus_weights: bool = True,
                write_cider_df: bool = True) -> dict[str, str]:
    """An MSVD distribution -> the files of :func:`import_msrvtt`; the
    corpus, ``mapping`` and split sizes as :func:`parse_msvd_corpus` takes
    them."""
    raw, splits = parse_msvd_corpus(corpus, mapping=mapping, n_train=n_train,
                                    n_val=n_val)
    return _write_dataset(out_dir, raw, splits, features, min_word_count,
                          write_consensus_weights, write_cider_df)
