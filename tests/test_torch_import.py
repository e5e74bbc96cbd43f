"""The port's dataset importers and their CLIs
(``cst_captioning_tpu_torch.data.importers``, ``cli.import_msrvtt``,
``cli.import_msvd``, ``cli.preprocess``) against the JAX package's, on
tiny MSR-VTT and MSVD distributions built in place (the layouts of
tests/test_import.py: an h5 source with a key outside the corpus, a
directory of 1-D ``.npy`` rows, non-English and empty CSV rows, a clip
outside the mapping, val/test-only words). Held: ``info.json`` equal
(vocab, splits, captions, caption ids); consensus weights within 1e-6;
the port's df npz equal to the JAX pickle read through ``CorpusDF.load``;
every clip's feature rows equal to the JAX h5's; every refusal with the
JAX message; the CLIs' printed path maps; the outputs load through
``CaptionDataset`` and batch."""

import json
import os

import h5py
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.cli.import_msrvtt import main as jax_msrvtt_cli
from cst_captioning_tpu.cli.import_msvd import main as jax_msvd_cli
from cst_captioning_tpu.cli.preprocess import main as jax_preprocess_cli
from cst_captioning_tpu.data import importers as jax_importers
from cst_captioning_tpu_torch.cli.import_msrvtt import main as msrvtt_cli
from cst_captioning_tpu_torch.cli.import_msvd import main as msvd_cli
from cst_captioning_tpu_torch.cli.preprocess import main as preprocess_cli
from cst_captioning_tpu_torch.config import DataConfig
from cst_captioning_tpu_torch.data import Batcher, CaptionDataset, importers
from cst_captioning_tpu_torch.data.dataset import index_path
from cst_captioning_tpu_torch.metrics import CorpusDF

torch.set_num_threads(1)

WEIGHT_TOL = 1e-6
PHRASES = [
    "a man is playing a guitar",
    "someone plays an acoustic guitar",
    "a woman is cooking in a kitchen",
    "a person slices some vegetables",
    "a dog runs across the yard",
]
MSVD_PHRASES = [
    "a cat chases a ball",
    "the kitten plays with a toy",
    "a man rides a bicycle downhill",
    "someone is riding a bike",
    "a chef stirs a pot of soup",
]


@pytest.fixture(scope="module")
def msrvtt(tmp_path_factory):
    """videodatainfo.json, an h5 source (plus a key outside the corpus) and
    a directory of 1-D <vid>.npy rows."""
    root = tmp_path_factory.mktemp("msrvtt_raw")
    rng = np.random.default_rng(0)
    n = 10
    videos, sentences = [], []
    for i in range(n):
        split = "train" if i < 6 else ("validate" if i < 8 else "test")
        videos.append({"video_id": f"video{i}", "split": split,
                       "category": i % 3})
        for j in range(3):
            sentences.append({"video_id": f"video{i}",
                              "caption": PHRASES[(i + j) % len(PHRASES)],
                              "sen_id": i * 3 + j})
    info = str(root / "videodatainfo.json")
    with open(info, "w") as f:
        json.dump({"videos": videos, "sentences": sentences}, f)
    h5_path = str(root / "resnet_raw.h5")
    with h5py.File(h5_path, "w") as f:
        for i in range(n):
            f[f"video{i}"] = rng.normal(size=(6, 32)).astype(np.float32)
        f["video_not_in_info"] = np.zeros((6, 32), np.float32)
    npy_dir = root / "c3d_npy"
    npy_dir.mkdir()
    for i in range(n):
        np.save(str(npy_dir / f"video{i}.npy"),
                rng.normal(size=(16,)).astype(np.float32))
    return {"info": info, "h5": h5_path, "npy_dir": str(npy_dir),
            "features": {"resnet": h5_path, "c3d": str(npy_dir)}}


@pytest.fixture(scope="module")
def msvd(tmp_path_factory):
    """video_corpus.csv (German and empty rows, an unmapped clip, val/test
    only words), youtube_mapping.txt out of file order, <clip>.npy."""
    root = tmp_path_factory.mktemp("msvd_raw")
    rng = np.random.default_rng(1)
    n = 8
    clips = [f"yt{i:02d}_{i * 10}_{i * 10 + 5}" for i in range(n)]
    csv_path = str(root / "video_corpus.csv")
    with open(csv_path, "w") as f:
        f.write("VideoID,Start,End,WorkerID,Source,AnnotationTime,"
                "Language,Description\n")
        for i in range(n):
            vid, start, end = f"yt{i:02d}", i * 10, i * 10 + 5
            for j in range(3):
                cap = MSVD_PHRASES[(i + j) % len(MSVD_PHRASES)]
                if i >= 5 and j == 2:
                    cap = f"a rare zzquux{i} appears"
                f.write(f"{vid},{start},{end},w{j},x,1,English,{cap}\n")
            f.write(f"{vid},{start},{end},w9,x,1,German,eine katze\n")
            f.write(f"{vid},{start},{end},w8,x,1,English,\n")
        f.write("ytXX,0,5,w0,x,1,English,this clip is not in the mapping\n")
    map_path = str(root / "youtube_mapping.txt")
    with open(map_path, "w") as f:
        for i in reversed(range(n)):
            f.write(f"{clips[i]} vid{i + 1}\n")
    npy_dir = root / "resnet_npy"
    npy_dir.mkdir()
    for clip in clips:
        np.save(str(npy_dir / f"{clip}.npy"),
                rng.normal(size=(5, 16)).astype(np.float32))
    return {"csv": csv_path, "mapping": map_path, "npy_dir": str(npy_dir),
            "clips": clips, "features": {"resnet": str(npy_dir)}}


def _rows(path, vid):
    with open(index_path(path)) as f:
        index = {v: (s, n) for v, s, n in json.load(f)["videos"]}
    start, n = index[vid]
    return np.load(path)[start:start + n]


def _assert_same_import(port, jax_paths, features):
    """The port's written files against the JAX importer's."""
    with open(port["info_json"]) as f, open(jax_paths["info_json"]) as g:
        assert json.load(f) == json.load(g)
    assert set(port) - {"feature_files"} == set(jax_paths) - set(features)
    assert set(port.get("feature_files", {})) == set(features)
    if "consensus_weights" in port:
        with np.load(port["consensus_weights"]) as w, \
                np.load(jax_paths["consensus_weights"]) as jw:
            assert sorted(w.files) == sorted(jw.files)
            for vid in w.files:
                np.testing.assert_allclose(w[vid], jw[vid], rtol=0,
                                           atol=WEIGHT_TOL)
    if "cider_df" in port:
        df, jdf = CorpusDF.load(port["cider_df"]), CorpusDF.load(
            jax_paths["cider_df"])
        assert port["cider_df"].endswith(".npz")
        assert df.num_docs == jdf.num_docs and df.df == jdf.df
    for name in features:
        path = port["feature_files"][name]
        with h5py.File(jax_paths[name], "r") as h5:
            with open(index_path(path)) as f:
                assert [v for v, _, _ in json.load(f)["videos"]] == list(h5)
            for vid in h5:
                np.testing.assert_array_equal(_rows(path, vid), h5[vid][()])


def test_msrvtt_import_matches_jax(msrvtt, tmp_path):
    port = importers.import_msrvtt(msrvtt["info"], str(tmp_path / "port"),
                                   features=msrvtt["features"],
                                   min_word_count=1)
    jax_paths = jax_importers.import_msrvtt(
        msrvtt["info"], str(tmp_path / "jax"), features=msrvtt["features"],
        min_word_count=1)
    _assert_same_import(port, jax_paths, msrvtt["features"])
    # the unknown h5 key stays out; the 1-D rows became one frame each
    assert "video_not_in_info" not in json.load(
        open(index_path(port["feature_files"]["resnet"])))["videos"]
    assert _rows(port["feature_files"]["c3d"], "video0").shape == (1, 16)
    cfg = DataConfig(**port)
    assert dict(cfg.feature_files) == port["feature_files"]
    for split, want in (("train", 6), ("val", 2), ("test", 2)):
        ds = CaptionDataset(cfg.info_json, dict(cfg.feature_files), split,
                            max_frames=6,
                            consensus_weights=cfg.consensus_weights)
        assert len(ds) == want
        batch = next(iter(Batcher(ds, batch_size=4, max_len=12)))
        assert batch.feats["resnet"].shape == (4, 6, 32)
        assert batch.feats["c3d"].shape == (4, 6, 16)
        assert batch.feat_masks["c3d"][0].sum() == 1.0
        assert batch.labels.max() > 3
        ds.close()


def test_msvd_import_matches_jax(msvd, tmp_path):
    kw = dict(mapping=msvd["mapping"], n_train=5, n_val=1, min_word_count=1)
    port = importers.import_msvd(msvd["csv"], str(tmp_path / "port"),
                                 features=msvd["features"], **kw)
    jax_paths = jax_importers.import_msvd(
        msvd["csv"], str(tmp_path / "jax"), features=msvd["features"], **kw)
    # the JAX importer writes h5; the rows must equal the port's
    _assert_same_import(port, jax_paths, msvd["features"])
    info = json.load(open(port["info_json"]))
    assert [v["id"] for v in info["videos"]] == msvd["clips"]
    assert [v["split"] for v in info["videos"]] == (
        ["train"] * 5 + ["val"] + ["test"] * 2)
    assert not any("zzquux" in w for w in info["vocab"])   # train-only vocab
    assert CorpusDF.load(port["cider_df"]).num_docs == 5
    for split, want in (("train", 5), ("val", 1), ("test", 2)):
        ds = CaptionDataset(port["info_json"], port["feature_files"], split,
                            max_frames=5)
        assert len(ds) == want
        ds.close()


def test_msvd_text_corpus_and_mapping_parse_like_jax(tmp_path, msvd):
    txt = tmp_path / "AllVideoDescriptions.txt"
    with open(txt, "w") as f:
        for i in range(4):
            f.write(f"clip{i} a short caption number {i}\n\n")
            f.write(f"clip{i} another sentence about {i}\n")
    for args in ((str(txt),), (msvd["csv"],)):
        kw = dict(n_train=2, n_val=1)
        assert importers.parse_msvd_corpus(*args, **kw) == \
            jax_importers.parse_msvd_corpus(*args, **kw)
    assert importers.parse_msvd_mapping(msvd["mapping"]) == \
        jax_importers.parse_msvd_mapping(msvd["mapping"]) == msvd["clips"]
    mapping = {"b": ["x y"], "a": ["z"], "c": ["w"]}
    assert importers.parse_msvd_corpus(mapping, n_train=1, n_val=1) == \
        jax_importers.parse_msvd_corpus(mapping, n_train=1, n_val=1)


def _refusals(msrvtt, msvd, tmp):
    """(name, call(module, out_dir)) for each refusal of the importers."""
    info = json.load(open(msrvtt["info"]))
    weird = json.loads(json.dumps(info))
    weird["videos"][0]["split"] = "weird"
    captionless = json.loads(json.dumps(info))
    captionless["videos"].append({"video_id": "video99", "split": "train"})
    orphan = json.loads(json.dumps(info))
    orphan["sentences"].append({"video_id": "nope", "caption": "a b"})
    no_train = json.loads(json.dumps(info))
    for v in no_train["videos"]:
        v["split"] = "test"
    bad_dir = os.path.join(tmp, "bad3d")
    os.makedirs(bad_dir, exist_ok=True)
    np.save(os.path.join(bad_dir, "video0.npy"), np.zeros((1, 6, 32),
                                                          np.float32))
    bad_map = os.path.join(tmp, "bad_mapping.txt")
    with open(bad_map, "w") as f:
        f.write("clip_without_tag\n")
    not_msvd = os.path.join(tmp, "other.csv")
    with open(not_msvd, "w") as f:
        f.write("a,b\n1,2\n")
    empty = os.path.join(tmp, "empty.txt")
    open(empty, "w").close()
    return [
        ("bad split", lambda m, o: m.import_msrvtt(weird, o)),
        ("captionless", lambda m, o: m.import_msrvtt(captionless, o)),
        ("orphan sentence", lambda m, o: m.import_msrvtt(orphan, o)),
        ("no train split", lambda m, o: m.import_msrvtt(no_train, o)),
        ("3-D features", lambda m, o: m.pack_features(
            bad_dir, os.path.join(o, "x.npy" if m is importers else "x.h5"),
            ["video0"])),
        ("missing npy", lambda m, o: m.pack_features(
            msrvtt["npy_dir"],
            os.path.join(o, "x.npy" if m is importers else "x.h5"),
            ["video0", "video404"])),
        ("missing h5 key", lambda m, o: m.pack_features(
            msrvtt["h5"],
            os.path.join(o, "x.npy" if m is importers else "x.h5"),
            ["video404"])),
        ("undersized msvd", lambda m, o: m.import_msvd(
            msvd["csv"], o, mapping=msvd["mapping"], n_train=100)),
        ("bad mapping", lambda m, o: m.parse_msvd_mapping(bad_map)),
        ("not an msvd csv", lambda m, o: m.parse_msvd_corpus(not_msvd)),
        ("empty corpus", lambda m, o: m.parse_msvd_corpus(empty)),
        ("unmapped clip", lambda m, o: m.parse_msvd_corpus(
            {"yt00_0_5": ["a b"]}, mapping=msvd["mapping"])),
    ]


def test_refusals_match_jax(msrvtt, msvd, tmp_path):
    cases = _refusals(msrvtt, msvd, str(tmp_path))
    for name, call in cases:
        msgs = []
        for m in (jax_importers, importers):
            with pytest.raises((ValueError, KeyError,
                                FileNotFoundError)) as e:
                call(m, str(tmp_path / m.__name__.split(".")[0]))
            msgs.append((type(e.value), str(e.value)))
        assert msgs[0] == msgs[1], name


def _cli_paths(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("which", ["msrvtt", "msvd"])
def test_cli_path_maps_match_jax(which, msrvtt, msvd, tmp_path, capsys):
    if which == "msrvtt":
        mains = (jax_msrvtt_cli, msrvtt_cli)
        args = ["--videodatainfo", msrvtt["info"],
                "--feature", f"resnet={msrvtt['h5']}",
                "--feature", f"c3d={msrvtt['npy_dir']}",
                "--min-word-count", "1", "--no-weights"]
        features = msrvtt["features"]
    else:
        mains = (jax_msvd_cli, msvd_cli)
        args = ["--corpus", msvd["csv"], "--mapping", msvd["mapping"],
                "--feature", f"resnet={msvd['npy_dir']}", "--n-train", "5",
                "--n-val", "1", "--min-word-count", "1", "--no-df"]
        features = msvd["features"]
    jax_paths = _cli_paths(mains[0], args + ["--out-dir",
                                             str(tmp_path / "jax")], capsys)
    port = _cli_paths(mains[1], args + ["--out-dir", str(tmp_path / "port")],
                      capsys)
    assert "consensus_weights" not in port or "cider_df" not in port
    for key, path in list(port.items()) + list(
            port["feature_files"].items()):
        if key != "feature_files":
            assert os.path.exists(path), key
    _assert_same_import(port, jax_paths, features)


def test_preprocess_cli_matches_jax(tmp_path, capsys):
    caps = {"videos": [
        {"id": f"v{i}", "split": "train" if i < 4 else "val",
         "captions": [PHRASES[(i + j) % len(PHRASES)] for j in range(3)]}
        for i in range(6)]}
    path = tmp_path / "captions.json"
    path.write_text(json.dumps(caps))
    jax_preprocess_cli(["--captions", str(path), "--out-dir",
                        str(tmp_path / "jax")])
    preprocess_cli(["--captions", str(path), "--out-dir",
                    str(tmp_path / "port")])
    assert "cider_df.npz" in capsys.readouterr().out
    d = lambda side, name: str(tmp_path / side / name)  # noqa: E731
    _assert_same_import(
        {"info_json": d("port", "info.json"),
         "consensus_weights": d("port", "consensus_weights.npz"),
         "cider_df": d("port", "cider_df.npz")},
        {"info_json": d("jax", "info.json"),
         "consensus_weights": d("jax", "consensus_weights.npz"),
         "cider_df": d("jax", "cider_df.pkl")}, {})
    assert CorpusDF.load(d("port", "cider_df.npz")).num_docs == 4
