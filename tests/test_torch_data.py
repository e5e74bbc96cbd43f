"""The port's data path against the JAX package's, on the CPU: the
synthetic corpus (both caption styles: the same info.json, every clip's
frames equal to the JAX h5's), the h5 converter, ``CaptionDataset`` with
its reference pools and WXE weights, the Batcher over epochs (order,
labels, masks, weights, valid, features; exact), the consensus weights,
the CIDEr df and ``CorpusDF`` files, ``build_info_json``, and the
prefetch thread's contract (order, errors in the consumer, no leaked
worker, ``stop_event``)."""

import json
import pickle
import threading
import time

import h5py
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.data.batcher import Batcher as JaxBatcher
from cst_captioning_tpu.data.dataset import CaptionDataset as JaxDataset
from cst_captioning_tpu.data.dataset import FeatureStore as JaxFeatureStore
from cst_captioning_tpu.data.preprocess import build_info_json as jax_info
from cst_captioning_tpu.data.preprocess import (
    compute_cider_df as jax_df,
)
from cst_captioning_tpu.data.preprocess import (
    compute_consensus_weights as jax_weights,
)
from cst_captioning_tpu.data.synthetic import (
    make_synthetic_dataset as jax_synthetic,
)
from cst_captioning_tpu.metrics.cider import CorpusDF as JaxCorpusDF
from cst_captioning_tpu_torch.data import (
    Batcher,
    CaptionDataset,
    FeatureStore,
    build_info_json,
    compute_cider_df,
    compute_consensus_weights,
    convert_h5_features,
    make_synthetic_dataset,
    prefetch_to_device,
)
from cst_captioning_tpu_torch.metrics.cider import CorpusDF

torch.set_num_threads(1)

MODAL = {"resnet": 12, "c3d": 7}
KW = dict(num_videos=24, num_topics=3, vocab_words=18, modalities=MODAL,
          max_frames=6, seed=5)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_data")
    jp = jax_synthetic(str(root / "jax"), **KW)
    tp = make_synthetic_dataset(str(root / "port"), **KW)
    info = json.load(open(jp["info_json"]))
    tok = {v["id"]: [c.split() for c in v["captions"]]
           for v in info["videos"] if v["split"] == "train"}
    w_path = str(root / "weights.npz")
    np.savez(w_path, **jax_weights(tok))
    return dict(jax=jp, port=tp, weights=w_path, tok=tok, root=root)


@pytest.mark.parametrize("style", ["pool", "template"])
def test_synthetic_corpus_equals_jax(tmp_path, style):
    kw = dict(KW, caption_style=style, templates_per_topic=2)
    jp = jax_synthetic(str(tmp_path / "jax"), **kw)
    tp = make_synthetic_dataset(str(tmp_path / "port"), **kw)
    assert json.load(open(tp["info_json"])) == json.load(open(jp["info_json"]))
    for name in MODAL:
        store = FeatureStore(tp[name], max_frames=64)
        with h5py.File(jp[name], "r") as h5:
            assert sorted(store.keys()) == sorted(h5.keys())
            for vid in h5:
                start, n = store._index[vid]
                want = np.asarray(h5[vid])
                got = np.asarray(store._frames[start:start + n])
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_frames", [3, 6, 9])
def test_converter_round_trips(corpora, tmp_path, max_frames):
    """h5 -> the port's format: FeatureStore.get equals the JAX store's,
    past max_frames (uniform subsample) and below it (padding)."""
    src = corpora["jax"]["resnet"]
    out = convert_h5_features(src, str(tmp_path / "resnet.npy"))
    got = FeatureStore(out, max_frames=max_frames)
    want = JaxFeatureStore(src, max_frames=max_frames)
    assert sorted(got.keys()) == sorted(want.keys())
    assert got.dim == want.dim == MODAL["resnet"]
    for vid in want.keys():
        gf, gm = got.get(vid)
        wf, wm = want.get(vid)
        np.testing.assert_array_equal(gf, wf)
        np.testing.assert_array_equal(gm, wm)
    want.close()
    # a 1-D dataset (one pooled vector) becomes one frame
    h5_path = str(tmp_path / "pooled.h5")
    with h5py.File(h5_path, "w") as h5:
        h5.create_dataset("v0", data=np.arange(4, dtype=np.float32))
    pooled = FeatureStore(convert_h5_features(h5_path,
                                              str(tmp_path / "pooled.npy")),
                          max_frames=2)
    f, m = pooled.get("v0")
    np.testing.assert_array_equal(f[0], np.arange(4))
    np.testing.assert_array_equal(m, [1.0, 0.0])


def _datasets(c, split, **kw):
    files_j = {n: c["jax"][n] for n in MODAL}
    files_t = {n: c["port"][n] for n in MODAL}
    return (JaxDataset(c["jax"]["info_json"], files_j, split, 5, **kw),
            CaptionDataset(c["port"]["info_json"], files_t, split, 5, **kw))


def _batches_equal(a, b):
    assert a.video_ids == b.video_ids
    for key in ("labels", "mask", "weights", "valid"):
        np.testing.assert_array_equal(getattr(b, key), getattr(a, key),
                                      err_msg=key)
    for n in MODAL:
        np.testing.assert_array_equal(b.feats[n], a.feats[n])
        np.testing.assert_array_equal(b.feat_masks[n], a.feat_masks[n])


@pytest.mark.parametrize("mode,seq", [("caption", 1), ("caption", 3),
                                      ("video", 1)])
def test_dataset_and_batcher_match_jax(corpora, mode, seq):
    jds, tds = _datasets(corpora, "train",
                         consensus_weights=corpora["weights"])
    assert [vars(r) for r in tds.records] == [vars(r) for r in jds.records]
    assert tds.gts_pool() == jds.gts_pool()
    assert tds.vocab.words == jds.vocab.words
    jb = JaxBatcher(jds, batch_size=7, max_len=8, mode=mode,
                    seq_per_vid=seq, seed=2)
    tb = Batcher(tds, batch_size=7, max_len=8, mode=mode, seq_per_vid=seq,
                 seed=2)
    assert tb.num_batches() == jb.num_batches()
    for epoch in range(2):
        jb.epoch_index = tb.epoch_index = epoch
        got = list(tb.epoch(shuffle=mode == "caption"))
        want = list(jb.epoch(shuffle=mode == "caption"))
        assert len(got) == len(want)
        assert not got[-1].valid.all()        # the last batch wraps
        for a, b in zip(want, got):
            _batches_equal(a, b)
    jds.close()


def test_dataset_cache_and_errors(corpora, tmp_path):
    _, tds = _datasets(corpora, "val", cache_features=True)
    vid = tds.records[0].video_id
    first = tds.features_for(vid)
    assert tds.features_for(vid) is first
    with pytest.raises(ValueError):
        first["resnet"][0][0, 0] = 1.0          # cached arrays are read-only
    files = {n: corpora["port"][n] for n in MODAL}
    info_path = corpora["port"]["info_json"]
    with pytest.raises(FileNotFoundError):
        CaptionDataset(info_path, files, "train", 5,
                       consensus_weights=str(tmp_path / "nope.npz"))
    with pytest.raises(ValueError, match="no videos for split"):
        CaptionDataset(info_path, files, "nosuch", 5)
    info = json.load(open(info_path))
    info["videos"][0]["caption_ids"] = []
    bad = tmp_path / "bad_info.json"
    bad.write_text(json.dumps(info))
    with pytest.raises(ValueError, match="no captions"):
        CaptionDataset(str(bad), files, info["videos"][0]["split"], 5)
    w = dict(np.load(corpora["weights"]))
    first_vid = next(iter(w))
    w[first_vid] = w[first_vid][:-1]
    short = str(tmp_path / "short.npz")
    np.savez(short, **w)
    with pytest.raises(ValueError, match="length mismatch"):
        CaptionDataset(info_path, files, "train", 5, consensus_weights=short)


def test_consensus_weights_and_df_match_jax(corpora):
    tok = corpora["tok"]
    got, want = compute_consensus_weights(tok), jax_weights(tok)
    assert got.keys() == want.keys()
    for vid in want:
        np.testing.assert_array_equal(got[vid], want[vid])
    raw = compute_consensus_weights(tok, normalize="none")
    want_raw = jax_weights(tok, normalize="none")
    for vid in want_raw:
        np.testing.assert_array_equal(raw[vid], want_raw[vid])
    df, jdf = compute_cider_df(tok), jax_df(tok)
    assert df.df == jdf.df and df.num_docs == jdf.num_docs


def test_corpus_df_files(corpora, tmp_path):
    """The port reads the JAX package's CorpusDF.save file and round-trips
    its own npz; both give the same df."""
    jdf = jax_df(corpora["tok"])
    jax_path = str(tmp_path / "cider_df.pkl")
    jdf.save(jax_path)
    got = CorpusDF.load(jax_path)
    assert got.df == jdf.df and got.num_docs == jdf.num_docs
    port_path = str(tmp_path / "cider_df.npz")
    got.save(port_path)
    with np.load(port_path, allow_pickle=False) as z:
        assert set(z.files) == {"grams", "counts", "num_docs"}
    again = CorpusDF.load(port_path)
    assert again.df == jdf.df and again.num_docs == jdf.num_docs
    # a pickle that names any global is refused
    evil = tmp_path / "evil.pkl"
    evil.write_bytes(pickle.dumps({"df": JaxCorpusDF, "num_docs": 1}))
    with pytest.raises(pickle.UnpicklingError):
        CorpusDF.load(str(evil))


def test_build_info_json_matches_jax(tmp_path):
    raw = {"a": ["A man is cooking.", "someone cooks food"],
           "b": ["Two dogs run!", "dogs are running in a field"]}
    splits = {"a": "train", "b": "val"}
    jv = jax_info(str(tmp_path / "j.json"), raw, splits, min_count=1)
    tv = build_info_json(str(tmp_path / "t.json"), raw, splits, min_count=1)
    assert tv.words == jv.words
    assert (json.load(open(tmp_path / "t.json"))
            == json.load(open(tmp_path / "j.json")))


# ---- prefetch -----------------------------------------------------------------


def test_prefetch_keeps_order_and_places(corpora):
    _, tds = _datasets(corpora, "train")
    b = Batcher(tds, batch_size=5, max_len=8, mode="caption", seed=1)
    want = list(b.epoch(shuffle=False))
    out = list(prefetch_to_device(
        b.epoch(shuffle=False), size=2, device="cpu",
        transform=lambda x: (x.feats, x.labels, list(x.video_ids))))
    assert len(out) == len(want)
    for (feats, labels, vids), w in zip(out, want):
        assert isinstance(labels, torch.Tensor) and vids == w.video_ids
        np.testing.assert_array_equal(labels.numpy(), w.labels)
        np.testing.assert_array_equal(feats["c3d"].numpy(), w.feats["c3d"])
    raw = list(prefetch_to_device(iter([np.zeros(2)]), place=False,
                                  device="cpu"))
    assert isinstance(raw[0], np.ndarray)
    # size 0: no thread, same items
    assert len(list(prefetch_to_device(b.epoch(shuffle=False), size=0,
                                       device="cpu",
                                       transform=lambda x: x.labels))) \
        == len(want)


def test_prefetch_raises_worker_errors_in_the_consumer():
    def bad():
        yield np.zeros(3)
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        list(prefetch_to_device(bad(), size=2, device="cpu"))


def _threads_settle(n_before):
    for _ in range(100):
        if threading.active_count() <= n_before:
            return True
        time.sleep(0.02)
    return False


def test_prefetch_early_abandon_does_not_leak_worker():
    n_before = threading.active_count()

    def src():
        for i in range(100):
            yield np.full((2,), i)

    it = prefetch_to_device(src(), size=2, device="cpu")
    assert int(next(it)[0]) == 0
    it.close()
    assert _threads_settle(n_before)


def test_prefetch_honours_stop_event():
    stop = threading.Event()
    pulled = []

    def src():
        for i in range(50):
            pulled.append(i)
            if i == 3:
                stop.set()
            yield np.full((1,), i)

    got = [int(x[0]) for x in prefetch_to_device(src(), size=1,
                                                 stop_event=stop,
                                                 device="cpu")]
    # the worker stops before staging past the item that set the event
    assert got == list(range(len(got))) and len(got) <= 4
    assert got == [0, 1, 2] and pulled == [0, 1, 2, 3]
