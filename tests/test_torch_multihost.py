"""The port's processes and ranks (``train/multihost.py``) against the JAX
package's ``train/multihost.py``: the single-process identities of every
helper (``tests/test_multihost.py:160``, ``:188``), ``initialize`` leaving
a run without a launcher untouched (with the SLURM / MPI warning); at two
gloo ranks (``test_torch_dp_child``): ``allgather_pyobj``,
``broadcast_pyobj``, ``global_weighted_mean`` over unequal weights,
``global_scalar_mean``, ``allgather_to_host`` along either axis, each
inside its ``dcn.collective`` span with the JAX op name; and the partial
kill on real ranks (``tests/test_multihost.py:243``): rank 1 dies by a
seeded chaos kill, rank 0's monitor declares it lost from staleness, the
strict trainer drains before its next step's collectives, saves a step
checkpoint and raises ``PeerLost([1])``."""

import logging
import os

import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.train import multihost as jmh
from cst_captioning_tpu_torch.data import make_synthetic_dataset
from cst_captioning_tpu_torch.train import multihost as mh
from test_torch_dp_child import launch

torch.set_num_threads(1)


# ---- one process: the identities ---------------------------------------------


def test_helpers_single_process_identity():
    assert not mh.is_multiprocess() and not jmh.is_multiprocess()
    assert mh.host_shard() == jmh.host_shard() == (0, 1)
    tree = ({"a": np.ones((8, 3), np.float32)}, np.arange(8, dtype=np.int32))
    placed = mh.put_global(tree, "cpu")
    np.testing.assert_array_equal(placed[0]["a"].numpy(), tree[0]["a"])
    np.testing.assert_array_equal(
        mh.put_full_global(np.ones((8, 2), np.float32), "cpu", dim=0).numpy(),
        np.ones((8, 2), np.float32))
    arr = placed[1]
    np.testing.assert_array_equal(mh.to_host_local(arr), tree[1])
    assert torch.equal(mh.from_host_local(tree[1], "cpu"), arr)
    np.testing.assert_array_equal(mh.allgather_to_host(arr), tree[1])
    assert mh.global_scalar_mean(2.5) == jmh.global_scalar_mean(2.5) == 2.5
    for v, w in ((6.0, 4.0), (0.0, 0.0), (1.5, 0.25)):
        assert mh.global_weighted_mean(v, w) == \
            jmh.global_weighted_mean(v, w)
    mh.barrier()                        # nothing to wait for


def test_pyobj_helpers_single_process():
    obj = {"a": [1, 2], "b": "caption text"}
    assert mh.allgather_pyobj(obj) == jmh.allgather_pyobj(obj) == [obj]
    assert mh.broadcast_pyobj(obj) is obj


def test_initialize_without_a_launcher_is_untouched(monkeypatch, caplog):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("SLURM_NTASKS", "4")
    with caplog.at_level(logging.WARNING):
        assert mh.initialize(device="cpu") is False
    assert "SLURM_NTASKS=4" in caplog.text
    assert not torch.distributed.is_initialized()
    assert mh.backend() == ""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="without a rank"):
        mh.initialize(device="cpu")
    assert mh.local_device(torch.device("cpu")) == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mh.local_device(torch.device("cuda")) == torch.device("cuda", 3)
    assert mh.local_device(torch.device("cuda", 1)) == torch.device("cuda", 1)


# ---- two ranks -----------------------------------------------------------------


@pytest.fixture(scope="module")
def helpers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_helpers")
    res, rcs, errs = launch("helpers", {
        "obs_dir": str(tmp / "obs"), "sums": [6.0, 1.5],
        "weights": [4.0, 1.0]}, tmp)
    assert rcs == [0, 0], "\n".join(e[-3000:] for e in errs)
    return res


def test_two_rank_pyobj_helpers(helpers):
    for rank, r in enumerate(helpers):
        assert r["host_shard"] == (rank, 2) and r["is_multiprocess"]
        assert r["pyobj"] == [{"rank": 0, "ids": []},
                              {"rank": 1, "ids": ["v1"]}]
        assert r["bcast"] == {"from": 0, "x": 0.1}


def test_two_rank_means(helpers):
    for r in helpers:
        # unequal weights: the exact cross-rank ratio, not a mean of means
        assert r["wmean"] == pytest.approx(7.5 / 5.0, abs=0, rel=1e-15)
        assert r["smean"] == 1.5


def test_two_rank_allgather_to_host(helpers):
    for r in helpers:
        np.testing.assert_array_equal(
            r["gather"], np.repeat(np.arange(2, dtype=np.int32), 2)[:, None]
            * np.ones((1, 3), np.int32))
        assert r["gather1"].shape == (2, 2, 3)
        np.testing.assert_array_equal(r["gather1"][:, 1], np.ones((2, 3)))


def test_two_rank_helpers_record_collective_spans(helpers):
    for r in helpers:
        ops = r["span_ops"]
        for op in ("allgather_pyobj", "global_weighted_mean",
                   "global_scalar_mean", "allgather_to_host", "barrier"):
            assert op in ops, (op, ops)
        # broadcast_pyobj rides allgather_pyobj: two allgather_pyobj spans
        assert ops.count("allgather_pyobj") == 2


# ---- the partial kill on real ranks --------------------------------------------


def test_partial_kill_survivor_drains(tmp_path):
    paths = make_synthetic_dataset(
        str(tmp_path / "data"), num_videos=16, num_topics=3, vocab_words=20,
        modalities={"resnet": 12}, max_frames=4, seed=9)
    vocab = len(__import__("json").load(open(paths["info_json"]))["vocab"])
    model = dict(vocab_size=vocab, modalities=(("resnet", 12),), d_embed=16,
                 d_hidden=16, d_att=8, encoder="temporal_attention",
                 dropout=0.0, max_len=8, max_frames=4, dtype="float32")
    overrides = {f"model__{k}": v for k, v in model.items()}
    overrides.update(
        data__batch_size=4, data__seq_per_vid=2, mesh__num_devices=2,
        train__lr=5e-3, train__epochs=2, train__eval_every_epochs=100,
        train__seed=0, train__health=True,
        train__health_dir=str(tmp_path / "health"),
        train__health_interval_s=0.1, train__peer_timeout_s=0.5,
        train__health_misses=2, train__elastic="strict")
    ckpt = str(tmp_path / "ckpt")
    res, rcs, errs = launch("partial_kill", {
        "preset": "msrvtt_xe_attention", "overrides": overrides,
        "info_json": paths["info_json"],
        "features": {"resnet": paths["resnet"]}, "max_frames": 4,
        "tmp": str(tmp_path), "ckpt_dir": ckpt}, tmp_path, timeout=120)
    survivor, victim = res
    assert victim == {"rank": 1, "died": "SimulatedKill"}, errs[1][-3000:]
    assert survivor is not None, errs[0][-3000:]
    assert survivor["peer_lost"] == [1], (survivor, errs[0][-3000:])
    # three steps with the peer, then the drain: no step past the loss
    assert survivor["step"] == 3
    assert survivor["drained_ckpts"] == ["step_00000003"]
    assert os.path.exists(os.path.join(ckpt, "step_00000003",
                                       "infos.json"))
