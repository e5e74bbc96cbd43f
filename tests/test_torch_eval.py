"""The port's Batcher and Evaluator against the JAX package's, on the same
CaptionDataset (the JAX package's synthetic corpus, written to a temporary
directory) and converted weights, float32 on the CPU: the same batches in
both modes over two epochs with wrap padding; the same captions and the
same metric table (exact: the captions are equal and the scorers run the
same host arithmetic) for beam 3, greedy and NPAD decoding, pipelined and
serial, with decode_impl "xla" and "pallas" (the JAX kernels in interpret
mode, the port's plain versions). NPAD's sampled lanes take the JAX
evaluator's draws."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.config.config import EvalConfig, ModelConfig
from cst_captioning_tpu.data.batcher import Batcher as JaxBatcher
from cst_captioning_tpu.data.dataset import CaptionDataset
from cst_captioning_tpu.data.synthetic import make_synthetic_dataset
from cst_captioning_tpu.decoding.common import (
    gumbel_step_noise,
    rollout_step_keys,
)
from cst_captioning_tpu.eval.evaluator import Evaluator as JaxEvaluator
from cst_captioning_tpu.models import CaptionModel
from cst_captioning_tpu.train.steps import batch_arrays
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch.convert import load_flax_params
from cst_captioning_tpu_torch.data import Batcher
from cst_captioning_tpu_torch.decoding import fused as fused_mod
from cst_captioning_tpu_torch.eval import Evaluator, evaluate_split
from cst_captioning_tpu_torch.models import CaptionModel as TorchCaptionModel

torch.set_num_threads(1)

T, F, NPAD_SEED = 8, 4, 7
EVAL_B = 4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_eval")
    paths = make_synthetic_dataset(
        str(out), num_videos=20, modalities={"resnet": 16, "c3d": 12},
        max_frames=F, splits=(0.4, 0.1), seed=3)
    files = {"resnet": paths["resnet"], "c3d": paths["c3d"]}
    test = CaptionDataset(paths["info_json"], files, "test", F)
    train = CaptionDataset(paths["info_json"], files, "train", F)
    kw = dict(vocab_size=len(test.vocab),
              modalities=(("resnet", 16), ("c3d", 12)), d_embed=12,
              d_hidden=12, d_att=6, encoder="temporal_attention", max_len=T,
              max_frames=F, dtype="float32", dropout=0.0)
    batch = next(iter(JaxBatcher(train, batch_size=4, max_len=T)
                      .epoch(shuffle=False)))
    feats, masks, labels, *_ = batch_arrays(batch)
    params = CaptionModel(ModelConfig(**kw)).init(jax.random.key(0), feats,
                                                  masks, labels)
    return dict(test=test, train=train, kw=kw, params=params)


def _batches_equal(a, b):
    assert a.video_ids == b.video_ids
    for name in ("labels", "mask", "weights", "valid"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for name in ("feats", "feat_masks"):
        x, y = getattr(a, name), getattr(b, name)
        assert list(x) == list(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("mode,seq", [("caption", 2), ("video", 1)])
def test_batcher_matches_jax(corpus, mode, seq):
    ds = corpus["train"]
    kw = dict(batch_size=5, max_len=T, mode=mode, seq_per_vid=seq, seed=4)
    jb, tb = JaxBatcher(ds, **kw), Batcher(ds, **kw)
    assert tb.num_batches() == jb.num_batches()
    for _ in range(2):                  # two epochs: the order changes
        want, got = list(jb), list(tb)
        assert len(got) == len(want) == tb.num_batches()
        for a, b in zip(got, want):
            _batches_equal(a, b)
        assert not got[-1].valid.all()  # the last batch wraps around
    assert tb.epoch_index == jb.epoch_index == (2 if mode == "caption" else 0)
    tb.salt = jb.salt = 1               # a rollback's fresh order
    for a, b in zip(tb.epoch(), jb.epoch()):
        _batches_equal(a, b)
    with pytest.raises(ValueError, match="host_shard"):
        Batcher(ds, batch_size=5, max_len=T, host_shard=(0, 2))


MODES = {
    "beam3": dict(beam_size=3),
    "greedy": dict(beam_size=1),
    "npad": dict(beam_size=1, npad_lanes=2, npad_temperature=1.5,
                 npad_seed=NPAD_SEED),
}


@pytest.fixture(scope="module")
def jax_results(corpus):
    """The JAX evaluator's result per (mode, decode_impl), pipelined."""
    out = {}
    for impl in ("xla", "pallas"):
        model = CaptionModel(ModelConfig(**{**corpus["kw"],
                                            "decode_impl": impl}))
        for mode, kw in MODES.items():
            cfg = EvalConfig(max_len=T, score_workers=2, **kw)
            out[mode, impl] = JaxEvaluator(
                model, corpus["test"], cfg, batch_size=EVAL_B
            ).evaluate(corpus["params"])
    return out


def _jax_draws(seed: int, K: int, B: int, V: int, device,
               row_offset: int = 0):
    """The JAX evaluator's NPAD draws for the batch whose port seed this
    is (``npad_batch_seed``); one rank, so its rows start at 0."""
    assert row_offset == 0
    bi = seed - NPAD_SEED * 1_000_003
    keys = rollout_step_keys(
        jax.random.fold_in(jax.random.key(NPAD_SEED), bi), K, T)
    return lambda t: torch.from_numpy(np.array(
        gumbel_step_noise(keys[t], (B, V), jnp.float32)))


@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["pipelined", "serial"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("mode", list(MODES))
def test_evaluator_matches_jax(corpus, jax_results, monkeypatch, mode, impl,
                               pipelined):
    monkeypatch.setattr(fused_mod, "rollout_noise", _jax_draws)
    model = load_flax_params(
        TorchCaptionModel(tcfg.ModelConfig(**{**corpus["kw"],
                                              "decode_impl": impl}),
                          device="cpu"),
        jax.tree.map(np.asarray, corpus["params"]))
    cfg = tcfg.EvalConfig(max_len=T, pipelined=pipelined, score_workers=2,
                          **MODES[mode])
    ev = Evaluator(model, corpus["test"], cfg, batch_size=EVAL_B)
    got = ev.evaluate()
    want = jax_results[mode, impl]
    assert got["split"] == want["split"] == "test"
    assert list(got["captions"]) == list(want["captions"])
    assert got["captions"] == want["captions"]
    assert json.dumps(got["metrics"], sort_keys=True) == \
        json.dumps(want["metrics"], sort_keys=True)
    assert len(got["captions"]) == len(corpus["test"].records)
    assert len(set(got["captions"].values())) > 1
    if pipelined:
        assert ev.timing["decode_s"] > 0 and ev.timing["score_s"] > 0


def test_results_json_and_evaluate_split(corpus, tmp_path):
    model = load_flax_params(
        TorchCaptionModel(tcfg.ModelConfig(**corpus["kw"]), device="cpu"),
        jax.tree.map(np.asarray, corpus["params"]))
    path = tmp_path / "out" / "results.json"
    res = evaluate_split(model, corpus["test"],
                         tcfg.EvalConfig(beam_size=2, max_len=T),
                         batch_size=EVAL_B, results_json=str(path))
    assert json.loads(path.read_text()) == json.loads(json.dumps(res))
    with pytest.raises(ValueError, match="beam_impl"):
        tcfg.EvalConfig(beam_impl="bogus")
    with pytest.raises(ValueError, match="npad_temperature"):
        tcfg.EvalConfig(npad_lanes=2, npad_temperature=0.0)
