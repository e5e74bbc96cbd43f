"""The port's online SCST from served traffic (``rl/online.py``) on the
CPU, float32 at a small width (V=31, E=H=12, A=6, T=8, one modality, up
to 5 frames), attention_impl and decode_impl "pallas" (the JAX kernels in
interpret mode, the port's plain versions):

- the same captures (numpy tokens and logprobs with their versions) fed
  through both packages' ``on_result``: the applied and dropped counts,
  the staleness ledger, the per-update history and the final params
  within 2e-5 (``tests/test_torch_train.py``'s TOL);
- the closed loop on a CPU ``CaptionService``: captures, updates and
  version-stamped publishes; a partial buffer waits; stale captures are
  dropped and counted; two runs end bitwise equal; every completed
  request replayed alone through a fresh service under its pinned
  version gives the same tokens and logprobs, bitwise;
- ``attach`` refusing a version mismatch and a learner that shares the
  served model's parameters, and a capture refusing a lane mismatch."""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.config.config import EOS_ID, ModelConfig, RLConfig
from cst_captioning_tpu.config.config import TrainConfig
from cst_captioning_tpu.data.vocab import Vocab
from cst_captioning_tpu.models import CaptionModel
from cst_captioning_tpu.rl import OnlineSCSTTrainer as JaxOnline
from cst_captioning_tpu.rl.rewards import RewardComputer
from cst_captioning_tpu.serving import ClipRequest as JaxClipRequest
from cst_captioning_tpu.train.schedule import make_optimizer
from cst_captioning_tpu.train.state import TrainState as JaxState
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch import rl as trl
from cst_captioning_tpu_torch import train as ttrain
from cst_captioning_tpu_torch.convert import load_flax_params, state_dict_to_flax
from cst_captioning_tpu_torch.data import Vocab as TorchVocab
from cst_captioning_tpu_torch.models import CaptionModel as TorchCaptionModel
from cst_captioning_tpu_torch.serving import CaptionService, ClipRequest

torch.set_num_threads(1)

TOL = 2e-5
MODAL = (("resnet", 8),)
T, MAX_F, V, N_CLIPS = 8, 5, 31, 8
WORDS = [f"w{i}" for i in range(V - 4)]
KW = dict(vocab_size=V, modalities=MODAL, d_embed=12, d_hidden=12, d_att=6,
          encoder="temporal_attention", dropout=0.0, max_len=T,
          max_frames=MAX_F, dtype="float32", attention_impl="pallas",
          decode_impl="pallas", decode_stride=4)
LR = 0.1


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    xla = CaptionModel(ModelConfig(**{**KW, "attention_impl": "xla"}))
    params = xla.init(
        jax.random.key(0),
        {"resnet": jnp.asarray(rng.normal(size=(2, MAX_F, 8)), jnp.float32)},
        {"resnet": jnp.ones((2, MAX_F), jnp.float32)},
        jnp.zeros((2, T), jnp.int32))
    # EOS-biased so caption lengths vary and lanes free at different
    # strides, straddling the swaps
    bias = params["params"]["cell"]["out_proj"]["bias"]
    params["params"]["cell"]["out_proj"]["bias"] = bias.at[EOS_ID].add(2.0)
    gts = {f"r{i}": [" ".join(rng.choice(WORDS[:12], rng.integers(2, 6)))
                     for _ in range(4)] for i in range(N_CLIPS)}
    return dict(params=params, gts=gts,
                jmodel=CaptionModel(ModelConfig(**KW)))


def _rl(**kw):
    base = dict(num_rollouts=2, baseline="greedy", lr=LR, rollout_depth=1,
                staleness_bound=8, online_batch_size=2, swap_every=1)
    base.update(kw)
    return base


def _model(s):
    return load_flax_params(
        TorchCaptionModel(tcfg.ModelConfig(**KW), device="cpu"),
        jax.tree.map(np.asarray, s["params"])).eval()


def _learner(s, served=None, **rl):
    """-> (OnlineSCSTTrainer over a copy of the served model, served)."""
    served = served or _model(s)
    model = copy.deepcopy(served)
    tx = ttrain.make_optimizer(tcfg.TrainConfig(
        optimizer="sgd", lr=LR, grad_clip=0.0, lr_decay_every=0), 10)
    state = ttrain.create_train_state(model, tx)
    reward = trl.RewardComputer(TorchVocab.from_corpus_words(WORDS), s["gts"])
    return trl.OnlineSCSTTrainer(model, reward, tcfg.RLConfig(**_rl(**rl)),
                                 state), served


def _requests(n=6, seed0=1000, cls=ClipRequest):
    out = []
    frames = (1, 5, 3, 5, 2, 4, 1, 5)
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        F = frames[i % len(frames)]
        out.append(cls(
            req_id=f"r{i}",
            feats={"resnet": rng.normal(size=(F, 8)).astype(np.float32)},
            masks={"resnet": np.ones((F,), np.float32)},
            seed=seed0 + i))
    return out


def _service(model):
    return CaptionService(model, capacity=2, num_rollouts=2, stride=4,
                          frame_bucket=1, device="cpu")


def _run_loop(s, n=6, **rl):
    trainer, served = _learner(s, **rl)
    svc = _service(served)
    trainer.attach(svc)
    published = {0: copy.deepcopy(served.state_dict())}
    real = svc.publish_params

    def publish(params, version=None):
        published[version] = copy.deepcopy(params.state_dict())
        return real(params, version=version)

    svc.publish_params = publish
    report = svc.serve(_requests(n))
    trainer.flush()
    return trainer, svc, report, published


def _equal_params(a, b):
    for x, y in zip(a.parameters(), b.parameters()):
        assert torch.equal(x, y)


# ---- the same captures through both packages -----------------------------------


def _captures(n, versions, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        F = int(rng.integers(1, MAX_F + 1))
        toks = rng.integers(4, V, size=(3, T)).astype(np.int32)
        for lane in range(3):
            end = int(rng.integers(1, T + 1))
            if end < T:
                toks[lane, end - 1] = EOS_ID
                toks[lane, end:] = 0
        out.append(dict(
            rid=f"r{i % N_CLIPS}", version=versions[i], seed=seed + i,
            feats={"resnet": rng.normal(size=(F, 8)).astype(np.float32)},
            masks={"resnet": np.ones((F,), np.float32)},
            result=SimpleNamespace(
                tokens=toks,
                logprobs=rng.normal(size=(3, T)).astype(np.float32) - 2.0)))
    return out


@pytest.mark.parametrize("depth,bound", [(1, 0), (2, 1)])
def test_on_result_matches_jax(setup, depth, bound):
    """Captures stamped with versions that lag the learner by 0-3 updates
    (a ring of ``depth`` batches of 2): both learners apply and drop the
    same batches, and their history and params agree."""
    versions = [0, 0, 0, 0, 1, 0, 2, 2, 1, 1, 3, 3, 3, 3, 6, 5]
    caps = _captures(len(versions), versions)
    rl = _rl(rollout_depth=depth, staleness_bound=bound)
    tx = make_optimizer(TrainConfig(optimizer="sgd", lr=LR, grad_clip=0.0,
                                    lr_decay_every=0), 10)
    params = setup["params"]
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      opt_state=tx.init(params), rng=jax.random.key(0),
                      tx=tx, apply_fn=setup["jmodel"].apply)
    jtr = JaxOnline(setup["jmodel"], RewardComputer(
        Vocab.from_corpus_words(WORDS), setup["gts"]),
        RLConfig(enabled=True, **rl), jstate)
    ttr, _ = _learner(setup, rollout_depth=depth, staleness_bound=bound)
    for c in caps:
        jtr.on_result(JaxClipRequest(req_id=c["rid"], feats=c["feats"],
                                     masks=c["masks"], seed=c["seed"]),
                      c["result"], c["version"])
        ttr.on_result(ClipRequest(req_id=c["rid"], feats=c["feats"],
                                  masks=c["masks"], seed=c["seed"]),
                      c["result"], c["version"])
    assert jtr.flush() == ttr.flush()
    assert (ttr.version, ttr.last_applied, ttr.last_dropped) == \
        (jtr.version, jtr.last_applied, jtr.last_dropped)
    assert ttr.last_dropped > 0 and ttr.last_applied > 2
    assert ttr.last_staleness == jtr.last_staleness
    assert len(ttr.history) == len(jtr.history)
    for a, b in zip(jtr.history, ttr.history):
        assert (b["staleness"], b["param_version"]) == \
            (a["staleness"], a["param_version"])
        for key in ("reward_mean", "baseline_mean", "advantage_mean"):
            assert b[key] == pytest.approx(a[key], abs=TOL, rel=TOL)
        np.testing.assert_allclose(b["rl_loss"], float(a["rl_loss"]),
                                   rtol=TOL, atol=TOL)
    want = jax.tree_util.tree_leaves_with_path(jtr.state.params)
    got = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(
        ttr.state.model.cfg, ttr.state.model.state_dict())))
    for path, leaf in want:
        np.testing.assert_allclose(got[path], np.asarray(leaf), rtol=TOL,
                                   atol=TOL, err_msg=str(path))


def test_stale_captures_are_dropped_and_counted(setup):
    """Drop-and-COUNT, never recount; a mixed-version batch is as stale
    as its oldest capture."""
    trainer, _ = _learner(setup, staleness_bound=0)
    caps = _captures(8, [0, 0, 0, 0, 1, 1, 0, 2])

    def feed(c):
        trainer.on_result(ClipRequest(req_id=c["rid"], feats=c["feats"],
                                      masks=c["masks"], seed=c["seed"]),
                          c["result"], c["version"])

    feed(caps[0]), feed(caps[1])
    assert trainer.version == 1 and trainer.last_dropped == 0
    feed(caps[2]), feed(caps[3])
    assert trainer.version == 1 and trainer.last_dropped == 1
    feed(caps[4]), feed(caps[5])
    assert trainer.version == 2 and trainer.last_applied == 2
    assert trainer.last_staleness == {0: 2, 1: 1}
    feed(caps[6]), feed(caps[7])
    assert trainer.last_dropped == 2 and trainer.version == 2
    assert trainer.last_staleness == {0: 2, 1: 1, 2: 1}


# ---- the closed loop on a CPU service -------------------------------------------


def test_online_loop_captures_updates_and_publishes(setup):
    trainer, svc, report, _ = _run_loop(setup)
    assert report.completed == 6 and not report.drained
    assert trainer.version == 3 == trainer.last_applied
    assert trainer.last_dropped == 0 and trainer.pending_captures == 0
    assert svc.param_version == 3
    assert [h["version"] for h in svc._swap_history] == [1, 2, 3]
    assert [m["param_version"] for m in trainer.history] == [1, 2, 3]
    assert all("reward_mean" in m for m in trainer.history)
    assert any(not torch.equal(a, b) for a, b in zip(
        _model(setup).parameters(), trainer.state.model.parameters()))
    versions = [report.results[f"r{i}"].param_version for i in range(6)]
    assert versions[0] == 0 and max(versions) >= 1
    assert versions == sorted(versions)


def test_partial_buffer_waits(setup):
    trainer, svc, report, _ = _run_loop(setup, n=5)
    assert report.completed == 5
    assert trainer.version == 2 and trainer.pending_captures == 1
    assert trainer.flush() == 0 and trainer.pending_captures == 1


def test_two_runs_are_bitwise_equal(setup):
    t1, s1, r1, _ = _run_loop(setup, n=8, staleness_bound=0,
                              rollout_depth=2)
    t2, s2, r2, _ = _run_loop(setup, n=8, staleness_bound=0,
                              rollout_depth=2)
    assert (t1.version, t1.last_applied, t1.last_dropped) == \
        (t2.version, t2.last_applied, t2.last_dropped)
    assert t1.last_staleness == t2.last_staleness
    assert t1.last_dropped > 0
    assert s1.param_version == s2.param_version
    _equal_params(t1.state.model, t2.state.model)
    assert [m["rl_loss"] for m in t1.history] == \
        [m["rl_loss"] for m in t2.history]


def test_replay_under_the_pinned_version_is_bitwise(setup):
    """Every completed request, served alone by a fresh service under the
    version it was admitted under, gives the same tokens and logprobs."""
    trainer, svc, report, published = _run_loop(setup, n=8)
    pinned = {r.param_version for r in report.results.values()}
    assert len(pinned) >= 2
    reqs = {r.req_id: r for r in _requests(8)}
    for rid, res in report.results.items():
        model = _model(setup)
        model.load_state_dict(published[res.param_version])
        alone = _service(model).serve([reqs[rid]]).results[rid]
        np.testing.assert_array_equal(alone.tokens, res.tokens)
        np.testing.assert_array_equal(alone.logprobs, res.logprobs)


# ---- wiring guards ---------------------------------------------------------------


def test_attach_refuses_a_version_mismatch(setup):
    trainer, served = _learner(setup)
    trainer.version = 2
    with pytest.raises(ValueError, match="version"):
        trainer.attach(_service(served))


def test_attach_refuses_shared_parameters(setup):
    trainer, served = _learner(setup)
    trainer.state.model = served   # the served model itself
    with pytest.raises(ValueError, match="shares parameter storage"):
        trainer.attach(_service(served))


def test_capture_refuses_a_lane_mismatch(setup):
    trainer, served = _learner(setup)
    svc = CaptionService(served, capacity=2, num_rollouts=1, stride=4,
                         device="cpu")
    trainer.attach(svc)
    with pytest.raises(ValueError, match="lanes"):
        svc.serve(_requests(1))
