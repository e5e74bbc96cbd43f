"""The port's decoupled actor/learner SCST (``rl/async_scst.py``) on the
CPU, float32 at a small width (V=97, E=H=16, A=8, T=8, B=6, two
modalities), attention_impl and decode_impl "pallas" on both sides (the
JAX kernels in interpret mode, the port's plain versions):

- the port's :class:`RolloutRing` against the JAX ring: the same pushes
  give the same pops, entries and ``drain_meta`` order;
- strict mode against the port's own sync ``SCSTTrainer.train_epoch``,
  pipelined and sequential, greedy and self-consensus baselines: the
  reward sees the same token rows, and metrics and params are bitwise
  equal; depth 1 with bound 0 is strict without the flag;
- depth/bound (2, 1), (3, 1) and (3, 0) against the JAX
  ``AsyncSCSTTrainer(mesh=None)`` on the same batches and converted
  weights, the JAX draws fed in through ``noise_fns``: the staleness
  ledger and the drop count equal, per-step rl_loss and reward_mean and
  the final params within 2e-5 (``tests/test_torch_train.py``'s TOL);
- two runs bitwise equal; drain and resume replaying the ring, bitwise
  in strict mode; the ring seam through ``Trainer._seam_bytes`` /
  ``_load_seam`` and a seam the JAX trainer wrote; a seam of another
  batch order discarded; the one-device preemption falling back to the
  sync loop; a rejoin without a split a no-op; a layout of several
  devices refused."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.config.config import EOS_ID, ModelConfig, RLConfig
from cst_captioning_tpu.config.config import TrainConfig
from cst_captioning_tpu.data.vocab import Vocab
from cst_captioning_tpu.decoding.common import (
    gumbel_step_noise,
    rollout_step_keys,
)
from cst_captioning_tpu.models import CaptionModel
from cst_captioning_tpu.rl import AsyncSCSTTrainer as JaxAsync
from cst_captioning_tpu.rl import RolloutRing as JaxRing
from cst_captioning_tpu.rl.rewards import RewardComputer
from cst_captioning_tpu.train.schedule import make_optimizer
from cst_captioning_tpu.train.state import TrainState as JaxState
from cst_captioning_tpu.train.trainer import Trainer as JaxTrainer
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch import rl as trl
from cst_captioning_tpu_torch import train as ttrain
from cst_captioning_tpu_torch.convert import load_flax_params, state_dict_to_flax
from cst_captioning_tpu_torch.data import Vocab as TorchVocab
from cst_captioning_tpu_torch.models import CaptionModel as TorchCaptionModel
from cst_captioning_tpu_torch.rl import async_scst
from cst_captioning_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

TOL = 2e-5
MODAL = (("resnet", 16), ("c3d", 12))
B, F, T, V, N_BATCHES = 6, 6, 8, 97, 6
WORDS = [f"w{i}" for i in range(V - 4)]
KW = dict(vocab_size=V, modalities=MODAL, d_embed=16, d_hidden=16, d_att=8,
          encoder="temporal_attention", dropout=0.0, max_len=T, max_frames=F,
          dtype="float32", attention_impl="pallas", decode_impl="pallas",
          decode_stride=1)
LR = 0.1


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    batches = []
    for i in range(N_BATCHES):
        feats = {n: rng.normal(size=(B, F, d)).astype(np.float32)
                 for n, d in MODAL}
        lens = rng.integers(1, F + 1, size=(B, 1))
        masks = {n: (np.arange(F)[None] < lens).astype(np.float32)
                 for n, _ in MODAL}
        vids = [f"v{(i % 2) * B + b}" for b in range(B)]
        batches.append((feats, masks, vids))
    xla = CaptionModel(ModelConfig(**{**KW, "attention_impl": "xla"}))
    params = xla.init(jax.random.key(0),
                      jax.tree.map(jnp.asarray, batches[0][0]),
                      jax.tree.map(jnp.asarray, batches[0][1]),
                      jnp.zeros((B, T), jnp.int32))
    # EOS-biased so rollouts end at different steps
    bias = params["params"]["cell"]["out_proj"]["bias"]
    params["params"]["cell"]["out_proj"]["bias"] = bias.at[EOS_ID].add(2.0)
    gts = {f"v{i}": [" ".join(rng.choice(WORDS[:20], rng.integers(3, 7)))
                     for _ in range(4)] for i in range(2 * B)}
    return dict(params=params, batches=batches, gts=gts,
                jmodel=CaptionModel(ModelConfig(**KW)))


class Recording:
    """Wraps a reward computer and keeps every scored row batch."""

    def __init__(self, reward):
        self.reward = reward
        self.calls: list[np.ndarray] = []

    def __call__(self, video_ids, rows):
        self.calls.append(np.asarray(rows).copy())
        return self.reward(video_ids, rows)


def _rl(**kw):
    base = dict(num_rollouts=2, baseline="greedy", reward_cider_weight=1.0,
                reward_bleu4_weight=0.5)
    base.update(kw)
    return base


def _port(s, rl, cls=trl.AsyncSCSTTrainer, **kw):
    model = load_flax_params(
        TorchCaptionModel(tcfg.ModelConfig(**KW), device="cpu"),
        jax.tree.map(np.asarray, s["params"]))
    tx = ttrain.make_optimizer(tcfg.TrainConfig(
        optimizer="sgd", lr=LR, grad_clip=0.0, lr_decay_every=0), 10)
    state = ttrain.create_train_state(model, tx)
    reward = Recording(trl.RewardComputer(TorchVocab.from_corpus_words(WORDS),
                                          s["gts"]))
    return cls(model, reward, tcfg.RLConfig(**rl), **kw), state


def _torch_batches(s, n=N_BATCHES):
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    return [(t(f), t(m), list(v), None) for f, m, v in s["batches"][:n]]


def _seeds(offset=0):
    return lambda j: trl.rollout_seed(7, 0, 1, offset + j)


def _equal_params(a, b):
    for x, y in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(x, y)


def _same_run(ma, mb, ra, rb):
    assert [m["rl_loss"] for m in ma] == [m["rl_loss"] for m in mb]
    assert [m["reward_mean"] for m in ma] == [m["reward_mean"] for m in mb]
    assert len(ra.calls) == len(rb.calls)
    for x, y in zip(ra.calls, rb.calls):
        np.testing.assert_array_equal(x, y)


# ---- the ring ----------------------------------------------------------------


def test_ring_matches_jax_ring():
    """Depth 3, pushes and pops interleaved: the same entries come out in
    the same order from both rings, and ``drain_meta`` returns the same
    metadata order."""
    rng = np.random.default_rng(3)
    K = 2
    jring, tring = JaxRing(3), trl.RolloutRing(3)
    pushed = 0

    def push():
        nonlocal pushed
        g = rng.integers(0, V, size=(B, T)).astype(np.int32)
        s = rng.integers(0, V, size=(K, B, T)).astype(np.int32)
        lp = rng.normal(size=(K, B, T)).astype(np.float32)
        jring.push(jnp.asarray(g), jnp.asarray(s), jnp.asarray(lp),
                   batch_index=pushed)
        tring.push(torch.from_numpy(g), torch.from_numpy(s),
                   torch.from_numpy(lp), batch_index=pushed)
        pushed += 1

    def same(jent, tent):
        (jm, jg, js, jl), (tm, tg, ts, tl) = jent, tent
        assert jm == tm
        for a, b in ((jg, tg), (js, ts), (jl, tl)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())

    for action in "ppp-p--pp-p":
        if action == "p":
            push()
        else:
            same(jring.pop(), tring.pop())
        assert len(jring) == len(tring)
        for je, te in zip(jring.entries(), tring.entries()):
            same(je, te)
    assert len(tring) == 3
    assert tring.drain_meta() == jring.drain_meta()
    assert len(tring) == 0 and tring._tokens is None


# ---- strict mode against the port's own sync loop -----------------------------


@pytest.mark.parametrize("baseline", ["greedy", "scb"])
@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["pipelined", "sequential"])
def test_strict_matches_sync_bitwise(setup, pipelined, baseline):
    rl = _rl(baseline=baseline, num_rollouts=2 if baseline == "greedy"
             else 3, pipelined=pipelined)
    sync, s_state = _port(setup, rl, cls=trl.SCSTTrainer)
    s_state, ms = sync.train_epoch(s_state, _torch_batches(setup), _seeds(),
                                   pipelined=pipelined)
    a, a_state = _port(setup, rl, strict=True)
    assert a._depth == (2 if pipelined else 1) and a._strict
    a_state, ma = a.train_epoch(a_state, _torch_batches(setup), _seeds())
    assert len(ms) == len(ma) == N_BATCHES
    _same_run(ms, ma, sync.reward, a.reward)
    _equal_params(s_state, a_state)
    assert a.last_dropped == 0
    assert a.last_staleness == ({0: 1, 1: N_BATCHES - 1} if pipelined
                                else {0: N_BATCHES})


def test_depth1_bound0_is_implicitly_strict(setup):
    rl = _rl(pipelined=True, rollout_depth=1, staleness_bound=0)
    sync, s_state = _port(setup, rl, cls=trl.SCSTTrainer)
    s_state, ms = sync.train_epoch(s_state, _torch_batches(setup, 3),
                                   _seeds(), pipelined=False)
    a, a_state = _port(setup, rl)
    assert a._strict and (a._depth, a._bound) == (1, 0)
    a_state, ma = a.train_epoch(a_state, _torch_batches(setup, 3), _seeds())
    _same_run(ms, ma, sync.reward, a.reward)
    _equal_params(s_state, a_state)


# ---- against the JAX decoupled trainer ------------------------------------------


def _jax_draws(n, K):
    """The JAX loop's per-batch draws: ``rng, srng = split(rng)`` from
    key(9), each srng's rollout noise."""
    rng = jax.random.key(9)
    fns = []
    for _ in range(n):
        rng, srng = jax.random.split(rng)
        keys = rollout_step_keys(srng, K, T)
        fns.append(lambda t, keys=keys: torch.from_numpy(np.array(
            gumbel_step_noise(keys[t], (B, V), jnp.float32))))
    return fns


@pytest.mark.parametrize("depth,bound,baseline", [
    (2, 1, "greedy"), (3, 1, "scb"), (3, 0, "greedy")],
    ids=["d2b1", "d3b1_scb", "d3b0"])
def test_decoupled_matches_jax(setup, depth, bound, baseline):
    K = 2 if baseline == "greedy" else 3
    rl = _rl(baseline=baseline, num_rollouts=K, rollout_depth=depth,
             staleness_bound=bound)
    jcfg = RLConfig(enabled=True, **rl)
    tx = make_optimizer(TrainConfig(optimizer="sgd", lr=LR, grad_clip=0.0,
                                    lr_decay_every=0), 10)
    params = setup["params"]
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      opt_state=tx.init(params), rng=jax.random.key(0),
                      tx=tx, apply_fn=setup["jmodel"].apply)
    jtr = JaxAsync(setup["jmodel"], RewardComputer(
        Vocab.from_corpus_words(WORDS), setup["gts"]), jcfg)
    jb = [(jax.tree.map(jnp.asarray, f), jax.tree.map(jnp.asarray, m), v,
           None) for f, m, v in setup["batches"]]
    jstate, jm = jtr.train_epoch(jstate, iter(jb), jax.random.key(9))

    ttr, tstate = _port(setup, rl)
    draws = _jax_draws(N_BATCHES, K)
    tstate, tm = ttr.train_epoch(tstate, _torch_batches(setup), _seeds(),
                                 noise_fns=lambda j: draws[j])
    assert ttr.last_staleness == jtr.last_staleness
    assert ttr.last_dropped == jtr.last_dropped
    if (depth, bound) != (2, 1):
        assert ttr.last_dropped > 0           # the bound fired: recounts
    assert len(tm) == len(jm) == N_BATCHES
    for a, b in zip(jm, tm):
        assert b["reward_mean"] == pytest.approx(a["reward_mean"], abs=TOL,
                                                 rel=TOL)
        np.testing.assert_allclose(b["rl_loss"], float(a["rl_loss"]),
                                   rtol=TOL, atol=TOL)
    want = jax.tree_util.tree_leaves_with_path(jstate.params)
    got = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(
        tstate.model.cfg, tstate.model.state_dict())))
    for path, leaf in want:
        np.testing.assert_allclose(got[path], np.asarray(leaf), rtol=TOL,
                                   atol=TOL, err_msg=str(path))


def test_two_runs_are_bitwise_equal(setup):
    rl = _rl(rollout_depth=3, staleness_bound=1)
    runs = []
    for _ in range(2):
        a, state = _port(setup, rl)
        state, m = a.train_epoch(state, _torch_batches(setup), _seeds())
        runs.append((a, state, m))
    (a0, s0, m0), (a1, s1, m1) = runs
    assert a0.last_dropped == a1.last_dropped == 4
    assert a0.last_staleness == a1.last_staleness == {0: 5, 1: 1}
    _same_run(m0, m1, a0.reward, a1.reward)
    _equal_params(s0, s1)
    occ = a0.last_occupancy
    assert 0.0 < occ["actor"] <= 1.0 and 0.0 < occ["learner"] <= 1.0
    assert occ["wall_s"] > 0


# ---- drain, seam and resume ---------------------------------------------------


def _stop_after(n):
    seen = {"n": 0}

    def stop():
        seen["n"] += 1
        return seen["n"] > n
    return stop


def _load(tmp_path, blob, batch_index):
    ckpt = tmp_path / "step_00000003"
    ckpt.mkdir(exist_ok=True)
    (ckpt / "seam.npz").write_bytes(blob)
    logged = []
    fake = types.SimpleNamespace(
        log=types.SimpleNamespace(log=lambda ev, **kw: logged.append(ev)))
    seam = Trainer._load_seam(fake, str(tmp_path), {
        "ckpt_name": ckpt.name, "phase": "rl", "batch_index": batch_index})
    assert "seam_loaded" in logged
    return seam


@pytest.mark.parametrize("depth", [2, 3])
def test_drain_persists_the_ring_and_resume_replays(setup, tmp_path, depth):
    """A stop before batch 4 persists the ring; through ``seam.npz`` and
    back, a resume from the consumed count replays the persisted tokens
    (the reward sees them first). Depth 2 is strict: the resumed run
    equals the uninterrupted one bitwise."""
    rl = _rl(rollout_depth=depth, staleness_bound=depth - 1)
    batches = _torch_batches(setup)
    full, f_state = _port(setup, rl)
    f_state, fm = full.train_epoch(f_state, batches, _seeds())

    part, p_state = _port(setup, rl)
    sink: dict = {}
    p_state, pm = part.train_epoch(p_state, batches, _seeds(),
                                   should_stop=_stop_after(4),
                                   seam_sink=sink)
    done = len(pm)
    assert done == p_state.step == 4 - (depth - 1)
    ring = sink["ring"]
    assert [e["batch_index"] for e in ring] == list(range(done, 4))
    assert [e["seed"] for e in ring] == [_seeds()(j) for j in range(done, 4)]
    seam = _load(tmp_path, Trainer._seam_bytes(sink, epoch=1,
                                               batch_index=done), done)
    assert seam["epoch"] == 1 and seam["batch_index"] == done
    for a, b in zip(ring, seam["ring"]):
        for key in ("samples", "lps", "greedy", "valid"):
            np.testing.assert_array_equal(a[key], b[key])
        assert (a["video_ids"], a["seed"], a["batch_index"]) == \
            (b["video_ids"], b["seed"], b["batch_index"])

    res, _ = _port(setup, rl)
    p_state, rm = res.train_epoch(p_state, batches[done:], _seeds(done),
                                  seam=seam)
    assert done + len(rm) == p_state.step == N_BATCHES
    # the sampled rows of the replayed batches are the first ones scored
    # (then their greedy rows)
    for i, e in enumerate(ring):
        np.testing.assert_array_equal(
            res.reward.calls[2 * i], e["samples"].reshape(-1, T))
    if depth == 2:
        _equal_params(p_state, f_state)
        assert [m["rl_loss"] for m in pm + rm] == \
            [m["rl_loss"] for m in fm]


def test_seam_written_by_the_jax_trainer_loads_and_replays(setup, tmp_path):
    """The JAX trainer's ring seam (key data, no port seed) loads; the
    resumed epoch replays its tokens, and a recount of such an entry
    would decode from the port's seed of that batch."""
    rng = np.random.default_rng(1)
    vids = setup["batches"][0][2]
    ring = [{
        "samples": rng.integers(4, V, size=(2, B, T)).astype(np.int32),
        "lps": rng.normal(size=(2, B, T)).astype(np.float32),
        "video_ids": vids, "valid": np.ones((B,), np.float32),
        "rng": np.asarray(jax.random.key_data(jax.random.key(7)),
                          np.uint32),
        "batch_index": 2,
        "greedy": rng.integers(4, V, size=(B, T)).astype(np.int32),
    }]
    blob = JaxTrainer._seam_bytes({"ring": ring}, epoch=1, batch_index=2)
    seam = _load(tmp_path, blob, 2)
    (e,) = seam["ring"]
    assert "seed" not in e and e["batch_index"] == 2
    np.testing.assert_array_equal(e["samples"], ring[0]["samples"])
    np.testing.assert_array_equal(e["greedy"], ring[0]["greedy"])
    a, state = _port(setup, _rl())
    batches = _torch_batches(setup)[:1]
    state, m = a.train_epoch(state, batches, _seeds(2), seam=seam)
    assert len(m) == 1
    np.testing.assert_array_equal(a.reward.calls[0],
                                  ring[0]["samples"].reshape(-1, T))
    # a replayed JAX entry carries the batch's own port seed, from which
    # a recount would decode
    feats, masks, vids_, _ = batches[0]
    a._replay_entry(e, feats, masks, vids_, np.ones((B,), np.float32),
                    batch_index=2, j=0, seed=_seeds(2)(0))
    assert a._ring._meta[0]["seed"] == _seeds(2)(0)


def test_seam_of_another_batch_order_is_discarded(setup):
    events = []
    a, state = _port(setup, _rl(),
                     on_event=lambda e, **kw: events.append((e, kw)))
    stale = {"ring": [{
        "samples": np.zeros((2, B, T), np.int32),
        "lps": np.zeros((2, B, T), np.float32),
        "video_ids": [f"other{i}" for i in range(B)],
        "valid": np.ones((B,), np.float32), "seed": 0, "batch_index": 0}]}
    state, m = a.train_epoch(state, _torch_batches(setup, 2), _seeds(),
                             seam=stale)
    assert len(m) == 2
    assert ("seam_ring_discarded", {"entries": 1}) in events


# ---- preemption, rejoin, layout ------------------------------------------------


def test_one_device_preemption_falls_back_to_sync(setup):
    """A preemption requested after the second update empties the ring,
    recounts its entry under the learner and runs the rest of the epoch
    on the sync schedule; every batch still gets one update. A rejoin
    without a split plan changes nothing."""
    events = []
    a, state = _port(setup, _rl(),
                     on_event=lambda e, **kw: events.append((e, kw)))

    def on_step(m):
        if len(events) == 0 and a._learner_version == 1:
            trl.request_actor_rejoin()
            trl.request_actor_preempt()

    state, m = a.train_epoch(state, _torch_batches(setup), _seeds(),
                             on_step=on_step)
    assert len(m) == state.step == N_BATCHES
    assert a._fallback_sync and a.last_rejoined == 0
    assert ("rl_actor_fallback_sync", {"recount": 1}) in events
    assert all(np.isfinite(x["rl_loss"]) for x in m)
    assert not async_scst._PREEMPT_REQUESTS
    assert not async_scst._REJOIN_REQUESTS


def test_several_devices_are_refused(setup):
    with pytest.raises(ValueError, match="actor/learner slice"):
        _port(setup, _rl(), devices=[torch.device("cuda", 0),
                                     torch.device("cuda", 1)])
    a, state = _port(setup, _rl(), devices=[torch.device("cpu")])
    state, m = a.train_epoch(state, _torch_batches(setup, 2), _seeds())
    assert len(m) == 2
