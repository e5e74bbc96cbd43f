"""The actor/learner split across ranks (``rl/async_scst.py`` on a mesh of
gloo ranks, ``tests/test_torch_dp_child.py``), float32 on the CPU, on
``tests/test_async_scst.py``'s model (V=14, B=8, T=5, meanpool, K=2,
greedy baseline, its rigged token reward, Adam at lr 5e-2):

- 2 ranks (1 actor + 1 learner) and 4 ranks (2 + 2), depth/bound 2/1 and
  3/1: the staleness ledger, drops and events equal the JAX
  ``AsyncSCSTTrainer`` on a mesh of as many of the conftest's virtual
  devices; the token rows every learner scores equal the port's
  one-process run (a mesh of virtual ranks: the same plan, every role in
  one process); the parameters bitwise equal with one learner and within
  the JAX RL tolerance (``tests/test_rl.py:159``) with two; every rank
  leaves the epoch with the learner's state;
- ``actor_preempt`` sheds an actor (4 ranks) or falls back to sync (2
  ranks), preempt then rejoin regrows the initial fleet, deterministic
  across two runs, and a request made on one rank alone lands on every
  rank; a drain gathers the learners' ring into the global batch's;
- the same through the port's ``Trainer`` (``tests/test_chaos_train.py``'s
  decoupled cases at ``:661``, ``:712``, ``:744`` and ``:783``): survivors,
  the regrown fleet, the sync fallback, and a SIGTERM drain of a split
  epoch resumed bitwise equal to the straight split run."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006
from jax.sharding import Mesh

from cst_captioning_tpu.config.config import ModelConfig as JaxModelConfig
from cst_captioning_tpu.config.config import RLConfig as JaxRLConfig
from cst_captioning_tpu.config.config import TrainConfig as JaxTrainConfig
from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.resilience.chaos import Fault as JaxFault
from cst_captioning_tpu.resilience.chaos import FaultPlan as JaxFaultPlan
from cst_captioning_tpu.rl import AsyncSCSTTrainer as JaxAsync
from cst_captioning_tpu.train import (
    create_train_state as jax_state,
    make_optimizer as jax_opt,
    replicate as jax_replicate,
    shard_batch as jax_shard,
)
from cst_captioning_tpu_torch.data import make_synthetic_dataset
from cst_captioning_tpu_torch.train.mesh import DataMesh
from test_torch_dp_child import TokenReward, launch_ok, split_run

torch.set_num_threads(1)

V, B, F, T, K = 14, 8, 3, 5, 2
MODEL = dict(vocab_size=V, modalities=(("resnet", 6),), d_embed=12,
             d_hidden=12, d_att=6, encoder="meanpool", dropout=0.0,
             max_len=T, max_frames=F, dtype="float32")
TRAIN = dict(lr=5e-2, grad_clip=5.0)
RL = dict(enabled=True, num_rollouts=K, baseline="greedy")
RL_TOL = dict(rtol=1e-2, atol=2e-3)       # tests/test_rl.py:159
D2B1 = dict(rollout_depth=2, staleness_bound=1)
D3B1 = dict(rollout_depth=3, staleness_bound=1)
CASES = {
    2: [dict(name="d2b1", rl=D2B1), dict(name="d3b1", rl=D3B1),
        dict(name="pre", rl=D2B1, faults=[("actor_preempt", 1, 0)]),
        dict(name="one_rank", rl=D2B1, faults=[("actor_preempt", 2, 0)],
             ranks=(1,)),
        dict(name="drain", rl=D3B1, stop_after=4),
        dict(name="strict", rl=dict(rollout_depth=1, staleness_bound=0))],
    4: [dict(name="d2b1", rl=D2B1), dict(name="d3b1", rl=D3B1),
        dict(name="pre", rl=D2B1, faults=[("actor_preempt", 2, 0)]),
        dict(name="prerej", rl=D2B1,
             faults=[("actor_preempt", 1, 0), ("host_rejoin", 3, 0)]),
        dict(name="prerej_again", rl=D2B1,
             faults=[("actor_preempt", 1, 0), ("host_rejoin", 3, 0)]),
        dict(name="drain", rl=D3B1, stop_after=4)],
}
# the cases held to the JAX trainer on a mesh of the same size: the drop
# ledger, the sync fallback, and the shrink and regrow (each JAX run
# compiles its own programs, about 10 s)
JAX_CASES = [(2, "d3b1"), (2, "pre"), (4, "prerej")]


@pytest.fixture(scope="module")
def direct(tmp_path_factory):
    """Every case on 2 and 4 gloo ranks, its one-process reference on as
    many virtual ranks, and the JAX runs."""
    tmp = tmp_path_factory.mktemp("rl_split")
    rng = np.random.default_rng(0)
    feats = {"resnet": rng.normal(size=(B, F, 6)).astype(np.float32)}
    masks = {"resnet": np.ones((B, F), np.float32)}
    labels = rng.integers(4, V, size=(B, T)).astype(np.int32)
    jmodel = JaxCaptionModel(JaxModelConfig(**MODEL))
    jst = jax_state(jmodel, jax_opt(JaxTrainConfig(**TRAIN), 10),
                    (jax.tree.map(jnp.asarray, feats),
                     jax.tree.map(jnp.asarray, masks), jnp.asarray(labels)),
                    seed=1)
    vids = [f"v{i}" for i in range(B)]
    args = dict(model=MODEL, params=jax.tree.map(np.asarray, jst.params),
                B=B, train=TRAIN, rl=RL, batches=[(feats, masks, vids)] * 6)
    runs, refs = {}, {}
    for world, cases in CASES.items():
        res = launch_ok("split", dict(args, cases=cases), tmp, world=world,
                        timeout=150)
        vmesh = DataMesh("data", 0, world, torch.device("cpu"))
        for c in cases:
            runs[world, c["name"]] = [r[c["name"]] for r in res]
            if "ranks" not in c:
                refs[world, c["name"]] = split_run(args, c, vmesh)
    jruns = {}
    cases = {(w, c["name"]): c for w, cs in CASES.items() for c in cs}
    for world, name in JAX_CASES:
        c = cases[world, name]
        mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))
        events = []
        a = JaxAsync(jmodel, TokenReward(), JaxRLConfig(**RL, **c["rl"]),
                     mesh=mesh, batch_size=B,
                     on_event=lambda e, **kw: events.append([e, kw]))
        f_s, m_s = jax_shard(mesh, (jax.tree.map(jnp.asarray, feats),
                                    jax.tree.map(jnp.asarray, masks)))
        plan = JaxFaultPlan([JaxFault("rl.actor.step", k, at=at, host=h)
                             for k, at, h in c.get("faults", ())])
        with plan.activate():
            a.train_epoch(jax_replicate(mesh, jst), iter(
                [(f_s, m_s, vids, None)] * 6), jax.random.key(9))
        jruns[world, name] = dict(staleness=dict(a.last_staleness),
                                  dropped=a.last_dropped, events=events,
                                  n_actors=a._plan.n_actors,
                                  fallback=a._fallback_sync)
    return dict(runs=runs, refs=refs, jax=jruns)


def _learners(runs):
    """The ranks that scored rows (the learners), in rank order."""
    return [r for r in runs if r["calls"]]


def _assembled_calls(runs):
    """Each scored batch of rows, assembled over the learners into the
    global batch's (samples rollout-major [K*B, T], then greedy [B, T])."""
    parts = [r["calls"] for r in _learners(runs)]
    out = []
    for i, group in enumerate(zip(*parts)):
        if i % 2 == 0:
            out.append(np.concatenate(
                [g.reshape(K, -1, T) for g in group], axis=1).reshape(-1, T))
        else:
            out.append(np.concatenate(group))
    return out


@pytest.mark.parametrize("world,name", JAX_CASES,
                         ids=[f"{w}ranks-{n}" for w, n in JAX_CASES])
def test_ledger_and_events_match_jax(direct, world, name):
    want = direct["jax"][world, name]
    for r in direct["runs"][world, name] + [direct["refs"][world, name]]:
        assert r["staleness"] == want["staleness"]
        assert r["dropped"] == want["dropped"]
        assert r["events"] == want["events"]
        assert (r["n_actors"], r["fallback"]) == (want["n_actors"],
                                                   want["fallback"])
    if name == "d3b1":
        assert want["dropped"] > 0            # the bound fired: recounts


_ALL = [(w, c["name"]) for w, cs in CASES.items() for c in cs
        if "ranks" not in c and c["name"] != "strict"]


@pytest.mark.parametrize("world,name", _ALL,
                         ids=[f"{w}ranks-{n}" for w, n in _ALL])
def test_tokens_equal_the_one_process_run(direct, world, name):
    runs, ref = direct["runs"][world, name], direct["refs"][world, name]
    assert len(_learners(runs)) == (1 if world == 2 else 2)
    got = _assembled_calls(runs)
    assert len(got) == len(ref["calls"]) > 0
    for a, b in zip(got, ref["calls"]):
        np.testing.assert_array_equal(a, b)
    for r in runs:
        assert (r["staleness"], r["dropped"], r["events"], r["stopped"]) \
            == (ref["staleness"], ref["dropped"], ref["events"],
                ref["stopped"])


@pytest.mark.parametrize("name", [c["name"] for c in CASES[2]
                                  if "ranks" not in c
                                  and c["name"] != "strict"])
def test_one_learner_is_bitwise_the_one_process_run(direct, name):
    ref = direct["refs"][2, name]
    for r in direct["runs"][2, name]:
        assert r["losses"] == ref["losses"]
        assert r["rewards"] == ref["rewards"]
        assert r["step"] == ref["step"]
        for a, b in zip(r["params"], ref["params"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", [c["name"] for c in CASES[4]])
def test_two_learners_within_the_rl_tolerance(direct, name):
    ref = direct["refs"][4, name]
    for r in direct["runs"][4, name]:
        np.testing.assert_allclose(r["losses"], ref["losses"], **RL_TOL)
        np.testing.assert_allclose(r["rewards"], ref["rewards"], rtol=1e-6)
        for a, b in zip(r["params"], ref["params"]):
            np.testing.assert_allclose(a, b, **RL_TOL)


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_leaves_with_the_learner_state(direct, world):
    for c in CASES[world]:
        runs = direct["runs"][world, c["name"]]
        for r in runs[1:]:
            assert r["step"] == runs[0]["step"]
            assert r["occupancy"] == runs[0]["occupancy"]
            for a, b in zip(r["params"], runs[0]["params"]):
                np.testing.assert_array_equal(a, b)
        occ = runs[0]["occupancy"]
        assert 0.0 < occ["actor"] <= 1.0 and 0.0 < occ["learner"] <= 1.0


def test_strict_across_ranks_is_the_shared_data_parallel_plan(direct):
    """Depth 1 with bound 0 is strict: both roles on every rank (the
    shared plan), each rank its own rows and the data-parallel update, so
    the tokens are the one-process run's and the params within the RL
    tolerance of it."""
    runs, ref = direct["runs"][2, "strict"], direct["refs"][2, "strict"]
    assert len(_learners(runs)) == 2 and all(
        r["n_actors"] == 2 for r in runs)
    for a, b in zip(_assembled_calls(runs), ref["calls"]):
        np.testing.assert_array_equal(a, b)
    for r in runs:
        assert r["staleness"] == ref["staleness"] == {0: 6}
        np.testing.assert_allclose(r["losses"], ref["losses"], **RL_TOL)
        for a, b in zip(r["params"], ref["params"]):
            np.testing.assert_allclose(a, b, **RL_TOL)
        for a, b in zip(r["params"], runs[0]["params"]):
            np.testing.assert_array_equal(a, b)


def test_actor_preempt_sheds_or_falls_back(direct):
    (deg,) = direct["runs"][4, "pre"][0]["events"]
    assert deg == ["rl_actor_degraded", {"survivors": 1, "recount": 1}]
    assert direct["runs"][4, "pre"][0]["n_actors"] == 1
    two = direct["runs"][2, "pre"][0]
    assert two["events"] == [["rl_actor_fallback_sync", {"recount": 1}]]
    assert two["fallback"] and len(two["losses"]) == 6


def test_preempt_then_rejoin_regrows_and_is_deterministic(direct):
    a, b = direct["runs"][4, "prerej"], direct["runs"][4, "prerej_again"]
    assert [e for e, _ in a[0]["events"]] == ["rl_actor_degraded",
                                              "rl_actor_regrown"]
    assert a[0]["events"][1][1]["actors"] == 2 and a[0]["rejoined"] == 1
    assert a[0]["n_actors"] == 2 and not a[0]["fallback"]
    for x, y in zip(a, b):
        assert (x["staleness"], x["losses"], x["events"]) == \
            (y["staleness"], y["losses"], y["events"])
        for p, q in zip(x["params"], y["params"]):
            np.testing.assert_array_equal(p, q)
    for p, q in zip(_assembled_calls(a), _assembled_calls(b)):
        np.testing.assert_array_equal(p, q)


def test_a_request_on_one_rank_lands_on_every_rank(direct):
    runs = direct["runs"][2, "one_rank"]
    assert runs[0]["fired"] == [] and runs[1]["fired"] == ["actor_preempt"]
    for r in runs:
        assert r["events"] == [["rl_actor_fallback_sync", {"recount": 1}]]
        assert r["fallback"] and len(r["losses"]) == 6


@pytest.mark.parametrize("world", [2, 4])
def test_a_drain_gathers_the_learners_ring(direct, world):
    runs, ref = direct["runs"][world, "drain"], direct["refs"][world, "drain"]
    assert ref["stopped"] and len(ref["ring"]) == 2
    for r in runs:
        assert r["stopped"] and len(r["ring"]) == len(ref["ring"])
        for e, w in zip(r["ring"], ref["ring"]):
            for k in ("samples", "greedy", "valid"):
                np.testing.assert_array_equal(e[k], w[k])
            np.testing.assert_allclose(e["lps"], w["lps"], rtol=1e-6,
                                       atol=1e-6)
            assert (e["video_ids"], e["seed"], e["batch_index"]) == \
                (w["video_ids"], w["seed"], w["batch_index"])


# ---- through the Trainer ----------------------------------------------------

MODAL = (("resnet", 10), ("c3d", 6))
TF = 4
PREEMPT = ("rl.actor.step", "actor_preempt", 1)
TRAINER_CASES = {
    2: [dict(name="straight"), dict(name="zero_actors", faults=[PREEMPT]),
        dict(name="drain", faults=[("rl.step", "preempt", 2)]),
        dict(name="resumed", resume="drain")],
    4: [dict(name="straight"), dict(name="survivors", faults=[PREEMPT]),
        dict(name="regrow", faults=[PREEMPT,
                                    ("rl.actor.step", "host_rejoin", 3)]),
        dict(name="regrow_again", faults=[
            PREEMPT, ("rl.actor.step", "host_rejoin", 3)]),
        dict(name="drain", faults=[("rl.step", "preempt", 2)]),
        dict(name="resumed", resume="drain")],
}


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    root = tmp_path_factory.mktemp("rl_split_trainer")
    tp = make_synthetic_dataset(
        str(root / "data"), num_videos=24, num_topics=3, vocab_words=20,
        modalities=dict(MODAL), max_frames=TF, seed=11,
        caption_style="template", splits=(0.75, 0.125))
    nv = len(json.load(open(tp["info_json"]))["vocab"])
    ov = {f"model__{k}": v for k, v in dict(
        d_embed=12, d_hidden=12, d_att=6, encoder="temporal_attention",
        dropout=0.0, max_frames=TF, dtype="float32").items()}
    ov.update(model__vocab_size=nv, model__modalities=MODAL,
              model__max_len=8, data__batch_size=4, rl__num_rollouts=3,
              rl__epochs=1, rl__lr=5e-2, train__seed=3,
              train__log_every_steps=1, train__rl_topology="decoupled")
    out = {}
    for world, cases in TRAINER_CASES.items():
        tmp = root / f"w{world}"
        tmp.mkdir()
        res = launch_ok("split_trainer", dict(
            preset="msrvtt_cst_consensus", overrides=ov,
            info_json=tp["info_json"], features={n: tp[n] for n, _ in MODAL},
            max_frames=TF, tmp=str(tmp), cases=cases), tmp, world=world,
            timeout=200)
        for c in cases:
            out[world, c["name"]] = [r[c["name"]] for r in res]
    return out


def _of(run, *names):
    return [e for e in run["events"] if e["event"] in names]


def _actor_events(run):
    return [(e["event"], {k: e[k] for k in ("survivors", "actors", "recount")
                          if k in e})
            for e in _of(run, "rl_actor_degraded", "rl_actor_regrown",
                         "rl_actor_fallback_sync")]


def _ranks_agree(runs):
    for r in runs[1:]:
        assert r["step"] == runs[0]["step"]
        assert _actor_events(r) == _actor_events(runs[0])
        assert [e["rl_loss"] for e in _of(r, "rl_step")] == \
            [e["rl_loss"] for e in _of(runs[0], "rl_step")]
        for a, b in zip(r["params"], runs[0]["params"]):
            np.testing.assert_array_equal(a, b)


def test_trainer_actor_preempt_degrades_to_survivors(trainer):
    runs = trainer[4, "survivors"]
    _ranks_agree(runs)
    # the plan the trainer logs: the first two ranks decode
    for r in runs:
        (plan,) = _of(r, "rl_split")
        assert (plan["actors"], plan["learners"], plan["shared"]) == \
            ([0, 1], [2, 3], False)
    assert _actor_events(runs[0]) == [("rl_actor_degraded",
                                       {"survivors": 1, "recount": 1})]
    assert all(r["fired"] == ["actor_preempt"] for r in runs)
    rewards = [e["reward"] for e in _of(runs[0], "rl_step")]
    assert rewards and np.isfinite(rewards).all()
    assert runs[0]["rl_epochs"] == 1
    assert all(np.isfinite(p).all() for p in runs[0]["params"])


def test_trainer_actor_rejoin_regrows_the_fleet(trainer):
    runs, again = trainer[4, "regrow"], trainer[4, "regrow_again"]
    _ranks_agree(runs)
    assert _actor_events(runs[0]) == [
        ("rl_actor_degraded", {"survivors": 1, "recount": 1}),
        ("rl_actor_regrown", {"actors": 2, "recount": 1})]
    assert runs[0]["fired"] == ["actor_preempt", "host_rejoin"]
    # deterministic: a second seeded run ends bitwise equal
    for a, b in zip(runs[0]["params"], again[0]["params"]):
        np.testing.assert_array_equal(a, b)


def test_trainer_zero_actors_fall_back_to_sync(trainer):
    runs = trainer[2, "zero_actors"]
    _ranks_agree(runs)
    assert _actor_events(runs[0]) == [("rl_actor_fallback_sync",
                                       {"recount": 1})]
    straight = trainer[2, "straight"][0]
    # every batch still got its step
    assert runs[0]["step"] == straight["step"] == len(
        _of(runs[0], "rl_step")) > 1


@pytest.mark.parametrize("world", [2, 4])
def test_trainer_drain_and_resume_is_bitwise(trainer, world):
    drained, resumed = trainer[world, "drain"], trainer[world, "resumed"]
    straight = trainer[world, "straight"]
    _ranks_agree(straight)
    _ranks_agree(resumed)
    assert all(r["preempted"] for r in drained)
    (save,) = _of(drained[0], "ckpt_step")
    assert save["phase"] == "rl" and save["seam"] is True
    assert 0 < save["batch_index"] < straight[0]["step"]
    assert _of(resumed[0], "seam_loaded")
    assert resumed[0]["step"] == straight[0]["step"]
    for a, b in zip(resumed[0]["params"], straight[0]["params"]):
        np.testing.assert_array_equal(a, b)
