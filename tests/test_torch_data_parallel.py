"""The port's data parallelism at two gloo ranks (``test_torch_dp_child``)
against the JAX package on a 2-device mesh of the conftest's virtual CPU
devices, float32, dropout 0, weights carried across by ``convert.py``:

- steps: ``make_parallel_xe_step`` and ``make_parallel_rl_update`` against
  JAX's on ``make_mesh(2)`` at ``tests/test_train.py:66`` and
  ``tests/test_rl.py:135``'s tolerances; the default f32 buckets bitwise
  equal to one all-reduce a leaf; bf16 on the wire within the JAX
  tolerance; overlap ``defer`` bitwise equal to ``eager`` and within the
  RL tolerance of unoverlapped (the JAX overlap tests are red, so the port
  holds its own spellings to each other);
- decodes: greedy sharded equals the one-device greedy decode
  (``tests/test_rl.py:325``, the JAX tokens), and the sampled rollouts of
  the two ranks equal the one-rank rollouts token for token;
- the sharded evaluator: captions and metrics equal the JAX evaluator's
  on a 2-device mesh, the indivisible batch wrap-padded
  (``tests/test_ckpt_eval.py:125``, ``:139``); rank 0 alone writes;
- the trainer: a 2-rank XE epoch and validation against the JAX Trainer
  with ``use_mesh=True, num_devices=2`` (losses and parameters at the XE
  tolerance, captions exact); a CST epoch's rollouts equal the port's
  one-rank run's from the same weights, parameters at the RL tolerance;
  a mid-epoch step checkpoint resumed on two ranks bitwise equal to the
  straight run; and ``cli.train`` under ``RANK`` / ``WORLD_SIZE`` with
  ``mesh.num_devices=2``: rank 0 alone writes checkpoints, ``proc1/``
  holds rank 1's obs stream."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from cst_captioning_tpu.config.config import EvalConfig as JaxEvalConfig
from cst_captioning_tpu.config.config import ModelConfig as JaxModelConfig
from cst_captioning_tpu.config.config import TrainConfig as JaxTrainConfig
from cst_captioning_tpu.config.presets import get_preset as jax_preset
from cst_captioning_tpu.data.dataset import CaptionDataset as JaxDataset
from cst_captioning_tpu.data.synthetic import (
    make_synthetic_dataset as jax_synthetic,
)
from cst_captioning_tpu.eval.evaluator import Evaluator as JaxEvaluator
from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.rl import make_parallel_rl_update as jax_rl_update
from cst_captioning_tpu.rl import make_rl_decode as jax_rl_decode
from cst_captioning_tpu.train import (
    create_train_state as jax_state,
    make_mesh as jax_mesh,
    make_optimizer as jax_opt,
    make_parallel_xe_step as jax_xe_step,
    replicate as jax_replicate,
    shard_batch as jax_shard,
)
from cst_captioning_tpu.train.trainer import Trainer as JaxTrainer
from cst_captioning_tpu_torch.config import ModelConfig
from cst_captioning_tpu_torch.convert import (
    load_flax_params,
    state_dict_to_flax,
)
from cst_captioning_tpu_torch.data import (
    CaptionDataset,
    make_synthetic_dataset,
)
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.presets import get_experiment
from cst_captioning_tpu_torch.rl import make_rl_decode
from cst_captioning_tpu_torch.train.trainer import Trainer
from test_torch_dp_child import launch_ok

torch.set_num_threads(1)

XE_TOL = dict(rtol=1e-3, atol=1e-5)      # tests/test_train.py:88-89
RL_TOL = dict(rtol=1e-2, atol=2e-3)      # tests/test_rl.py:159
B, F, T, V, K = 8, 4, 6, 17, 4
MODEL = dict(vocab_size=V, modalities=(("resnet", 8),), d_embed=12,
             d_hidden=12, d_att=6, encoder="temporal_attention", dropout=0.0,
             max_len=T, max_frames=F, dtype="float32")
# the optimizers of tests/test_train.py (XE) and tests/test_rl.py (RL)
TRAIN_XE = dict(lr=1e-3, grad_clip=1.0)
TRAIN_RL = dict(lr=5e-2, grad_clip=5.0)


def _port_params(arrays):
    m = load_flax_params(CaptionModel(ModelConfig(**MODEL), device="cpu"),
                         jax.tree.map(np.asarray, arrays))
    return state_dict_to_flax(m.cfg, m.state_dict())


def _close(port_params, jax_params, tol, model=MODEL):
    """The port's parameter list (model order) against a JAX tree."""
    m = CaptionModel(ModelConfig(**model), device="cpu")
    with torch.no_grad():
        for p, v in zip(m.parameters(), port_params):
            p.copy_(torch.from_numpy(v))
    got = state_dict_to_flax(m.cfg, m.state_dict())
    want = jax.tree.map(np.asarray, jax.device_get(jax_params))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        np.testing.assert_allclose(b, a, err_msg=str(path), **tol)


def _bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# ---- steps, decodes and the evaluator: one launch ----------------------------


def _comms_setup():
    """tests/test_comms.py's model_setup and _rl_args (meanpool, B=8,
    F=3, T=5, K=4)."""
    kw = dict(vocab_size=V, modalities=(("resnet", 6),), d_embed=12,
              d_hidden=12, d_att=6, encoder="meanpool", dropout=0.0,
              max_len=5, max_frames=3, dtype="float32")
    rng = np.random.default_rng(0)
    feats = {"resnet": rng.normal(size=(8, 3, 6)).astype(np.float32)}
    masks = {"resnet": np.ones((8, 3), np.float32)}
    labels = rng.integers(4, V, size=(8, 5)).astype(np.int32)
    jm = JaxCaptionModel(JaxModelConfig(**kw))
    st = jax_state(jm, jax_opt(JaxTrainConfig(**TRAIN_RL), 10),
                   (jax.tree.map(jnp.asarray, feats),
                    jax.tree.map(jnp.asarray, masks), jnp.asarray(labels)),
                   seed=1)
    rng = np.random.default_rng(5)
    return dict(model=kw, params=jax.tree.map(np.asarray, st.params),
                feats=feats, masks=masks,
                samples=rng.integers(2, V, size=(4, 8, 5)).astype(np.int32),
                adv=rng.normal(size=(4, 8)).astype(np.float32),
                valid=np.ones((8,), np.float32))


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_steps")
    rng = np.random.default_rng(0)
    jm = JaxCaptionModel(JaxModelConfig(**MODEL))
    feats = {"resnet": rng.normal(size=(B, F, 8)).astype(np.float32)}
    masks = {"resnet": np.ones((B, F), np.float32)}
    masks["resnet"][::3, 2:] = 0.0
    labels = rng.integers(4, V, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    for i in range(B):
        mask[i, 2 + (i % 4):] = 0.0
    weights = rng.uniform(0.5, 1.5, size=(B,)).astype(np.float32)
    jfeats = jax.tree.map(jnp.asarray, feats)
    jmasks = jax.tree.map(jnp.asarray, masks)
    state, xe_state = (jax_state(jm, jax_opt(JaxTrainConfig(**kw), 10),
                                 (jfeats, jmasks, jnp.asarray(labels)),
                                 seed=1) for kw in (TRAIN_RL, TRAIN_XE))
    params = jax.tree.map(np.asarray, jax.device_get(state.params))
    samples = rng.integers(2, V, size=(K, B, T)).astype(np.int32)
    adv = rng.normal(size=(K, B)).astype(np.float32)
    valid = np.ones((B,), np.float32)
    valid[-1] = 0.0

    mesh = jax_mesh(2)
    xe_s, xe_m = jax_xe_step(jm, mesh)(
        jax_replicate(mesh, xe_state), *jax_shard(mesh, (
            jfeats, jmasks, jnp.asarray(labels), jnp.asarray(mask),
            jnp.asarray(weights))))
    kb = NamedSharding(mesh, P(None, "data"))
    rl_s, rl_m = jax_rl_update(jm, mesh)(
        jax_replicate(mesh, state), *jax_shard(mesh, (jfeats, jmasks)),
        jax.device_put(jnp.asarray(samples), kb),
        jax.device_put(jnp.asarray(adv), kb),
        jax_shard(mesh, jnp.asarray(valid)))
    greedy_jax, _ = jax_rl_decode(jm, K, max_len=T)(
        state.params, jfeats, jmasks, jax.random.key(11))
    rl_comms = _comms_setup()

    # the eval corpus, in each package's files
    corpus = dict(num_videos=20, modalities={"resnet": 16}, max_frames=F,
                  splits=(0.4, 0.1), seed=3)
    jp = jax_synthetic(str(tmp / "jax"), **corpus)
    tp = make_synthetic_dataset(str(tmp / "port"), **corpus)
    jds = JaxDataset(jp["info_json"], {"resnet": jp["resnet"]}, "test", F)
    ekw = dict(MODEL, vocab_size=len(jds.vocab), modalities=(("resnet", 16),),
               max_len=8)
    ejm = JaxCaptionModel(JaxModelConfig(**ekw))
    eparams = ejm.init(jax.random.key(2),
                       {"resnet": jnp.zeros((2, F, 16))},
                       {"resnet": jnp.ones((2, F))},
                       jnp.zeros((2, 8), jnp.int32))
    cases = [("greedy4", 1, 4), ("beam3", 3, 4), ("odd3", 1, 3)]
    jeval = {}
    for name, beam, bs in cases:
        ev = JaxEvaluator(ejm, jds, JaxEvalConfig(
            beam_size=beam, max_len=8, metrics=("CIDEr-D", "Bleu")),
            batch_size=bs, mesh=mesh)
        res = ev.evaluate(jax_replicate(mesh, eparams))
        jeval[name] = (res["captions"], res["metrics"], ev.batcher.batch_size)

    res = launch_ok("steps", {
        "model": MODEL, "params": params, "train_xe": TRAIN_XE,
        "train_rl": TRAIN_RL, "K": K,
        "xe": (feats, masks, labels.astype(np.int64), mask, weights),
        "rl": dict(feats=feats, masks=masks, samples=samples, adv=adv,
                   valid=valid),
        "dec": dict(feats=feats, masks=masks), "rl_comms": rl_comms,
        "eval": dict(info_json=tp["info_json"],
                     features={"resnet": tp["resnet"]}, max_frames=F,
                     model=ekw, params=jax.tree.map(np.asarray, eparams),
                     cases=cases, tmp=str(tmp))}, tmp, timeout=150)
    return dict(res=res, xe=(xe_s, xe_m), rl=(rl_s, rl_m), jeval=jeval,
                greedy_jax=np.asarray(greedy_jax), params=params,
                feats=feats, masks=masks, tmp=tmp)


def test_parallel_xe_step_matches_jax_mesh(steps):
    js, jm = steps["xe"]
    r0, r1 = steps["res"]
    np.testing.assert_allclose(r0["xe"][0], float(jm["loss"]), rtol=1e-5)
    _close(r0["xe"][1], js.params, XE_TOL)
    assert r0["xe"][0] == r1["xe"][0]
    _bitwise(r0["xe"][1], r1["xe"][1])


def test_parallel_rl_update_matches_jax_mesh(steps):
    js, jm = steps["rl"]
    r0, r1 = steps["res"]
    for name in ("none", "f32"):
        np.testing.assert_allclose(r0[f"rl_{name}"][0], float(jm["rl_loss"]),
                                   rtol=1e-5)
        _close(r0[f"rl_{name}"][1], js.params, RL_TOL)
        _bitwise(r0[f"rl_{name}"][1], r1[f"rl_{name}"][1])
    # the default f32 buckets equal one all-reduce a leaf, bit for bit
    assert r0["rl_none"][0] == r0["rl_f32"][0]
    _bitwise(r0["rl_none"][1], r0["rl_f32"][1])


def _bf16_wire_update(c):
    """The bf16-on-the-wire RL update by its definition, in this process:
    each rank's gradient of its REINFORCE numerator, rounded to bfloat16,
    summed and rounded again (a two-rank all-reduce in bfloat16), divided
    by the global token count, then the optimizer step."""
    from cst_captioning_tpu_torch.config import TrainConfig
    from cst_captioning_tpu_torch.rl.scst import _decode_loss_sums, _tile_enc
    from cst_captioning_tpu_torch.train import (
        create_train_state, make_optimizer)

    model = load_flax_params(CaptionModel(ModelConfig(**c["model"]),
                                          device="cpu"), c["params"])
    state = create_train_state(model, make_optimizer(
        TrainConfig(**TRAIN_RL), 10), seed=1)
    Kc, Bc, Tc = c["samples"].shape
    h = Bc // 2
    grads, num, den = [], 0.0, 0.0
    for r in range(2):
        rows = slice(r * h, (r + 1) * h)
        t = lambda x: torch.from_numpy(np.ascontiguousarray(x))  # noqa
        enc = model.encode({k: t(v[rows]) for k, v in c["feats"].items()},
                           {k: t(v[rows]) for k, v in c["masks"].items()})
        n, d = _decode_loss_sums(
            model, _tile_enc(enc, Kc),
            t(c["samples"][:, rows]).long().reshape(Kc * h, Tc),
            t(c["adv"][:, rows]).reshape(-1), t(c["valid"][rows]).repeat(Kc))
        grads.append(torch.autograd.grad(n, state.params))
        num, den = num + n.detach(), den + d
    wire = [(a.bfloat16() + b.bfloat16()).float()
            for a, b in zip(*grads)]
    den = torch.clamp(den, min=1.0)
    state.apply_gradients([g / den for g in wire])
    return float(num / den), [p.detach().numpy() for p in state.params]


def test_bf16_rl_update_is_its_wire_definition(steps):
    """bf16 on the wire is exactly its definition (:func:`_bf16_wire_update`)
    on tests/test_comms.py's model and inputs, and its loss, which is not on
    the wire, equals the f32 update's within 1e-6. (tests/test_comms.py
    holds the bf16 update within 5e-3 of f32 at lr 5e-2; at two ranks an
    element whose addends cancel within one bf16 rounding sums to 0 on the
    wire, and Adam's first step then moves it 0 instead of lr: that bound
    is checked on the card at the RL rate, chip_smoke's data_parallel arm
    (c).)"""
    want_loss, want = _bf16_wire_update(_comms_setup())
    for r in steps["res"]:
        np.testing.assert_allclose(r["comms_bf16"][0], r["comms_f32"][0],
                                   rtol=1e-6)
        np.testing.assert_allclose(r["comms_bf16"][0], want_loss, rtol=1e-6)
        for a, b in zip(r["comms_bf16"][1], want):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r["rl_bf16"][0], r["rl_f32"][0],
                                   rtol=1e-6)
    _bitwise(steps["res"][0]["comms_bf16"][1],
             steps["res"][1]["comms_bf16"][1])


def test_overlap_defer_bitwise_eager_and_close_to_unoverlapped(steps):
    for r in steps["res"]:
        assert r["rl_c2_defer"][0] == r["rl_c2_eager"][0]
        _bitwise(r["rl_c2_defer"][1], r["rl_c2_eager"][1])
        np.testing.assert_allclose(r["rl_c2_defer"][0], r["rl_c2_off"][0],
                                   rtol=1e-6)
        for a, b in zip(r["rl_c2_defer"][1], r["rl_c2_off"][1]):
            np.testing.assert_allclose(a, b, **RL_TOL)
    _close(steps["res"][0]["rl_c2_defer"][1], steps["rl"][0].params, RL_TOL)


@pytest.mark.parametrize("name", ["fused", "two_loop", "sample"])
def test_sharded_rollouts_equal_one_rank(steps, name):
    model = load_flax_params(CaptionModel(ModelConfig(**MODEL), device="cpu"),
                             steps["params"])
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa
    wg, fused = {"fused": (True, True), "two_loop": (True, False),
                 "sample": (False, True)}[name]
    g1, s1 = make_rl_decode(model, K, with_greedy=wg, fused=fused)(
        model, t(steps["feats"]), t(steps["masks"]), 7)
    (g_a, s_a), (g_b, s_b) = (r[f"dec_{name}"] for r in steps["res"])
    np.testing.assert_array_equal(np.concatenate([s_a, s_b], axis=1),
                                  s1.numpy())
    if wg:
        greedy = np.concatenate([g_a, g_b])
        np.testing.assert_array_equal(greedy, g1.numpy())
        # tests/test_rl.py:325: sharded greedy == the one-device JAX decode
        np.testing.assert_array_equal(greedy, steps["greedy_jax"])
    else:
        assert g_a is None and g_b is None


@pytest.mark.parametrize("name", ["greedy4", "beam3", "odd3"])
def test_sharded_evaluator_matches_jax_mesh(steps, name):
    caps, metrics, padded = steps["jeval"][name]
    for rank, r in enumerate(steps["res"]):
        got_caps, got_metrics, bs, local = r[f"eval_{name}"]
        assert got_caps == caps
        assert got_metrics == metrics
        assert bs == padded == 4 and local == 2
    # one writer: rank 0's results json, none from rank 1
    assert os.path.exists(steps["tmp"] / f"{name}.rank0.json")
    assert not os.path.exists(steps["tmp"] / f"{name}.rank1.json")


# ---- the trainer ---------------------------------------------------------------

MODAL = (("resnet", 10), ("c3d", 6))
CORPUS = dict(num_videos=24, num_topics=3, vocab_words=20,
              modalities=dict(MODAL), max_frames=F, seed=11,
              caption_style="template", splits=(0.75, 0.125))


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_trainer")
    jp = jax_synthetic(str(root / "jax"), **CORPUS)
    tp = make_synthetic_dataset(str(root / "port"), **CORPUS)
    nv = len(json.load(open(jp["info_json"]))["vocab"])
    ov = {f"model__{k}": v for k, v in MODEL.items()
          if k not in ("vocab_size", "modalities")}
    ov.update(model__vocab_size=nv, model__modalities=MODAL,
              model__max_len=8, data__batch_size=4, data__seq_per_vid=2,
              train__epochs=1, train__log_every_steps=1, rl__num_rollouts=3,
              rl__epochs=1, mesh__num_devices=2, train__seed=3)
    # the JAX trainer on a 2-device mesh
    files = {n: jp[n] for n, _ in MODAL}
    jds = {s: JaxDataset(jp["info_json"], files, s, F)
           for s in ("train", "val")}
    jcfg = jax_preset("msrvtt_cst_consensus").override(
        train__ckpt_dir=str(root / "jax_ck"), **ov)
    jtr = JaxTrainer(jcfg, jds["train"], jds["val"],
                     log_path=str(root / "jax.jsonl"), use_mesh=True)
    assert jtr.mesh.shape["data"] == 2
    params0 = jax.tree.map(np.asarray, jax.device_get(jtr.state.params))
    jval = jtr.train_xe()
    jcaps = jtr.validator.evaluate(jtr.state.params)["captions"]
    args = dict(preset="msrvtt_cst_consensus", overrides=ov,
                info_json=tp["info_json"],
                features={n: tp[n] for n, _ in MODAL}, max_frames=F,
                params=params0, tmp=str(root / "straight"),
                ckpt_dir=str(root / "ck"), rl=True,
                extra=dict(train__ckpt_every_steps=2, train__keep_ckpts=10))
    os.makedirs(args["tmp"])
    straight = launch_ok("trainer", args, root, timeout=150)
    # resume from the mid-epoch step_2 save alone, on two ranks
    resume_dir = root / "ck_resume"
    os.makedirs(resume_dir)
    shutil.copytree(root / "ck" / "step_00000002", resume_dir /
                    "step_00000002")
    rargs = dict(args, ckpt_dir=str(resume_dir), tmp=str(root / "resumed"))
    os.makedirs(rargs["tmp"])
    resumed = launch_ok("resume", rargs, root, timeout=150)
    model = dict(MODEL, vocab_size=nv, modalities=MODAL, max_len=8)
    return dict(root=root, jtr=jtr, jval=jval, jcaps=jcaps, model=model,
                straight=straight, resumed=resumed, args=args, tp=tp)


def _events(path, name):
    return [e for e in map(json.loads, open(path)) if e["event"] == name]


def test_two_rank_xe_epoch_matches_jax_trainer(trainer_runs):
    r = trainer_runs
    s0, s1 = r["straight"]
    assert s0["mesh"] == (0, 2) and s1["mesh"] == (1, 2)
    assert s0["local_batch"] == s1["local_batch"] == 2
    jl = [e["loss"] for e in _events(r["root"] / "jax.jsonl", "xe_step")]
    log0 = os.path.join(r["args"]["tmp"], "log.jsonl")
    log1 = os.path.join(r["args"]["tmp"], "log.proc1.jsonl")
    tl = [e["loss"] for e in _events(log0, "xe_step")]
    assert len(tl) == len(jl) > 2
    np.testing.assert_allclose(tl, jl, **XE_TOL)
    # the loss is the global one: both ranks log the same
    assert [e["loss"] for e in _events(log1, "xe_step")] == tl
    _close(s0["xe_params"], r["jtr"].state.params, XE_TOL, r["model"])
    _bitwise(s0["xe_params"], s1["xe_params"])
    assert s0["captions"] == s1["captions"] == r["jcaps"]
    assert s0["val"] == s1["val"] == pytest.approx(r["jval"], rel=1e-6)
    assert _events(log0, "distributed")[0]["processes"] == 2


def test_two_rank_rl_epoch_matches_one_rank(trainer_runs, tmp_path):
    """The CST epoch of the two ranks against the port's one-rank run from
    the same post-XE weights: the rollouts of the global batches equal,
    token for token, the parameters within the RL tolerance."""
    r = trainer_runs
    s0, s1 = r["straight"]
    a = r["args"]
    m = CaptionModel(ModelConfig(**r["model"]), device="cpu")
    with torch.no_grad():
        for p, v in zip(m.parameters(), s0["xe_params"]):
            p.copy_(torch.from_numpy(v))
    ov = {k: v for k, v in a["overrides"].items() if k != "mesh__num_devices"}
    cfg = get_experiment(a["preset"]).override(
        train__ckpt_dir=str(tmp_path / "ck"), **ov)
    ds = {s: CaptionDataset(a["info_json"], a["features"], s, F)
          for s in ("train", "val")}
    from cst_captioning_tpu_torch.rl import scst as scst_mod

    rollouts = []
    orig = scst_mod.SCSTTrainer._score

    def recording(self, greedy, samples, *rest, **kw):
        rollouts.append(samples.detach().cpu().numpy().copy())
        return orig(self, greedy, samples, *rest, **kw)

    tr = Trainer(cfg, ds["train"], ds["val"], device="cpu",
                 params=state_dict_to_flax(m.cfg, m.state_dict()))
    assert tr.mesh is None
    tr.epoch = tr.xe_epochs = 1          # as after the XE epoch
    scst_mod.SCSTTrainer._score = recording
    try:
        tr.train_rl()
    finally:
        scst_mod.SCSTTrainer._score = orig
        tr.close()
    assert len(rollouts) == len(s0["rollouts"]) == len(s1["rollouts"]) > 1
    for one, a0, a1 in zip(rollouts, s0["rollouts"], s1["rollouts"]):
        np.testing.assert_array_equal(np.concatenate([a0, a1], axis=1), one)
    _bitwise(s0["rl_params"], s1["rl_params"])
    for got, p in zip(s0["rl_params"], tr.state.params):
        np.testing.assert_allclose(got, p.detach().numpy(), **RL_TOL)


def test_two_rank_mid_epoch_resume_is_bitwise(trainer_runs):
    r = trainer_runs
    resumed, straight = r["resumed"], r["straight"]
    for res in resumed:
        _bitwise(res["xe_params"], straight[0]["xe_params"])
    log = os.path.join(r["root"] / "resumed", "log.jsonl")
    [ev] = _events(log, "resume")
    assert ev["batch_index"] == 2 and ev["phase"] == "xe"


def test_rank_zero_alone_writes_checkpoints(trainer_runs):
    r = trainer_runs
    log0 = os.path.join(r["args"]["tmp"], "log.jsonl")
    log1 = os.path.join(r["args"]["tmp"], "log.proc1.jsonl")
    assert _events(log0, "ckpt_epoch") and not _events(log1, "ckpt_epoch")
    assert all("bytes" not in e for e in _events(log1, "ckpt_step"))
    assert [e["step"] for e in _events(log0, "ckpt_step")] == \
        [e["step"] for e in _events(log1, "ckpt_step")]
    steps = sorted(d for d in os.listdir(r["root"] / "ck")
                   if d.startswith("step_"))
    assert "step_00000002" in steps


def test_cli_train_two_ranks(trainer_runs, tmp_path):
    """cli.train with mesh.num_devices=2 under RANK / WORLD_SIZE and
    --dist-init: trains, validates and checkpoints; rank 0 alone writes
    checkpoints and the run's log; proc1/ holds rank 1's obs stream."""
    r = trainer_runs
    tp = r["tp"]
    ov = r["args"]["overrides"]
    argv = ["--preset", "msrvtt_xe_attention", "--info-json",
            tp["info_json"], "--device", "cpu",
            "--dist-init", f"file://{tmp_path / 'cli.init'}",
            "--log-jsonl", str(tmp_path / "cli.jsonl"),
            "--obs", str(tmp_path / "obs")]
    for n, _ in MODAL:
        argv += ["--feature", f"{n}={tp[n]}"]
    for k, v in {**ov, "train__ckpt_dir": str(tmp_path / "ck")}.items():
        argv += ["--set", f"{k}={v!r}"]
    res = launch_ok("cli", {"argv": argv}, tmp_path, timeout=150)
    assert [(x["rank"], x["world"]) for x in res] == [(0, 2), (1, 2)]
    assert res[0]["steps"] == res[1]["steps"] > 0
    assert os.path.exists(tmp_path / "ck" / "best" / "infos.json")
    assert os.path.exists(tmp_path / "ck" / "latest" / "infos.json")
    assert _events(tmp_path / "cli.jsonl", "validate")
    assert _events(tmp_path / "cli.proc1.jsonl", "validate")
    assert not _events(tmp_path / "cli.proc1.jsonl", "ckpt_epoch")
    assert os.path.exists(tmp_path / "obs" / "events.jsonl")
    proc1 = tmp_path / "obs" / "proc1" / "events.jsonl"
    spans = [json.loads(x) for x in open(proc1)]
    assert any(e.get("name") == "xe.step" for e in spans)
    assert any(e.get("name") == "dcn.collective" for e in spans)


def test_decoupled_topology_across_ranks_is_refused(monkeypatch, tmp_path):
    """The actor/learner split across ranks comes with its slice: a world
    of two (the rank helpers report it) with rl_topology='decoupled'
    raises before anything is built."""
    from cst_captioning_tpu_torch.train import multihost

    monkeypatch.setattr(multihost, "host_shard", lambda: (0, 2))
    cfg = get_experiment("msrvtt_cst_consensus").override(
        train__rl_topology="decoupled", train__ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="actor/learner slice"):
        Trainer(cfg, None, device="cpu")
