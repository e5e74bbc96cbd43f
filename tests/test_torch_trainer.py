"""The port's Trainer and CST epoch against the JAX package's, float32 on
the CPU at a small width (V=24, E=H=12, A=6, T=8, two modalities, 24
clips), the composite attention and decode on both sides:

- one XE epoch (``loss="xe"`` and ``"wxe"``) of the port's ``Trainer``
  against the JAX ``Trainer`` on the same corpus (each package's files,
  equal by ``test_torch_data.py``) from the same initial params, dropout
  0, at the presets' XE rate (1e-4; Adam divides by sqrt(v), so an
  element whose gradient is near 0 carries float summation-order
  differences at the scale of the rate): per-step losses and the final
  params within 1e-5 relative, the validation CIDEr-D equal, the
  checkpoint ``infos`` equal;
- exact resume on the CPU: two epochs equal one epoch and a resume, params
  bitwise, and the same from a mid-epoch ``ckpt_every_steps`` checkpoint,
  from a SIGTERM during an XE step, and from a SIGTERM during a pipelined
  RL epoch (the seam replayed);
- ``SCSTTrainer.train_epoch``, pipelined and sequential, against the JAX
  loop over 3 batches with the JAX draws fed in (1e-4);
- the ``should_stop`` drain (exactly ``len(metrics)`` steps) and the seam
  replay (bitwise);
- the XE -> RL handoff (a fresh optimizer, step 0, a constant ``rl.lr``);
- ``rl.reward_threads`` reaching ``RewardComputer``;
- every config value whose machinery is not ported raising (the
  observability and health knobs are ported: ``test_torch_obs.py``), and
  the health, decoupled and online RL knobs validated with the JAX
  messages;
- ``train.rl_topology="decoupled"`` through ``train_rl`` against the sync
  trainer (bitwise), and a SIGTERM during a decoupled RL epoch resumed
  from its persisted ring to the uninterrupted run;
- the divergence sentinel's policies, and a rollback that restores the
  last checkpoint and salts the data order."""

import dataclasses
import json
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.config.config import RLConfig as JaxRLConfig
from cst_captioning_tpu.config.config import TrainConfig as JaxTrainConfig
from cst_captioning_tpu.config.presets import get_preset as jax_preset
from cst_captioning_tpu.data.batcher import Batcher as JaxBatcher
from cst_captioning_tpu.data.dataset import CaptionDataset as JaxDataset
from cst_captioning_tpu.data.preprocess import compute_consensus_weights
from cst_captioning_tpu.models import CaptionModel
from cst_captioning_tpu.data.synthetic import (
    make_synthetic_dataset as jax_synthetic,
)
from cst_captioning_tpu.decoding.common import (
    gumbel_step_noise,
    rollout_step_keys,
)
from cst_captioning_tpu.rl.rewards import RewardComputer as JaxReward
from cst_captioning_tpu.rl.scst import SCSTTrainer as JaxSCST
from cst_captioning_tpu.train.schedule import make_optimizer as jax_opt
from cst_captioning_tpu.train.state import TrainState as JaxState
from cst_captioning_tpu.train.trainer import Trainer as JaxTrainer
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch import rl as trl
from cst_captioning_tpu_torch import train as ttrain
from cst_captioning_tpu_torch.convert import (
    load_flax_params,
    state_dict_to_flax,
)
from cst_captioning_tpu_torch.data import (
    CaptionDataset,
    Vocab,
    make_synthetic_dataset,
)
from cst_captioning_tpu_torch.models import CaptionModel as TorchCaptionModel
from cst_captioning_tpu_torch.presets import EXPERIMENTS, get_experiment
from cst_captioning_tpu_torch.presets import get_preset as port_preset
from cst_captioning_tpu_torch.resilience.preempt import Preempted
from cst_captioning_tpu_torch.train import trainer as trainer_mod
from cst_captioning_tpu_torch.train.mesh import make_mesh
from cst_captioning_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

TOL = 1e-5
RL_TOL = 1e-4
MODAL = (("resnet", 10), ("c3d", 6))
F, T, BATCH = 4, 8, 4
CORPUS = dict(num_videos=24, num_topics=3, vocab_words=20,
              modalities=dict(MODAL), max_frames=F, seed=11,
              caption_style="template", splits=(0.75, 0.125))
MODEL = dict(modalities=MODAL, d_embed=12, d_hidden=12, d_att=6,
             max_len=T, max_frames=F, dtype="float32", dropout=0.0)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_trainer")
    jp = jax_synthetic(str(root / "jax"), **CORPUS)
    tp = make_synthetic_dataset(str(root / "port"), **CORPUS)
    info = json.load(open(jp["info_json"]))
    tok = {v["id"]: [c.split() for c in v["captions"]]
           for v in info["videos"] if v["split"] == "train"}
    weights = str(root / "weights.npz")
    np.savez(weights, **compute_consensus_weights(tok))
    return dict(jax=jp, port=tp, weights=weights, V=len(info["vocab"]),
                root=root)


def _overrides(c, ckpt_dir, **extra):
    out = {f"model__{k}": v for k, v in MODEL.items()}
    out.update(model__vocab_size=c["V"], data__batch_size=BATCH,
               data__seq_per_vid=2, train__epochs=1,
               train__log_every_steps=1, train__ckpt_dir=str(ckpt_dir),
               data__consensus_weights=c["weights"], rl__num_rollouts=3,
               rl__epochs=1)
    out.update(extra)
    return out


def _port_cfg(c, ckpt_dir, preset="msrvtt_cst_consensus", **extra):
    return get_experiment(preset).override(**_overrides(c, ckpt_dir, **extra))


def _port_ds(c, split, cfg):
    return CaptionDataset(c["port"]["info_json"],
                          {n: c["port"][n] for n, _ in MODAL}, split, F,
                          consensus_weights=cfg.data.consensus_weights)


def _port_trainer(c, cfg, log, params=None):
    return Trainer(cfg, _port_ds(c, "train", cfg), _port_ds(c, "val", cfg),
                   log_path=str(log), device="cpu", params=params)


def _events(path, name):
    return [e for e in map(json.loads, open(path)) if e["event"] == name]


def _flax(trainer):
    return state_dict_to_flax(trainer.model.cfg, trainer.model.state_dict())


def _infos(ckpt_dir, name="latest"):
    infos = json.load(open(os.path.join(ckpt_dir, name, "infos.json")))
    return {k: infos[k] for k in ("epoch", "xe_epochs", "rl_epochs", "phase",
                                  "batch_index", "global_step", "data_salt",
                                  "best_value")}


def _close_trees(want, got, tol):
    w = jax.tree_util.tree_leaves_with_path(want)
    g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(w) == len(g)
    for path, leaf in w:
        np.testing.assert_allclose(g[path], np.asarray(leaf), rtol=tol,
                                   atol=tol, err_msg=str(path))


def _equal_params(a, b):
    for x, y in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(x, y)


# ---- one XE epoch against the JAX Trainer -----------------------------------


@pytest.mark.parametrize("loss", ["xe", "wxe"])
def test_xe_epoch_matches_jax_trainer(corpus, tmp_path, loss):
    ov = _overrides(corpus, tmp_path / "jax_ck", train__loss=loss)
    jcfg = jax_preset("msrvtt_xe_attention").override(**ov)
    files = {n: corpus["jax"][n] for n, _ in MODAL}
    jds = {s: JaxDataset(corpus["jax"]["info_json"], files, s, F,
                         consensus_weights=corpus["weights"])
           for s in ("train", "val")}
    jtr = JaxTrainer(jcfg, jds["train"], jds["val"],
                     log_path=str(tmp_path / "jax.jsonl"), use_mesh=False)
    params0 = jax.tree.map(np.asarray, jax.device_get(jtr.state.params))
    jval = jtr.train_xe()

    tcfg_ = _port_cfg(corpus, tmp_path / "port_ck",
                      preset="msrvtt_xe_attention", train__loss=loss)
    ttr = _port_trainer(corpus, tcfg_, tmp_path / "port.jsonl",
                        params=params0)
    tval = ttr.train_xe()

    jl = [e["loss"] for e in _events(tmp_path / "jax.jsonl", "xe_step")]
    tl = [e["loss"] for e in _events(tmp_path / "port.jsonl", "xe_step")]
    assert len(tl) == len(jl) == ttr.steps_per_epoch > 2
    np.testing.assert_allclose(tl, jl, rtol=TOL)
    _close_trees(jax.device_get(jtr.state.params), _flax(ttr), TOL)
    assert tval == jval and tval is not None
    assert _infos(tmp_path / "port_ck") == _infos(tmp_path / "jax_ck")
    assert _infos(tmp_path / "port_ck", "best") == \
        _infos(tmp_path / "jax_ck", "best")
    jxe = _events(tmp_path / "jax.jsonl", "xe_epoch")[0]
    txe = _events(tmp_path / "port.jsonl", "xe_epoch")[0]
    np.testing.assert_allclose(txe["loss"], jxe["loss"], rtol=TOL)
    assert txe["clips_per_s"] > 0 and txe["step_ms_median"] > 0
    assert _events(tmp_path / "port.jsonl", "new_best")


# ---- exact resume on the CPU ----------------------------------------------------


@pytest.fixture(scope="module")
def reference_run(corpus, tmp_path_factory):
    """Two XE epochs and one pipelined RL epoch, uninterrupted."""
    root = tmp_path_factory.mktemp("reference")
    cfg = _port_cfg(corpus, root / "ck", train__epochs=2)
    tr = _port_trainer(corpus, cfg, root / "log.jsonl")
    tr.train_xe()
    xe = tr.state.clone()
    xe_infos = _infos(root / "ck")
    tr.train_rl()
    return dict(trainer=tr, xe_state=xe, xe_infos=xe_infos,
                ckpt=root / "ck", log=root / "log.jsonl")


def _xe_losses(log):
    return [(e["step"], e["loss"]) for e in _events(log, "xe_step")]


def test_resume_at_epoch_end_is_bitwise(corpus, reference_run, tmp_path):
    ref = reference_run
    cfg = _port_cfg(corpus, tmp_path / "ck", train__epochs=1)
    _port_trainer(corpus, cfg, tmp_path / "log.jsonl").train_xe()
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, epochs=2, resume="auto"))
    tr = _port_trainer(corpus, cfg2, tmp_path / "log.jsonl")
    assert _events(tmp_path / "log.jsonl", "resume")
    tr.train_xe()
    _equal_params(tr.state, ref["xe_state"])
    assert _infos(tmp_path / "ck") == ref["xe_infos"]
    assert tr.state.opt_state["count"] == ref["xe_state"].opt_state["count"]
    for a, b in zip(tr.state.opt_state["nu"], ref["xe_state"].opt_state["nu"]):
        assert torch.equal(a, b)
    assert _xe_losses(tmp_path / "log.jsonl") == _xe_losses(ref["log"])


def test_resume_from_a_step_checkpoint_is_bitwise(corpus, reference_run,
                                                   tmp_path):
    ref = reference_run
    cfg = _port_cfg(corpus, tmp_path / "ck", train__epochs=2,
                    train__ckpt_every_steps=4, train__keep_ckpts=5)
    full = _port_trainer(corpus, cfg, tmp_path / "full.jsonl")
    full.train_xe()
    _equal_params(full.state, ref["xe_state"])   # saving changes nothing
    steps = full.steps_per_epoch
    mid = 4 * ((steps + 4) // 4)                 # a save inside epoch 2
    assert steps < mid < 2 * steps
    # keep only that mid-epoch save, then resume from it
    cut = tmp_path / "cut"
    os.makedirs(cut)
    shutil.copytree(tmp_path / "ck" / f"step_{mid:08d}",
                    cut / f"step_{mid:08d}")
    infos = json.load(open(cut / f"step_{mid:08d}" / "infos.json"))
    assert infos["phase"] == "xe" and infos["batch_index"] == mid - steps
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, resume="auto", ckpt_dir=str(cut)))
    tr = _port_trainer(corpus, cfg2, tmp_path / "resumed.jsonl")
    tr.train_xe()
    _equal_params(tr.state, ref["xe_state"])
    # best_value aside: the cut directory holds no epoch-1 best
    got = _infos(cut)
    assert got == ref["xe_infos"] | {"best_value": got["best_value"]}
    assert _xe_losses(tmp_path / "resumed.jsonl") == \
        _xe_losses(ref["log"])[mid:]


def test_sigterm_during_xe_then_resume_is_bitwise(corpus, reference_run,
                                                  tmp_path, monkeypatch):
    ref = reference_run
    cfg = _port_cfg(corpus, tmp_path / "ck", train__epochs=2)
    tr = _port_trainer(corpus, cfg, tmp_path / "log.jsonl")
    step = tr.xe_step
    calls = {"n": 0}

    def xe_step(*a):
        calls["n"] += 1
        if calls["n"] == tr.steps_per_epoch + 2:
            os.kill(os.getpid(), signal.SIGTERM)   # during the step
        return step(*a)

    tr.xe_step = xe_step
    with pytest.raises(Preempted, match="checkpoint saved"):
        tr.train_xe()
    saved = _events(tmp_path / "log.jsonl", "preempt")[0]
    assert saved["batch_index"] == 2 and saved["phase"] == "xe"
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, resume="auto"))
    again = _port_trainer(corpus, cfg2, tmp_path / "log2.jsonl")
    again.train_xe()
    _equal_params(again.state, ref["xe_state"])
    assert _infos(tmp_path / "ck") == ref["xe_infos"]


def test_sigterm_during_rl_then_resume_is_bitwise(corpus, reference_run,
                                                  tmp_path):
    """A pipelined RL epoch preempted at a batch boundary drains, saves
    its seam with the state, and the resumed run replays it."""
    ref = reference_run
    # the XE part of the reference, then RL preempted mid-epoch
    cfg = _port_cfg(corpus, tmp_path / "ck", train__epochs=2)
    tr = _port_trainer(corpus, cfg, tmp_path / "log.jsonl")
    tr.train_xe()
    real = trl.SCSTTrainer._apply
    calls = {"n": 0}

    def apply(self, *a):
        calls["n"] += 1
        if calls["n"] == 1:       # update(0), in the third iteration
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self, *a)

    trl.SCSTTrainer._apply = apply
    try:
        with pytest.raises(Preempted):
            tr.train_rl()
    finally:
        trl.SCSTTrainer._apply = real
    ev = _events(tmp_path / "log.jsonl", "ckpt_step")[-1]
    # the drain applied update(1) and score+update(2); batch 3 is the seam
    assert ev["phase"] == "rl" and ev["seam"] and ev["batch_index"] == 3
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, resume="auto"))
    again = _port_trainer(corpus, cfg2, tmp_path / "log2.jsonl")
    assert _events(tmp_path / "log2.jsonl", "seam_loaded")
    again.train_rl()
    _equal_params(again.state, ref["trainer"].state)
    assert _infos(tmp_path / "ck") == _infos(ref["ckpt"])
    want = [e["reward"] for e in _events(ref["log"], "rl_step")]
    got = [e["reward"] for e in _events(tmp_path / "log.jsonl", "rl_step")
           + _events(tmp_path / "log2.jsonl", "rl_step")]
    assert got == want


# ---- the CST epoch against the JAX loop ----------------------------------------


@pytest.fixture(scope="module")
def rl_setup(corpus):
    mc = jax_preset("msrvtt_xe_attention").model
    jcfg = dataclasses.replace(mc, vocab_size=corpus["V"], **MODEL)
    files = {n: corpus["jax"][n] for n, _ in MODAL}
    jds = JaxDataset(corpus["jax"]["info_json"], files, "train", F)
    batches = list(JaxBatcher(jds, batch_size=BATCH, max_len=T,
                              mode="video", seed=0).epoch(shuffle=True))[:3]
    jmodel = CaptionModel(jcfg)
    feats = {n: jnp.asarray(v) for n, v in batches[0].feats.items()}
    masks = {n: jnp.asarray(v) for n, v in batches[0].feat_masks.items()}
    params = jmodel.init(jax.random.key(3), feats, masks,
                         jnp.zeros((BATCH, T), jnp.int32))
    rl = dict(num_rollouts=3, baseline="scb", reward_cider_weight=1.0,
              reward_bleu4_weight=0.5)
    jtr = JaxSCST(jmodel, JaxReward(jds.vocab, jds.gts_pool()),
                  JaxRLConfig(**rl))
    return dict(jmodel=jmodel, params=params, batches=batches, jtr=jtr,
                jds=jds, rl=rl, vocab=jds.vocab.words)


def _port_scst(s):
    cfg = tcfg.ModelConfig(vocab_size=len(s["vocab"]), **MODEL,
                           encoder="temporal_attention")
    model = load_flax_params(TorchCaptionModel(cfg, device="cpu"),
                             jax.tree.map(np.asarray, s["params"]))
    tx = ttrain.make_optimizer(tcfg.TrainConfig(), 10, lr_override=1e-3)
    state = ttrain.create_train_state(model, tx)
    reward = trl.RewardComputer(Vocab(s["vocab"]), s["jds"].gts_pool())
    return trl.SCSTTrainer(model, reward, tcfg.RLConfig(**s["rl"])), state


def _torch_batches(batches):
    t = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}  # noqa: E731
    return [(t(b.feats), t(b.feat_masks), list(b.video_ids),
             [bool(v) for v in b.valid]) for b in batches]


def _jax_draws(n, K, B, V):
    rng = jax.random.key(31)
    fns = []
    for _ in range(n):
        rng, srng = jax.random.split(rng)
        keys = rollout_step_keys(srng, K, T)
        fns.append(lambda t, keys=keys: torch.from_numpy(np.array(
            gumbel_step_noise(keys[t], (B, V), jnp.float32))))
    return fns


@pytest.mark.parametrize("pipelined", [True, False],
                         ids=["pipelined", "sequential"])
def test_train_epoch_matches_jax(rl_setup, pipelined):
    s = rl_setup
    tx = jax_opt(jax_preset("msrvtt_xe_attention").train, 10,
                 lr_override=1e-3)
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=s["params"],
                      opt_state=tx.init(s["params"]), rng=jax.random.key(0),
                      tx=tx, apply_fn=s["jmodel"].apply)
    jb = [({k: jnp.asarray(v) for k, v in b.feats.items()},
           {k: jnp.asarray(v) for k, v in b.feat_masks.items()},
           b.video_ids, b.valid) for b in s["batches"]]
    jstate, jm = s["jtr"].train_epoch(jstate, jb, jax.random.key(31),
                                      pipelined=pipelined)
    ttr, tstate = _port_scst(s)
    draws = _jax_draws(3, 3, BATCH, len(s["vocab"]))
    tstate, tm = ttr.train_epoch(tstate, _torch_batches(s["batches"]),
                                 seeds=lambda j: 0, pipelined=pipelined,
                                 noise_fns=lambda j: draws[j])
    assert len(tm) == len(jm) == 3
    for a, b in zip(jm, tm):
        for key in ("reward_mean", "baseline_mean", "valid_rows"):
            np.testing.assert_allclose(b[key], a[key], rtol=RL_TOL)
        np.testing.assert_allclose(b["rl_loss"], float(a["rl_loss"]),
                                   rtol=RL_TOL, atol=RL_TOL)
    assert tstate.step == int(jstate.step) == 3
    _close_trees(jstate.params,
                 state_dict_to_flax(tstate.model.cfg,
                                    tstate.model.state_dict()), RL_TOL)


def test_should_stop_drain_and_seam_replay(rl_setup):
    s = rl_setup
    batches = _torch_batches(s["batches"] * 2)          # 6 batches

    def seeds(offset=0):
        return lambda j: trl.rollout_seed(7, 0, 1, offset + j)

    ttr, full = _port_scst(s)
    full, fm = ttr.train_epoch(full, batches, seeds())
    assert full.step == 6

    # the pipelined drain with a seam sink, stopped at batch 3
    ttr, part = _port_scst(s)
    sink: dict = {}
    seen = {"n": 0}

    def stop():
        seen["n"] += 1
        return seen["n"] == 4
    part, pm = ttr.train_epoch(part, batches, seeds(), should_stop=stop,
                               seam_sink=sink)
    assert len(pm) == part.step == 3
    assert sink["video_ids"] == batches[3][2]
    # resumed: batch 3 replays the seam's tokens, the rest decode anew
    part, rm = ttr.train_epoch(part, batches[3:], seeds(3), seam=sink)
    assert part.step == 6
    _equal_params(part, full)
    assert [m["reward_mean"] for m in pm + rm] == \
        [m["reward_mean"] for m in fm]
    # a seam of other clips is not replayed
    bad = dict(sink, video_ids=["x"] * BATCH)
    ttr, other = _port_scst(s)
    other, om = ttr.train_epoch(other, batches[3:4], seeds(3), seam=bad)
    assert len(om) == 1

    # the sequential drain stops at the boundary: len(metrics) steps
    ttr, seq = _port_scst(s)
    seen["n"] = 0
    seq, sm = ttr.train_epoch(seq, batches, seeds(), pipelined=False,
                              should_stop=stop)
    assert len(sm) == seq.step == 3
    # without a sink the pipelined drain also applies every decoded batch
    ttr, nos = _port_scst(s)
    seen["n"] = 0
    nos, nm = ttr.train_epoch(nos, batches, seeds(), should_stop=stop)
    assert len(nm) == nos.step == 3


# ---- the handoff, reward_threads, unported values ---------------------------


def test_handoff_starts_a_fresh_optimizer(corpus, reference_run, tmp_path):
    ref = reference_run
    tr = ref["trainer"]
    rl = tr.cfg.rl
    # after one RL epoch from the XE state: the step counts RL steps only
    n_rl = len(_events(ref["log"], "rl_step"))
    assert tr.state.step == tr.state.opt_state["count"] == n_rl > 0
    assert tr.state.tx.lr(0) == tr.state.tx.lr(10_000) == rl.lr
    # params-only handoff from a checkpoint directory
    cfg = _port_cfg(corpus, tmp_path / "ck", preset="msrvtt_scst",
                    rl__init_from=str(ref["ckpt"]))
    other = _port_trainer(corpus, cfg, tmp_path / "log.jsonl")
    other.load_params_from(str(ref["ckpt"]), "best")
    assert _events(tmp_path / "log.jsonl", "handoff")
    assert other.state.step == 0
    best = json.load(open(ref["ckpt"] / "best" / "infos.json"))
    assert best["phase"] == ""
    # a mid-RL resume whose optimizer state does not fit raises
    other.rl_epochs = 1
    other.state.opt_state = {"count": 3}
    with pytest.raises(RuntimeError, match="mid-RL resume"):
        other.train_rl(1)


@pytest.mark.parametrize("threads", [0, 3])
def test_reward_threads_reach_the_scorer(corpus, tmp_path, monkeypatch,
                                         threads):
    seen = {}

    class Stop(Exception):
        pass

    class Recording(trl.RewardComputer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["reward"] = self
            raise Stop

    monkeypatch.setattr(trainer_mod, "RewardComputer", Recording)
    cfg = _port_cfg(corpus, tmp_path / "ck", rl__reward_threads=threads)
    tr = _port_trainer(corpus, cfg, tmp_path / "log.jsonl")
    with pytest.raises(Stop):
        tr.train_rl(1)
    assert seen["reward"].num_threads == (threads or os.cpu_count())


# the observability, health and data-parallel knobs are ported
# (tests/test_torch_obs.py), and so are the degraded and regrown meshes of
# elastic training (tests/test_torch_elastic.py) and the sequence-parallel
# grid (tests/test_torch_seq_parallel.py) and the model-parallel one
# (tests/test_torch_model_parallel.py).
# (section, name, value, still refused)
UNPORTED = [
    ("mesh", "seq_devices", 2, False), ("mesh", "mp_devices", 2, False),
    ("train", "elastic_regrow", False, False),
    ("train", "elastic", "degraded", False),
]


@pytest.mark.parametrize("section,name,value,refused", UNPORTED,
                         ids=[f"{s}.{n}" for s, n, _, _ in UNPORTED])
def test_unported_config_values_raise(section, name, value, refused):
    """A value whose machinery is not ported raises; one the elastic or
    sequence-parallel slice brought is accepted, and its JSON round trip
    equals the JAX package's ``to_json()`` of the same override."""
    cfg = get_experiment("msrvtt_cst_consensus")
    key = f"{section}__{name}"
    if refused:
        with pytest.raises(ValueError, match="not ported"):
            cfg.override(**{key: value})
    else:
        got = cfg.override(**{key: value})
        assert getattr(getattr(got, section), name) == value
        want = jax_preset("msrvtt_cst_consensus").override(**{key: value})
        assert json.loads(got.to_json()) == json.loads(want.to_json())
        assert tcfg.ExperimentConfig.from_json(want.to_json()) == got
    # the default is accepted, and a round trip through JSON keeps it
    assert tcfg.ExperimentConfig.from_json(cfg.to_json()) == cfg


# ported with the data-parallel slice: the config takes them; a mesh wider
# than this run's ranks raises, saying how many processes to launch
DATA_PARALLEL = [("mesh", "num_devices", 2), ("train", "comm_dtype", "bf16")]


@pytest.mark.parametrize("section,name,value", DATA_PARALLEL,
                         ids=[f"{s}.{n}" for s, n, _ in DATA_PARALLEL])
def test_data_parallel_config_values_are_accepted(section, name, value):
    cfg = get_experiment("msrvtt_cst_consensus").override(
        **{f"{section}__{name}": value})
    assert getattr(getattr(cfg, section), name) == value
    assert tcfg.ExperimentConfig.from_json(cfg.to_json()) == cfg
    if name == "num_devices":
        with pytest.raises(ValueError, match="launch 2 processes"):
            make_mesh(cfg.mesh.num_devices, device="cpu")


# ---- config parity ---------------------------------------------------------


@pytest.mark.parametrize("name", sorted(EXPERIMENTS))
def test_jax_preset_json_loads_and_equals_the_port_preset(name):
    """Every JAX preset's ``to_json()`` (``model.seq_axis`` included) loads
    in the port and equals the port's own preset in every field of every
    section; ``get_preset`` returns the ExperimentConfig in both
    packages."""
    jcfg = jax_preset(name)
    got = tcfg.ExperimentConfig.from_json(jcfg.to_json())
    want = port_preset(name)
    assert isinstance(want, tcfg.ExperimentConfig)
    assert type(jcfg).__name__ == "ExperimentConfig"
    assert got.name == want.name == name
    for section in ("model", "data", "train", "rl", "eval", "mesh"):
        g, w = getattr(got, section), getattr(want, section)
        for f in dataclasses.fields(w):
            assert getattr(g, f.name) == getattr(w, f.name), \
                f"{name}: {section}.{f.name}"
    assert got == want and got.model.seq_axis == ""


# the adaptive spike bound is ported: a bad value raises the JAX package's
# message (tests/test_resilience.py::test_train_config_validates_spike_mode),
# and a good one round-trips
BAD_SPIKE_VALUES = [
    ({"spike_mode": "bogus"}, "unknown spike_mode 'bogus'"),
    ({"spike_mode": "adaptive"}, "needs spike_factor > 0"),
    ({"spike_mode": "adaptive", "spike_factor": 10.0,
      "spike_factor_min": 0.0},
     r"spike_factor_min 0.0 must be in \(0, spike_factor=10.0\]"),
    ({"spike_mode": "adaptive", "spike_factor": 10.0,
      "spike_factor_min": 20.0},
     r"spike_factor_min 20.0 must be in \(0, spike_factor=10.0\]"),
]


@pytest.mark.parametrize("fields,message", BAD_SPIKE_VALUES,
                         ids=["mode", "no_factor", "min_zero", "min_above"])
def test_spike_mode_values_are_validated(fields, message):
    with pytest.raises(ValueError, match=message):
        tcfg.TrainConfig(**fields)
    # the JAX package refuses the same values with the same message
    with pytest.raises(ValueError, match=message):
        JaxTrainConfig(**fields)
    cfg = get_experiment("msrvtt_cst_consensus").override(
        train__spike_factor=10.0, train__spike_mode="adaptive")
    assert tcfg.ExperimentConfig.from_json(cfg.to_json()) == cfg


# the health knobs are ported: a bad value raises the JAX package's message
BAD_HEALTH_VALUES = [
    ({"elastic": "bogus"}, "unknown elastic mode 'bogus'"),
    ({"health_interval_s": 0.0}, "health knobs out of range"),
    ({"peer_timeout_s": -1.0}, "health knobs out of range"),
    ({"health_sim_hosts": -1}, "health_sim_hosts -1 must be >= 0"),
]


@pytest.mark.parametrize("fields,message", BAD_HEALTH_VALUES,
                         ids=["elastic", "interval", "timeout", "sim_hosts"])
def test_health_values_are_validated(fields, message):
    with pytest.raises(ValueError, match=message) as got:
        tcfg.TrainConfig(**fields)
    with pytest.raises(ValueError, match=message) as want:
        JaxTrainConfig(**fields)
    assert str(got.value) == str(want.value)


# the decoupled and online RL knobs are ported: a bad value raises the JAX
# package's message, and a good one round-trips
BAD_RL_VALUES = [
    ("train", "rl_topology", "ring", "unknown rl_topology"),
    ("rl", "rollout_depth", 0, "rl.rollout_depth 0 must be >= 1"),
    ("rl", "staleness_bound", -1, "rl.staleness_bound -1 must be >= 0"),
    ("rl", "actor_fraction", 0.0, r"rl.actor_fraction 0.0 must be in \(0, 1\)"),
    ("rl", "actor_fraction", 1.0, r"rl.actor_fraction 1.0 must be in \(0, 1\)"),
    ("rl", "online_batch_size", 0, "rl.online_batch_size 0 must be >= 1"),
    ("rl", "swap_every", 0, "rl.swap_every 0 must be >= 1"),
]


@pytest.mark.parametrize(
    "section,name,value,message", BAD_RL_VALUES,
    ids=[f"{s}.{n}={v}" for s, n, v, _ in BAD_RL_VALUES])
def test_rl_topology_values_are_validated(section, name, value, message):
    cfg = get_experiment("msrvtt_cst_consensus")
    with pytest.raises(ValueError, match=message):
        cfg.override(**{"train__rl_topology": "decoupled",
                        f"{section}__{name}": value})
    good = cfg.override(train__rl_topology="decoupled", rl__rollout_depth=3,
                        rl__staleness_bound=0, rl__actor_fraction=0.25,
                        rl__online_batch_size=8, rl__swap_every=2)
    assert tcfg.ExperimentConfig.from_json(good.to_json()) == good


# ---- the decoupled topology through the Trainer ---------------------------


@pytest.mark.parametrize("depth,bound,pipelined", [(2, 1, True),
                                                   (1, 0, False)],
                         ids=["d2b1_vs_pipelined", "d1b0_vs_sequential"])
def test_decoupled_train_rl_matches_sync(corpus, tmp_path, depth, bound,
                                         pipelined):
    """``train.rl_topology="decoupled"`` builds the AsyncSCSTTrainer; at
    depth 2 / bound 1 its ring replays the pipelined sync schedule and at
    depth 1 / bound 0 (strict) the sequential one: the parameters and the
    rewards of every step equal the sync trainer's."""
    runs = {}
    for topo in ("sync", "decoupled"):
        extra = (dict(rl__rollout_depth=depth, rl__staleness_bound=bound)
                 if topo == "decoupled" else {})
        cfg = _port_cfg(corpus, tmp_path / topo, train__epochs=1,
                        rl__pipelined=pipelined, train__rl_topology=topo,
                        **extra)
        tr = _port_trainer(corpus, cfg, tmp_path / f"{topo}.jsonl")
        tr.train_xe()
        tr.train_rl()
        runs[topo] = tr
    _equal_params(runs["sync"].state, runs["decoupled"].state)
    want = [e["reward"] for e in _events(tmp_path / "sync.jsonl", "rl_step")]
    got = [e["reward"] for e in _events(tmp_path / "decoupled.jsonl",
                                         "rl_step")]
    assert got == want and len(got) > 2
    assert _infos(tmp_path / "decoupled") == _infos(tmp_path / "sync")


def test_sigterm_during_decoupled_rl_then_resume_is_bitwise(
        corpus, reference_run, tmp_path):
    """A decoupled RL epoch (depth 2, bound 1: the pipelined schedule)
    preempted at a batch boundary persists its in-flight ring in
    ``seam.npz``; the resumed run replays it and ends equal to the
    uninterrupted pipelined run."""
    ref = reference_run
    cfg = _port_cfg(corpus, tmp_path / "ck", train__epochs=2,
                    train__rl_topology="decoupled")
    tr = _port_trainer(corpus, cfg, tmp_path / "log.jsonl")
    tr.train_xe()
    real = trl.SCSTTrainer._apply
    calls = {"n": 0}

    def apply(self, *a):
        calls["n"] += 1
        if calls["n"] == 1:       # update(0), while batch 1 is consumed
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self, *a)

    trl.SCSTTrainer._apply = apply
    try:
        with pytest.raises(Preempted):
            tr.train_rl()
    finally:
        trl.SCSTTrainer._apply = real
    ev = _events(tmp_path / "log.jsonl", "ckpt_step")[-1]
    # the stop came before batch 2: batch 1's rollouts are the ring
    assert ev["phase"] == "rl" and ev["seam"] and ev["batch_index"] == 1
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, resume="auto"))
    again = _port_trainer(corpus, cfg2, tmp_path / "log2.jsonl")
    assert _events(tmp_path / "log2.jsonl", "seam_loaded")
    assert len(again._pending_seam["ring"]) == 1
    again.train_rl()
    _equal_params(again.state, ref["trainer"].state)
    assert _infos(tmp_path / "ck") == _infos(ref["ckpt"])
    want = [e["reward"] for e in _events(ref["log"], "rl_step")]
    got = [e["reward"] for e in _events(tmp_path / "log.jsonl", "rl_step")
           + _events(tmp_path / "log2.jsonl", "rl_step")]
    assert got == want


# ---- the divergence sentinel ------------------------------------------------


def test_sentinel_policies():
    from cst_captioning_tpu_torch.resilience import (
        DivergenceSentinel,
        RollbackRequested,
        TrainingDiverged,
    )

    events = []
    log = lambda e, **f: events.append((e, f))  # noqa: E731
    s = DivergenceSentinel("skip_batch", log=log, spike_factor=2.0, warmup=2)
    for step, loss in enumerate([1.0, 1.1, 0.9, 5.0, float("nan")], 1):
        s.push(step, loss, 1.0 if step == 5 else 0.0)
    s.flush()
    assert [(f["kind"], f["action"]) for _, f in events] == [
        ("spike", "logged"), ("nonfinite", "skip_batch")]
    assert s.skipped == 1
    off = DivergenceSentinel("off")
    off.push(1, float("nan"), 1.0)
    off.flush()
    rb = DivergenceSentinel("rollback", check_every=2)
    rb.push(1, 1.0)
    with pytest.raises(RollbackRequested) as err:
        rb.push(2, float("inf"))
    assert err.value.step == 2 and err.value.kind == "nonfinite"
    ab = DivergenceSentinel("abort")
    ab.push(3, float("nan"))
    with pytest.raises(TrainingDiverged):
        ab.flush()
    with pytest.raises(ValueError):
        DivergenceSentinel("retry")


def test_rollback_restores_and_salts_the_order(corpus, tmp_path):
    """A non-finite step under ``rollback``: the trainer restores the
    last epoch-end checkpoint and replays the epoch under salt 1."""
    cfg = _port_cfg(corpus, tmp_path / "ck", train__epochs=2,
                    train__on_divergence="rollback")
    tr = _port_trainer(corpus, cfg, tmp_path / "log.jsonl")
    step = tr.xe_step
    calls = {"n": 0}

    def xe_step(state, *a):
        calls["n"] += 1
        if calls["n"] == tr.steps_per_epoch + 2:       # epoch 2, step 2
            return state, {"loss": float("nan"), "grad_norm": float("nan"),
                           "nonfinite": 1.0}
        return step(state, *a)

    tr.xe_step = xe_step
    tr.train_xe()
    rb = _events(tmp_path / "log.jsonl", "rollback")
    assert len(rb) == 1 and rb[0]["salt"] == 1 and rb[0]["restored_epoch"] == 1
    assert tr.batcher.salt == 1 and tr.xe_epochs == 2
    assert _infos(tmp_path / "ck")["data_salt"] == 1
    assert calls["n"] == 3 * tr.steps_per_epoch      # epoch 2 ran twice
