"""The port's training path against the JAX package on converted weights,
float32 on the CPU at a small width (V=97, E=H=16, A=8, T=8), with
attention_impl and decode_impl "pallas" on both sides (the JAX kernels in
interpret mode): teacher forcing, dropout, the losses, the optimizer chain,
the XE step, the consensus reward, sampling, the REINFORCE update and the
whole CST step. Tolerances: 2e-5 where float32 sums run in another order
through a model (the JAX kernel parity tests' bound), 1e-6 for the losses
and the optimizer on their own, exact for tokens and rewards."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.config.config import (
    EOS_ID,
    ModelConfig,
    RLConfig,
    TrainConfig,
)
from cst_captioning_tpu.data.vocab import Vocab
from cst_captioning_tpu.decoding.common import (
    gumbel_step_noise,
    rollout_step_keys,
)
from cst_captioning_tpu.decoding.sample import sample_decode as jax_sample
from cst_captioning_tpu.losses import losses as jl
from cst_captioning_tpu.models import CaptionModel
from cst_captioning_tpu.models.captioner import CaptionModel as CM
from cst_captioning_tpu.models.captioner import shift_right as jax_shift_right
from cst_captioning_tpu.rl.rewards import RewardComputer
from cst_captioning_tpu.rl.rewards import scb_baseline as jax_scb
from cst_captioning_tpu.rl.scst import SCSTTrainer, make_rl_update
from cst_captioning_tpu.train.schedule import make_optimizer
from cst_captioning_tpu.train.state import TrainState as JaxState
from cst_captioning_tpu.train.steps import _local_loss_sums, make_xe_step
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch import losses as tl
from cst_captioning_tpu_torch import rl as trl
from cst_captioning_tpu_torch import train as ttrain
from cst_captioning_tpu_torch.convert import load_flax_params, state_dict_to_flax
from cst_captioning_tpu_torch.data import Vocab as TorchVocab
from cst_captioning_tpu_torch.decoding import sample_decode
from cst_captioning_tpu_torch.models import CaptionModel as TorchCaptionModel
from cst_captioning_tpu_torch.models.captioner import EncoderOutput, shift_right
from cst_captioning_tpu_torch.models.decoder import dropout
from cst_captioning_tpu_torch.train.steps import xe_loss_and_grads

torch.set_num_threads(1)

TOL = 2e-5
EXACT_TOL = 1e-6
MODAL = (("resnet", 16), ("c3d", 12))
B, F, T, V, K = 6, 6, 8, 97, 3
WORDS = [f"w{i}" for i in range(V - 4)]
KW = dict(vocab_size=V, modalities=MODAL, d_embed=16, d_hidden=16, d_att=8,
          encoder="temporal_attention", dropout=0.0, max_len=T, max_frames=F,
          dtype="float32", attention_impl="pallas", decode_impl="pallas")


@pytest.fixture(scope="module")
def setup():
    jmodel = CaptionModel(ModelConfig(**KW))
    rng = np.random.default_rng(0)
    feats = {n: rng.normal(size=(B, F, d)).astype(np.float32)
             for n, d in MODAL}
    lens = np.array([[1], [6], [3], [6], [2], [5]])
    masks = {n: (np.arange(F)[None] < lens).astype(np.float32)
             for n, _ in MODAL}
    # the composite model has the same parameter tree and inits faster
    xla = CaptionModel(ModelConfig(**{**KW, "attention_impl": "xla"}))
    params = xla.init(jax.random.key(0), jax.tree.map(jnp.asarray, feats),
                      jax.tree.map(jnp.asarray, masks),
                      jnp.zeros((B, T), jnp.int32))
    # EOS-biased so rollouts end at different steps (the early exit runs)
    bias = params["params"]["cell"]["out_proj"]["bias"]
    params["params"]["cell"]["out_proj"]["bias"] = bias.at[EOS_ID].add(2.0)
    labels = rng.integers(4, V, size=(B, T)).astype(np.int32)
    mask = (np.arange(T)[None] < np.array([[3], [8], [5], [1], [8], [6]])
            ).astype(np.float32)
    labels = np.where(mask > 0, labels, 0).astype(np.int32)
    gts = {f"v{i}": [" ".join(rng.choice(WORDS[:20], rng.integers(3, 7)))
                     for _ in range(4)] for i in range(B)}
    return dict(jmodel=jmodel, params=params, feats=feats, masks=masks,
                labels=labels, mask=mask, gts=gts,
                vids=[f"v{i}" for i in range(B)])


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_model(params, **overrides):
    return load_flax_params(
        TorchCaptionModel(tcfg.ModelConfig(**{**KW, **overrides}),
                          device="cpu"),
        jax.tree.map(np.asarray, params))


def _jax_state(s, train_cfg):
    tx = make_optimizer(train_cfg, 10)
    return JaxState(step=jnp.zeros((), jnp.int32), params=s["params"],
                    opt_state=tx.init(s["params"]), rng=jax.random.key(0),
                    tx=tx, apply_fn=s["jmodel"].apply)


def _port_state(s, train_cfg):
    model = _port_model(s["params"])
    tx = ttrain.make_optimizer(tcfg.TrainConfig(
        optimizer=train_cfg.optimizer, lr=train_cfg.lr,
        grad_clip=train_cfg.grad_clip), 10)
    return ttrain.create_train_state(model, tx)


def _tree_close(want, got_tree, tol):
    w = jax.tree_util.tree_leaves_with_path(want)
    g = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    assert len(w) == len(g)
    for path, leaf in w:
        np.testing.assert_allclose(g[path], np.asarray(leaf), rtol=tol,
                                   atol=tol, err_msg=str(path))


def _named(state, tensors):
    return {n: t for (n, _), t in zip(state.model.named_parameters(),
                                      tensors)}


# ---- model ------------------------------------------------------------------


def test_teacher_forcing_matches_jax(setup):
    s = setup
    jm, params = s["jmodel"], s["params"]
    feats = jax.tree.map(jnp.asarray, s["feats"])
    masks = jax.tree.map(jnp.asarray, s["masks"])
    labels = jnp.asarray(s["labels"])
    jenc = jm.apply(params, feats, masks, method=CM.encode)
    want_logits = jm.apply(params, jenc, labels, method=CM.decode_logits)
    want_logps = jm.apply(params, jenc, labels,
                          method=CM.teacher_force_logps)
    model = _port_model(params)
    tenc = EncoderOutput(_t(jenc.memory), _t(jenc.memory_proj),
                         _t(jenc.memory_mask),
                         tuple((_t(c), _t(h)) for c, h in jenc.carry))
    np.testing.assert_array_equal(
        shift_right(_t(s["labels"])).numpy(), np.asarray(jax_shift_right(labels)))
    with torch.no_grad():
        got_logits = model.decode_logits(tenc, _t(s["labels"]).long())
        got_logps = model.teacher_force_logps(tenc, _t(s["labels"]).long())
        got_fwd = model({k: _t(v) for k, v in s["feats"].items()},
                        {k: _t(v) for k, v in s["masks"].items()},
                        _t(s["labels"]).long())
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_logps.numpy(), np.asarray(want_logps),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_fwd.numpy(), np.asarray(want_logits),
                               rtol=TOL, atol=TOL)


def test_dropout_masks_scale_and_eval():
    x = torch.ones(200, 50)
    a = dropout(x, 0.3, torch.Generator().manual_seed(7))
    b = dropout(x, 0.3, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    kept = a != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.02
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.7))
    assert torch.equal(dropout(x, 0.0, torch.Generator()), x)
    cfg = tcfg.ModelConfig(**{**KW, "dropout": 0.5})
    model = TorchCaptionModel(cfg, device="cpu")
    enc = model.encode({n: torch.randn(2, F, d) for n, d in MODAL},
                       {n: torch.ones(2, F) for n, _ in MODAL})
    labels = torch.randint(4, V, (2, T))
    det = model.decode_logits(enc, labels)
    g = torch.Generator().manual_seed(1)
    assert not torch.equal(model.decode_logits(enc, labels, True, g), det)
    model.eval()
    torch.testing.assert_close(
        model.decode_logits(enc, labels, True, torch.Generator()), det,
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        model.decode_logits(enc, labels, train=True)


# ---- losses and optimizer ---------------------------------------------------


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("weighted", [False, True], ids=["xe", "wxe"])
def test_losses_match_jax(weighted, smoothing):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(4, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, size=(4, 5)).astype(np.int32)
    mask = (rng.random((4, 5)) < 0.7).astype(np.float32)
    weights = rng.random(4).astype(np.float32) if weighted else None
    adv = rng.normal(size=(4,)).astype(np.float32)
    want = jl.masked_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask),
        None if weights is None else jnp.asarray(weights), smoothing)
    got = tl.masked_cross_entropy(
        _t(logits), _t(labels), _t(mask),
        None if weights is None else _t(weights), smoothing)
    np.testing.assert_allclose(got.item(), float(want), rtol=EXACT_TOL)
    want_lp = jl.sequence_log_probs(jnp.asarray(logits), jnp.asarray(labels))
    got_lp = tl.sequence_log_probs(_t(logits), _t(labels))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp),
                               rtol=EXACT_TOL, atol=EXACT_TOL)
    want_rl = jl.reinforce_loss(want_lp, jnp.asarray(mask), jnp.asarray(adv))
    got_rl = tl.reinforce_loss(got_lp, _t(mask), _t(adv))
    np.testing.assert_allclose(got_rl.item(), float(want_rl), rtol=EXACT_TOL)


@pytest.mark.parametrize("clip", [0.5, 100.0], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "rmsprop"])
def test_optimizer_matches_optax(name, clip):
    rng = np.random.default_rng(3)
    params = [rng.normal(size=(7, 5)).astype(np.float32),
              rng.normal(size=(5,)).astype(np.float32)]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in params]
             for _ in range(3)]
    # one decay per step: the staircase halves the rate after each update
    cfg = dict(optimizer=name, lr=0.1, lr_decay=0.5, lr_decay_every=1,
               grad_clip=clip, weight_decay=0.01)
    jtx = make_optimizer(TrainConfig(**cfg), steps_per_epoch=1)
    ttx = ttrain.make_optimizer(tcfg.TrainConfig(**cfg), steps_per_epoch=1)
    jp = [jnp.asarray(p) for p in params]
    tp = [_t(p) for p in params]
    jst, tst = jtx.init(jp), ttx.init(tp)
    for g in grads:
        upd, jst = jtx.update([jnp.asarray(x) for x in g], jst, jp)
        jp = optax.apply_updates(jp, upd)
        upd, tst = ttx.update([_t(x) for x in g], tst, tp)
        tp = [p + u for p, u in zip(tp, upd)]
    assert tst["count"] == 3
    for a, b in zip(jp, tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=EXACT_TOL,
                                   atol=EXACT_TOL * float(np.abs(a).max()))
    with pytest.raises(ValueError, match="unknown optimizer"):
        ttrain.make_optimizer(tcfg.TrainConfig(optimizer="lamb"), 1)


# ---- XE step ----------------------------------------------------------------


@pytest.mark.parametrize("loss", ["xe", "wxe"])
def test_xe_row_weights_follow_the_loss(loss):
    weights = torch.tensor([0.5, 2.0, 1.5])
    valid = torch.tensor([1.0, 1.0, 0.0])              # a wrap-padded row
    # the JAX trainer's XE epoch: valid rows, or their consensus weights
    want = valid if loss == "xe" else weights * valid
    got = ttrain.xe_row_weights(tcfg.TrainConfig(loss=loss).loss, weights,
                                valid)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown loss"):
        tcfg.TrainConfig(loss="wxe2")


def test_xe_step_matches_jax(setup):
    s = setup
    train_cfg = TrainConfig(lr=1e-3, grad_clip=5.0)
    jm = s["jmodel"]
    batch = (jax.tree.map(jnp.asarray, s["feats"]),
             jax.tree.map(jnp.asarray, s["masks"]), jnp.asarray(s["labels"]),
             jnp.asarray(s["mask"]), jnp.ones((B,), jnp.float32))
    tbatch = ({k: _t(v) for k, v in s["feats"].items()},
              {k: _t(v) for k, v in s["masks"].items()},
              _t(s["labels"]).long(), _t(s["mask"]), torch.ones(B))
    jstate = _jax_state(s, train_cfg)
    tstate = _port_state(s, train_cfg)

    def jloss(p):
        num, den = _local_loss_sums(jm, p, *batch, jax.random.key(1), 0.0)
        return num / jnp.maximum(den, 1.0)

    want_loss, want_grads = jax.jit(jax.value_and_grad(jloss),
                                    donate_argnums=())(jstate.params)
    loss, grads = xe_loss_and_grads(tstate, *tbatch)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=TOL)
    _tree_close(want_grads,
                state_dict_to_flax(tstate.model.cfg, _named(tstate, grads)),
                TOL)

    jstep = make_xe_step(jm, guard=True)
    tstep = ttrain.make_xe_step(tstate.model, guard=True)
    for _ in range(2):
        jstate, jm_ = jstep(jstate, *batch)
        tstate, tm_ = tstep(tstate, *tbatch)
        np.testing.assert_allclose(tm_["loss"], float(jm_["loss"]), rtol=TOL)
        np.testing.assert_allclose(tm_["grad_norm"], float(jm_["grad_norm"]),
                                   rtol=TOL)
        assert tm_["nonfinite"] == float(jm_["nonfinite"]) == 0.0
    assert tstate.step == int(jstate.step) == 2
    _tree_close(jstate.params,
                state_dict_to_flax(tstate.model.cfg,
                                   tstate.model.state_dict()), TOL)

    # a non-finite loss leaves params, optimizer state and step untouched
    before = tstate.clone()
    bad = ({k: v * float("nan") for k, v in tbatch[0].items()},) + tbatch[1:]
    tstate, tm_ = tstep(tstate, *bad)
    assert tm_["nonfinite"] == 1.0 and tstate.step == 2
    assert tstate.opt_state["count"] == before.opt_state["count"]
    for a, b in zip(tstate.params, before.params):
        assert torch.equal(a, b)
    for a, b in zip(tstate.opt_state["mu"], before.opt_state["mu"]):
        assert torch.equal(a, b)


# ---- rewards ----------------------------------------------------------------


@pytest.mark.parametrize("bleu", [0.0, 0.5], ids=["cider", "cider_bleu"])
@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_rewards_match_jax(setup, native, bleu):
    s = setup
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 30, size=(3 * B, T)).astype(np.int32)
    rows[:, -2] = EOS_ID
    rows[0] = 0                                      # an empty caption
    rows[1, 3] = V + 5                               # an id past the vocab
    kw = dict(cider_weight=1.0, bleu_weight=bleu, bleu_scale=10.0,
              use_native=native)
    jrc = RewardComputer(Vocab.from_corpus_words(WORDS), s["gts"], **kw)
    assert bool(jrc._native) == native
    trc = trl.RewardComputer(TorchVocab.from_corpus_words(WORDS), s["gts"],
                             **kw)
    want, got = jrc(s["vids"], rows), trc(s["vids"], rows)
    assert got.dtype == np.float32 and (want > 0).any()
    np.testing.assert_array_equal(got, want)
    kb = want.reshape(3, B)
    np.testing.assert_array_equal(trl.scb_baseline(kb), jax_scb(kb))


# ---- sampling, REINFORCE, the CST step --------------------------------------


def _jax_noise(rng, K_, T_, B_):
    keys = rollout_step_keys(rng, K_, T_)
    return lambda t: torch.from_numpy(np.array(
        gumbel_step_noise(keys[t], (B_, V), jnp.float32)))


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_sample_decode_matches_jax(setup, impl):
    """The port's decode-step path and its cell-module path ("xla") both
    against the JAX sampler on its decode-step kernel."""
    s = setup
    rng = jax.random.key(11)
    feats = jax.tree.map(jnp.asarray, s["feats"])
    masks = jax.tree.map(jnp.asarray, s["masks"])
    want_tok, want_lp = jax_sample(s["jmodel"], s["params"], feats, masks,
                                   rng, num_rollouts=K, temperature=0.8,
                                   min_len=2)
    got_tok, got_lp = sample_decode(
        _port_model(s["params"], decode_impl=impl),
        {k: _t(v) for k, v in s["feats"].items()},
        {k: _t(v) for k, v in s["masks"].items()}, num_rollouts=K,
        temperature=0.8, min_len=2, noise_fn=_jax_noise(rng, K, T, B))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp), rtol=TOL,
                               atol=TOL)
    lens = (got_tok.numpy() != 0).sum(-1)
    assert lens.min() < T and (got_tok.numpy()[..., 0] != EOS_ID).any()


def _sgd(s):
    """Plain SGD at lr 1 without clipping: the update is minus the grads."""
    cfg = TrainConfig(optimizer="sgd", lr=1.0, grad_clip=0.0,
                      lr_decay_every=0)
    return _jax_state(s, cfg), _port_state(s, cfg)


def _grads_close(jstate_old, jstate, tstate_old_sd, tstate):
    want = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                        jstate_old.params, jstate.params)
    new = tstate.model.state_dict()
    got = {k: tstate_old_sd[k] - new[k] for k in new}
    _tree_close(want, state_dict_to_flax(tstate.model.cfg, got), TOL)


@pytest.mark.parametrize("chunks", [1, K])
def test_rl_update_matches_jax(setup, chunks):
    s = setup
    rng = np.random.default_rng(5)
    samples = rng.integers(3, V, size=(K, B, T)).astype(np.int32)
    ends = rng.integers(1, T + 1, size=(K, B))
    for k in range(K):
        for b in range(B):
            if ends[k, b] < T:
                samples[k, b, ends[k, b] - 1] = EOS_ID
                samples[k, b, ends[k, b]:] = 0
    adv = rng.normal(size=(K, B)).astype(np.float32)
    valid = np.ones((B,), np.float32)
    valid[-1] = 0.0                                   # a wrap-padded row
    jstate, tstate = _sgd(s)
    jold, told = jstate, {k: v.clone() for k, v in
                          tstate.model.state_dict().items()}
    jstate, jmet = make_rl_update(s["jmodel"], chunks=chunks)(
        jstate, jax.tree.map(jnp.asarray, s["feats"]),
        jax.tree.map(jnp.asarray, s["masks"]), jnp.asarray(samples),
        jnp.asarray(adv), jnp.asarray(valid))
    tstate, tmet = trl.make_rl_update(tstate.model, chunks=chunks)(
        tstate, {k: _t(v) for k, v in s["feats"].items()},
        {k: _t(v) for k, v in s["masks"].items()}, _t(samples), _t(adv),
        _t(valid))
    np.testing.assert_allclose(tmet["rl_loss"], float(jmet["rl_loss"]),
                               rtol=TOL, atol=TOL)
    _grads_close(jold, jstate, told, tstate)


def test_cst_step_matches_jax(setup):
    s = setup
    cfg = dict(num_rollouts=K, baseline="scb", reward_cider_weight=1.0,
               reward_bleu4_weight=0.5)
    vocab = Vocab.from_corpus_words(WORDS)
    jtr = SCSTTrainer(s["jmodel"], RewardComputer(vocab, s["gts"]),
                      RLConfig(**cfg))
    jstate, tstate = _sgd(s)
    ttr = trl.SCSTTrainer(tstate.model, trl.RewardComputer(
        TorchVocab.from_corpus_words(WORDS), s["gts"]), tcfg.RLConfig(**cfg))
    feats = jax.tree.map(jnp.asarray, s["feats"])
    masks = jax.tree.map(jnp.asarray, s["masks"])
    tfeats = {k: _t(v) for k, v in s["feats"].items()}
    tmasks = {k: _t(v) for k, v in s["masks"].items()}
    rng = jax.random.key(21)
    noise = _jax_noise(rng, K, T, B)

    _, jsam = jtr.decode(jstate.params, feats, masks, rng)
    tgreedy, tsam = ttr.decode(tstate.model, tfeats, tmasks, 0, noise)
    assert tgreedy is None               # the scb baseline needs no greedy
    np.testing.assert_array_equal(tsam.numpy(), np.asarray(jsam))
    valid = np.ones((B,), np.float32)
    jadv, jm_ = jtr._advantage(None, np.asarray(jsam), s["vids"], valid)
    tadv, tm_ = ttr._advantage(None, tsam.numpy(), s["vids"], valid)
    np.testing.assert_array_equal(tadv, jadv)
    assert tm_ == jm_ and jm_["reward_mean"] > 0

    jold, told = jstate, {k: v.clone() for k, v in
                          tstate.model.state_dict().items()}
    jstate, jmet = jtr.train_step(jstate, feats, masks, s["vids"], rng)
    tstate, tmet = ttr.train_step(tstate, tfeats, tmasks, s["vids"], 0,
                                  noise_fn=noise)
    for key in ("reward_mean", "baseline_mean", "advantage_mean"):
        assert tmet[key] == jmet[key]
    np.testing.assert_allclose(tmet["rl_loss"], float(jmet["rl_loss"]),
                               rtol=TOL, atol=TOL)
    _grads_close(jold, jstate, told, tstate)
    assert 1 <= tmet["decode_steps"] <= T
    with pytest.raises(ValueError, match="greedy rollout"):
        trl.SCSTTrainer(tstate.model, ttr.reward,
                        tcfg.RLConfig(num_rollouts=K, baseline="greedy")
                        )._advantage(None, tsam.numpy(), s["vids"], valid)


@pytest.mark.parametrize("stride", [1, 8], ids=["per_step", "stride8"])
def test_greedy_baseline_scst_step_matches_jax(setup, stride):
    """SCST (baseline 'greedy', K=2): the fused decode's greedy lane and
    rollouts (the decode-step kernel per step, or one stride-kernel launch
    per stride, on both sides), their rewards, the advantage, and the
    update."""
    s = setup
    K2 = 2
    cfg = dict(num_rollouts=K2, baseline="greedy", reward_cider_weight=1.0,
               reward_bleu4_weight=0.0)
    jmodel = CaptionModel(ModelConfig(**{**KW, "decode_stride": stride}))
    jstate, tstate = _sgd(s)
    tstate = ttrain.create_train_state(
        _port_model(s["params"], decode_stride=stride), tstate.tx)
    feats = jax.tree.map(jnp.asarray, s["feats"])
    masks = jax.tree.map(jnp.asarray, s["masks"])
    tfeats = {k: _t(v) for k, v in s["feats"].items()}
    tmasks = {k: _t(v) for k, v in s["masks"].items()}
    rng = jax.random.key(23)
    noise = _jax_noise(rng, K2, T, B)
    tgreedy, tsam = trl.make_rl_decode(None, K2)(tstate.model, tfeats,
                                                 tmasks, 0, noise)
    # the two-loop reference gives the same rollouts
    two = trl.make_rl_decode(None, K2, fused=False)(tstate.model, tfeats,
                                                    tmasks, 0, noise)
    assert torch.equal(two[0], tgreedy) and torch.equal(two[1], tsam)
    vocab = Vocab.from_corpus_words(WORDS)
    jtr = SCSTTrainer(jmodel, RewardComputer(vocab, s["gts"]),
                      RLConfig(**cfg))
    ttr = trl.SCSTTrainer(tstate.model, trl.RewardComputer(
        TorchVocab.from_corpus_words(WORDS), s["gts"]), tcfg.RLConfig(**cfg))

    jgreedy, jsam = jtr.decode(jstate.params, feats, masks, rng)
    np.testing.assert_array_equal(tgreedy.numpy(), np.asarray(jgreedy))
    np.testing.assert_array_equal(tsam.numpy(), np.asarray(jsam))
    valid = np.ones((B,), np.float32)
    valid[-1] = 0.0
    jadv, jm_ = jtr._advantage(np.asarray(jgreedy), np.asarray(jsam),
                               s["vids"], valid)
    tadv, tm_ = ttr._advantage(tgreedy.numpy(), tsam.numpy(), s["vids"],
                               valid)
    np.testing.assert_array_equal(tadv, jadv)
    assert tm_ == jm_
    # advantage = (rollout reward - the clip's greedy reward) on valid rows
    r_s = ttr.reward(s["vids"], tsam.numpy().reshape(K2 * B, T))
    r_g = ttr.reward(s["vids"], tgreedy.numpy())
    np.testing.assert_array_equal(
        tadv, (r_s.reshape(K2, B) - r_g[None]) * valid[None])

    jold, told = jstate, {k: v.clone() for k, v in
                          tstate.model.state_dict().items()}
    jstate, jmet = jtr.train_step(jstate, feats, masks, s["vids"], rng,
                                  valid=valid)
    tstate, tmet = ttr.train_step(tstate, tfeats, tmasks, s["vids"], 0,
                                  valid=valid, noise_fn=noise)
    for key in ("reward_mean", "baseline_mean", "advantage_mean"):
        assert tmet[key] == jmet[key]
    np.testing.assert_allclose(tmet["rl_loss"], float(jmet["rl_loss"]),
                               rtol=TOL, atol=TOL)
    _grads_close(jold, jstate, told, tstate)
    assert 1 <= tmet["decode_steps"] <= T
