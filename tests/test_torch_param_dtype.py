"""``ModelConfig.param_dtype="bfloat16"`` in the port, held against the JAX
package on the CPU.

The JAX init cannot draw bfloat16 parameters on the CPU (LAPACK's QR behind
the LSTM's orthogonal init has no bfloat16), so both packages take a seeded
float32 tree (``convert.random_flax_params``) cast to bfloat16, as
``jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)``. The model is
the training slice's (V=97, E=H=16, A=8, T=8, temporal attention, EOS bias
+2), at compute dtype
float32 and bfloat16 and at ``attention_impl`` / ``decode_impl`` "xla"
and "pallas" (the JAX kernels in interpret mode, the port's plain
versions).

Tolerances:
- forward logits: 2e-5 at float32 compute (the float32 parity bound); at
  bfloat16 compute 2^-5 relative and absolute, four bfloat16 ulps of
  values of order 1 (the encoder's one-ulp bound, carried through eight
  bfloat16 LSTM steps and the vocabulary projection). The port's bf16
  model and its float32 model holding the same values: bitwise.
- greedy, sampled and beam-5 tokens, and the services' tokens: equal;
  their logprobs and scores 2e-5 (float32 compute).
- one XE step and one SCST update at float32 compute: the loss 2e-5; the
  grad norm and the parameters bitwise (share 1.0); the Adam moments
  bitwise on at least 0.995 of the elements, and each within 2
  (``mu = 0.1 g``) or 4 (``nu = 0.001 g^2``) bfloat16 steps of the JAX
  one (a one-step gradient difference rounded through those products) or
  within one bfloat16 ulp of its leaf's largest value (2^-8 of it: an
  element whose per-step bfloat16 gradient terms nearly cancel). At bfloat16
  compute the gradients run through bfloat16 arithmetic in another order:
  the loss 2^-7 relative, the grad norm within one bfloat16 step, and the
  moments, which carry the gradient (``mu = 0.1 g`` after one step), by
  ``moments_close``: each leaf's element errors within 2^-4 (``mu``) and
  2^-3 (``nu``) of its largest value, each leaf's relative L2 distance
  within 2^-4 and 2^-3, the whole tree's within 2^-6 and 2^-5 (the
  largest read: 0.029, 0.027 and 0.0084 for ``mu``; a gradient scaled by
  1.05 gives 0.05 over the tree, and is refused). The parameters,
  which Adam's first step moves by about ``lr`` whatever the gradient,
  are held only within that step (``|dp| <= 2 lr (1 + 2^-6) + ulp(p)``)
  and bitwise on at least 0.98 of them.
- the optimizer alone on fixed bfloat16 gradients, and on float32
  gradients of bfloat16 parameters: bitwise against optax run op by op
  (unjitted), for adam, adamw, sgd and rmsprop, clipped and not; the
  moments in the gradients' dtype. A guarded skip widens the moments as
  the JAX guard's select does, values kept.
- checkpoints: bitwise, dtypes kept, both the port's round trip and a JAX
  ``CheckpointManager`` save loaded by the port.
- the gradient bucket plan of the bf16 tree: equal to the JAX plan (the
  data-parallel, chunked, SP and MP steps at bf16:
  ``tests/test_torch_param_dtype_parallel.py``).
- the train and eval CLIs with ``--set model__param_dtype=bfloat16``: a
  resumed XE run bitwise equal to the uninterrupted one, the handoff to
  CST, beam-5 eval of the RL checkpoint, all in bfloat16.
"""

import copy
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.ckpt import CheckpointManager as JaxManager
from cst_captioning_tpu.config.config import (
    EOS_ID,
    ModelConfig,
    TrainConfig,
)
from cst_captioning_tpu.config.config import (
    ExperimentConfig as JaxExperimentConfig,
)
from cst_captioning_tpu.decoding import beam_search as jax_beam
from cst_captioning_tpu.decoding import greedy_decode as jax_greedy
from cst_captioning_tpu.decoding.common import (
    gumbel_step_noise,
    rollout_step_keys,
)
from cst_captioning_tpu.decoding.sample import sample_decode as jax_sample
from cst_captioning_tpu.models import CaptionModel
from cst_captioning_tpu.parallel import comms as jcomms
from cst_captioning_tpu.resilience.guard import (
    guarded_apply_gradients as jax_guard,
)
from cst_captioning_tpu.rl.scst import make_rl_update
from cst_captioning_tpu.serving import CaptionService as JaxCaptionService
from cst_captioning_tpu.serving import ClipRequest as JaxClipRequest
from cst_captioning_tpu.train.schedule import make_optimizer
from cst_captioning_tpu.train.state import TrainState as JaxState
from cst_captioning_tpu.train.steps import make_xe_step
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch import rl as trl
from cst_captioning_tpu_torch import train as ttrain
from cst_captioning_tpu_torch.cli.eval import main as eval_main
from cst_captioning_tpu_torch.cli.train import main as train_main
from cst_captioning_tpu_torch.ckpt import CheckpointManager, load_params
from cst_captioning_tpu_torch.ckpt.checkpoint import load_state, save_state
from cst_captioning_tpu_torch.data import Vocab as TorchVocab
from cst_captioning_tpu_torch.data import make_synthetic_dataset
from cst_captioning_tpu_torch.convert import (
    load_flax_params,
    random_flax_params,
    state_dict_to_flax,
)
from cst_captioning_tpu_torch.decoding import (
    beam_search,
    greedy_decode,
    sample_decode,
)
from cst_captioning_tpu_torch.models import CaptionModel as TorchCaptionModel
from cst_captioning_tpu_torch.ops import stride_weights
from cst_captioning_tpu_torch.parallel import comms
from cst_captioning_tpu_torch.serving import CaptionService, ClipRequest
from cst_captioning_tpu_torch.train.mesh import param_leaves

torch.set_num_threads(1)

TOL = 2e-5
BF16_LOGITS = 2.0 ** -5
MODAL = (("resnet", 16), ("c3d", 12))
B, F, T, V, K = 6, 6, 8, 97, 3
LR = 1e-3
CLIP = 0.1                      # below the step's grad norm: the clip fires
DTYPES = ["float32", "bfloat16"]
IMPLS = ["xla", "pallas"]


def _kw(dtype="float32", impl="xla", **over):
    return dict(vocab_size=V, modalities=MODAL, d_embed=16, d_hidden=16,
                d_att=8, encoder="temporal_attention", dropout=0.0,
                max_len=T, max_frames=F, dtype=dtype, attention_impl=impl,
                decode_impl=impl, **over)


@functools.lru_cache(maxsize=None)
def _jmodel(dtype="float32", impl="xla"):
    return CaptionModel(ModelConfig(**_kw(dtype, impl,
                                          param_dtype="bfloat16")))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    feats = {n: rng.normal(size=(B, F, d)).astype(np.float32)
             for n, d in MODAL}
    lens = np.array([[1], [6], [3], [6], [2], [5]])
    masks = {n: (np.arange(F)[None] < lens).astype(np.float32)
             for n, _ in MODAL}
    # seeded float32 weights in the flax layout (the JAX init's tree),
    # then the whole tree cast to bfloat16
    params = random_flax_params(tcfg.ModelConfig(**_kw()), 0, eos_bias=2.0)
    params = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16),
                          params)
    labels = rng.integers(4, V, size=(B, T)).astype(np.int32)
    mask = (np.arange(T)[None] < np.array([[3], [8], [5], [1], [8], [6]])
            ).astype(np.float32)
    labels = np.where(mask > 0, labels, 0).astype(np.int32)
    samples = rng.integers(3, V, size=(K, B, T)).astype(np.int32)
    ends = rng.integers(1, T + 1, size=(K, B))
    for k in range(K):
        for b in range(B):
            if ends[k, b] < T:
                samples[k, b, ends[k, b] - 1] = EOS_ID
                samples[k, b, ends[k, b]:] = 0
    adv = rng.normal(size=(K, B)).astype(np.float32)
    valid = np.ones((B,), np.float32)
    valid[-1] = 0.0
    return dict(params=params, np_params=jax.tree.map(np.asarray, params),
                feats=feats, masks=masks, labels=labels, mask=mask,
                samples=samples, adv=adv, valid=valid)


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _j(d):
    return jax.tree.map(jnp.asarray, d)


def _pmodel(s, dtype="float32", impl="xla", param_dtype="bfloat16"):
    return load_flax_params(
        TorchCaptionModel(tcfg.ModelConfig(**_kw(dtype, impl,
                                                 param_dtype=param_dtype)),
                          device="cpu"), s["np_params"]).eval()


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if isinstance(
        x, jax.Array) else np.asarray(x, np.float32)


def _steps(a, b):
    """bfloat16 steps between two arrays of bfloat16 values."""
    def order(x):
        bits = (_f32(x).view(np.int32) >> 16).astype(np.int64)
        return np.where(bits < 0, -(bits & 0x7FFF), bits)
    return np.abs(order(a) - order(b))


def _flax(model, tensors):
    return state_dict_to_flax(model.cfg, {n: t for (n, _), t in zip(
        model.named_parameters(), tensors)})


def _pairs(jtree, model, tensors):
    got = dict(jax.tree_util.tree_leaves_with_path(_flax(model, tensors)))
    return [(jax.tree_util.keystr(k), _f32(v), got[k])
            for k, v in jax.tree_util.tree_leaves_with_path(jtree)]


# (mu, nu) bounds: per leaf, element by element over the leaf's largest
# value and as a relative L2 distance, and over the whole tree
ELEM = (2.0 ** -4, 2.0 ** -3)
LEAF_L2 = (2.0 ** -4, 2.0 ** -3)
TREE_L2 = (2.0 ** -6, 2.0 ** -5)
GRAD_NORM = 2.0 ** -8


def moments_close(pairs, which: int = 0) -> tuple[bool, dict]:
    """``pairs`` of (path, reference, other) arrays of one moment
    (``which``: 0 ``mu``, 1 ``nu``) -> (within the bounds of the module
    docstring, the worst element error over its leaf's largest value, the
    worst leaf's and the tree's relative L2 distances)."""
    worst = dict(elem=0.0, leaf_l2=0.0)
    d2 = w2 = 0.0
    for _, w, g in pairs:
        w, g = _f32(w), _f32(g)
        d = np.abs(g - w)
        top = max(float(np.abs(w).max()), 1e-30)
        worst["elem"] = max(worst["elem"], float(d.max()) / top)
        worst["leaf_l2"] = max(worst["leaf_l2"], float(
            np.linalg.norm(d) / max(np.linalg.norm(w), 1e-30)))
        d2 += float(np.sum(d.astype(np.float64) ** 2))
        w2 += float(np.sum(w.astype(np.float64) ** 2))
    worst["tree_l2"] = (d2 / max(w2, 1e-60)) ** 0.5
    ok = (worst["elem"] <= ELEM[which] and worst["leaf_l2"] <= LEAF_L2[which]
          and worst["tree_l2"] <= TREE_L2[which])
    return ok, worst


def _bits(t):
    return t.detach().view(torch.int16) if t.dtype == torch.bfloat16 else t


# ---- the config and the model -------------------------------------------------


def test_param_dtype_config():
    """bfloat16 builds every parameter in bfloat16, float16 is refused as
    the compute dtype is, and a JAX-written bf16 config loads."""
    cfg = tcfg.ModelConfig(**_kw(param_dtype="bfloat16"))
    model = TorchCaptionModel(cfg, device="cpu")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    with pytest.raises(ValueError, match="unsupported param dtype"):
        tcfg.ModelConfig(**_kw(param_dtype="float16"))
    with pytest.raises(ValueError, match="unsupported compute dtype"):
        tcfg.ModelConfig(**_kw(dtype="float16"))
    jexp = JaxExperimentConfig(model=ModelConfig(**_kw(
        param_dtype="bfloat16")))
    got = tcfg.ExperimentConfig.from_json(jexp.to_json())
    assert got.model.param_dtype == "bfloat16"
    # the seeded random tree holds bfloat16 values for a bf16 model
    tree = random_flax_params(cfg, 3)
    leaf = tree["params"]["cell"]["out_proj"]["kernel"]
    assert leaf.dtype == np.float32
    np.testing.assert_array_equal(
        torch.from_numpy(leaf).bfloat16().float().numpy(), leaf)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_logits_match_jax(setup, dtype, impl):
    s = setup
    want = _jmodel(dtype, impl).apply(s["params"], _j(s["feats"]),
                                      _j(s["masks"]), jnp.asarray(s["labels"]))
    model = _pmodel(s, dtype, impl)
    f32 = _pmodel(s, dtype, impl, param_dtype="float32")
    with torch.no_grad():
        got = model(_t(s["feats"]), _t(s["masks"]),
                    torch.from_numpy(s["labels"]).long())
        same = f32(_t(s["feats"]), _t(s["masks"]),
                   torch.from_numpy(s["labels"]).long())
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    tol = TOL if dtype == "float32" else BF16_LOGITS
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
    assert torch.equal(got, same)


# ---- decoding and serving -------------------------------------------------------


def _jax_noise(rng):
    keys = rollout_step_keys(rng, K, T)
    return lambda t: torch.from_numpy(np.array(
        gumbel_step_noise(keys[t], (B, V), jnp.float32)))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_greedy_and_sampled_tokens_match_jax(setup, dtype, impl):
    s = setup
    jm, model = _jmodel(dtype, impl), _pmodel(s, dtype, impl)
    want_tok, want_lp = jax_greedy(jm, s["params"], _j(s["feats"]),
                                   _j(s["masks"]), min_len=1)
    got_tok, got_lp = greedy_decode(model, _t(s["feats"]), _t(s["masks"]),
                                    min_len=1)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    rng = jax.random.key(11)
    want_s, want_slp = jax_sample(jm, s["params"], _j(s["feats"]),
                                  _j(s["masks"]), rng, num_rollouts=K,
                                  temperature=0.8, min_len=2)
    got_s, got_slp = sample_decode(model, _t(s["feats"]), _t(s["masks"]),
                                   num_rollouts=K, temperature=0.8,
                                   min_len=2, noise_fn=_jax_noise(rng))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if dtype == "float32":
        np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got_slp.numpy(), np.asarray(want_slp),
                                   rtol=TOL, atol=TOL)
    lens = (got_s.numpy() != 0).sum(-1)
    assert lens.min() < T < lens.max() + 1


@pytest.mark.parametrize("impl", IMPLS)
def test_beam5_matches_jax(setup, impl):
    s = setup
    want_tok, want_sc = jax_beam(_jmodel("float32", impl), s["params"],
                                 _j(s["feats"]), _j(s["masks"]), beam_size=5,
                                 min_len=2)
    tok, sc = beam_search(_pmodel(s, "float32", impl), _t(s["feats"]),
                          _t(s["masks"]), beam_size=5, min_len=2)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(sc.numpy(), np.asarray(want_sc), rtol=TOL,
                               atol=TOL)


def _requests(cls):
    out = []
    for i, nf in enumerate((1, 6, 3, 6, 2, 5)):
        rng = np.random.default_rng(100 + i)
        out.append(cls(req_id=f"r{i}",
                       feats={n: rng.normal(size=(nf, d)).astype(np.float32)
                              for n, d in MODAL},
                       masks={n: np.ones((nf,), np.float32)
                              for n, _ in MODAL},
                       seed=1000 + i))
    return out


@functools.partial(jax.jit, static_argnums=2)
def _jax_row_noise(seed, ts, k):
    """The JAX service's per-request draws -> [S, K, V]."""
    key = jax.random.key(seed)
    ks = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(k))

    def step(t):
        ks_t = jax.vmap(lambda kk: jax.random.fold_in(kk, t))(ks)
        return gumbel_step_noise(ks_t, (1, V), jnp.float32)[:, 0]

    return jax.vmap(step)(ts)


def _service_noise(seeds, ts, k, v):
    rows = [np.asarray(_jax_row_noise(jnp.int32(sd),
                                      jnp.asarray(ts[:, b], jnp.int32), k))
            for b, sd in enumerate(seeds.tolist())]
    return torch.from_numpy(np.stack(rows, axis=2))


@pytest.mark.parametrize("impl", IMPLS, ids=["composite", "kernel"])
def test_caption_service_matches_jax(setup, impl):
    """Six ragged requests through capacity 2, K=2, stride 4: the kernel
    service (``decode_impl="pallas"``, the stride kernel's plain version
    on float32-packed bf16 weights) and the composite one against the JAX
    service on the same bf16 tree; a publish of a bf16 state dict swaps
    in."""
    s = setup
    kw = dict(capacity=2, num_rollouts=2, stride=4, frame_bucket=2)
    jrep = JaxCaptionService(_jmodel("float32", impl), s["params"],
                             **kw).serve(_requests(JaxClipRequest))
    model = _pmodel(s, "float32", impl)
    svc = CaptionService(model, device="cpu", noise_fn=_service_noise, **kw)
    assert svc.use_kernel == (impl == "pallas")
    rep = svc.serve(_requests(ClipRequest))
    assert rep.completed == 6
    for rid, jres in jrep.results.items():
        res = rep.results[rid]
        np.testing.assert_array_equal(res.tokens, jres.tokens, err_msg=rid)
        np.testing.assert_allclose(res.logprobs, jres.logprobs, rtol=TOL,
                                   atol=TOL, err_msg=rid)
        assert res.caption_ids == jres.caption_ids
    if svc.use_kernel:
        w = svc._weights
        assert w.wo.dtype == torch.float32
        assert torch.equal(w.wo, model.cell.out_proj.weight.float().t())
    assert svc.publish_params(model.state_dict())
    again = svc.serve(_requests(ClipRequest))
    assert svc.param_version == 1
    assert {p.dtype for p in svc.model.parameters()} == {torch.bfloat16}
    for rid, res in again.results.items():
        np.testing.assert_array_equal(res.tokens, rep.results[rid].tokens)


def test_online_rl_on_a_bf16_service(setup):
    """The online learner on a bf16 kernel service: captures, bf16 Adam
    updates and version-stamped publishes that the service swaps in at
    stride boundaries; the served model ends bitwise the learner's."""
    s = setup
    served = _pmodel(s, "float32", "pallas")
    model = copy.deepcopy(served)
    state = ttrain.create_train_state(model, ttrain.make_optimizer(
        tcfg.TrainConfig(lr=LR), 10))
    words = [f"w{i}" for i in range(V - 4)]
    rng = np.random.default_rng(7)
    gts = {f"r{i}": [" ".join(rng.choice(words[:20], 4)) for _ in range(3)]
           for i in range(6)}
    trainer = trl.OnlineSCSTTrainer(
        model, trl.RewardComputer(TorchVocab.from_corpus_words(words), gts),
        tcfg.RLConfig(num_rollouts=2, baseline="greedy", lr=LR,
                      rollout_depth=1, staleness_bound=8,
                      online_batch_size=2, swap_every=1), state)
    svc = CaptionService(served, capacity=2, num_rollouts=2, stride=4,
                         frame_bucket=2, device="cpu")
    trainer.attach(svc)
    report = svc.serve(_requests(ClipRequest))
    trainer.flush()
    assert report.completed == 6 and trainer.version >= 2
    assert svc.param_version == trainer.version
    assert {t.dtype for t in trainer.state.opt_state["mu"]} == \
        {torch.bfloat16}
    for a, b in zip(svc.model.parameters(), trainer.state.model.parameters()):
        assert a.dtype == torch.bfloat16 and torch.equal(_bits(a), _bits(b))
    assert any(not torch.equal(_bits(a), _bits(b)) for a, b in zip(
        served.parameters(), svc.model.parameters()))


# ---- training -------------------------------------------------------------------


def _jax_state(s, jm):
    tx = make_optimizer(TrainConfig(lr=LR, grad_clip=CLIP), 10)
    return JaxState(step=jnp.zeros((), jnp.int32), params=s["params"],
                    opt_state=tx.init(s["params"]), rng=jax.random.key(0),
                    tx=tx, apply_fn=jm.apply)


def _port_state(s, dtype, impl):
    tx = ttrain.make_optimizer(tcfg.TrainConfig(lr=LR, grad_clip=CLIP), 10)
    return ttrain.create_train_state(_pmodel(s, dtype, impl).train(), tx)


def _hold_step(dtype, jstate, jmet, tstate, tmet, key):
    """The step's tolerances (module docstring)."""
    if dtype == "float32":
        np.testing.assert_allclose(tmet[key], float(jmet[key]), rtol=TOL,
                                   atol=TOL)
        assert tmet["grad_norm"] == float(jmet["grad_norm"])
    else:
        np.testing.assert_allclose(tmet[key], float(jmet[key]),
                                   rtol=2.0 ** -7)
        assert _steps(tmet["grad_norm"], float(jmet["grad_norm"])) <= 1
    model = tstate.model
    adam = jstate.opt_state[1][0]
    assert {p.dtype for p in tstate.params} == {torch.bfloat16}
    for m in ("mu", "nu"):
        assert {t.dtype for t in tstate.opt_state[m]} == {torch.bfloat16}
    params = _pairs(jstate.params, model, tstate.params)
    mu = _pairs(adam.mu, model, tstate.opt_state["mu"])
    nu = _pairs(adam.nu, model, tstate.opt_state["nu"])
    if dtype == "float32":
        for path, w, g in params:
            np.testing.assert_array_equal(g, w, err_msg=path)
        for pairs, most in ((mu, 2), (nu, 4)):
            same = []
            for path, w, g in pairs:
                steps = _steps(w, g)
                near = np.abs(g - w) <= 2.0 ** -8 * np.abs(w).max()
                assert ((steps <= most) | near).all(), path
                same.append(steps.ravel() == 0)
            assert np.mean(np.concatenate(same)) >= 0.995
        return
    bitwise = []
    for path, w, g in params:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126)))
                      - 7)
        assert (np.abs(g - w) <= 2 * LR * (1 + 2.0 ** -6) + ulp).all(), path
        bitwise.append(g.ravel() == w.ravel())
    assert np.mean(np.concatenate(bitwise)) >= 0.98
    for which, pairs in enumerate((mu, nu)):
        ok, worst = moments_close(pairs, which)
        assert ok, (which, worst)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_xe_step_matches_jax(setup, dtype, impl):
    """One clipped, guarded XE step with the update ratios on; the ratios
    within 2^-6 relative (the JAX package sums them in bfloat16, the port
    in float32 from the exact bfloat16 differences)."""
    s = setup
    jm = _jmodel(dtype, impl)
    batch = (_j(s["feats"]), _j(s["masks"]), jnp.asarray(s["labels"]),
             jnp.asarray(s["mask"]), jnp.ones((B,), jnp.float32))
    jstate, jmet = make_xe_step(jm, guard=True, stats=True)(
        _jax_state(s, jm), *batch)
    tstate = _port_state(s, dtype, impl)
    tstate, tmet = ttrain.make_xe_step(guard=True, stats=True)(
        tstate, _t(s["feats"]), _t(s["masks"]),
        torch.from_numpy(s["labels"]).long(), torch.from_numpy(s["mask"]),
        torch.ones(B))
    assert tmet["nonfinite"] == float(jmet["nonfinite"]) == 0.0
    assert tmet["grad_norm"] > CLIP
    _hold_step(dtype, jstate, jmet, tstate, tmet, "loss")
    ratios = [k for k in jmet if k.startswith("upd_ratio/")]
    assert sorted(ratios) == sorted(k for k in tmet
                                    if k.startswith("upd_ratio/"))
    for k in ratios:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=2.0 ** -6, err_msg=k)


@pytest.mark.parametrize("dtype,impl", [("float32", "pallas"),
                                        ("bfloat16", "xla")])
def test_scst_update_matches_jax(setup, dtype, impl):
    """One clipped REINFORCE update on fixed rollouts and advantages, at
    the two corners the XE step's grid does not repeat in cost: float32
    compute through the kernels' plain versions, bfloat16 through the
    composite."""
    s = setup
    jm = _jmodel(dtype, impl)
    jstate, jmet = make_rl_update(jm)(
        _jax_state(s, jm), _j(s["feats"]), _j(s["masks"]),
        jnp.asarray(s["samples"]), jnp.asarray(s["adv"]),
        jnp.asarray(s["valid"]))
    tstate, tmet = trl.make_rl_update(None)(
        _port_state(s, dtype, impl), _t(s["feats"]), _t(s["masks"]),
        torch.from_numpy(s["samples"]), torch.from_numpy(s["adv"]),
        torch.from_numpy(s["valid"]))
    _hold_step(dtype, jstate, jmet, tstate, tmet, "rl_loss")


def _optimizer_against_optax(name, clip, grad_dtype):
    """Four updates of bfloat16 parameters on fixed gradients in
    ``grad_dtype`` under the staircase schedule: bitwise to optax op by
    op, the parameters bfloat16, the moments in the gradients' dtype."""
    rng = np.random.default_rng(3)
    shapes = [(7, 5), (5,), (3, 4)]
    params = [rng.normal(size=sh).astype(np.float32) for sh in shapes]
    grads = [[(rng.normal(size=sh) * 0.1).astype(np.float32)
              for sh in shapes] for _ in range(4)]
    cfg = dict(optimizer=name, lr=0.1, lr_decay=0.5, lr_decay_every=1,
               grad_clip=clip, weight_decay=0.01)
    jtx = make_optimizer(TrainConfig(**cfg), steps_per_epoch=1)
    ttx = ttrain.make_optimizer(tcfg.TrainConfig(**cfg), steps_per_epoch=1)
    jp = [jnp.asarray(p).astype(jnp.bfloat16) for p in params]
    tp = [torch.from_numpy(p).bfloat16() for p in params]
    jst, tst = jtx.init(jp), ttx.init(tp)
    jdt, tdt = getattr(jnp, grad_dtype), getattr(torch, grad_dtype)
    for g in grads:
        upd, jst = jtx.update([jnp.asarray(x).astype(jnp.bfloat16)
                               .astype(jdt) for x in g], jst, jp)
        jp = optax.apply_updates(jp, upd)
        upd, tst = ttx.update([torch.from_numpy(x).bfloat16().to(tdt)
                               for x in g], tst, tp)
        with torch.no_grad():
            for p, u in zip(tp, upd):
                p.add_(u)       # TrainState.apply_gradients
        for a, b in zip(jp, tp):
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(b.float().numpy(), _f32(a))
    for m in ("mu", "nu"):
        for t in tst.get(m, []):
            assert t.dtype == tdt


@pytest.mark.parametrize("clip", [0.5, 100.0], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "rmsprop"])
def test_optimizer_matches_optax_bf16(name, clip):
    """bfloat16 gradients: the moments stay bfloat16."""
    _optimizer_against_optax(name, clip, "bfloat16")


@pytest.mark.parametrize("clip", [0.5, 100.0], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "rmsprop"])
def test_optimizer_matches_optax_on_float32_grads(name, clip):
    """float32 gradients of bfloat16 parameters (the data-parallel and
    chunked steps' ``divide_grads``): the moments widen to float32 at the
    first update, as optax's do, and the parameters stay bfloat16."""
    _optimizer_against_optax(name, clip, "float32")


def test_guarded_skip_widens_the_moments_as_jax(setup):
    """A non-finite loss with float32 gradients of the bf16 model: no
    update, and the moments take float32 (the JAX guard selects the old
    state against the widened new one), their values kept."""
    s = setup
    jm = _jmodel()
    jstate = _jax_state(s, jm)
    jgrads = jax.tree.map(lambda x: jnp.ones(x.shape, jnp.float32),
                          s["params"])
    jnew, jbad = jax_guard(jstate, jgrads, jnp.float32(jnp.nan),
                           jnp.float32(1.0))
    state = _port_state(s, "float32", "xla")
    before = [p.detach().clone() for p in state.params]
    state, bad = ttrain.guarded_apply_gradients(
        state, [torch.ones(p.shape) for p in state.params],
        torch.tensor(float("nan")), torch.tensor(1.0))
    assert bad == float(jbad) == 1.0 and state.step == 0
    adam = jnew.opt_state[1][0]
    for m, tree in (("mu", adam.mu), ("nu", adam.nu)):
        assert {str(x.dtype) for x in jax.tree.leaves(tree)} == {"float32"}
        assert {t.dtype for t in state.opt_state[m]} == {torch.float32}
        assert all(not t.any() for t in state.opt_state[m])
    for a, b in zip(before, state.params):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b)


# ---- checkpoints and the gradient wire ------------------------------------------


def test_checkpoint_round_trip_is_bitwise(setup, tmp_path):
    """A stepped bf16 state saves at 2 bytes a parameter and moment
    element and restores bit for bit, dtypes kept; the XE -> RL handoff
    (params only) too."""
    s = setup
    state = _port_state(s, "float32", "xla")
    state.apply_gradients([torch.randn(p.shape, generator=torch.Generator()
                                       .manual_seed(i)).bfloat16()
                           for i, p in enumerate(state.params)])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, 0.5, {"epoch": 1, "global_step": 1})
    with np.load(tmp_path / "latest" / "state.npz") as z:
        arrays = {k: z[k] for k in z.files}
    n = sum(p.numel() for p in state.params)
    floats = [a for k, a in arrays.items() if k.startswith(("params/",
                                                             "opt_state/mu",
                                                             "opt_state/nu"))]
    assert {a.dtype for a in floats} == {np.dtype(np.uint16)}
    assert sum(a.nbytes for a in floats) == 3 * 2 * n
    fresh = _port_state(s, "float32", "xla")
    got, infos = mgr.restore_latest(fresh)
    assert got.step == 1 and got.opt_state["count"] == 1
    for a, b in zip(state.params + state.opt_state["mu"]
                    + state.opt_state["nu"],
                    got.params + got.opt_state["mu"] + got.opt_state["nu"]):
        assert b.dtype == torch.bfloat16 and torch.equal(_bits(a), _bits(b))
    handoff = _pmodel(s, "float32", "xla")
    load_params(str(tmp_path), "latest", handoff)
    for a, b in zip(state.params, handoff.parameters()):
        assert torch.equal(_bits(a), _bits(b))


def test_jax_bf16_checkpoint_loads_bitwise(setup, tmp_path):
    """A JAX TrainState at bf16 after one XE step, written by the JAX
    CheckpointManager (flax msgpack, bfloat16 leaves), into the port."""
    s = setup
    jm = _jmodel()
    batch = (_j(s["feats"]), _j(s["masks"]), jnp.asarray(s["labels"]),
             jnp.asarray(s["mask"]), jnp.ones((B,), jnp.float32))
    js, _ = make_xe_step(jm)(_jax_state(s, jm), *batch)
    JaxManager(str(tmp_path)).save(jax.device_get(js), 0.5,
                                   {"epoch": 1, "global_step": 1})
    state = _port_state(s, "float32", "xla")
    state, _ = load_state(str(tmp_path), "latest", state)
    assert state.step == 1 and state.opt_state["count"] == 1
    adam = js.opt_state[1][0]
    for tree, got in ((js.params, state.params),
                      (adam.mu, state.opt_state["mu"]),
                      (adam.nu, state.opt_state["nu"])):
        assert {t.dtype for t in got} == {torch.bfloat16}
        for path, w, g in _pairs(tree, state.model, got):
            np.testing.assert_array_equal(g, w, err_msg=path)
    # and the port's save of it reads back the same bits
    save_state(str(tmp_path), "port", state)
    again, _ = load_state(str(tmp_path), "port", _port_state(s, "float32",
                                                              "xla"))
    for a, b in zip(state.params + state.opt_state["nu"],
                    again.params + again.opt_state["nu"]):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("kw", [dict(), dict(bucket_mb=0.001),
                                dict(dtype="bf16"), dict(bucket_mb=0.0)],
                         ids=["default", "small", "bf16_wire", "per_leaf"])
def test_bucket_plan_matches_jax_bf16(setup, kw):
    """At ``comm_dtype="f32"`` a bf16 leaf goes on the wire as bf16 (the
    leaf's dtype): wire dtypes, indices and bytes equal the JAX plan."""
    s = setup
    leaves = param_leaves(_pmodel(s))
    assert {lf.dtype for lf in leaves} == {torch.bfloat16}
    want = jcomms.plan_buckets(s["params"], jcomms.CommConfig(**kw))
    got = comms.plan_buckets(leaves, comms.CommConfig(**kw))
    rows = lambda plan: [(tuple(b.indices), str(b.wire_dtype),  # noqa: E731
                          int(b.bytes_on_wire)) for b in plan.buckets]
    assert rows(got) == rows(want)
    assert {b.wire_dtype for b in got.buckets} == {"bfloat16"}
    assert got.bytes_on_wire == 2 * sum(lf.numel for lf in leaves)
    assert comms.ledger(leaves, comms.CommConfig(**kw), 3) == \
        jcomms.ledger(s["params"], jcomms.CommConfig(**kw), 3)


def test_stride_weights_pack_bf16_exactly(setup):
    """The kernels' packed float32 weights of the bf16 model equal the
    float32 model's holding the same values."""
    s = setup
    a = stride_weights(_pmodel(s).cell)
    b = stride_weights(_pmodel(s, param_dtype="float32").cell)
    for name in ("wq", "bq", "v", "wx", "wh", "bg", "wo", "bo", "embt"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == torch.float32 and torch.equal(x, y), name


# ---- the CLIs: train, resume, hand off, evaluate -------------------------------


def test_clis_train_resume_and_evaluate_at_bf16(tmp_path):
    paths = make_synthetic_dataset(str(tmp_path / "data"), num_videos=16,
                                   num_topics=3, vocab_words=20,
                                   modalities={"resnet": 12}, max_frames=4,
                                   seed=13)
    vocab = len(json.load(open(paths["info_json"]))["vocab"])
    common = [
        "--info-json", paths["info_json"],
        "--feature", f"resnet={paths['resnet']}",
        "--set", f"model__vocab_size={vocab}",
        "--set", "model__modalities=(('resnet',12),)",
        "--set", "model__d_embed=12", "--set", "model__d_hidden=12",
        "--set", "model__d_att=8", "--set", "model__max_len=8",
        "--set", "model__max_frames=4", "--set", "model__param_dtype=bfloat16",
        "--set", "data__batch_size=8", "--device", "cpu",
    ]

    def xe(ckpt, epochs, *extra):
        return train_main(["--preset", "msrvtt_xe_attention", *common,
                           "--set", "train__lr=5e-3",
                           "--set", f"train__epochs={epochs}",
                           "--set", f"train__ckpt_dir='{ckpt}'", *extra])

    full = xe(tmp_path / "full", 2)
    assert full.cfg.model.param_dtype == "bfloat16"
    xe(tmp_path / "cut", 1)
    resumed = str(tmp_path / "resumed.jsonl")
    again = xe(tmp_path / "cut", 2, "--set", "train__resume='auto'",
               "--log-jsonl", resumed)
    events = [json.loads(line) for line in open(resumed)]
    assert [e for e in events if e["event"] == "resume"]
    assert len([e for e in events if e["event"] == "xe_epoch"]) == 1
    for name in ("mu", "nu"):
        assert {t.dtype for t in again.state.opt_state[name]} == \
            {torch.bfloat16}
    for a, b in zip(full.state.params + full.state.opt_state["nu"],
                    again.state.params + again.state.opt_state["nu"]):
        assert a.dtype == torch.bfloat16 and torch.equal(_bits(a), _bits(b))
    log = str(tmp_path / "rl.jsonl")
    rl = train_main(["--preset", "msrvtt_scst", *common, "--skip-xe",
                     "--set", f"rl__init_from='{tmp_path / 'full'}'",
                     "--set", "rl__epochs=1", "--set", "rl__num_rollouts=3",
                     "--log-jsonl", log,
                     "--set", f"train__ckpt_dir='{tmp_path / 'rl'}'"])
    events = [json.loads(line) for line in open(log)]
    assert [e for e in events if e["event"] == "handoff"]
    assert rl.rl_epochs == 1
    assert {p.dtype for p in rl.state.params} == {torch.bfloat16}
    # the decoupled topology (the actor/learner ring) from the same start
    ring = train_main(["--preset", "msrvtt_scst", *common, "--skip-xe",
                       "--set", f"rl__init_from='{tmp_path / 'full'}'",
                       "--set", "rl__epochs=1", "--set", "rl__num_rollouts=3",
                       "--set", "train__rl_topology='decoupled'",
                       "--set", "rl__rollout_depth=3",
                       "--set", "rl__staleness_bound=1",
                       "--set", f"train__ckpt_dir='{tmp_path / 'ring'}'"])
    assert ring.rl_epochs == 1
    assert {t.dtype for t in ring.state.params + ring.state.opt_state["nu"]
            } == {torch.bfloat16}
    result = eval_main(["--preset", "msrvtt_eval_beam5", *common,
                        "--ckpt-dir", str(tmp_path / "rl"), "--ckpt-name",
                        "latest", "--split", "test",
                        "--set", "eval__max_len=8",
                        "--results-json", str(tmp_path / "results.json")])
    assert result["captions"]
    assert all(np.isfinite(v) for v in result["metrics"].values())
