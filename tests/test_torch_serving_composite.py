"""The port's composite serving stride (``decode_impl="xla"``, every
preset's default) on the CPU, held against the JAX CaptionService's XLA
scan stride on the same seeded inputs.

The tiny float32 model of ``tests/test_torch_serving.py`` with +0.2 on the
EOS bias (greedy captions of 1 to 12 tokens, so the greedy-only lanes
free at different strides). The JAX service's own Gumbel draws go into the
port's service through ``noise_fn``. Tolerances: tokens, NPAD lanes,
captions and versions exact; logprobs within 2e-5 (the serving slice's
TOL). Covered: K=2, per-row min_len, greedy-only lanes (K=0) and a
tempered K=3 against the JAX service; a request mid-flight equal to
itself alone, bit for bit; the mid-flight hot swap against the JAX one;
drains replayed bit for bit (the port's snapshot onto a grown service, and
a JAX composite service's snapshot in the port); grow_capacity with live
lanes; ``static_batch_serve``; ``attention_impl="pallas"`` (kernel 1's
plain version on the CPU) against ``"xla"``; the online learner on a
composite service against the JAX one; the preset's own model; the
refusals with the JAX messages; ``stride_cost`` and the counters.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
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
from cst_captioning_tpu.models import CaptionModel
from cst_captioning_tpu.rl import OnlineSCSTTrainer as JaxOnline
from cst_captioning_tpu.rl.rewards import RewardComputer
from cst_captioning_tpu.serving import CaptionService as JaxCaptionService
from cst_captioning_tpu.serving import ClipRequest as JaxClipRequest
from cst_captioning_tpu.serving import load_snapshot as jax_load_snapshot
from cst_captioning_tpu.serving import static_batch_serve as jax_static_serve
from cst_captioning_tpu.train.schedule import make_optimizer
from cst_captioning_tpu.train.state import TrainState as JaxState
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch import obs
from cst_captioning_tpu_torch import rl as trl
from cst_captioning_tpu_torch import train as ttrain
from cst_captioning_tpu_torch.convert import load_flax_params, state_dict_to_flax
from cst_captioning_tpu_torch.data import Vocab as TorchVocab
from cst_captioning_tpu_torch.models import CaptionModel as TorchCaptionModel
from cst_captioning_tpu_torch.obs.flops import serving_bank_bytes_per_stride
from cst_captioning_tpu_torch.ops import attention as attention_ops
from cst_captioning_tpu_torch.ops import decode_stride
from cst_captioning_tpu_torch.presets import get_preset
from cst_captioning_tpu_torch.serving import (
    CaptionService,
    ClipRequest,
    load_snapshot,
    static_batch_serve,
)

torch.set_num_threads(1)

MODAL = (("resnet", 16),)
T = 12
MAX_F = 8
V = 97
TOL = 2e-5
KW = dict(vocab_size=V, modalities=MODAL, d_embed=16, d_hidden=16, d_att=8,
          encoder="temporal_attention", dropout=0.0, max_len=T,
          max_frames=MAX_F, dtype="float32", decode_stride=4)
WORDS = [f"w{i}" for i in range(V - 4)]
LR = 0.1


def _tmodel(params, **overrides):
    return load_flax_params(
        TorchCaptionModel(tcfg.ModelConfig(**{**KW, **overrides}),
                          device="cpu"),
        jax.tree.map(np.asarray, params)).eval()


@pytest.fixture(scope="module")
def setup():
    jmodel = CaptionModel(ModelConfig(**KW))
    assert jmodel.cfg.decode_impl == "xla"
    rng = np.random.default_rng(0)
    params = jmodel.init(
        jax.random.key(0),
        {"resnet": jnp.asarray(rng.normal(size=(1, MAX_F, 16)), jnp.float32)},
        {"resnet": jnp.ones((1, MAX_F), jnp.float32)},
        jnp.zeros((1, T), jnp.int32),
    )
    # greedy captions of several lengths: the greedy lane ends at steps
    # 1 to 12 across the requests
    bias = params["params"]["cell"]["out_proj"]["bias"]
    params["params"]["cell"]["out_proj"]["bias"] = bias.at[EOS_ID].add(0.2)
    # a second version whose captions differ: one output logit raised
    p2 = jax.tree.map(lambda x: x, params)
    p2["params"]["cell"]["out_proj"]["bias"] = (
        params["params"]["cell"]["out_proj"]["bias"].at[5].add(3.0))
    # the JAX swap test's versions: +2 on the init's EOS bias (lanes end
    # at different strides, so requests complete one by one), then one
    # output logit raised
    swap = [jax.tree.map(lambda x: x, params) for _ in range(2)]
    for i, p in enumerate(swap):
        p["params"]["cell"]["out_proj"]["bias"] = bias.at[EOS_ID].add(
            1.8).at[5].add(3.0 * i)
    gts = {f"r{i}": [" ".join(rng.choice(WORDS[:12], rng.integers(2, 6)))
                     for _ in range(4)] for i in range(8)}
    return dict(jmodel=jmodel, params=params, p2=p2, gts=gts, swap=swap,
                tmodel=_tmodel(params), tmodel2=_tmodel(p2),
                tswap=[_tmodel(p) for p in swap])


def _requests(frames=(1, 8, 3, 8, 2, 5), seed0=1000, cls=ClipRequest,
              prefix="r"):
    out = []
    for i, F in enumerate(frames):
        rng = np.random.default_rng(100 + i)
        out.append(cls(
            req_id=f"{prefix}{i}",
            feats={"resnet": rng.normal(size=(F, 16)).astype(np.float32)},
            masks={"resnet": np.ones((F,), np.float32)},
            seed=seed0 + i,
        ))
    return out


@functools.partial(jax.jit, static_argnums=2)
def _jax_row_noise(seed, ts, K):
    """The JAX service's per-request draws: gumbel(fold_in(fold_in(
    key(seed), k), t), (1, V)) for local steps ts [S] -> [S, K, V]."""
    key = jax.random.key(seed)
    ks = jax.vmap(lambda k: jax.random.fold_in(key, k))(jnp.arange(K))

    def step(t):
        ks_t = jax.vmap(lambda kk: jax.random.fold_in(kk, t))(ks)
        return gumbel_step_noise(ks_t, (1, V), jnp.float32)[:, 0]

    return jax.vmap(step)(ts)


def jax_noise(seeds, ts, K, v):
    assert v == V
    if K == 0:
        return torch.zeros((ts.shape[0], 0, ts.shape[1], V))
    rows = [np.asarray(_jax_row_noise(jnp.int32(s),
                                      jnp.asarray(ts[:, b], jnp.int32), K))
            for b, s in enumerate(seeds.tolist())]
    return torch.from_numpy(np.stack(rows, axis=2))


def _service(tmodel, **kw):
    base = dict(capacity=2, num_rollouts=2, stride=4, frame_bucket=2,
                device="cpu", noise_fn=jax_noise)
    return CaptionService(tmodel, **{**base, **kw})


def _jax_service(s, params=None, **kw):
    base = dict(capacity=2, num_rollouts=2, stride=4, frame_bucket=2)
    return JaxCaptionService(s["jmodel"], s["params"] if params is None
                             else params, **{**base, **kw})


def _assert_match(got, want, rids=None):
    for rid in rids or want:
        g, w = got[rid], want[rid]
        np.testing.assert_array_equal(g.tokens, w.tokens, err_msg=rid)
        np.testing.assert_allclose(g.logprobs, w.logprobs, rtol=TOL,
                                   atol=TOL, err_msg=rid)
        assert g.best_lane == w.best_lane and g.caption_ids == w.caption_ids
        assert g.param_version == w.param_version


def _assert_bitwise(got, want, rids=None):
    for rid in rids or want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens,
                                      err_msg=rid)
        np.testing.assert_array_equal(got[rid].logprobs, want[rid].logprobs,
                                      err_msg=rid)


def _drain_after(svc, n):
    """feedback: drain once the n-th completion is recorded."""
    seen = []

    def feedback(req, result, version):
        seen.append(req.req_id)
        if len(seen) == n:
            svc.drain("test")

    svc._feedback = feedback


# ---- the composite stride against the JAX service ---------------------------


@pytest.mark.parametrize("K,min_len,temperature", [
    (2, 0, 1.0), (2, 3, 1.0), (0, 0, 1.0), (3, 0, 1.3)],
    ids=["k2", "k2_min_len3", "greedy_only", "k3_temp1.3"])
def test_composite_matches_jax_service(setup, K, min_len, temperature):
    """Capacity 2, six ragged requests: most take lanes freed mid-flight.
    Every lane's tokens, the NPAD pick and the caption equal the JAX
    service's; logprobs within TOL; no stride kernel launches."""
    s = setup
    kw = dict(num_rollouts=K, min_len=min_len, temperature=temperature)
    jrep = _jax_service(s, **kw).serve(_requests(cls=JaxClipRequest))
    svc = _service(s["tmodel"], **kw)
    assert svc.paged is False and svc.G == 1 + K
    decode_stride.reset_launches()
    rep = svc.serve(_requests())
    assert rep.completed == 6 and rep.strides == jrep.strides
    assert decode_stride.fused_decode_stride.launches == 0
    assert decode_stride.fused_decode_stride_paged.launches == 0
    _assert_match(rep.results, jrep.results)
    lens = np.stack([(r.tokens != 0).sum(axis=1)
                     for r in rep.results.values()])   # [requests, G]
    assert lens.shape == (6, 1 + K)
    assert len(set(lens[:, 0].tolist())) > 1     # greedy lanes vary
    if min_len:
        assert (lens >= min_len + 1).all()       # no EOS before step 3
    assert svc.bank.pages_in_use == 0 and len(svc._free_slots) == 2


@pytest.mark.parametrize("K", [2, 0], ids=["k2", "greedy_only"])
def test_composite_midflight_equals_alone(setup, K):
    """Per-request determinism with the port's own counter noise (its
    [S, 0, B, V] draw at K=0) and a per-row min_len: each request served
    among others equals it served alone at the same capacity, bit for
    bit."""
    s = setup
    reqs = _requests(seed0=2000)
    kw = dict(noise_fn=None, min_len=2, num_rollouts=K)
    rep = _service(s["tmodel"], **kw).serve(reqs)
    for req in reqs:
        alone = _service(s["tmodel"], **kw).serve([req]).results
        _assert_bitwise(rep.results, alone, [req.req_id])
    lens = [int((r.tokens != 0).sum()) for r in rep.results.values()]
    assert min(lens) < max(lens)


# ---- the serving lifecycle on a composite service ----------------------------


@pytest.mark.parametrize("K", [2, 0], ids=["k2", "greedy_only"])
def test_composite_hot_swap_matches_jax(setup, K):
    """The JAX ``test_hot_param_swap_midflight_parity`` scenario (its
    versions, EOS +2 then one logit raised, at K=2) on both packages: a
    publish from the first completion lands at the next stride boundary,
    and every request matches the JAX service under the same pinned
    version; replayed alone under that version it is bitwise itself. At
    K=0 the greedy lanes end one request at a time, so strides run with
    both versions live, once per version with the other's lanes frozen."""
    s = setup
    if K:
        jparams, tmodels = s["swap"], s["tswap"]
    else:
        jparams, tmodels = (s["params"], s["p2"]), (s["tmodel"], s["tmodel2"])
    jsvc = _jax_service(s, params=jparams[0], num_rollouts=K)
    jpub = []

    def jfeedback(req, result, version):
        if not jpub:
            jpub.append(jsvc.publish_params(jparams[1], version=1))

    jsvc._feedback = jfeedback
    jrep = jsvc.serve(_requests(cls=JaxClipRequest))

    svc = _service(tmodels[0], num_rollouts=K)
    pub, live = [], []

    def feedback(req, result, version):
        if not pub:
            pub.append(svc.publish_params(tmodels[1], version=1))

    svc._feedback = feedback
    run_stride = svc._run_stride

    def counted(report, now):
        live.append(len({t.param_version for t in svc._inflight.values()}))
        run_stride(report, now)

    svc._run_stride = counted
    rep = svc.serve(_requests())
    assert pub == jpub == [True]
    if not K:
        assert max(live) == 2
    versions = {r: res.param_version for r, res in rep.results.items()}
    assert set(versions.values()) == {0, 1}
    _assert_match(rep.results, jrep.results)
    assert svc._old_versions == {} and jsvc._old_params == {}
    assert svc._weights is None
    reqs = {r.req_id: r for r in _requests()}
    for rid, v in versions.items():
        alone = _service(tmodels[v], num_rollouts=K).serve([reqs[rid]])
        _assert_bitwise(rep.results, alone.results, [rid])


def test_composite_drain_replays_bitwise(setup, tmp_path):
    """A drain after the second completion snapshots the lanes in flight
    and the queue; ``load_snapshot`` onto a capacity-1 service grown to 2
    replays them, and drained plus replayed equal the undrained serve bit
    for bit."""
    s = setup
    base = _service(s["tmodel"], min_len=2).serve(_requests())
    snap = str(tmp_path / "drain")
    svc = _service(s["tmodel"], min_len=2)
    _drain_after(svc, 2)
    drained = svc.serve(_requests(), snapshot_dir=snap)
    assert drained.drained and drained.completed == 2
    assert svc.bank.pages_in_use == 0 and not svc._inflight
    regrown = _service(s["tmodel"], capacity=1, min_len=2)
    restored = load_snapshot(snap, service=regrown, grow_to=2)
    assert len(restored) == 4 and regrown.B == 2
    replay = regrown.serve()
    union = {**drained.results, **replay.results}
    assert set(union) == set(base.results)
    _assert_bitwise(union, base.results)


def test_jax_composite_snapshot_replays_in_port(setup, tmp_path):
    """A JAX composite service's snapshot (the same layout) replays in the
    port: the port's replay matches the JAX service's replay of it."""
    s = setup
    snap = str(tmp_path / "jax_drain")
    jsvc = _jax_service(s, min_len=2)
    _drain_after(jsvc, 2)
    drained = jsvc.serve(_requests(cls=JaxClipRequest), snapshot_dir=snap)
    assert drained.drained and 0 < drained.completed < 6
    jrep = _jax_service(s, min_len=2)
    jax_load_snapshot(snap, service=jrep)
    jreplay = jrep.serve(())
    svc = _service(s["tmodel"], min_len=2)
    restored = load_snapshot(snap, service=svc)
    assert [r.req_id for r in restored] == [
        r.req_id for r in jax_load_snapshot(snap)]
    replay = svc.serve()
    assert set(replay.results) == set(jreplay.results)
    assert set(replay.results) | set(drained.results) == {
        f"r{i}" for i in range(6)}
    _assert_match(replay.results, jreplay.results)


def test_composite_grow_capacity_with_live_lanes_matches_jax(setup):
    s = setup
    first = dict(frames=(1, 8, 3), seed0=1000)
    second = dict(frames=(8, 2, 5, 4), seed0=2000, prefix="g")
    jsvc = _jax_service(s, num_rollouts=0)
    jsvc.serve(_requests(cls=JaxClipRequest, **first))
    jsvc.grow_capacity(4)
    jrep = jsvc.serve(_requests(cls=JaxClipRequest, **second))
    svc = _service(s["tmodel"], num_rollouts=0)
    svc.serve(_requests(**first))
    pages, width = svc.bank.num_pages, svc.table_width
    svc.grow_capacity(4)
    assert svc.B == 4 and svc.bank.num_pages == pages + 2 * width
    assert tuple(svc._lanes.token.shape) == (1, 4)
    rep = svc.serve(_requests(**second))
    assert rep.completed == 4
    _assert_match(rep.results, jrep.results)
    with pytest.raises(ValueError, match="only grows"):
        svc.grow_capacity(2)


def test_static_batch_serve_composite_matches_jax(setup):
    """The static-batching policy on the composite model with min_len and
    the JAX batch draws fed in: every lane equal to the JAX policy's."""
    s = setup
    jrep = jax_static_serve(s["jmodel"], s["params"],
                            _requests(cls=JaxClipRequest), capacity=4,
                            num_rollouts=2, min_len=3, service_seed=3)

    def noise_fn(batch):
        keys = rollout_step_keys(jax.random.fold_in(jax.random.key(3),
                                                    batch), 2, T)
        return lambda t: torch.from_numpy(np.array(
            gumbel_step_noise(keys[t], (4, V), jnp.float32)))

    rep = static_batch_serve(s["tmodel"], _requests(), capacity=4,
                             num_rollouts=2, min_len=3, noise_fn=noise_fn,
                             device="cpu")
    assert rep.completed == jrep.completed == 6
    _assert_match(rep.results, jrep.results)


# ---- kernel 1 on the composite stride -----------------------------------------


def test_composite_attention_kernel_matches_xla(setup):
    """``attention_impl="pallas"``: the decode cell's attention goes
    through ``ops.attention.fused_additive_attention`` (its plain version
    on CPU tensors, so no launch); tokens equal to ``"xla"``'s, logprobs
    within TOL."""
    s = setup
    pal = _tmodel(s["params"], attention_impl="pallas")
    calls = []
    real = attention_ops.fused_additive_attention

    def counted(q, *args):
        calls.append(tuple(q.shape))
        return real(q, *args)

    reqs = _requests(seed0=3000)
    want = _service(s["tmodel"], noise_fn=None).serve(reqs)
    attention_ops.fused_additive_attention.launches = 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention_ops, "fused_additive_attention", counted)
        svc = _service(pal, noise_fn=None)
        got = svc.serve(reqs)
    assert real.launches == 0
    # once a lane a step, over the whole capacity
    assert len(calls) == got.strides * svc.S * svc.G
    assert set(calls) == {(2, KW["d_att"])}
    _assert_match(got.results, want.results)


# ---- the online learner on a composite service --------------------------------


def _rl(**kw):
    base = dict(num_rollouts=2, baseline="greedy", lr=LR, rollout_depth=1,
                staleness_bound=8, online_batch_size=2, swap_every=1)
    return {**base, **kw}


def test_online_update_on_composite_matches_jax(setup):
    """The JAX closed loop (``tests/test_rl_online.py``) against the
    port's: both learners attached to composite services, six requests,
    batches of 2, a publish after each update. The served results, the
    versions they pinned, the learner's history and its params agree."""
    s = setup
    tx = make_optimizer(TrainConfig(optimizer="sgd", lr=LR, grad_clip=0.0,
                                    lr_decay_every=0), 10)
    params = s["params"]
    jstate = JaxState(step=jnp.zeros((), jnp.int32), params=params,
                      opt_state=tx.init(params), rng=jax.random.key(0),
                      tx=tx, apply_fn=s["jmodel"].apply)
    jtr = JaxOnline(s["jmodel"], RewardComputer(
        Vocab.from_corpus_words(WORDS), s["gts"]),
        RLConfig(enabled=True, **_rl()), jstate)
    jsvc = _jax_service(s)
    jtr.attach(jsvc)
    jrep = jsvc.serve(_requests(cls=JaxClipRequest))
    jtr.flush()

    served = _tmodel(params)
    model = copy.deepcopy(served)
    state = ttrain.create_train_state(model, ttrain.make_optimizer(
        tcfg.TrainConfig(optimizer="sgd", lr=LR, grad_clip=0.0,
                         lr_decay_every=0), 10))
    ttr = trl.OnlineSCSTTrainer(model, trl.RewardComputer(
        TorchVocab.from_corpus_words(WORDS), s["gts"]),
        tcfg.RLConfig(**_rl()), state)
    svc = _service(served)
    ttr.attach(svc)
    rep = svc.serve(_requests())
    ttr.flush()

    assert ttr.version == jtr.version == 3 and svc.param_version == 3
    assert ttr.last_applied == jtr.last_applied
    assert ttr.last_staleness == jtr.last_staleness
    assert {r.param_version for r in rep.results.values()} > {0}
    _assert_match(rep.results, jrep.results)
    for a, b in zip(jtr.history, ttr.history):
        assert b["param_version"] == a["param_version"]
        for key in ("reward_mean", "baseline_mean", "advantage_mean"):
            assert b[key] == pytest.approx(a[key], abs=TOL, rel=TOL)
        np.testing.assert_allclose(b["rl_loss"], float(a["rl_loss"]),
                                   rtol=TOL, atol=TOL)
    want = jax.tree_util.tree_leaves_with_path(jtr.state.params)
    got = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(
        model.cfg, ttr.state.model.state_dict())))
    for path, leaf in want:
        np.testing.assert_allclose(got[path], np.asarray(leaf), rtol=TOL,
                                   atol=TOL, err_msg=str(path))


# ---- the preset's model, refusals, cost --------------------------------------


def test_preset_model_serves_on_the_composite_path():
    """The port's ``msrvtt_xe_attention`` model, unmodified (decode_impl
    and attention_impl "xla", bfloat16 compute, full width), serves on the
    CPU: captions of the expected shape, finite logprobs."""
    cfg = get_preset("msrvtt_xe_attention").model
    assert cfg.decode_impl == "xla" and cfg.attention_impl == "xla"
    torch.manual_seed(0)
    model = TorchCaptionModel(cfg, device="cpu").eval()
    svc = CaptionService(model, capacity=2, num_rollouts=1, stride=2,
                         max_len=4, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [ClipRequest(
        f"p{i}",
        {n: rng.normal(size=(F, d)).astype(np.float32)
         for n, d in cfg.modalities},
        {n: np.ones((F,), np.float32) for n, _ in cfg.modalities}, seed=i)
        for i, F in enumerate((3, 7, 2))]
    rep = svc.serve(reqs)
    assert rep.completed == 3 and svc.paged is False
    for res in rep.results.values():
        assert res.tokens.shape == (2, 4)
        assert np.isfinite(res.logprobs).all() and (res.logprobs <= 0).all()
        assert ((res.tokens >= 0) & (res.tokens < cfg.vocab_size)).all()


def _message(fn):
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


def test_refusals_match_jax(setup):
    """min_len > 0 and num_rollouts < 1 are refused only with the stride
    kernel, paged=True only without it, each with the JAX message; the
    composite path serves both."""
    s = setup
    jpal = CaptionModel(ModelConfig(**KW, decode_impl="pallas"))
    tpal = _tmodel(s["params"], decode_impl="pallas")
    for kw in (dict(min_len=2), dict(num_rollouts=0)):
        assert _message(lambda: CaptionService(tpal, device="cpu", **kw)) \
            == _message(lambda: JaxCaptionService(jpal, s["params"], **kw))
    assert _message(lambda: _service(s["tmodel"], paged=True)) == _message(
        lambda: _jax_service(s, paged=True))
    assert "dense-bank footprint" in _message(
        lambda: _service(s["tmodel"], page_size=2, num_pages=40))
    assert _service(s["tmodel"], min_len=2, num_rollouts=0).paged is False
    assert CaptionService(tpal, device="cpu").paged is True


def test_composite_stride_cost_and_counters(setup):
    """``stride_cost`` counts the composite stride's bank traffic (the
    gather's read and write, then one read a lane a step) and its FLOPs;
    the stride counters count it; ``serving.gather_bytes_avoided`` and
    encode-ahead staging stay with the paged kernel path."""
    s = setup
    obs.REGISTRY.reset()
    svc = _service(s["tmodel"], page_size=2)
    assert svc.stride_cost() is None
    rep = svc.serve(_requests())
    cost = svc.stride_cost()
    bank = serving_bank_bytes_per_stride(
        2, svc.table_width * 2, KW["d_embed"], KW["d_att"], 4, paged=True)
    assert cost["backend"] == "analytic"
    assert cost["bytes_accessed"] == (2 + svc.G * svc.S) * bank
    assert cost["flops"] == 2 * svc.G * svc.S * svc._tok_flops
    snap = obs.snapshot()["counters"]
    assert snap["serving.strides"] == rep.strides
    assert snap["flops.serving.stride"] > 0
    assert snap.get("serving.gather_bytes_avoided", 0) == 0
    assert snap.get("serving.requests_staged", 0) == 0
    obs.REGISTRY.reset()
