"""The port's greedy decode, fused greedy-plus-rollouts decode, NPAD and
beam search against the JAX package on converted weights, float32 on the
CPU at a small width (V=97, E=H=16, A=8, T=8); the JAX sampling lanes'
own draws go to the port through ``noise_fn``. Tolerances: tokens exact;
logprobs 2e-5 and beam scores 1e-5 (float32 sums in another order through
the model, the JAX kernel parity tests' bounds); the port's strided and
compacted loops exact against its own per-step loop on the cell module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.config.config import EOS_ID, ModelConfig
from cst_captioning_tpu.decoding import beam_search as jax_beam
from cst_captioning_tpu.decoding import greedy_decode as jax_greedy
from cst_captioning_tpu.decoding.common import (
    gumbel_step_noise,
    rollout_step_keys,
)
from cst_captioning_tpu.decoding.fused import fused_decode as jax_fused
from cst_captioning_tpu.decoding.fused import npad_decode as jax_npad
from cst_captioning_tpu.models import CaptionModel
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch.convert import load_flax_params
from cst_captioning_tpu_torch.decoding import (
    beam_search,
    fused_decode,
    greedy_decode,
    npad_decode,
)
from cst_captioning_tpu_torch.models import CaptionModel as TorchCaptionModel

torch.set_num_threads(1)

TOL = 2e-5
SCORE_TOL = 1e-5
MODAL = (("resnet", 16), ("c3d", 12))
B, F, T, V, K = 6, 6, 8, 97, 2
KW = dict(vocab_size=V, modalities=MODAL, d_embed=16, d_hidden=16, d_att=8,
          encoder="temporal_attention", dropout=0.0, max_len=T, max_frames=F,
          dtype="float32")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    feats = {n: rng.normal(size=(B, F, d)).astype(np.float32)
             for n, d in MODAL}
    lens = np.array([[1], [6], [3], [6], [2], [5]])
    masks = {n: (np.arange(F)[None] < lens).astype(np.float32)
             for n, _ in MODAL}
    xla = CaptionModel(ModelConfig(**KW))
    params = xla.init(jax.random.key(0), jax.tree.map(jnp.asarray, feats),
                      jax.tree.map(jnp.asarray, masks),
                      jnp.zeros((B, T), jnp.int32))
    # EOS-biased so captions end at different steps (the early exits run)
    bias = params["params"]["cell"]["out_proj"]["bias"]
    params["params"]["cell"]["out_proj"]["bias"] = bias.at[EOS_ID].add(2.5)
    return dict(params=params, feats=feats, masks=masks,
                jfeats=jax.tree.map(jnp.asarray, feats),
                jmasks=jax.tree.map(jnp.asarray, masks))


def _jmodel(impl):
    return CaptionModel(ModelConfig(**{**KW, "decode_impl": impl}))


def _tmodel(s, impl, **overrides):
    return load_flax_params(
        TorchCaptionModel(tcfg.ModelConfig(**{**KW, "decode_impl": impl,
                                              **overrides}), device="cpu"),
        jax.tree.map(np.asarray, s["params"]))


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _jax_noise(rng, K_, T_, B_):
    keys = rollout_step_keys(rng, K_, T_)
    return lambda t: torch.from_numpy(np.array(
        gumbel_step_noise(keys[t], (B_, V), jnp.float32)))


# ---- greedy -----------------------------------------------------------------


@pytest.mark.parametrize("min_len", [0, 2])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_greedy_matches_jax(setup, impl, min_len):
    s = setup
    want_tok, want_lp = jax_greedy(_jmodel(impl), s["params"], s["jfeats"],
                                   s["jmasks"], min_len=min_len)
    got_tok, got_lp = greedy_decode(_tmodel(s, impl), _t(s["feats"]),
                                    _t(s["masks"]), min_len=min_len)
    assert got_tok.dtype == torch.int32 and got_tok.shape == (B, T)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp),
                               rtol=TOL, atol=TOL)
    lens = (got_tok.numpy() != 0).sum(-1)
    assert lens.min() < T
    if min_len:
        assert lens.min() > min_len


# ---- the fused greedy + rollouts decode -------------------------------------


@pytest.fixture(scope="module")
def fused_ref(setup):
    """The JAX per-step loop on its cell module: the exactness baseline."""
    s = setup
    rng = jax.random.key(7)
    out = jax_fused(_jmodel("xla"), s["params"], s["jfeats"], s["jmasks"],
                    rng, num_rollouts=K, temperature=0.8, min_len=1,
                    decode_stride=1, compact=False)
    return rng, [np.asarray(x) for x in out]


def _port_fused(s, rng, impl, stride, compact):
    return fused_decode(_tmodel(s, impl), _t(s["feats"]), _t(s["masks"]),
                        num_rollouts=K, temperature=0.8, min_len=1,
                        decode_stride=stride, compact=compact,
                        noise_fn=_jax_noise(rng, K, T, B))


@pytest.mark.parametrize("compact", [False, True], ids=["dense", "compact"])
@pytest.mark.parametrize("stride", [1, 3, 8])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_fused_decode_matches_jax(setup, fused_ref, impl, stride, compact):
    rng, want = fused_ref
    got = _port_fused(setup, rng, impl, stride, compact)
    assert got[0].shape == (B, T) and got[2].shape == (K, B, T)
    for g, w in zip(got[0::2], want[0::2]):
        np.testing.assert_array_equal(g.numpy(), w)
    for g, w in zip(got[1::2], want[1::2]):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)
    lens = (got[2].numpy() != 0).sum(-1)
    assert lens.min() < T and lens.max() == T   # compaction has work


@pytest.mark.parametrize("stride,compact", [(3, False), (3, True), (8, True)])
def test_strided_loop_exact_against_per_step(setup, fused_ref, stride,
                                             compact):
    rng, _ = fused_ref
    base = _port_fused(setup, rng, "xla", 1, False)
    got = _port_fused(setup, rng, "xla", stride, compact)
    for g, b in zip(got, base):
        assert torch.equal(g, b)


def test_fused_decode_kernel_path_matches_jax_kernel(setup):
    """The JAX stride kernel (interpret mode) at stride 8 with compaction,
    against the port's stride at the same settings."""
    s = setup
    rng = jax.random.key(9)
    want = jax_fused(_jmodel("pallas"), s["params"], s["jfeats"],
                     s["jmasks"], rng, num_rollouts=K, temperature=1.0)
    got = fused_decode(_tmodel(s, "pallas"), _t(s["feats"]), _t(s["masks"]),
                       num_rollouts=K, noise_fn=_jax_noise(rng, K, T, B))
    for g, w in zip(got[0::2], want[0::2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[1::2], want[1::2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_npad_matches_jax(setup):
    s = setup
    rng = jax.random.key(3)
    want_tok, want_sc = jax_npad(_jmodel("xla"), s["params"], s["jfeats"],
                                 s["jmasks"], rng, num_lanes=3,
                                 temperature=1.5)
    got_tok, got_sc = npad_decode(_tmodel(s, "xla"), _t(s["feats"]),
                                  _t(s["masks"]), num_lanes=3,
                                  temperature=1.5,
                                  noise_fn=_jax_noise(rng, 3, T, B))
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(got_sc.numpy(), np.asarray(want_sc),
                               rtol=TOL, atol=TOL)
    # the answer is never below the greedy lane
    g_tok, g_lp, _, _ = fused_decode(_tmodel(s, "xla"), _t(s["feats"]),
                                     _t(s["masks"]), num_rollouts=3,
                                     temperature=1.5,
                                     noise_fn=_jax_noise(rng, 3, T, B))
    assert bool((got_sc >= g_lp.sum(-1)).all())


# ---- beam search ------------------------------------------------------------


@pytest.fixture(scope="module")
def beam_ref(setup):
    """JAX beams on the cell module (lanes; token- and score-exact against
    its reference impl), every beam ranked, at each width and penalty."""
    s = setup
    out = {}
    for W in (1, 3, 5):
        for lp in (0.0, 0.7):
            tok, sc = jax_beam(_jmodel("xla"), s["params"], s["jfeats"],
                               s["jmasks"], beam_size=W, min_len=2,
                               length_penalty=lp, return_all=True)
            out[W, lp] = (np.asarray(tok), np.asarray(sc))
    return out


def _port_beam(s, impl, W, lp, return_all, beam_impl):
    return beam_search(_tmodel(s, impl), _t(s["feats"]), _t(s["masks"]),
                       beam_size=W, min_len=2, length_penalty=lp,
                       return_all=return_all, beam_impl=beam_impl)


@pytest.mark.parametrize("return_all", [False, True], ids=["best", "all"])
@pytest.mark.parametrize("lp", [0.0, 0.7])
@pytest.mark.parametrize("impl,beam_impl", [("xla", "lanes"),
                                            ("pallas", "lanes"),
                                            ("xla", "reference")])
@pytest.mark.parametrize("W", [1, 3, 5])
def test_beam_matches_jax(setup, beam_ref, W, impl, beam_impl, lp,
                          return_all):
    want_tok, want_sc = beam_ref[W, lp]
    if not return_all:
        want_tok, want_sc = want_tok[:, 0], want_sc[:, 0]
    tok, sc = _port_beam(setup, impl, W, lp, return_all, beam_impl)
    assert tok.dtype == torch.int32 and sc.dtype == torch.float32
    np.testing.assert_array_equal(tok.numpy(), want_tok)
    np.testing.assert_allclose(sc.numpy(), want_sc, rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    assert (tok.numpy() != 0).sum(-1).min() > 2          # min_len holds


@pytest.mark.parametrize("W", [3, 5])
def test_beam_matches_jax_kernel(setup, W):
    """The JAX lanes on its beam-step kernel (interpret mode) against the
    port's lanes on the beam step's plain version."""
    s = setup
    want_tok, want_sc = jax_beam(_jmodel("pallas"), s["params"], s["jfeats"],
                                 s["jmasks"], beam_size=W, min_len=2,
                                 return_all=True)
    tok, sc = _port_beam(s, "pallas", W, 0.0, True, "lanes")
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(sc.numpy(), np.asarray(want_sc),
                               rtol=SCORE_TOL, atol=SCORE_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_beam_one_is_greedy(setup, impl):
    s = setup
    model = _tmodel(s, impl)
    tok, sc = beam_search(model, _t(s["feats"]), _t(s["masks"]), beam_size=1)
    g_tok, g_lp = greedy_decode(model, _t(s["feats"]), _t(s["masks"]))
    assert torch.equal(tok, g_tok)
    torch.testing.assert_close(sc, g_lp.sum(-1), rtol=TOL, atol=TOL)


def test_beam_matches_brute_force_oracle():
    """On a 6-token vocab at T=3, the beam as wide as the whole candidate
    set finds the best complete caption by enumeration (the scoring of
    tests/test_decoding.py's oracle: PAD continues a finished caption)."""
    Vs, Ts, Bs = 6, 3, 2
    kw = {**KW, "vocab_size": Vs, "max_len": Ts}
    rng = np.random.default_rng(5)
    feats = {n: rng.normal(size=(Bs, F, d)).astype(np.float32)
             for n, d in MODAL}
    masks = {n: np.ones((Bs, F), np.float32) for n, _ in MODAL}
    params = CaptionModel(ModelConfig(**kw)).init(
        jax.random.key(1), jax.tree.map(jnp.asarray, feats),
        jax.tree.map(jnp.asarray, masks), jnp.zeros((Bs, Ts), jnp.int32))
    model = load_flax_params(
        TorchCaptionModel(tcfg.ModelConfig(**kw), device="cpu"),
        jax.tree.map(np.asarray, params))
    tf, tm = _t(feats), _t(masks)
    W = (Vs - 2) ** 2            # every 2-token prefix survives
    tok, sc = beam_search(model, tf, tm, beam_size=W, max_len=Ts)
    enc = model.encode(tf, tm)
    words = range(2, Vs)         # EOS and the real words
    best = np.full((Bs,), -np.inf)
    for seq in np.array(np.meshgrid(*[list(words)] * Ts)).T.reshape(-1, Ts):
        seq = list(seq)
        if EOS_ID in seq:
            seq = seq[:seq.index(EOS_ID) + 1]
        carry, last, total = enc.carry, torch.ones((Bs,), dtype=torch.long), 0
        with torch.no_grad():
            for w in seq:
                carry, logits = model.decode_step(carry, last, enc)
                logits = logits.clone()
                logits[:, 0] = -1e9
                logits[:, 1] = -1e9
                total = total + torch.log_softmax(logits, -1)[:, w].double()
                last = torch.full((Bs,), w, dtype=torch.long)
        best = np.maximum(best, total.numpy())
    np.testing.assert_allclose(sc.numpy(), best, rtol=1e-5, atol=1e-5)
