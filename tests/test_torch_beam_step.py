"""The port's beam step (ops/beam_step.py, its plain version on the CPU)
against the JAX package's fused_beam_step (its Pallas kernel in interpret
mode) and its plain composite ``_reference_beam_topk``, on converted
weights, for 1 and 2 LSTM layers, beam widths 1 and 4, about 30% finished
lanes, three (t, min_len) regimes and float32 and bfloat16 banks.
Tolerances, those of the JAX kernel's own parity test: flat candidate ids
equal, scores within 1e-5, the carry within 2e-6 (both compute in
float32). The CUDA kernel is held against the plain version in
tests/test_torch_cuda.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.config.config import ModelConfig
from cst_captioning_tpu.models import CaptionModel
from cst_captioning_tpu.models.captioner import CaptionModel as CM
from cst_captioning_tpu.ops.decode_pallas import (  # graftlint: disable=GL008
    _reference_beam_topk,
)
from cst_captioning_tpu.ops.decode_pallas import (  # graftlint: disable=GL008
    fused_beam_step as jax_beam_step,
)
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch.convert import load_flax_params
from cst_captioning_tpu_torch.models import CaptionModel as TorchCaptionModel
from cst_captioning_tpu_torch.ops import beam_step_plain, stride_weights
from cst_captioning_tpu_torch.ops.beam_step import (
    fused_beam_step,
    fused_beam_step_,
)
from cst_captioning_tpu_torch.ops.decode_step import (
    stack_carry,
    unstack_carry,
)

torch.set_num_threads(1)

SCORE_TOL = 1e-5
CARRY_TOL = 2e-6
MODAL = (("resnet", 16), ("c3d", 12))
B, F, V, H = 5, 6, 97, 16


@pytest.fixture(scope="module", params=[1, 2], ids=["L1", "L2"])
def setup(request):
    kw = dict(vocab_size=V, modalities=MODAL, d_embed=16, d_hidden=H,
              d_att=8, encoder="temporal_attention", dropout=0.0, max_len=8,
              max_frames=F, dtype="float32", num_layers=request.param)
    jmodel = CaptionModel(ModelConfig(**kw))
    rng = np.random.default_rng(request.param)
    feats = {n: rng.normal(size=(B, F, d)).astype(np.float32)
             for n, d in MODAL}
    lens = np.array([[1], [6], [3], [6], [2]])
    masks = {n: (np.arange(F)[None] < lens).astype(np.float32)
             for n, _ in MODAL}
    params = jmodel.init(jax.random.key(request.param),
                         jax.tree.map(jnp.asarray, feats),
                         jax.tree.map(jnp.asarray, masks),
                         jnp.zeros((B, 8), jnp.int32))
    enc = jmodel.apply(params, jax.tree.map(jnp.asarray, feats),
                       jax.tree.map(jnp.asarray, masks), method=CM.encode)
    tmodel = load_flax_params(
        TorchCaptionModel(tcfg.ModelConfig(**kw), device="cpu"),
        jax.tree.map(np.asarray, params))
    return params, enc, tmodel


def _inputs(enc, W, seed):
    rng = np.random.default_rng(seed)
    carry = tuple(
        (np.asarray(c)[None] + rng.normal(scale=0.01, size=(W,) + c.shape),
         np.asarray(h)[None] + rng.normal(scale=0.01, size=(W,) + h.shape))
        for c, h in enc.carry)
    carry = tuple((c.astype(np.float32), h.astype(np.float32))
                  for c, h in carry)
    token = rng.integers(1, V, size=(W, B)).astype(np.int32)
    finished = rng.random(size=(W, B)) < 0.3
    scores = rng.normal(scale=2.0, size=(W, B)).astype(np.float32)
    return carry, token, finished, scores


def _torch(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("bank", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,min_len", [(0, 0), (1, 3), (4, 3)])
@pytest.mark.parametrize("W", [1, 4])
def test_plain_matches_jax_kernel_and_composite(setup, W, t, min_len, bank):
    params, enc, tmodel = setup
    carry, token, finished, scores = _inputs(enc, W, 3 + t)
    jd = jnp.dtype(bank)
    mem, proj = enc.memory.astype(jd), enc.memory_proj.astype(jd)
    cell = params["params"]["cell"]
    jargs = (cell, jax.tree.map(jnp.asarray, carry), jnp.asarray(token),
             jnp.asarray(finished), jnp.asarray(scores), mem, proj,
             enc.memory_mask)
    kw = dict(t=jnp.int32(t), min_len=min_len)
    outs = {"kernel": jax_beam_step(*jargs, **kw),
            "composite": _reference_beam_topk(*jargs, **kw)}
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[bank]
    tcarry, tsc, tfl = fused_beam_step(
        tmodel.cell, tuple((_torch(c), _torch(h)) for c, h in carry),
        _torch(token), _torch(finished), _torch(scores),
        _torch(mem.astype(jnp.float32), td),
        _torch(proj.astype(jnp.float32), td), _torch(enc.memory_mask),
        t=t, min_len=min_len)
    assert tsc.shape == (B, W) and tsc.dtype == torch.float32
    assert tfl.dtype == torch.int32
    for name, (jc, jsc, jfl) in outs.items():
        np.testing.assert_array_equal(tfl.numpy(), np.asarray(jfl),
                                      err_msg=name)
        np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc),
                                   rtol=SCORE_TOL, atol=SCORE_TOL,
                                   err_msg=name)
        for a, b in zip(jax.tree.leaves(jc),
                        [x for layer in tcarry for x in layer]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                       rtol=CARRY_TOL, atol=CARRY_TOL,
                                       err_msg=name)
    # a finished lane offers its PAD continuation at its frozen score
    fl = tfl.numpy()
    for b in range(B):
        for g in range(W):
            if finished[g, b] and g * V in fl[b]:
                j = list(fl[b]).index(g * V)
                assert tsc[b, j] == scores[g, b]
    if min_len and t < min_len:
        assert not (fl % V == 2).any()             # EOS blocked


def test_in_place_matches_functional(setup):
    _, enc, tmodel = setup
    W = 3
    carry, token, finished, scores = _inputs(enc, W, 11)
    carry = tuple((_torch(c, torch.bfloat16), _torch(h, torch.bfloat16))
                  for c, h in carry)
    bank = (_torch(enc.memory), _torch(enc.memory_proj),
            _torch(enc.memory_mask))
    args = (_torch(token), _torch(finished), _torch(scores)) + bank
    want_carry, want_sc, want_fl = fused_beam_step(tmodel.cell, carry, *args,
                                                   t=1, min_len=2)
    state = stack_carry(carry)
    got_sc, got_fl = fused_beam_step_(
        tmodel.cell, state, *args, torch.bfloat16, t=1, min_len=2,
        weights=stride_weights(tmodel.cell))
    assert torch.equal(got_sc, want_sc) and torch.equal(got_fl, want_fl)
    for (a, b), (c, d) in zip(unstack_carry(state, torch.bfloat16),
                              want_carry):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, c) and torch.equal(b, d)


def test_plain_version_is_the_step_then_the_selection(setup):
    """beam_step_plain with the embedding rows given is what the wrapper
    runs on the CPU, exactly."""
    _, enc, tmodel = setup
    W = 2
    carry, token, finished, scores = _inputs(enc, W, 5)
    carry = tuple((_torch(c), _torch(h)) for c, h in carry)
    w = stride_weights(tmodel.cell)
    bank = (_torch(enc.memory), _torch(enc.memory_proj),
            _torch(enc.memory_mask))
    fin, sc = _torch(finished), _torch(scores)
    want = fused_beam_step(tmodel.cell, carry, _torch(token), fin, sc,
                           *bank, t=0, min_len=0)
    got = beam_step_plain(w, carry, w.embt[_torch(token).long()], fin, sc,
                          *bank, t=0, min_len=0)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_refuses_a_beam_wider_than_the_vocab(setup):
    _, enc, tmodel = setup
    W = V + 1
    carry = tuple((torch.zeros(W, B, H), torch.zeros(W, B, H))
                  for _ in enc.carry)
    bank = (_torch(enc.memory), _torch(enc.memory_proj),
            _torch(enc.memory_mask))
    with pytest.raises(ValueError, match="beam width"):
        fused_beam_step(tmodel.cell, carry,
                        torch.ones((W, B), dtype=torch.int32),
                        torch.zeros((W, B), dtype=torch.bool),
                        torch.zeros((W, B)), *bank, t=0)
    two = tuple((c[:2], h[:2]) for c, h in carry)
    with pytest.raises(ValueError, match="scores"):
        fused_beam_step(tmodel.cell, two, torch.ones((2, B), dtype=torch.int32),
                        torch.zeros((2, B), dtype=torch.bool),
                        torch.zeros((3, B)), *bank, t=0)
