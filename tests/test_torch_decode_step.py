"""The port's decode step (ops/decode_step.py) against the JAX package's
fused_decode_step (its Pallas kernel in interpret mode) on converted
weights: logits and carry within 2e-5 (both compute in float32) for 1 and 2
LSTM layers, 1 and 3 lanes, float32 and bfloat16 banks; the in-place step
on a stacked carry equal to the functional one. CPU only; the CUDA
kernel is held against the plain version in tests/test_torch_cuda.py and
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.config.config import ModelConfig
from cst_captioning_tpu.models import CaptionModel
from cst_captioning_tpu.models.captioner import CaptionModel as CM
from cst_captioning_tpu.ops.decode_pallas import (  # graftlint: disable=GL008
    fused_decode_step as jax_step,
)
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch.convert import load_flax_params
from cst_captioning_tpu_torch.models import CaptionModel as TorchCaptionModel
from cst_captioning_tpu_torch.ops import decode_step_plain, stride_weights
from cst_captioning_tpu_torch.ops.decode_step import (
    fused_decode_step,
    fused_decode_step_,
    stack_carry,
    step_workspace,
    unstack_carry,
)

torch.set_num_threads(1)

TOL = 2e-5
MODAL = (("resnet", 16), ("c3d", 12))
B, F, V = 5, 6, 97


@pytest.fixture(scope="module", params=[1, 2], ids=["L1", "L2"])
def setup(request):
    kw = dict(vocab_size=V, modalities=MODAL, d_embed=16, d_hidden=16,
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
    return params, enc, tmodel, rng


@pytest.mark.parametrize("bank", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 3])
def test_plain_matches_jax_kernel(setup, G, bank):
    params, enc, tmodel, rng = setup
    H = 16
    carry = tuple(
        (rng.normal(size=(G, B, H)).astype(np.float32),
         rng.normal(size=(G, B, H)).astype(np.float32))
        for _ in enc.carry)
    token = rng.integers(0, V, size=(G, B)).astype(np.int32)
    mask = np.asarray(enc.memory_mask).copy()
    mask[3] = 0.0                     # a fully masked row
    jd = jnp.dtype(bank)
    mem, proj = enc.memory.astype(jd), enc.memory_proj.astype(jd)
    jcarry, jlogits = jax_step(
        params["params"]["cell"], jax.tree.map(jnp.asarray, carry),
        jnp.asarray(token), mem, proj, jnp.asarray(mask))
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[bank]
    t = lambda x: torch.from_numpy(np.array(x, np.float32))  # noqa: E731
    tcarry, tlogits = fused_decode_step(
        tmodel.cell, tuple((t(c), t(h)) for c, h in carry),
        torch.from_numpy(token), t(mem).to(td), t(proj).to(td), t(mask))
    assert tlogits.shape == (G, B, V) and tlogits.dtype == torch.float32
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=TOL, atol=TOL)
    for (jc, jh), (tc_, th) in zip(jcarry, tcarry):
        np.testing.assert_allclose(tc_.numpy(), np.asarray(jc), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=TOL,
                                   atol=TOL)


def test_carry_keeps_its_dtype_and_emb_overrides_gather(setup):
    _, enc, tmodel, rng = setup
    G, H = 2, 16
    carry = tuple((torch.randn(G, B, H).bfloat16(),
                   torch.randn(G, B, H).bfloat16()) for _ in enc.carry)
    token = torch.from_numpy(rng.integers(0, V, size=(G, B)))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    bank = (t(enc.memory), t(enc.memory_proj), t(enc.memory_mask))
    w = stride_weights(tmodel.cell)
    new_carry, logits = fused_decode_step(tmodel.cell, carry, token, *bank)
    assert all(c.dtype == torch.bfloat16 and h.dtype == torch.bfloat16
               for c, h in new_carry)
    _, ref = decode_step_plain(w, carry, w.embt[token], *bank)
    torch.testing.assert_close(logits, ref, rtol=0, atol=0)
    # pre-gathered rows and pre-packed weights give the same step
    _, given = fused_decode_step(tmodel.cell, carry, token, *bank,
                                 emb=w.embt[token], weights=w)
    torch.testing.assert_close(given, logits, rtol=0, atol=0)
    with pytest.raises(ValueError, match="num_layers"):
        fused_decode_step(tmodel.cell, carry, token, *bank, num_layers=7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_in_place_step_matches_functional(setup, dtype):
    _, enc, tmodel, rng = setup
    G, H = 3, 16
    carry = tuple((torch.randn(G, B, H).to(dtype), torch.randn(G, B, H).to(dtype))
                  for _ in enc.carry)
    token = torch.from_numpy(rng.integers(0, V, size=(G, B)))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    bank = (t(enc.memory), t(enc.memory_proj), t(enc.memory_mask))
    want_carry, want = fused_decode_step(tmodel.cell, carry, token, *bank)
    state = stack_carry(carry)
    assert state.shape == (2, len(carry), G, B, H)
    assert state.dtype == torch.float32
    got = fused_decode_step_(tmodel.cell, state, token, *bank, dtype)
    # exact: both run the plain version; the stacked carry holds the new
    # carry's values, rounded to its dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for (a, b), (c, d) in zip(unstack_carry(state, dtype), want_carry):
        assert a.dtype == dtype and b.dtype == dtype
        torch.testing.assert_close(a, c, rtol=0, atol=0)
        torch.testing.assert_close(b, d, rtol=0, atol=0)


def test_step_workspace_at_the_rollout_shape():
    # msrvtt widths, G=5 lanes x B=64 rows = 320: q (512 deep) in 2
    # split-K slices of 256, layer-0 gates (1024 + 512 deep) in 6
    ws = step_workspace(G=5, B=64, E=512, Em=512, A=256, H=512)
    assert ws == {"q": 2 * 320 * 256, "gates": 6 * 320 * 2048,
                  "x": 320 * 1024, "h": 320 * 512}
    assert sum(ws.values()) == 4_587_520


def test_step_workspace_at_a_small_shape():
    # 2 x 3 = 6 rows, one slice each (k = 12 + 6 and 6 deep), every region
    # rounded up to 4 floats
    ws = step_workspace(G=2, B=3, E=5, Em=7, A=3, H=6)
    assert ws == {"q": 20, "gates": 144, "x": 72, "h": 36}
