"""The port's additive attention (ops/attention.py) against the JAX
package's fused_additive_attention (its Pallas kernel in interpret mode):
the plain version's forward in float32 (within 1e-6) and bfloat16 (within
two bfloat16 ulps of values up to 1: the JAX kernel sums the softmax in
float32 while the reference composite the plain version mirrors rounds
the scores and the weights to bfloat16); the CUDA kernel's float32
reference, which the bfloat16 kernel is held to on the GPU, equal to the
plain version on float32 inputs (within 1e-6) and rounding proj + q and
tanh to bfloat16 on bfloat16 inputs (within 1e-6); the autograd rule's gradients
(within 2e-5), and the model's teacher-forced logits with
attention_impl "pallas" against "xla" (within 2e-5). CPU only; the CUDA
kernel is held against the plain version in tests/test_torch_cuda.py and
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.ops.attention_pallas import (  # graftlint: disable=GL008
    fused_additive_attention as jax_attention,
)
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch.convert import load_flax_params, random_flax_params
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.ops.attention import (
    additive_attention_f32,
    additive_attention_plain,
    fused_additive_attention,
)

torch.set_num_threads(1)

A, E = 8, 16
F32_TOL = 1e-6
BF16_TOL = 2.0 ** -6      # two bfloat16 ulps at magnitude 1
GRAD_TOL = 2e-5


def _inputs(B, M, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, A)).astype(np.float32)
    v = (rng.normal(size=(A,)) / np.sqrt(A)).astype(np.float32)
    mem = np.tanh(rng.normal(size=(B, M, E))).astype(np.float32)
    proj = rng.normal(size=(B, M, A)).astype(np.float32)
    lens = rng.integers(1, M + 1, size=(B,))
    mask = (np.arange(M)[None, :] < lens[:, None]).astype(np.float32)
    if B > 1:
        mask[B // 2] = 0.0            # one fully masked row: uniform softmax
    return q, v, mem, proj, mask


@pytest.mark.parametrize("M", [1, 7, 130])
@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(B, M, dtype):
    q, v, mem, proj, mask = _inputs(B, M, seed=B * 1000 + M)
    jd = jnp.dtype(dtype)
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = jax_attention(*(jnp.asarray(x, jd) for x in (q, v, mem, proj)),
                         jnp.asarray(mask))
    got = fused_additive_attention(
        *(torch.from_numpy(x).to(td) for x in (q, v, mem, proj)),
        torch.from_numpy(mask))
    assert got.dtype == td and got.shape == (B, E)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_kernel_numerics_reference():
    q, v, mem, proj, mask = _inputs(5, 130, seed=8)
    ins = [torch.from_numpy(x) for x in (q, v, mem, proj)]
    tmask = torch.from_numpy(mask)
    torch.testing.assert_close(additive_attention_f32(*ins, tmask),
                               additive_attention_plain(*ins, tmask),
                               rtol=F32_TOL, atol=F32_TOL)
    # in bfloat16: float32 sums over the two roundings, nothing rounded after
    bq, bv, bmem, bproj = (x.bfloat16() for x in ins)
    t = torch.tanh((bproj.float() + bq.float()[:, None]).bfloat16().float())
    s = torch.where(tmask > 0, t.bfloat16().float() @ bv.float(), -1e9)
    want = torch.softmax(s, -1)[:, None, :] @ bmem.float()
    got = additive_attention_f32(bq, bv, bmem, bproj, tmask)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want[:, 0], rtol=F32_TOL, atol=F32_TOL)


def test_fully_masked_row_is_uniform():
    q, v, mem, proj, mask = _inputs(5, 7)
    got = additive_attention_plain(
        *(torch.from_numpy(x) for x in (q, v, mem, proj)),
        torch.from_numpy(mask))
    np.testing.assert_allclose(got[2].numpy(), mem[2].mean(axis=0),
                               rtol=F32_TOL, atol=F32_TOL)


def test_gradients_match_jax():
    q, v, mem, proj, mask = _inputs(5, 7, seed=3)
    g = np.random.default_rng(9).normal(size=(5, E)).astype(np.float32)

    def jloss(q_, v_, m_, p_):
        return jnp.sum(jax_attention(q_, v_, m_, p_, jnp.asarray(mask))
                       * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x) for x in (q, v, mem, proj)))
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, v, mem, proj)]
    out = fused_additive_attention(*ins, torch.from_numpy(mask))
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), ins)
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_pallas_impl_matches_xla_in_teacher_forcing():
    kw = dict(vocab_size=97, modalities=(("resnet", 16), ("c3d", 12)),
              d_embed=16, d_hidden=16, d_att=8,
              encoder="temporal_attention", dropout=0.0, max_len=8,
              max_frames=6, dtype="float32")
    tree = random_flax_params(tcfg.ModelConfig(**kw), seed=4)
    models = {impl: load_flax_params(
        CaptionModel(tcfg.ModelConfig(attention_impl=impl, **kw),
                     device="cpu"), tree) for impl in ("xla", "pallas")}
    rng = np.random.default_rng(5)
    feats = {n: torch.from_numpy(rng.normal(size=(4, 6, d)).astype(np.float32))
             for n, d in kw["modalities"]}
    lens = torch.tensor([[1], [6], [3], [5]])
    masks = {n: (torch.arange(6)[None] < lens).float()
             for n, _ in kw["modalities"]}
    labels = torch.from_numpy(rng.integers(3, 97, size=(4, 8)))
    out = {impl: m(feats, masks, labels) for impl, m in models.items()}
    assert out["pallas"].shape == (4, 8, 97)
    torch.testing.assert_close(out["pallas"], out["xla"], rtol=GRAD_TOL,
                               atol=GRAD_TOL)
