"""The port's stride op (cst_captioning_tpu_torch.ops.decode_stride) against
the JAX package's public fused_decode_stride / fused_decode_stride_paged,
which run here in Pallas interpret mode. On CPU tensors the port's wrappers
run their plain PyTorch versions, so this holds the plain versions (the
reference the CUDA kernel is held against on the GPU) to the TPU kernels'
contract: the same numpy inputs and Gumbel noise go to both; tokens must be
equal, logprobs within 2e-5 (the float32 bound of the JAX kernel's own
parity tests). The carry is compared on rows still unfinished at the
stride's end: a finished row's carry is never read again, and the two
kernels stop updating it at different points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.config.config import EOS_ID, PAD_ID, ModelConfig
from cst_captioning_tpu.models import CaptionModel
from cst_captioning_tpu.models.captioner import CaptionModel as CM
# Pallas interpret mode on CPU: the TPU kernels themselves are the reference
from cst_captioning_tpu.ops.decode_pallas import (  # graftlint: disable=GL008
    fused_decode_stride as jax_stride,
    fused_decode_stride_paged as jax_stride_paged,
)
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch.convert import load_flax_params
from cst_captioning_tpu_torch.models import CaptionModel as TorchCaptionModel
from cst_captioning_tpu_torch.ops import (
    fused_decode_stride,
    fused_decode_stride_paged,
    gather_pages,
    stride_weights,
)

torch.set_num_threads(1)

TOL = 2e-5
B, V, D, A, F, S, K, P = 5, 97, 16, 8, 7, 3, 2, 3
G = 1 + K

CASES = {
    "shared_noise": {},
    "ragged_mem_lens": dict(lens=[1, F, 2, 5, 1]),
    "prefinished": dict(finished=[0, 1, 0, 0, 1]),
    "n_active": dict(n_active=3),
    "temperature": dict(temperature=0.7),
    "min_len": dict(min_len=2, t0=1),
    "two_layers": dict(layers=2, lens=[2, F, 3, 1, 6], finished=[0, 0, 1, 0, 0]),
}

_SETUPS = {}


@pytest.fixture(scope="module")
def setup():
    return _setup(1)


def _setup(layers):
    if layers not in _SETUPS:
        _SETUPS[layers] = _build(layers)
    return _SETUPS[layers]


def _build(layers):
    kw = dict(vocab_size=V, modalities=(("resnet", 16),), d_embed=D,
              d_hidden=D, d_att=A, encoder="temporal_attention", dropout=0.0,
              max_len=8, max_frames=F, dtype="float32", num_layers=layers)
    jmodel = CaptionModel(ModelConfig(**kw))
    rng = np.random.default_rng(0)
    feats = {"resnet": jnp.asarray(rng.normal(size=(B, F, 16)), jnp.float32)}
    masks = {"resnet": jnp.asarray(
        np.arange(F)[None, :] < rng.integers(2, F + 1, size=(B, 1)),
        jnp.float32)}
    params = jmodel.init(jax.random.key(0), feats, masks,
                         jnp.zeros((B, 8), jnp.int32))
    bias = params["params"]["cell"]["out_proj"]["bias"]
    # EOS-biased so rows finish inside the stride
    params["params"]["cell"]["out_proj"]["bias"] = bias.at[EOS_ID].add(1.5)
    enc = jmodel.apply(params, feats, masks, method=CM.encode)
    tmodel = load_flax_params(
        TorchCaptionModel(tcfg.ModelConfig(**kw), device="cpu"),
        jax.tree.map(np.asarray, params))
    carry = [tuple(np.broadcast_to(np.asarray(x)[None], (G, B, D)).copy()
                   for x in layer) for layer in enc.carry]
    token = rng.integers(3, V, size=(G, B)).astype(np.int32)
    noise = rng.gumbel(size=(S, K, B, V)).astype(np.float32)
    bank = tuple(np.array(x) for x in
                 (enc.memory, enc.memory_proj, enc.memory_mask))
    return params["params"]["cell"], tmodel.cell, carry, token, noise, bank


def _pages(bank, lens, seed=0):
    """Scatter each row's first lens[b] slots over a pool in random page
    order -> (mem_pool, proj_pool, mask_pool, table); page 0 stays zero."""
    mem, proj, mask = bank
    width = -(-F // P)
    n_pages = B * width + 3
    pools = [np.zeros((n_pages + 1, P) + x.shape[2:], np.float32)
             for x in bank]
    table = np.zeros((B, width), np.int32)
    free = list(np.random.default_rng(seed).permutation(
        np.arange(1, n_pages + 1)))
    for b in range(B):
        for p in range(-(-int(lens[b]) // P)):
            pg = free.pop()
            table[b, p] = pg
            lo, hi = p * P, min((p + 1) * P, int(lens[b]))
            for pool, x in zip(pools, bank):
                pool[pg, :hi - lo] = x[b, lo:hi]
    return (*pools, table)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_stride_matches_jax_kernel(case, paged):
    c = CASES[case]
    jcell, tcell, carry, token, noise, bank = _setup(c.get("layers", 1))
    lens = np.asarray(c.get("lens", [F] * B), np.int32)
    n_active = c.get("n_active", B)
    finished = np.zeros((G, B), bool)
    finished[:, np.asarray(c.get("finished", [0] * B), bool)] = True
    finished[:, n_active:] = True   # past the prefix every lane is done
    kw = dict(steps=S, temperature=c.get("temperature", 1.0),
              min_len=c.get("min_len", 0))
    t0 = c.get("t0", 0)
    if paged:
        ins = _pages(bank, lens)
        jfn, tfn = jax_stride_paged, fused_decode_stride_paged
    else:
        ins = bank
        jfn, tfn = jax_stride, fused_decode_stride
    jc, jtok, jlp = jfn(
        jcell, tuple(tuple(map(jnp.asarray, layer)) for layer in carry),
        jnp.asarray(token), jnp.asarray(finished), *map(jnp.asarray, ins),
        jnp.asarray(noise), jnp.int32(t0), jnp.int32(n_active),
        mem_lens=jnp.asarray(lens), **kw)
    tc, ttok, tlp = tfn(
        tcell, tuple(tuple(map(torch.from_numpy, layer)) for layer in carry),
        torch.from_numpy(token), torch.from_numpy(finished),
        *map(torch.from_numpy, ins), torch.from_numpy(noise), t0, n_active,
        mem_lens=torch.from_numpy(lens), **kw)
    jtok = np.asarray(jtok)
    np.testing.assert_array_equal(ttok.numpy(), jtok)
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), rtol=TOL,
                               atol=TOL)
    assert (jtok[:, finished] == PAD_ID).all()
    live = ~(finished | (jtok == EOS_ID).any(axis=0))
    assert live.any() and not live.all()
    for jl, tl in zip(jc, tc):
        for a, b in zip(jl, tl):
            np.testing.assert_allclose(b.numpy()[live], np.asarray(a)[live],
                                       rtol=TOL, atol=TOL)


def test_paged_plain_equals_dense_plain(setup):
    """The paged wrapper's plain version is the dense one on the gathered
    bank, bit for bit."""
    _, tcell, carry, token, noise, bank = setup
    lens = np.asarray([1, F, 4, 2, F], np.int32)
    pools = [torch.from_numpy(x) for x in _pages(bank, lens, seed=3)]
    args = (tcell, tuple(tuple(map(torch.from_numpy, layer))
                         for layer in carry),
            torch.from_numpy(token), torch.zeros((G, B), dtype=torch.bool))
    kw = dict(steps=S, mem_lens=torch.from_numpy(lens))
    noise_t = torch.from_numpy(noise)
    pc, ptok, plp = fused_decode_stride_paged(*args, *pools, noise_t, **kw)
    dc, dtok, dlp = fused_decode_stride(
        *args, *gather_pages(*pools), noise_t, **kw)
    assert torch.equal(ptok, dtok) and torch.equal(plp, dlp)
    for p_, d_ in zip(pc, dc):
        assert torch.equal(p_[0], d_[0]) and torch.equal(p_[1], d_[1])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_packed_weights_give_the_same_stride(setup, paged):
    """``weights=`` (packed once per decode or serve) changes no result."""
    _, tcell, carry, token, noise, bank = setup
    lens = np.asarray([2, F, 4, 1, F], np.int32)
    ins = ([torch.from_numpy(x) for x in _pages(bank, lens, seed=1)] if paged
           else [torch.from_numpy(x) for x in bank])
    fn = fused_decode_stride_paged if paged else fused_decode_stride
    args = (tcell, tuple(tuple(map(torch.from_numpy, layer))
                         for layer in carry),
            torch.from_numpy(token), torch.zeros((G, B), dtype=torch.bool),
            *ins, torch.from_numpy(noise))
    kw = dict(steps=S, mem_lens=torch.from_numpy(lens), temperature=0.9)
    want = fn(*args, **kw)
    got = fn(*args, weights=stride_weights(tcell), **kw)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])


def test_wrappers_validate_operands(setup):
    _, tcell, carry, token, noise, bank = setup
    tcarry = tuple(tuple(map(torch.from_numpy, layer)) for layer in carry)
    tok = torch.from_numpy(token)
    fin = torch.zeros((G, B), dtype=torch.bool)
    mem, proj, mask = map(torch.from_numpy, bank)
    with pytest.raises(ValueError, match="noise shape"):
        fused_decode_stride(tcell, tcarry, tok, fin, mem, proj, mask,
                            torch.from_numpy(noise[:, :1]), steps=S)
    with pytest.raises(ValueError, match="K >= 1"):
        fused_decode_stride(tcell, tcarry, tok[:1], fin[:1], mem, proj, mask,
                            torch.zeros((S, 0, B, V)), steps=S)
    with pytest.raises(ValueError, match="page_table"):
        fused_decode_stride_paged(
            tcell, tcarry, tok, fin, mem, proj, mask,
            torch.zeros((B, 2, 1), dtype=torch.int32),
            torch.from_numpy(noise), steps=S)
    with pytest.raises(ValueError, match="num_layers"):
        fused_decode_stride(tcell, tcarry, tok, fin, mem, proj, mask,
                            torch.from_numpy(noise), steps=S, num_layers=2)
