"""Kernels 2-5's weight pack in the parameter dtype: a bfloat16 model's
``stride_weights`` holds bfloat16, as the TPU kernels take the cell
parameters (``cst_captioning_tpu/ops/decode_pallas.py`` widens them in its
kernel bodies), and the port widens each weight to float32 where it reads
it. CPU only: here the wrappers run their plain versions (the CUDA kernels
against them on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py``'s ``param_bf16`` phase).

The model is seeded random weights (``convert.random_flax_params`` with
``param_dtype="bfloat16"``: every value a bfloat16 one, the biases drawn
too), at widths E=H=16, A=8 and E=H=12, A=6 (not a multiple of 8), V=98,
one and two LSTM layers; the banks, carries, tokens and noise are numpy
draws from a seed.

(a) The pack of the bf16 model is all bfloat16, exactly half the float32
    pack's bytes, and widened equals the pack of a float32 model holding
    the same values; the float32 model's pack is its parameters'
    transposes, float32, as before.
(b) Each plain version fed the bf16 pack is bitwise the same plain version
    fed the float32 pack: the decode step, the dense and paged strides,
    the beam step, and the sharded decode (``decode_mp``'s stride and beam
    step on one rank, and kernel 2 on each of two vocabulary shards from
    ``shard_weights``).
(c) The plain versions on the bf16 pack against the JAX kernels in
    interpret mode on the bf16 cell parameters: tokens and beam ids
    equal; logits, carry, logprobs and scores within 2e-5
    (``tests/test_torch_param_dtype.py``'s float32-compute bound, both
    sides computing in float32).
(d) A pack that mixes dtypes, or holds one the kernels do not read,
    raises; so does a cell whose parameters mix dtypes.
(e) The step kernels' argument struct carries the pack's dtype
    (``weights_bf16``) and takes embedding rows only in it.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

# Pallas interpret mode on CPU: the TPU kernels themselves are the reference
from cst_captioning_tpu.ops.decode_pallas import (  # graftlint: disable=GL008
    fused_beam_step as jax_beam_step,
    fused_decode_step as jax_step,
    fused_decode_stride as jax_stride,
    fused_decode_stride_paged as jax_stride_paged,
)
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch.config import EOS_ID
from cst_captioning_tpu_torch.convert import load_flax_params, random_flax_params
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.ops import decode_mp
from cst_captioning_tpu_torch.ops.beam_step import fused_beam_step
from cst_captioning_tpu_torch.ops.decode_step import (
    fused_decode_step,
    fused_decode_step_,
    stack_carry,
    step_args,
)
from cst_captioning_tpu_torch.ops.decode_stride import (
    fused_decode_stride,
    fused_decode_stride_paged,
    stride_weights,
)
from cst_captioning_tpu_torch.train.mesh import DataMesh

torch.set_num_threads(1)

TOL = 2e-5
B, F, V, S, K, P = 5, 6, 98, 3, 2, 4
G = 1 + K
WIDTHS = {"w16": (16, 8), "w12": (12, 6)}      # (E = H, A)
PACKED = ("wq", "bq", "v", "wx", "wh", "bg", "wo", "bo", "embt")
CPU = torch.device("cpu")

_MODELS = {}


def _models(width: str, layers: int):
    """-> (JAX bf16 cell params, the bf16-param model, the float32-param
    model holding the same values), cached."""
    key = (width, layers)
    if key not in _MODELS:
        E, A = WIDTHS[width]
        kw = dict(vocab_size=V, modalities=(("resnet", 10),), d_embed=E,
                  d_hidden=E, d_att=A, encoder="temporal_attention",
                  dropout=0.0, max_len=8, max_frames=F, dtype="float32",
                  num_layers=layers)
        tree = random_flax_params(
            tcfg.ModelConfig(**kw, param_dtype="bfloat16"), 5, eos_bias=1.5)
        rng = np.random.default_rng(6)
        tree = jax.tree_util.tree_map_with_path(
            lambda p, a: a + rng.normal(scale=0.1, size=a.shape).astype(
                np.float32) if "bias" in jax.tree_util.keystr(p) else a,
            tree)
        tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(
            jnp.bfloat16).astype(jnp.float32)), tree)
        jcell = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                             tree["params"]["cell"])
        models = [load_flax_params(CaptionModel(tcfg.ModelConfig(
            **kw, param_dtype=pd), device="cpu"), tree).eval()
            for pd in ("bfloat16", "float32")]
        _MODELS[key] = (jcell, *models)
    return _MODELS[key]


def _inputs(width: str, layers: int, seed: int = 0) -> dict:
    """numpy draws: a float32 bank of F slots (row 3 fully masked), a
    carry of G lanes, tokens, finished rows, Gumbel noise, memory lengths,
    beam scores."""
    E, A = WIDTHS[width]
    rng = np.random.default_rng(seed)
    mask = (np.arange(F)[None] < np.array([[1], [6], [3], [6], [2]])
            ).astype(np.float32)
    mask[3] = 0.0
    finished = np.zeros((G, B), bool)
    finished[:, 1] = True
    finished[2, 0] = True
    finished[:, B - 1:] = True      # past the n_active prefix every lane
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(
        mem=f32(B, F, E), proj=f32(B, F, A), mask=mask,
        carry=[(0.5 * f32(G, B, E), 0.5 * f32(G, B, E))
               for _ in range(layers)],
        token=rng.integers(3, V, size=(G, B)).astype(np.int32),
        finished=finished, noise=rng.gumbel(size=(S, K, B, V)).astype(
            np.float32),
        lens=np.array([1, F, 2, 5, 3], np.int32),
        scores=rng.normal(scale=2.0, size=(G, B)).astype(np.float32))


def _t(x):
    return torch.from_numpy(np.array(x))


def _carry(x):
    return tuple((_t(c), _t(h)) for c, h in x["carry"])


def _pages(x):
    """The bank scattered over a pool in random page order -> (mem_pool,
    proj_pool, mask_pool, table); page 0 stays zero."""
    width = -(-F // P)
    n = B * width
    order = np.random.default_rng(1).permutation(n) + 1
    pools = []
    for a in (x["mem"], x["proj"], x["mask"]):
        pad = [(0, 0), (0, width * P - F)] + [(0, 0)] * (a.ndim - 2)
        pool = np.zeros((n + 1, P) + a.shape[2:], np.float32)
        pool[order] = np.pad(a, pad).reshape((n, P) + a.shape[2:])
        pools.append(pool)
    return (*pools, order.reshape(B, width).astype(np.int32))


def _packs(width, layers):
    _, b16, f32 = _models(width, layers)
    return b16, stride_weights(b16.cell), stride_weights(f32.cell)


def _bitwise(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_bitwise(p, q) for p, q in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


# ---- (a) the pack ----------------------------------------------------------------


@pytest.mark.parametrize("layers", [1, 2], ids=["L1", "L2"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_pack_keeps_the_parameter_dtype(width, layers):
    _, b16, f32 = _models(width, layers)
    wb, wf = stride_weights(b16.cell), stride_weights(f32.cell)
    assert wb.dtype == torch.bfloat16 and wf.dtype == torch.float32
    nbytes = lambda w: sum(getattr(w, n).numel() * getattr(  # noqa: E731
        w, n).element_size() for n in PACKED)
    assert 2 * nbytes(wb) == nbytes(wf)
    for name in PACKED:
        x, y = getattr(wb, name), getattr(wf, name)
        assert x.dtype == torch.bfloat16, name
        assert torch.equal(x.float(), y), name
    # the float32 model's pack: its parameters' transposes, float32
    c, att = f32.cell, f32.cell.attention
    assert torch.equal(wf.wq, att.query_proj.weight.t())
    assert torch.equal(wf.v, att.score)
    assert torch.equal(wf.wo, c.out_proj.weight.t())
    assert torch.equal(wf.embt, c.word_embed.weight)
    assert torch.equal(wf.wh, torch.stack([m.weight_h.t() for m in c.lstm]))
    assert torch.equal(wf.wx, torch.cat([m.weight_i.t().reshape(-1)
                                         for m in c.lstm]))
    assert torch.equal(wf.bg, torch.stack([m.bias for m in c.lstm]))
    # shard_weights keeps the dtype
    for k in range(2):
        sb = decode_mp.shard_weights(wb, k, 2)
        sf = decode_mp.shard_weights(wf, k, 2)
        assert sb.dtype == torch.bfloat16 and sf.dtype == torch.float32
        assert all(torch.equal(getattr(sb, n).float(), getattr(sf, n))
                   for n in PACKED)


# ---- (b) bf16 pack against the float32 pack, bitwise ------------------------------


def _run(kernel: str, cell, w, x):
    """One plain-version call of ``kernel`` through its wrapper on CPU
    tensors, on the pack ``w`` -> its outputs."""
    carry = _carry(x)
    token, fin = _t(x["token"]), _t(x["finished"])
    bank = (_t(x["mem"]), _t(x["proj"]), _t(x["mask"]))
    kw = dict(steps=S, temperature=0.8, min_len=2, mem_lens=_t(x["lens"]),
              weights=w)
    if kernel == "decode_step":
        return fused_decode_step(cell, carry, token, *bank, weights=w)
    if kernel == "stride_dense":
        return fused_decode_stride(cell, carry, token, fin, *bank,
                                   _t(x["noise"]), 1, B - 1, **kw)
    if kernel == "stride_paged":
        return fused_decode_stride_paged(cell, carry, token, fin,
                                         *map(_t, _pages(x)),
                                         _t(x["noise"]), 1, B - 1, **kw)
    if kernel == "beam_step":
        return fused_beam_step(cell, carry, token, fin, _t(x["scores"]),
                               *bank, t=1, min_len=2, weights=w)
    mesh = DataMesh("mp", 0, 1, CPU)
    if kernel == "mp_stride":
        return decode_mp.mp_decode_stride(
            cell, carry, token, fin, *bank, _t(x["noise"]), 1, mesh=mesh,
            steps=S, temperature=0.8, min_len=2,
            weights=decode_mp.shard_weights(w, 0, 1))
    if kernel == "mp_beam":
        return decode_mp.mp_beam_step(
            cell, carry, token, fin, _t(x["scores"]), *bank, mesh=mesh,
            t=1, min_len=2, weights=decode_mp.shard_weights(w, 0, 1))
    # kernel 2 on each of two vocabulary shards, the rows given (emb=)
    outs = []
    for k in range(2):
        shard = decode_mp.shard_weights(w, k, 2)
        state = stack_carry(carry)
        logits = fused_decode_step_(cell, state, token, *bank,
                                    torch.float32, emb=w.embt[token.long()],
                                    weights=shard)
        outs += [state, logits]
    return outs


KERNELS = ("decode_step", "stride_dense", "stride_paged", "beam_step",
           "mp_stride", "mp_beam", "mp_shards")


@pytest.mark.parametrize("layers", [1, 2], ids=["L1", "L2"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_on_bf16_pack_is_bitwise_the_float32_pack(kernel, width,
                                                        layers):
    b16, wb, wf = _packs(width, layers)
    x = _inputs(width, layers)
    got, want = _run(kernel, b16.cell, wb, x), _run(kernel, b16.cell, wf, x)
    assert _bitwise(got, want)
    if kernel.startswith("stride"):
        tokens = got[1]
        assert bool((tokens == EOS_ID).any())   # rows finish in the stride


# ---- (c) against the JAX kernels on bf16 cell parameters ---------------------------


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=TOL, atol=TOL,
                               err_msg=what)


def _carry_close(jc, tc, what):
    for (a, b), (c, d) in zip(jc, tc):
        _close(a, c.numpy(), what + " c")
        _close(b, d.numpy(), what + " h")


@pytest.mark.parametrize("kernel", ["decode_step", "stride_dense",
                                    "stride_paged", "beam_step"])
def test_plain_on_bf16_pack_matches_jax_kernel(kernel):
    width, layers = "w12", 2
    jcell, b16, _ = _models(width, layers)
    w = stride_weights(b16.cell)
    x = _inputs(width, layers, seed=2)
    jcarry = tuple(tuple(map(jnp.asarray, layer)) for layer in x["carry"])
    j = {k: jnp.asarray(x[k]) for k in ("token", "finished", "noise",
                                        "mem", "proj", "mask", "scores")}
    got = _run(kernel, b16.cell, w, x)
    if kernel == "decode_step":
        jc, jlogits = jax_step(jcell, jcarry, j["token"], j["mem"],
                               j["proj"], j["mask"])
        _close(jlogits, got[1].numpy(), "logits")
        _carry_close(jc, got[0], "carry")
        return
    if kernel == "beam_step":
        jc, jsc, jfl = jax_beam_step(jcell, jcarry, j["token"],
                                     j["finished"], j["scores"], j["mem"],
                                     j["proj"], j["mask"], t=jnp.int32(1),
                                     min_len=2)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(jfl))
        _close(jsc, got[1].numpy(), "scores")
        _carry_close(jc, got[0], "carry")
        return
    bank = ((j["mem"], j["proj"], j["mask"]) if kernel == "stride_dense"
            else tuple(map(jnp.asarray, _pages(x))))
    fn = jax_stride if kernel == "stride_dense" else jax_stride_paged
    jc, jtok, jlp = fn(jcell, jcarry, j["token"], j["finished"], *bank,
                       j["noise"], jnp.int32(1), jnp.int32(B - 1), steps=S,
                       temperature=0.8, min_len=2,
                       mem_lens=jnp.asarray(x["lens"]))
    tc, ttok, tlp = got
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _close(jlp, tlp.numpy(), "logprobs")
    # the carry of rows still live at the stride's end (a finished row's
    # carry is never read again; the two stop updating it at other points)
    live = ~(x["finished"] | (ttok.numpy() == EOS_ID).any(0))
    live[:, B - 1:] = False
    for (a, b), (c, d) in zip(jc, tc):
        _close(np.asarray(a)[live], c.numpy()[live], "carry c")
        _close(np.asarray(b)[live], d.numpy()[live], "carry h")


# ---- (d) refusals -----------------------------------------------------------------


def _mixed(w):
    return dataclasses.replace(w, wo=w.wo.float())


def _all_as(dtype):
    return lambda w: dataclasses.replace(
        w, **{n: getattr(w, n).to(dtype) for n in PACKED})


@pytest.mark.parametrize("make", [_mixed, _all_as(torch.float64),
                                  _all_as(torch.float16)],
                         ids=["mixed", "float64", "float16"])
def test_a_pack_of_other_dtypes_raises(make):
    _, wb, _ = _packs("w16", 1)
    with pytest.raises(ValueError, match="one dtype"):
        make(wb)


def test_a_cell_of_mixed_dtypes_raises():
    model = copy.deepcopy(_models("w16", 1)[1])    # the cached one stays
    model.cell.out_proj.bias.data = model.cell.out_proj.bias.data.float()
    with pytest.raises(ValueError, match="one dtype"):
        stride_weights(model.cell)


# ---- (e) the kernels' argument struct ---------------------------------------------


@pytest.mark.parametrize("pack", ["bfloat16", "float32"])
def test_step_args_carry_the_weight_dtype(pack):
    b16, wb, wf = _packs("w12", 1)
    w = wb if pack == "bfloat16" else wf
    x = _inputs("w12", 1)
    state = stack_carry(_carry(x))
    token = _t(x["token"]).long()
    bank = (_t(x["mem"]), _t(x["proj"]), _t(x["mask"]))
    args, scratch = step_args(w, state, w.embt[token], *bank,
                              torch.float32, None)
    assert args.weights_bf16 == int(pack == "bfloat16")
    assert args.bank_bf16 == 0 and scratch.dtype == torch.float32
    assert any(key[-1] == w.dtype for key in w.checked)
    other = torch.float32 if pack == "bfloat16" else torch.bfloat16
    with pytest.raises(ValueError, match="emb has dtype"):
        step_args(w, state, w.embt[token].to(other), *bank, torch.float32,
                  None)
