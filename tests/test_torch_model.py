"""The PyTorch port's model (cst_captioning_tpu_torch.models) against the
JAX CaptionModel on converted weights: encode with both encoders and one
decode step, float32 on the CPU, within the 2e-5 bound the JAX kernel
parity tests use for float32; encode also at dtype bfloat16, within one
bfloat16 ulp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.config.config import ModelConfig
from cst_captioning_tpu.models import CaptionModel
from cst_captioning_tpu.models.captioner import CaptionModel as CM
from cst_captioning_tpu_torch import config as tcfg
from cst_captioning_tpu_torch.convert import (
    flax_to_state_dict,
    load_flax_params,
    random_flax_params,
)
from cst_captioning_tpu_torch.models import CaptionModel as TorchCaptionModel
from cst_captioning_tpu_torch.models import EncoderOutput
from cst_captioning_tpu_torch.presets import PRESETS, get_preset

torch.set_num_threads(1)

TOL = 2e-5
BF16_ULP = 2.0 ** -7
MODAL = (("resnet", 16), ("c3d", 12))


def _configs(encoder, layers=1, dtype="float32"):
    kw = dict(vocab_size=97, modalities=MODAL, d_embed=16, d_hidden=16,
              d_att=8, encoder=encoder, dropout=0.0, max_len=12,
              max_frames=8, dtype=dtype, num_layers=layers)
    return ModelConfig(**kw), tcfg.ModelConfig(**kw)


def _inputs(rng, B, F):
    feats = {n: rng.normal(size=(B, F, d)).astype(np.float32)
             for n, d in MODAL}
    lens = rng.integers(1, F + 1, size=(B, 1))
    masks = {n: (np.arange(F)[None, :] < lens).astype(np.float32)
             for n, _ in MODAL}
    return feats, masks


def _pair(encoder, layers=1, seed=0, dtype="float32"):
    jcfg, tc = _configs(encoder, layers, dtype)
    jmodel = CaptionModel(jcfg)
    rng = np.random.default_rng(seed)
    feats, masks = _inputs(rng, 4, 8)
    params = jmodel.init(
        jax.random.key(seed), jax.tree.map(jnp.asarray, feats),
        jax.tree.map(jnp.asarray, masks), jnp.zeros((4, 12), jnp.int32),
    )
    tmodel = load_flax_params(TorchCaptionModel(tc, device="cpu"),
                              jax.tree.map(np.asarray, params))
    return jmodel, params, tmodel, rng


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("encoder", ["meanpool", "temporal_attention"])
@pytest.mark.parametrize("layers", [1, 2])
def test_encode_matches_jax(encoder, layers):
    jmodel, params, tmodel, rng = _pair(encoder, layers)
    feats, masks = _inputs(rng, 5, 8)
    jenc = jmodel.apply(params, jax.tree.map(jnp.asarray, feats),
                        jax.tree.map(jnp.asarray, masks), method=CM.encode)
    tenc = tmodel.encode({k: torch.from_numpy(v) for k, v in feats.items()},
                         {k: torch.from_numpy(v) for k, v in masks.items()})
    _close(jenc.memory, tenc.memory)
    _close(jenc.memory_proj, tenc.memory_proj)
    np.testing.assert_array_equal(np.asarray(jenc.memory_mask),
                                  tenc.memory_mask.numpy())
    for (jc, jh), (tc_, th) in zip(jenc.carry, tenc.carry):
        _close(jc, tc_)
        _close(jh, th)


@pytest.mark.parametrize("encoder", ["meanpool", "temporal_attention"])
@pytest.mark.parametrize("layers", [1, 2])
def test_encode_matches_jax_bf16(encoder, layers):
    """Both encoders at dtype bfloat16 from the same float32 parameters:
    every output in bfloat16 on both sides, within one bfloat16 ulp
    (2^-7) of values of order 1, relative and absolute: both round the
    same float32 sums to bfloat16, and a sum taken in another order can
    land across a rounding boundary."""
    jmodel, params, tmodel, rng = _pair(encoder, layers, dtype="bfloat16")
    feats, masks = _inputs(rng, 5, 8)
    jenc = jmodel.apply(params, jax.tree.map(jnp.asarray, feats),
                        jax.tree.map(jnp.asarray, masks), method=CM.encode)
    tenc = tmodel.encode({k: torch.from_numpy(v) for k, v in feats.items()},
                         {k: torch.from_numpy(v) for k, v in masks.items()})
    pairs = [(jenc.memory, tenc.memory), (jenc.memory_proj, tenc.memory_proj)]
    pairs += [p for (jc, jh), (tc_, th) in zip(jenc.carry, tenc.carry)
              for p in ((jc, tc_), (jh, th))]
    for j, t in pairs:
        assert j.dtype == jnp.bfloat16 and t.dtype == torch.bfloat16
        np.testing.assert_allclose(np.asarray(j.astype(jnp.float32)),
                                   t.detach().float().numpy(), rtol=BF16_ULP,
                                   atol=BF16_ULP)
    np.testing.assert_array_equal(np.asarray(jenc.memory_mask),
                                  tenc.memory_mask.numpy())


@pytest.mark.parametrize("encoder", ["meanpool", "temporal_attention"])
@pytest.mark.parametrize("layers", [1, 2])
def test_decode_step_matches_jax(encoder, layers):
    jmodel, params, tmodel, rng = _pair(encoder, layers, seed=1)
    feats, masks = _inputs(rng, 5, 8)
    jenc = jmodel.apply(params, jax.tree.map(jnp.asarray, feats),
                        jax.tree.map(jnp.asarray, masks), method=CM.encode)
    token = rng.integers(0, 97, size=(5,)).astype(np.int32)
    # the same encoder output feeds both steps, so only the step is compared
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    tenc = EncoderOutput(
        t(jenc.memory), t(jenc.memory_proj), t(jenc.memory_mask),
        tuple((t(c), t(h)) for c, h in jenc.carry),
    )
    jcarry, jlogits = jmodel.apply(params, jenc.carry, jnp.asarray(token),
                                   jenc, method=CM.decode_step)
    tcarry, tlogits = tmodel.decode_step(tenc.carry,
                                         torch.from_numpy(token).long(), tenc)
    assert tlogits.dtype == torch.float32
    _close(jlogits, tlogits)
    for (jc, jh), (tc_, th) in zip(jcarry, tcarry):
        _close(jc, tc_)
        _close(jh, th)


def test_convert_maps_every_parameter():
    """The converted state dict names every port parameter with its shape,
    and the seeded random tree converts the same way."""
    _, params, tmodel, _ = _pair("temporal_attention", layers=2)
    sd = flax_to_state_dict(tmodel.cfg, jax.tree.map(np.asarray, params))
    want = {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    rand = flax_to_state_dict(tmodel.cfg, random_flax_params(tmodel.cfg, 3))
    assert {k: tuple(v.shape) for k, v in rand.items()} == want


def test_presets_and_device_default():
    cfg = get_preset("msrvtt_xe_attention").model
    assert cfg.vocab_size == 9000 and cfg.d_att == 256
    assert cfg.modalities == (("resnet", 2048), ("c3d", 500))
    assert cfg.max_frames == 28 and cfg.dtype == "bfloat16"
    assert set(PRESETS) == {
        "msvd_xe_meanpool", "msrvtt_xe_attention", "msrvtt_scst",
        "msrvtt_cst_consensus", "msrvtt_eval_beam5",
    }
    with pytest.raises(ValueError, match="decode_impl"):
        tcfg.ModelConfig(decode_impl="triton")
    if not torch.cuda.is_available():
        # entry points default to the GPU and never fall back on their own
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TorchCaptionModel(_configs("meanpool")[1])


def test_decoding_common_matches_jax():
    from cst_captioning_tpu.decoding import common as jc
    from cst_captioning_tpu_torch.decoding import common as tc

    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32)
    tok = rng.integers(0, 11, size=(3, 5)).astype(np.int32)
    fin = rng.random((3, 5)) < 0.4
    lt, tt = torch.from_numpy(logits), torch.from_numpy(tok)
    _close(jc.selected_logprob(jnp.asarray(logits), jnp.asarray(tok)),
           tc.selected_logprob(lt, tt))
    _close(jc.row_logprobs(jnp.asarray(logits)), tc.row_logprobs(lt))
    np.testing.assert_array_equal(
        np.asarray(jc.forbid_special(jnp.asarray(logits))),
        tc.forbid_special(lt).numpy())
    j_out = jc.step_outputs(jnp.asarray(tok), jnp.asarray(logits[..., 0]),
                            jnp.asarray(fin))
    t_out = tc.step_outputs(tt, lt[..., 0], torch.from_numpy(fin))
    for a, b in zip(j_out, t_out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    lp = rng.normal(size=(3, 5, 7)).astype(np.float32)
    lp[2] = lp[0]                      # a tie: the lowest lane wins
    want = np.asarray(jc.npad_best_lane_index(jnp.asarray(lp)))
    np.testing.assert_array_equal(
        tc.npad_best_lane_index(torch.from_numpy(lp)).numpy(), want)
    np.testing.assert_array_equal(tc.npad_best_lane_index(lp), want)
