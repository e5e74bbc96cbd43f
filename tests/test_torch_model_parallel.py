"""The port's model parallelism: the sharded-vocab decode
(``ops/decode_mp.py``) on an ``'mp'`` row of gloo ranks
(``test_torch_mp_child.py``), the ``('data', 'mp')`` grid, its 2-D split
and the Trainer on it, against the JAX package's replicated kernels and
the port's own runs.

The decode cases follow ``tests/test_mp.py:184-322`` (V=24, E=H=12, one
LSTM layer, float32 and bfloat16 banks) at mp=2, with ties planted across
the shard boundary: ``out_proj`` columns 17 and 20 duplicate 5 and 8 (and
the noise with them), so an argmax or top-W tie falls between shard 0 and
shard 1, and token 13 (shard 1's local 1, BOS's local index on shard 0)
is boosted, so a shard that masked by local id would show. Tolerances:
tokens and beam candidate ids bitwise against the JAX replicated
``fused_decode_stride`` / ``fused_beam_step`` (interpret mode) and the
port's plain stride and beam step; logprobs and scores within 1e-5 (the
JAX pins' few-ulp allowance: the cross-shard logsumexp reassociates).
The JAX ``mp_decode_stride`` / ``mp_beam_step`` oracles are not used (red
on this JAX version).

The grid: ``make_mesh(mp_devices=2)`` on four ranks; a (2 x 2) grid's XE
and CST epochs (dropout 0.5, validation) and its split RL epoch bitwise
equal to two data-parallel ranks' and to the 1-D split's, every rank of a
row bitwise equal to its replica; the row's gradient broadcast holds a
perturbed replica to its row and, skipped (a planted fault), does not.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006
from jax.sharding import PartitionSpec as P

from cst_captioning_tpu.config.config import (
    ExperimentConfig as JaxExperimentConfig,
    MeshConfig as JaxMeshConfig,
    ModelConfig as JaxModelConfig,
)
from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.models.captioner import CaptionModel as CM
from cst_captioning_tpu.ops import decode_mp as jax_mp  # graftlint: disable=GL008
from cst_captioning_tpu.ops.decode_pallas import (  # graftlint: disable=GL008
    fused_beam_step as jax_beam_step,
    fused_decode_stride as jax_stride,
)
from cst_captioning_tpu.train.mesh import make_mesh as jax_make_mesh
from cst_captioning_tpu_torch.config import (
    ExperimentConfig,
    MeshConfig,
    ModelConfig,
    RLConfig,
)
from cst_captioning_tpu_torch.convert import (
    load_flax_params,
    random_flax_params,
)
from cst_captioning_tpu_torch.data import make_synthetic_dataset
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.ops import decode_mp
from cst_captioning_tpu_torch.ops.beam_step import fused_beam_step
from cst_captioning_tpu_torch.ops.decode_stride import fused_decode_stride
from cst_captioning_tpu_torch.rl import SCSTTrainer
from cst_captioning_tpu_torch.train.mesh import (
    DataMesh,
    GridMesh,
    is_seq_grid,
    mp_row,
)
from test_torch_dp_child import finish_ok, start

torch.set_num_threads(1)

MP_CHILD = os.path.join(os.path.dirname(__file__), "test_torch_mp_child.py")
ULP = 1e-5          # logprobs / scores (tests/test_mp.py's few-ulp allowance)
V, B, D, F = 24, 5, 12, 6
TIES = ((5, 17, 2.0), (8, 20, 1.0))   # (shard-0 id, its shard-1 twin, boost)
BANKS = ("float32", "bfloat16")
WIDTHS = (3, 5)


def _model_kw(vocab=V):
    return dict(vocab_size=vocab, modalities=(("resnet", 16),), d_embed=D,
                d_hidden=D, d_att=6, encoder="temporal_attention",
                dropout=0.0, max_len=8, max_frames=F, dtype="float32")


def _setup():
    """The JAX model's weights with the ties planted, and its encoder
    output on ragged masks."""
    jm = JaxCaptionModel(JaxModelConfig(**_model_kw()))
    rng = np.random.default_rng(0)
    feats = {"resnet": jnp.asarray(rng.normal(size=(B, F, 16)), jnp.float32)}
    masks = {"resnet": jnp.asarray(
        np.arange(F)[None] < rng.integers(2, F + 1, size=(B, 1)),
        jnp.float32)}
    params = jm.init(jax.random.key(0), feats, masks,
                     jnp.zeros((B, 8), jnp.int32))
    params = jax.tree.map(np.array, params)
    head = params["params"]["cell"]["out_proj"]
    for lo, hi, boost in TIES:
        head["bias"][lo] += boost
        head["kernel"][:, hi] = head["kernel"][:, lo]
        head["bias"][hi] = head["bias"][lo]
    head["bias"][2] += 2.5     # EOS: rollouts end at different steps
    head["bias"][13] += 1.5    # shard 1's local 1 (global 13) must stay live
    enc = jm.apply(params, feats, masks, method=CM.encode)
    return params, enc, rng


def _lanes(enc, G, rng, finished):
    carry = tuple((np.broadcast_to(np.asarray(c)[None], (G,) + c.shape)
                   + rng.normal(scale=0.01, size=(G,) + c.shape),
                   np.broadcast_to(np.asarray(h)[None], (G,) + h.shape)
                   + rng.normal(scale=0.01, size=(G,) + h.shape))
                  for c, h in enc.carry)
    carry = tuple((c.astype(np.float32), h.astype(np.float32))
                  for c, h in carry)
    token = rng.integers(3, V, size=(G, B)).astype(np.int32)
    return carry, token, np.asarray(finished, bool)


def _cases(params, enc, rng):
    """The decode cases: stride (S=4, K=2, T=0.7, min_len 2) and with
    prefinished lanes (t0=3), beam W=3 and W=5 (the last lane finished),
    each on a float32 and a bfloat16 bank."""
    cases = {}
    S, K = 4, 2
    for bank in BANKS:
        common = dict(model=_model_kw(), params=params, bank=bank,
                      memory=np.array(enc.memory),
                      memory_proj=np.array(enc.memory_proj),
                      memory_mask=np.array(enc.memory_mask))
        for name, t0, fin, temp in (("stride", 0, np.zeros((K + 1, B)), 0.7),
                                    ("prefinished", 3, np.zeros((K + 1, B)),
                                     1.0)):
            if name == "prefinished":
                fin[1, :2] = 1
            carry, token, finished = _lanes(enc, K + 1, rng, fin)
            noise = rng.gumbel(size=(S, K, B, V)).astype(np.float32)
            for lo, hi, _ in TIES:
                noise[..., hi] = noise[..., lo]
            cases[f"{name}_{bank}"] = dict(
                common, kind="stride", carry=carry, token=token,
                finished=finished, noise=noise, t0=t0, steps=S,
                temperature=temp, min_len=2 if name == "stride" else 0)
        for W in WIDTHS:
            fin = np.zeros((W, B))
            fin[W - 1] = 1
            carry, token, finished = _lanes(enc, W, rng, fin)
            cases[f"beam{W}_{bank}"] = dict(
                common, kind="beam", carry=carry, token=token,
                finished=finished,
                scores=rng.normal(size=(W, B)).astype(np.float32), t=1,
                min_len=2)
    return cases


def _references(cases):
    """Each case through the JAX replicated kernel (interpret mode) and
    the port's plain version on the CPU."""
    port = load_flax_params(CaptionModel(ModelConfig(**_model_kw()),
                                         device="cpu"),
                            next(iter(cases.values()))["params"])
    out = {}
    for name, c in cases.items():
        cell = c["params"]["params"]["cell"]
        jd = jnp.dtype(c["bank"])
        td = getattr(torch, c["bank"])
        jbank = (jnp.asarray(c["memory"]).astype(jd),
                 jnp.asarray(c["memory_proj"]).astype(jd),
                 jnp.asarray(c["memory_mask"]))
        tbank = (torch.from_numpy(c["memory"]).to(td),
                 torch.from_numpy(c["memory_proj"]).to(td),
                 torch.from_numpy(c["memory_mask"]))
        jcarry = jax.tree.map(jnp.asarray, c["carry"])
        tcarry = tuple((torch.from_numpy(x), torch.from_numpy(y))
                       for x, y in c["carry"])
        tok, fin = torch.from_numpy(c["token"]), torch.from_numpy(
            c["finished"])
        if c["kind"] == "stride":
            kw = dict(steps=c["steps"], temperature=c["temperature"],
                      min_len=c["min_len"])
            _, jt, jl = jax_stride(cell, jcarry, jnp.asarray(c["token"]),
                                   jnp.asarray(c["finished"]), *jbank,
                                   jnp.asarray(c["noise"]),
                                   jnp.int32(c["t0"]), **kw)
            _, pt, pl = fused_decode_stride(
                port.cell, tcarry, tok, fin, *tbank,
                torch.from_numpy(c["noise"]), c["t0"], **kw)
        else:
            kw = dict(min_len=c["min_len"])
            _, jl, jt = jax_beam_step(cell, jcarry, jnp.asarray(c["token"]),
                                      jnp.asarray(c["finished"]),
                                      jnp.asarray(c["scores"]), *jbank,
                                      t=jnp.int32(c["t"]), **kw)
            _, pl, pt = fused_beam_step(port.cell, tcarry, tok, fin,
                                        torch.from_numpy(c["scores"]),
                                        *tbank, t=c["t"], **kw)
        out[name] = {"jax": (np.asarray(jt), np.asarray(jl)),
                     "plain": (pt.numpy(), pl.numpy())}
    return out


# ---- the trainer's corpus ----------------------------------------------------

TF = 8
MODAL = (("resnet", 8), ("c3d", 6))
CORPUS = dict(num_videos=24, num_topics=3, vocab_words=20,
              modalities=dict(MODAL), max_frames=TF, seed=11,
              caption_style="template", splits=(0.75, 0.125))


def _overrides(nv, **extra):
    return dict(model__vocab_size=nv, model__modalities=MODAL,
                model__d_embed=12, model__d_hidden=12, model__d_att=6,
                model__encoder="temporal_attention", model__max_len=8,
                model__max_frames=TF, model__dtype="float32",
                data__batch_size=4, rl__num_rollouts=3, rl__epochs=1,
                train__seed=3, train__log_every_steps=1, **extra)


def _xe_case():
    """A small model's weights and one global XE batch (the grid job)."""
    kw = dict(vocab_size=20, modalities=(("resnet", 10),), d_embed=12,
              d_hidden=12, d_att=8, encoder="temporal_attention",
              dropout=0.0, max_len=6, max_frames=8, dtype="float32")
    rng = np.random.default_rng(4)
    return dict(model=kw, params=random_flax_params(ModelConfig(**kw), 5),
                feats={"resnet": rng.normal(size=(4, 8, 10)).astype(
                    np.float32)},
                masks={"resnet": np.ones((4, 8), np.float32)},
                labels=rng.integers(4, 20, size=(4, 6)).astype(np.int64),
                mask=np.ones((4, 6), np.float32),
                weights=np.ones((4,), np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch of the file, started together (the JAX references
    are computed while the ranks run)."""
    root = tmp_path_factory.mktemp("mp")
    params, enc, rng = _setup()
    cases = _cases(params, enc, rng)
    tp = make_synthetic_dataset(str(root / "corpus"), **CORPUS)
    nv = len(json.load(open(tp["info_json"]))["vocab"])
    mkw = dict(vocab_size=nv, modalities=MODAL, d_embed=12, d_hidden=12,
               d_att=6, encoder="temporal_attention", max_len=8,
               max_frames=TF, dtype="float32")
    base = dict(preset="msrvtt_cst_consensus", info_json=tp["info_json"],
                features={n: tp[n] for n, _ in MODAL}, max_frames=TF)
    start_params = random_flax_params(ModelConfig(**mkw), 3)
    handles = {}
    for name, world, mesh in (("dp", 2, {}), ("grid", 4,
                                              {"mesh__mp_devices": 2})):
        tmp = root / f"trainer_{name}"
        tmp.mkdir()
        handles["trainer_" + name] = start("trainer", dict(
            base, overrides=_overrides(nv, model__dropout=0.5, **mesh),
            params=start_params, tmp=str(tmp), ckpt_dir=str(tmp / "ck"),
            rl=True), tmp, world, 240)
        tmp = root / f"split_{name}"
        tmp.mkdir()
        handles["split_" + name] = start("split_trainer", dict(
            base, overrides=_overrides(
                nv, model__dropout=0.0, rl__lr=5e-2,
                train__rl_topology="decoupled", **mesh),
            tmp=str(tmp), cases=[{"name": "split"}]), tmp, world, 240)
    handles["decode"] = start("decode", dict(cases=cases), root, 2, 240,
                              script=MP_CHILD)
    handles["grid"] = start("grid", dict(xe=_xe_case()), root, 4, 240,
                            script=MP_CHILD)
    refs = _references(cases)
    out = {k: finish_ok(h, k) for k, h in handles.items()}
    return dict(out=out, cases=cases, refs=refs)


# ---- the sharded decode ------------------------------------------------------


@pytest.mark.parametrize("bank", BANKS)
@pytest.mark.parametrize("name", ["stride", "prefinished"])
def test_mp_stride_matches_replicated(runs, name, bank):
    """Tokens bitwise equal to the JAX replicated stride and the port's
    plain stride on both ranks of the row; logprobs within 1e-5. The
    planted cross-shard ties went to shard 0's id (17 and 20 never win),
    shard 1's boosted token 13 was emitted, and EOS ended some lanes."""
    key = f"{name}_{bank}"
    ranks = runs["out"]["decode"]
    for r in ranks:
        tok, lp = r[key]
        for ref in ("jax", "plain"):
            want_t, want_l = runs["refs"][key][ref]
            np.testing.assert_array_equal(tok, want_t, err_msg=ref)
            np.testing.assert_allclose(lp, want_l, rtol=0, atol=ULP,
                                       err_msg=ref)
    tok = ranks[0][key][0]
    assert not np.isin(tok, [17, 20]).any()
    if name == "stride":
        assert (tok == 5).any() and (tok == 13).any()
        assert (tok == 2).any() and (tok == 0).any()
    else:
        assert (tok[:, 1, :2] == 0).all()
        assert (ranks[0][key][1][:, 1, :2] == 0.0).all()


@pytest.mark.parametrize("bank", BANKS)
@pytest.mark.parametrize("W", WIDTHS)
def test_mp_beam_step_matches_replicated(runs, W, bank):
    """Candidate flat ids bitwise equal to the JAX ``fused_beam_step`` and
    the port's plain beam step, in their tie order (the finished lane's
    PAD continuation and the duplicated columns tie exactly); scores
    within 1e-5."""
    key = f"beam{W}_{bank}"
    for r in runs["out"]["decode"]:
        sc, fl = r[key]
        for ref in ("jax", "plain"):
            want_f, want_s = runs["refs"][key][ref]
            np.testing.assert_array_equal(fl, want_f, err_msg=ref)
            np.testing.assert_allclose(sc, want_s, rtol=0, atol=ULP,
                                       err_msg=ref)
    # a shard-1 twin is chosen only right after its shard-0 id, same lane
    flat = runs["out"]["decode"][0][key][1]
    twins = [(row, k) for row in range(B) for k in range(W)
             if flat[row, k] % V in (17, 20)]
    assert twins
    for row, k in twins:
        assert k > 0 and flat[row, k - 1] == flat[row, k] - 12


@pytest.mark.parametrize("kind", ["stride", "beam3"])
def test_mp_collectives_per_step(runs, kind):
    """A stride step is the JAX spelling's 8 collectives (one embedding
    sum, two argmax merges of two gathers, the max and the sum of the
    logsumexp, the selected logit), a beam step 5; the bytes are those of
    the reduced buffers."""
    c = runs["cases"][f"{kind}_float32"]
    got = runs["out"]["decode"][0][f"{kind}_float32_counts"]
    G, E = c["token"].shape[0], D
    if kind == "stride":
        S = c["steps"]
        want = {"psum_embed": S, "all_gather": 4 * S, "pmax": S,
                "psum_lse": S, "psum_select": S}
        want_bytes = S * (G * B * E * 4 + 2 * (2 * B * 4 + 2 * (G - 1)
                                                * B * 4)
                          + 3 * G * B * 4)
    else:
        want = {"psum_embed": 1, "all_gather": 2, "pmax": 1, "psum_lse": 1}
        want_bytes = G * B * E * 4 + 2 * (2 * B * G * 4) + 2 * G * B * 4
    assert {k: v for k, v in got.items() if not k.endswith("_bytes")} == want
    assert sum(v for k, v in got.items() if k.endswith("_bytes")) == \
        want_bytes


@pytest.mark.parametrize("W", [1, 3, 5])
def test_merge_topw_matches_jax(W):
    """``_merge_topw`` alone on pools with planted score ties (equal
    scores under different flat ids, in any order): the JAX merge's
    scores and ids, which are the (score descending, id ascending)
    order."""
    rng = np.random.default_rng(W)
    N = 2 * 5
    pool_s = rng.choice([-1.0, 0.5, 0.5, 2.0, -np.inf], size=(6, N)
                        ).astype(np.float32)
    pool_f = np.stack([rng.permutation(100)[:N] for _ in range(6)]
                      ).astype(np.int32)
    js, jf = jax_mp._merge_topw(jnp.asarray(pool_s), jnp.asarray(pool_f), W)
    ts, tf = decode_mp._merge_topw(torch.from_numpy(pool_s),
                                   torch.from_numpy(pool_f), W)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert tf.dtype == torch.int32
    for b in range(6):
        order = sorted(range(N), key=lambda i: (-pool_s[b, i], pool_f[b, i]))
        np.testing.assert_array_equal(tf[b].numpy(), pool_f[b, order[:W]])


def _virtual_grid(mp=2, rank=0):
    dev = torch.device("cpu")
    return GridMesh(rank=rank, world=mp, device=dev,
                    data=DataMesh("data", 0, 1, dev, ranks=(rank,)),
                    row=DataMesh("mp", rank, mp, dev,
                                 ranks=tuple(range(mp))))


def _raises(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_mp_stride_validates_inputs():
    """The JAX messages: a vocabulary that does not divide over the row,
    a mesh without an ``'mp'`` axis, a noise of another vocabulary; and a
    row of several ranks without a process group."""
    cell23 = CaptionModel(ModelConfig(**_model_kw(23)), device="cpu").cell
    cell24 = CaptionModel(ModelConfig(**_model_kw()), device="cpu").cell
    fake = {"out_proj": {"kernel": np.zeros((4, 23), np.float32)},
            "word_embed": {"embedding": np.zeros((23, 4), np.float32)}}
    fake24 = {"out_proj": {"kernel": np.zeros((4, 24), np.float32)},
              "word_embed": {"embedding": np.zeros((24, 4), np.float32)}}
    jgrid = jax_make_mesh(mp_devices=2)
    noise = lambda v: np.zeros((1, 1, 1, v), np.float32)  # noqa: E731
    pairs = [
        (lambda: decode_mp.mp_decode_stride(
            cell23, None, None, None, None, None, None,
            torch.zeros(1, 1, 1, 23), 0, mesh=_virtual_grid(), steps=1),
         lambda: jax_mp.mp_decode_stride(
            fake, None, None, None, None, None, None, noise(23), 0,
            mesh=jgrid, steps=1)),
        (lambda: decode_mp.mp_decode_stride(
            cell24, None, None, None, None, None, None,
            torch.zeros(1, 1, 1, 24), 0,
            mesh=DataMesh("data", 0, 1, torch.device("cpu")), steps=1),
         lambda: jax_mp.mp_decode_stride(
            fake, None, None, None, None, None, None, noise(24), 0,
            mesh=jax_make_mesh(), steps=1)),
        (lambda: decode_mp.mp_decode_stride(
            cell24, None, None, None, None, None, None,
            torch.zeros(1, 1, 1, 23), 0, mesh=_virtual_grid(), steps=1),
         lambda: jax_mp.mp_decode_stride(
            fake24, None, None, None, None, None, None, noise(23), 0,
            mesh=jgrid, steps=1))]
    for mine, theirs in pairs:
        assert _raises(mine) == _raises(theirs)
    assert "has no process group" in _raises(
        lambda: decode_mp.mp_decode_stride(
            cell24, None, None, None, None, None, None,
            torch.zeros(1, 1, 1, 24), 0, mesh=_virtual_grid(), steps=1))


def test_mp_beam_step_rejects_wide_beam():
    cell8 = CaptionModel(ModelConfig(**_model_kw(8)), device="cpu").cell
    fake = {"out_proj": {"kernel": np.zeros((4, 8), np.float32)},
            "word_embed": {"embedding": np.zeros((8, 4), np.float32)}}
    mine = _raises(lambda: decode_mp.mp_beam_step(
        cell8, None, torch.zeros(5, 2, dtype=torch.int32), None, None, None,
        None, None, mesh=_virtual_grid(), t=0))
    theirs = _raises(lambda: jax_mp.mp_beam_step(
        fake, None, np.zeros((5, 2), np.int32), None, None, None, None,
        None, mesh=jax_make_mesh(mp_devices=2), t=0))
    assert mine == theirs and "beam width 5" in mine


@pytest.mark.parametrize("axis", ["mp", "model"])
def test_mp_cell_specs_shard_only_vocab_families(axis):
    """The vocab families shard over the axis, the recurrent weights the
    kernel consumes whole stay replicated: the JAX specs leaf for leaf."""
    kw = dict(_model_kw(), num_layers=2)
    jm = JaxCaptionModel(JaxModelConfig(**kw))
    params = jm.init(jax.random.key(0), {"resnet": jnp.zeros((1, F, 16))},
                     {"resnet": jnp.ones((1, F))},
                     jnp.zeros((1, 8), jnp.int32))
    want = jax.tree.map(tuple, jax_mp.mp_cell_specs(
        params["params"]["cell"], axis), is_leaf=lambda s: isinstance(s, P))
    got = decode_mp.mp_cell_specs(
        CaptionModel(ModelConfig(**kw), device="cpu"), axis)
    assert got == want
    assert got["word_embed"]["embedding"] == (axis,)
    assert got["out_proj"]["kernel"] == (None, axis)
    assert got["lstm1"]["hf"]["kernel"] == ()


def test_mp_row_of_one_rank_is_the_plain_stride():
    """A row of one rank runs no collective and gives the plain stride's
    tokens and logprobs (the carry is not frozen on finished rows, as in
    the JAX ``_reference_stride``)."""
    params, enc, rng = _setup()
    c = _cases(params, enc, rng)["stride_float32"]
    model = load_flax_params(CaptionModel(ModelConfig(**_model_kw()),
                                          device="cpu"), params)
    args = (model.cell, tuple((torch.from_numpy(x), torch.from_numpy(y))
                              for x, y in c["carry"]),
            torch.from_numpy(c["token"]), torch.from_numpy(c["finished"]),
            torch.from_numpy(c["memory"]), torch.from_numpy(c["memory_proj"]),
            torch.from_numpy(c["memory_mask"]), torch.from_numpy(c["noise"]),
            0)
    kw = dict(steps=c["steps"], temperature=c["temperature"],
              min_len=c["min_len"])
    decode_mp.reset_counts()
    _, tok, lp = decode_mp.mp_decode_stride(
        *args, mesh=DataMesh("mp", 0, 1, torch.device("cpu")), **kw)
    _, ptok, plp = fused_decode_stride(*args, **kw)
    assert torch.equal(tok, ptok) and decode_mp.COUNTS == {}
    np.testing.assert_allclose(lp.numpy(), plp.numpy(), rtol=0, atol=ULP)


# ---- the grid -------------------------------------------------------------


def test_make_mesh_mp_grid_on_four_ranks(runs):
    """``make_mesh(mp_devices=2)`` on four ranks: rank r is cell (r // 2,
    r % 2) of the ('data', 'mp') grid, its column the ranks of its mp
    coordinate, its row those of its data coordinate, and each group sums
    over exactly those ranks."""
    for r, res in enumerate(runs["out"]["grid"]):
        assert res["cell"] == (r // 2, r % 2)
        assert res["axis_names"] == ("data", "mp")
        assert res["shape"] == {"data": 2, "mp": 2}
        assert res["column"] == (r % 2, r % 2 + 2)
        assert res["row"] == (r - r % 2, r - r % 2 + 1)
        assert res["sums"] == [float(sum(res["column"])),
                               float(sum(res["row"]))]


def test_row_broadcast_holds_a_perturbed_replica(runs):
    """One XE step of the grid with the mp-rank-1 replicas' loss scaled by
    1 + 1e-3: the row's broadcast (one flat tensor, every gradient and
    the loss) leaves every rank with the mp-rank-0 replicas' parameters;
    skipped (planted), the rows' ranks differ."""
    res = runs["out"]["grid"]
    n = sum(p.size for p in res[0]["xe"][1]) + 1
    for r in res:
        assert r["xe"][2] == {"broadcasts": 1, "bytes": 4 * n}
        assert r["xe"][0] == res[0]["xe"][0]
        for a, b in zip(r["xe"][1], res[0]["xe"][1]):
            np.testing.assert_array_equal(a, b)
    assert not all(np.array_equal(a, b) for a, b in zip(
        res[1]["planted"][1], res[0]["planted"][1]))
    for a, b in zip(res[0]["planted"][1], res[0]["xe"][1]):
        np.testing.assert_array_equal(a, b)


def _bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("key", ["xe_params", "rl_params", "captions",
                                 "val", "rollouts"])
def test_grid_epochs_equal_data_parallel(runs, key):
    """A (2 x 2) mp grid's XE epoch (dropout 0.5, greedy validation) and
    CST epoch bitwise equal to two data-parallel ranks': each grid rank
    against its data coordinate's rank; every row's ranks alike."""
    dp, grid = runs["out"]["trainer_dp"], runs["out"]["trainer_grid"]
    for r, res in enumerate(grid):
        want = dp[r // 2][key]
        if isinstance(want, list):
            _bitwise(res[key], want)
        else:
            assert res[key] == want
        assert res["local_batch"] == dp[0]["local_batch"] == 2


def test_grid_split_rl_equals_one_dimensional_split(runs):
    """The split RL epoch over the (2 x 2) grid: each column runs the
    1-D split of its data ranks, and every rank ends bitwise equal to the
    1-D split over two ranks, with its steps and losses."""
    dp = runs["out"]["split_dp"]
    grid = runs["out"]["split_grid"]
    want = dp[0]["split"]
    for res in grid:
        got = res["split"]
        _bitwise(got["params"], want["params"])
        assert got["step"] == want["step"] > 0
        losses = [e["rl_loss"] for e in got["events"]
                  if e["event"] == "rl_step"]
        assert losses == [e["rl_loss"] for e in want["events"]
                          if e["event"] == "rl_step"]
    plans = [e for res in grid for e in res["split"]["events"]
             if e["event"] == "rl_split"]
    assert {(tuple(e["actors"]), tuple(e["learners"])) for e in plans} == \
        {((0,), (2,)), ((1,), (3,))}


def test_sp_branches_stay_off_on_an_mp_grid():
    """An mp grid is not sequence parallel (the JAX axis-name test): the
    SCST trainer takes the data-parallel decode and the row broadcast."""
    grid = _virtual_grid()
    assert not is_seq_grid(grid) and mp_row(grid) is grid.row
    with pytest.raises(AttributeError):
        grid.seq
    model = CaptionModel(ModelConfig(**_model_kw()), device="cpu")
    scst = SCSTTrainer(model, None, RLConfig(), mesh=grid)
    assert not scst.sp and scst.row is grid.row and scst._row_ranks() == 2


def test_experiment_config_validates_mp_devices():
    """The cases of the JAX config test, with the JAX messages."""
    ok = ExperimentConfig(model=ModelConfig(vocab_size=512, d_hidden=128),
                          mesh=MeshConfig(mp_devices=2, num_devices=8))
    assert ok.mesh.mp_devices == 2
    for model, mesh in (
            ({}, dict(mp_devices=0)),
            (dict(vocab_size=512, d_hidden=128),
             dict(mp_devices=2, seq_devices=2)),
            (dict(vocab_size=511, d_hidden=128), dict(mp_devices=2)),
            (dict(vocab_size=512, d_hidden=127), dict(mp_devices=2)),
            (dict(vocab_size=512, d_hidden=128),
             dict(mp_devices=2, num_devices=3))):
        mine = _raises(lambda: ExperimentConfig(
            model=ModelConfig(**model), mesh=MeshConfig(**mesh)))
        theirs = _raises(lambda: JaxExperimentConfig(
            model=JaxModelConfig(**model), mesh=JaxMeshConfig(**mesh)))
        assert mine == theirs
