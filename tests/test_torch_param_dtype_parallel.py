"""The data-parallel, chunked, sequence-parallel and model-parallel steps of
a ``param_dtype="bfloat16"`` model in the port, held against the JAX
package on the CPU.

``tests/test_torch_param_dtype.py``'s model, weights (a seeded float32
tree cast to bfloat16) and inputs, at compute dtype float32; the port's
ranks are two gloo processes (``test_torch_dp_child.job_bf16_steps``):
data parallel, a (1 x 2) ``('data', 'seq')`` grid and a (1 x 2)
``('data', 'mp')`` grid.

Where the JAX package divides the summed gradients by a float32
denominator (the data-parallel XE step and RL update, every chunked RL
update, the model-parallel grid's steps, which are the data-parallel ones
with the row's broadcast) jnp promotes a bfloat16 gradient to float32,
and optax's Adam moments are float32 from that update on. The port does
the same (``train.steps.divide_grads``); the one-device XE step, the
unchunked update and the SP XE step keep both in bfloat16. Each case
pins those dtypes on both sides.

The references: the data-parallel cases against JAX's
``make_parallel_xe_step`` / ``make_parallel_rl_update`` on a one-device
mesh (the same code, the whole batch); the chunked cases against
``make_rl_update(chunks=3)``; the SP cases against the one-device JAX
functions, as ``tests/test_torch_seq_parallel.py`` holds them. JAX's
data-parallel steps on a two-device mesh are not a reference here: on
this JAX version they give twice the gradient, bfloat16 or float32 (the
grad norm reads 0.5345 against 0.2673 on one device; the clip hides it
in the update).

Tolerances, one step from zero moments. The first moment is ``mu = 0.1
g``, the gradient itself, so it is what the step is held by; Adam's first
update is about ``lr`` an element whatever the gradient, so the
parameters carry little. The two sides' bfloat16 gradient sums round in
another order (each rank rounds its half, then the sum rounds):
- the loss 2e-5 relative, the grad norm 2^-8 relative (read: 1.1e-3);
- ``mu`` and ``nu`` by ``test_torch_param_dtype.moments_close`` (each
  leaf's element errors within 2^-4 and 2^-3 of its largest value, its
  relative L2 distance within 2^-4 and 2^-3, the tree's within 2^-6 and
  2^-5; the largest read for ``mu``: 0.021, 0.0099 and 0.0074, for
  ``nu``: 0.042, 0.026 and 0.016);
- the parameters within one bfloat16 ulp plus ``2 lr (1 + 2^-6)`` (two
  opposite first steps), bitwise on at least 0.98 of the elements.
``test_moment_gate_rejects_other_gradients`` shows the moment bound
failing for a step on half of the batch and for moments scaled by 1.05.
The two ranks of a case are bitwise equal, and the two-rank steps agree
with the port's one-process step on the whole batch by the same bounds
(there the moments are bfloat16, the two-rank ones float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from cst_captioning_tpu.rl.scst import make_parallel_rl_update as jax_prl
from cst_captioning_tpu.rl.scst import make_rl_update as jax_rl
from cst_captioning_tpu.train import make_mesh as jax_mesh
from cst_captioning_tpu.train import make_parallel_xe_step as jax_pxe
from cst_captioning_tpu.train import replicate as jax_replicate
from cst_captioning_tpu.train import shard_batch as jax_shard
from cst_captioning_tpu.train.steps import make_xe_step as jax_xe
from cst_captioning_tpu_torch import rl as trl
from cst_captioning_tpu_torch import train as ttrain
from test_torch_dp_child import launch_ok
from test_torch_param_dtype import (  # noqa: F401  (setup: a fixture)
    B,
    CLIP,
    GRAD_NORM,
    LR,
    _f32,
    _j,
    _jax_state,
    _jmodel,
    _kw,
    _pairs,
    _port_state,
    _t,
    moments_close,
    setup,
)

torch.set_num_threads(1)

PARAM_BITWISE = 0.98
def _params_close(pairs):
    same = []
    for path, w, g in pairs:
        w, g = _f32(w), _f32(g)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126)))
                      - 7)
        assert (np.abs(g - w) <= ulp + 2 * LR * (1 + 2.0 ** -6)).all(), path
        same.append(g.ravel() == w.ravel())
    assert np.mean(np.concatenate(same)) >= PARAM_BITWISE


def _jax_record(state, met, key):
    adam = state.opt_state[1][0]
    return dict(loss=float(met[key]), grad_norm=float(met["grad_norm"]),
                params=state.params, mu=adam.mu, nu=adam.nu,
                mdt={str(x.dtype) for x in jax.tree.leaves(adam.mu)
                     + jax.tree.leaves(adam.nu)})


def _hold(model, want, got):
    """``got`` (a port record: lists in parameter order) against ``want``
    (a JAX record: trees, or a port record) by the module's bounds."""
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=GRAD_NORM)
    for which, m in enumerate(("mu", "nu")):
        ok, worst = moments_close(_tree_pairs(model, want[m], got[m]), which)
        assert ok, (m, worst)
    _params_close(_tree_pairs(model, want["params"], got["params"]))


def _tree_pairs(model, want, got):
    if isinstance(want, list):
        return [(str(i), w, g) for i, (w, g) in enumerate(zip(want, got))]
    return _pairs(want, model, [torch.from_numpy(np.asarray(x))
                                for x in got])


def _port_record(state, m, key):
    f32 = lambda ts: [t.detach().float().numpy() for t in ts]  # noqa: E731
    return dict(loss=m[key], grad_norm=m["grad_norm"],
                params=f32(state.params), mu=f32(state.opt_state["mu"]),
                nu=f32(state.opt_state["nu"]),
                mdt={str(x.dtype).replace("torch.", "")
                     for x in state.opt_state["mu"] + state.opt_state["nu"]})


def _xe_args(s, rows=slice(None)):
    return (_t({k: v[rows] for k, v in s["feats"].items()}),
            _t({k: v[rows] for k, v in s["masks"].items()}),
            torch.from_numpy(s["labels"][rows]).long(),
            torch.from_numpy(s["mask"][rows]),
            torch.ones(len(s["labels"][rows])))


def _rl_args(s):
    return (_t(s["feats"]), _t(s["masks"]), torch.from_numpy(s["samples"]),
            torch.from_numpy(s["adv"]), torch.from_numpy(s["valid"]))


def _jax_rl_args(s):
    return (_j(s["feats"]), _j(s["masks"]), jnp.asarray(s["samples"]),
            jnp.asarray(s["adv"]), jnp.asarray(s["valid"]))


def _jax_xe_args(s):
    return (_j(s["feats"]), _j(s["masks"]), jnp.asarray(s["labels"]),
            jnp.asarray(s["mask"]), jnp.ones((B,), jnp.float32))


@pytest.fixture(scope="module")
def runs(setup, tmp_path_factory):
    """The port's two-rank cases (one launch), the JAX references and the
    port's one-process steps."""
    s = setup
    kw = _kw()
    args = dict(model={**kw, "modalities": list(kw["modalities"]),
                       "param_dtype": "bfloat16"},
                params=s["np_params"], train=dict(lr=LR, grad_clip=CLIP),
                xe=(s["feats"], s["masks"], s["labels"], s["mask"],
                    np.ones((B,), np.float32)),
                rl=dict(feats=s["feats"], masks=s["masks"],
                        samples=s["samples"], adv=s["adv"],
                        valid=s["valid"]))
    ranks = launch_ok("bf16_steps", args, tmp_path_factory.mktemp("bf16p"),
                      timeout=180)
    jm = _jmodel()
    jax_out = {}
    one = jax_mesh(1)
    kb = NamedSharding(one, P(None, "data"))
    xs, rs = _jax_xe_args(s), _jax_rl_args(s)
    st, met = jax_pxe(jm, one)(jax_replicate(one, _jax_state(s, jm)),
                               *jax_shard(one, xs))
    jax_out["dp_xe"] = _jax_record(st, met, "loss")
    rl_in = (*jax_shard(one, rs[:2]), jax.device_put(rs[2], kb),
             jax.device_put(rs[3], kb), jax_shard(one, rs[4]))
    st, met = jax_prl(jm, one)(jax_replicate(one, _jax_state(s, jm)),
                               *rl_in)
    jax_out["dp_rl"] = _jax_record(st, met, "rl_loss")
    st, met = jax_xe(jm)(_jax_state(s, jm), *xs)
    jax_out["xe"] = _jax_record(st, met, "loss")
    for chunks in (1, 3):
        st, met = jax_rl(jm, chunks=chunks)(_jax_state(s, jm), *rs)
        jax_out[f"rl{chunks}"] = _jax_record(st, met, "rl_loss")
    port = {}
    state, m = ttrain.make_xe_step(guard=True)(
        _port_state(s, "float32", "xla"), *_xe_args(s))
    port["xe"] = _port_record(state, m, "loss")
    for chunks in (1, 3):
        state, m = trl.make_rl_update(None, chunks=chunks)(
            _port_state(s, "float32", "xla"), *_rl_args(s))
        port[f"rl{chunks}"] = _port_record(state, m, "rl_loss")
    return dict(ranks=ranks, jax=jax_out, port=port,
                model=_port_state(s, "float32", "xla").model)


# the JAX reference of each two-rank case, and its moments' dtype
CASES = {
    "xe_none": ("dp_xe", "float32"), "xe_f32": ("dp_xe", "float32"),
    "xe_bf16": ("dp_xe", "float32"),
    "rl_none": ("dp_rl", "float32"), "rl_f32": ("dp_rl", "float32"),
    "rl_bf16": ("dp_rl", "float32"),
    "rl_c3": ("rl3", "float32"), "rl_c3_eager": ("rl3", "float32"),
    "rl_c3_defer": ("rl3", "float32"),
    "sp_xe": ("xe", "bfloat16"), "sp_rl1": ("rl1", "bfloat16"),
    "sp_rl3": ("rl3", "float32"),
    "mp_xe": ("dp_xe", "float32"), "mp_rl3": ("rl3", "float32"),
}


def test_jax_promotes_where_it_divides_by_a_float32_array(runs):
    """The reference's dtypes, pinned: float32 moments after the
    data-parallel and chunked steps, bfloat16 after the one-device XE
    step and the unchunked update."""
    j = runs["jax"]
    for key in ("dp_xe", "dp_rl", "rl3"):
        assert j[key]["mdt"] == {"float32"}, key
    for key in ("xe", "rl1"):
        assert j[key]["mdt"] == {"bfloat16"}, key
    for key in j:
        assert {str(x.dtype) for x in jax.tree.leaves(j[key]["params"])} \
            == {"bfloat16"}


@pytest.mark.parametrize("chunks", [1, 3])
def test_one_process_rl_update_matches_jax(runs, chunks):
    """``make_rl_update(chunks)`` of the bf16 model: chunks 3 widens the
    moments to float32 as JAX's does."""
    want, got = runs["jax"][f"rl{chunks}"], runs["port"][f"rl{chunks}"]
    assert got["mdt"] == want["mdt"] == {
        "float32" if chunks > 1 else "bfloat16"}
    _hold(runs["model"], want, got)


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_rank_step_matches_jax(runs, case):
    """Each two-rank case against its JAX reference (``CASES``); the two
    ranks bitwise equal, the parameters bfloat16 and finite."""
    r0, r1 = (r[case] for r in runs["ranks"])
    ref, mdt = CASES[case]
    assert r0["pdt"] == {"torch.bfloat16"} and r0["finite"]
    assert r0["mdt"] == {f"torch.{mdt}"} and runs["jax"][ref]["mdt"] == {mdt}
    assert r0["loss"] == r1["loss"] and r0["grad_norm"] == r1["grad_norm"]
    for m in ("params", "mu", "nu"):
        for a, b in zip(r0[m], r1[m]):
            np.testing.assert_array_equal(a, b, err_msg=f"{case} {m}")
    _hold(runs["model"], runs["jax"][ref], r0)


@pytest.mark.parametrize("kind", ["xe", "rl1"])
def test_two_ranks_agree_with_one_process(runs, kind):
    """The two-rank step against the port's one-process step on the whole
    batch: loss, grad norm and moments within the same bounds (the
    one-process moments are bfloat16, the two-rank ones float32; each is
    compared as float32 values)."""
    two = runs["ranks"][0]["xe_f32" if kind == "xe" else "rl_f32"]
    _hold(runs["model"], runs["port"][kind], two)


def test_moment_gate_rejects_other_gradients(setup, runs):
    """Controls: the moment bound fails for the XE step on the first half
    of the batch, and for the JAX step's moments scaled by 1.05."""
    s = setup
    full = runs["port"]["xe"]
    state, m = ttrain.make_xe_step(guard=True)(
        _port_state(s, "float32", "xla"), *_xe_args(s, slice(0, B // 2)))
    half = _port_record(state, m, "loss")
    assert not moments_close([(str(i), w, g) for i, (w, g) in enumerate(
        zip(full["mu"], half["mu"]))])[0]
    leaves = [_f32(x) for x in jax.tree.leaves(runs["jax"]["xe"]["mu"])]
    assert moments_close([(str(i), w, w) for i, w in enumerate(leaves)])[0]
    assert not moments_close([(str(i), w, w * 1.05)
                              for i, w in enumerate(leaves)])[0]
