"""The port's gradient communication (``parallel/comms.py``) against the
JAX package's: the bucket plan leaf for leaf and byte for byte (the JAX
test trees of ``tests/test_comms.py`` and a real model, whose JAX leaves
the port locates in its fused tensors), ``ledger``, ``per_leaf_f32_bytes``
and ``mp_shard_view``; the ``comm.*`` gauges; the knobs' validation with
the JAX messages. At two gloo ranks (one launch, ``test_torch_dp_child``):
the per-leaf f32 all-reduce equals the elementwise sum, bucketed f32 at
every target is bitwise equal to it, bf16 on the wire stays within the JAX
tolerance, a started (async) reduction equals the blocking one, and
``train.mesh.replicate`` leaves every rank with rank 0's state. The bf16
master-accumulation drift runs in this process (world 1 casts as two
ranks do)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.config.config import (
    ExperimentConfig as JaxExperimentConfig,
)
from cst_captioning_tpu.config.config import ModelConfig as JaxModelConfig
from cst_captioning_tpu.config.config import TrainConfig as JaxTrainConfig
from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.parallel import comms as jcomms
from cst_captioning_tpu_torch import obs
from cst_captioning_tpu_torch.config import (
    ExperimentConfig,
    MeshConfig,
    ModelConfig,
    RLConfig,
    TrainConfig,
)
from cst_captioning_tpu_torch.convert import load_flax_params
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.parallel import comms
from cst_captioning_tpu_torch.rl import make_parallel_rl_update
from cst_captioning_tpu_torch.train.mesh import (
    make_mesh,
    param_leaves,
    tree_leaves,
)
from test_torch_dp_child import launch_ok

torch.set_num_threads(1)

V = 17
MODEL = dict(vocab_size=29, modalities=(("resnet", 8), ("c3d", 6)),
             d_embed=12, d_hidden=10, d_att=6, max_len=6, max_frames=4,
             dtype="float32", dropout=0.0, num_layers=2)


def _param_like_tree(rng):
    """The JAX test's tree: paths hit the families, flatten order (sorted
    keys) differs from family order."""
    shape = {"params": {
        "cell": {"out_proj": {"kernel": (24, V), "bias": (V,)},
                 "word_embed": {"embedding": (V, 24)}},
        "encoder": {"embed_resnet": {"kernel": (8, 24), "bias": (24,)}},
        "init_h0": {"kernel": (24, 24)}}}
    return jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                        shape, is_leaf=lambda x: isinstance(x, tuple))


def _plan_rows(plan):
    return [(tuple(b.indices), str(b.wire_dtype), int(b.bytes_on_wire))
            for b in plan.buckets]


def _np_tree(jtree):
    return jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), jtree)


@pytest.fixture(scope="module")
def model_pair():
    jm = JaxCaptionModel(JaxModelConfig(**MODEL))
    feats = {"resnet": jnp.zeros((2, 4, 8)), "c3d": jnp.zeros((2, 4, 6))}
    masks = {k: jnp.ones((2, 4)) for k in feats}
    params = jm.init(jax.random.key(0), feats, masks,
                     jnp.zeros((2, 6), jnp.int32))
    tm = CaptionModel(ModelConfig(**MODEL), device="cpu")
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    return params, tm


# ---- the planner against the JAX planner -------------------------------------

JAX_TREES = {
    "families": lambda: {"params": {
        "cell": {"word_embed": {"embedding":
                                jax.ShapeDtypeStruct((4000, 32), jnp.float32)}},
        "encoder": {"embed_resnet": {"kernel":
                                     jax.ShapeDtypeStruct((64, 32),
                                                          jnp.float32)}},
        "stray": jax.ShapeDtypeStruct((7,), jnp.float32)}},
    "small_leaves": lambda: {f"params/x{i:02d}":
                             jax.ShapeDtypeStruct((10,), jnp.float32)
                             for i in range(12)},
    "two": lambda: {"a": jax.ShapeDtypeStruct((5,), jnp.float32),
                    "b": jax.ShapeDtypeStruct((6,), jnp.float32)},
    "param_like": lambda: jax.tree.map(
        jnp.asarray, _param_like_tree(np.random.default_rng(0))),
}
COMMS = [dict(), dict(bucket_mb=0.25), dict(bucket_mb=0.0),
         dict(bucket_mb=0.001), dict(dtype="bf16"),
         dict(dtype="bf16", bucket_mb=0.0)]


@pytest.mark.parametrize("tree", sorted(JAX_TREES))
@pytest.mark.parametrize("kw", COMMS, ids=lambda kw: str(kw) or "default")
def test_plan_buckets_equals_jax_on_the_jax_trees(tree, kw):
    jtree = JAX_TREES[tree]()
    leaves, _ = tree_leaves(_np_tree(jtree))
    want = jcomms.plan_buckets(jtree, jcomms.CommConfig(**kw))
    got = comms.plan_buckets(leaves, comms.CommConfig(**kw))
    assert _plan_rows(got) == _plan_rows(want)
    assert (got.n_leaves, got.bytes_on_wire) == \
        (want.n_leaves, want.bytes_on_wire)
    assert comms.per_leaf_f32_bytes(leaves) == \
        jcomms.per_leaf_f32_bytes(jtree)


def test_plan_orders_by_family_and_keeps_the_size_target():
    """tests/test_comms.py's planner case, on the port."""
    leaves, _ = tree_leaves(_np_tree(JAX_TREES["families"]()))
    plan = comms.plan_buckets(leaves, comms.CommConfig(bucket_mb=0.25))
    order = [leaves[i].path for b in plan.buckets for i in b.indices]
    assert order == ["params/encoder/embed_resnet/kernel",
                     "params/cell/word_embed/embedding", "params/stray"]
    target = int(0.25 * (1 << 20))
    assert all(b.bytes_on_wire <= target or len(b.indices) == 1
               for b in plan.buckets)
    [emb] = [b for b in plan.buckets if 0 in b.indices]
    assert emb.indices == (0,)


@pytest.mark.parametrize("kw", COMMS, ids=lambda kw: str(kw) or "default")
def test_model_plan_equals_jax(model_pair, kw):
    """The port's model, its leaves located in the fused tensors, plans
    exactly the JAX model's buckets."""
    params, tm = model_pair
    leaves = param_leaves(tm)
    want = jcomms.plan_buckets(params, jcomms.CommConfig(**kw))
    got = comms.plan_buckets(leaves, comms.CommConfig(**kw))
    assert _plan_rows(got) == _plan_rows(want)
    for reductions, mp in ((1, 1), (3, 1), (1, 2)):
        assert comms.ledger(leaves, comms.CommConfig(**kw), reductions,
                            mp) == jcomms.ledger(
            params, jcomms.CommConfig(**kw), reductions, mp)
    assert comms.ledger(leaves, None, 2) == jcomms.ledger(params, None, 2)


def test_mp_shard_view_equals_jax(model_pair):
    params, tm = model_pair
    want = [x.size for x in jax.tree_util.tree_leaves(
        jcomms.mp_shard_view(params, 4))]
    got = [lf.numel for lf in comms.mp_shard_view(param_leaves(tm), 4)]
    assert got == want
    assert comms.mp_shard_view(param_leaves(tm), 1) == param_leaves(tm)
    assert comms.per_leaf_f32_bytes(param_leaves(tm)) == \
        jcomms.per_leaf_f32_bytes(params)


def test_reduce_observes_the_plan_gauges(model_pair, tmp_path):
    _, tm = model_pair
    leaves = param_leaves(tm)
    comm = comms.CommConfig(bucket_mb=0.001)
    obs.configure(str(tmp_path), run="comms")
    try:
        grads = [torch.ones_like(p) for p in tm.parameters()]
        out = comms.reduce_tree(grads, make_mesh(device="cpu"), comm, leaves)
        led = comms.ledger(leaves, comm)
        assert obs.gauge("comm.buckets").value == led["buckets"]
        assert obs.gauge("comm.bytes_on_wire").value == \
            led["bytes_on_wire_per_update"]
        assert obs.histogram("comm.bucket_bytes").count == led["buckets"]
        # world 1: the reduction is the identity, in new tensors
        assert all(torch.equal(a, b) and a is not b
                   for a, b in zip(out, grads))
    finally:
        obs.shutdown()


def test_reducer_plans_once_and_observes_once(model_pair, tmp_path):
    """A step factory's reducer builds its plan once and sets the gauges
    at its first reduction only: the histogram holds one sample a bucket
    after three reductions (the JAX step observes its plan at trace)."""
    _, tm = model_pair
    leaves = param_leaves(tm)
    comm = comms.CommConfig(bucket_mb=0.001)
    obs.REGISTRY.reset()
    obs.configure(str(tmp_path), run="comms")
    try:
        reducer = comms.GradReducer(leaves, make_mesh(device="cpu"), comm)
        assert reducer.plan == comms.plan_buckets(leaves, comm)
        grads = [torch.ones_like(p) for p in tm.parameters()]
        for _ in range(3):
            out = reducer(grads)
        assert obs.histogram("comm.bucket_bytes").count == \
            len(reducer.plan.buckets)
        assert obs.gauge("comm.buckets").value == len(reducer.plan.buckets)
        assert all(torch.equal(a, b) for a, b in zip(out, grads))
    finally:
        obs.shutdown()


# ---- two ranks --------------------------------------------------------------


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, model_pair):
    rng = np.random.default_rng(1)
    trees = [_param_like_tree(rng) for _ in range(2)]
    params, _ = model_pair
    base = jax.tree.map(np.asarray, params)
    model_rank = [{"model": MODEL, "params": jax.tree.map(
        lambda x, r=r: x + np.float32(r), base)} for r in range(2)]
    res = launch_ok("comms", {"trees": trees, "model_rank": model_rank},
                    tmp_path_factory.mktemp("dp_comms"))
    leaves, values = tree_leaves(trees[0])
    _, values1 = tree_leaves(trees[1])
    want = [a + b for a, b in zip(values, values1)]
    return dict(res=res, want=want, model_rank=model_rank, tree0=values)


def test_two_rank_per_leaf_is_the_elementwise_sum(two_ranks):
    for r in two_ranks["res"]:
        assert r["inputs_kept"]
        for got, want in zip(r["none"], two_ranks["want"]):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mb", [4.0, 0.001, 0.0])
def test_two_rank_bucketed_f32_bitwise_per_leaf(two_ranks, mb):
    for r in two_ranks["res"]:
        for got, want in zip(r[f"mb{mb}"], r["none"]):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(r["async"], r["none"]):
            np.testing.assert_array_equal(got, want)


def test_two_rank_bf16_within_jax_tolerance(two_ranks):
    """As tests/test_comms.py: a replicated tree (rank 0's on both ranks)
    reduced with bf16 on the wire, against its f32 sum."""
    for r in two_ranks["res"]:
        for got, x in zip(r["bf16"], two_ranks["tree0"]):
            assert got.dtype == x.dtype
            np.testing.assert_allclose(got, x + x, rtol=1.2e-2, atol=1e-6)
    np.testing.assert_array_equal(two_ranks["res"][0]["bf16"][0],
                                  two_ranks["res"][1]["bf16"][0])


def test_two_rank_replicate_takes_rank_zero(two_ranks):
    r0 = load_flax_params(CaptionModel(ModelConfig(**MODEL), device="cpu"),
                          two_ranks["model_rank"][0]["params"])
    want = [p.detach().numpy() for p in r0.parameters()]
    for r in two_ranks["res"]:
        params, mu0, step, count, seed = r["replicated"]
        for got, w in zip(params, want):
            np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(mu0, np.ones_like(mu0))
        assert (step, count, seed) == (3, 5, 0)


# ---- bf16 on the wire, the master accumulation ------------------------------


def test_bf16_master_accumulation_drift_bounded():
    """tests/test_comms.py's 50 synthetic SGD steps: bf16 on the wire
    against f32, the f32 parameters drift only by the per-step rounding."""
    rng = np.random.default_rng(3)
    leaves, values = tree_leaves(_param_like_tree(rng))
    mesh = make_mesh(device="cpu")
    lr = 0.01

    def run(comm):
        p = [torch.from_numpy(v.copy()) for v in values]
        for step in range(50):
            g = [torch.from_numpy(np.random.default_rng(step).normal(
                size=x.shape).astype(np.float32) * 8) for x in p]
            g = comms.reduce_tree(g, mesh, comm, leaves)
            p = [x - lr * gg for x, gg in zip(p, g)]
        return p

    p_ref, p_bf = run(None), run(comms.CommConfig(dtype="bf16"))
    for a, b in zip(p_ref, p_bf):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-2, rtol=0)
        assert not torch.equal(a, b)      # the wire really rounded


# ---- validation, with the JAX messages ---------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(dtype="f16"), "comm dtype"), (dict(overlap="async"), "overlap"),
    (dict(bucket_mb=-1.0), "bucket_mb")])
def test_comm_config_validation_as_jax(kw, match):
    msgs = []
    for cls in (comms.CommConfig, jcomms.CommConfig):
        with pytest.raises(ValueError, match=match) as e:
            cls(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kw,match", [
    (dict(comm_dtype="f16"), "comm_dtype"),
    (dict(comm_bucket_mb=-2.0), "comm_bucket_mb")])
def test_train_config_validates_comm_knobs_as_jax(kw, match):
    with pytest.raises(ValueError, match=match) as e1:
        TrainConfig(**kw)
    with pytest.raises(ValueError, match=match) as e2:
        JaxTrainConfig(**kw)
    assert str(e1.value) == str(e2.value)


def test_experiment_config_overlap_needs_chunks_as_jax():
    with pytest.raises(ValueError, match="update_chunks") as e1:
        ExperimentConfig(train=TrainConfig(comm_overlap=True))
    with pytest.raises(ValueError, match="update_chunks") as e2:
        JaxExperimentConfig(train=JaxTrainConfig(comm_overlap=True))
    assert str(e1.value) == str(e2.value)
    ExperimentConfig(train=TrainConfig(comm_overlap=True),
                     rl=RLConfig(update_chunks=5))


def test_comm_on_seq_parallel_is_refused():
    with pytest.raises(ValueError, match="sequence-parallel"):
        ExperimentConfig(train=TrainConfig(comm_dtype="bf16"),
                         mesh=MeshConfig(seq_devices=2))


def test_factory_rejects_overlap_without_chunks(model_pair):
    _, tm = model_pair
    with pytest.raises(ValueError, match="chunks"):
        make_parallel_rl_update(tm, make_mesh(device="cpu"), chunks=1,
                                comm=comms.CommConfig(overlap="defer"))


def test_from_train_maps_knobs():
    t = TrainConfig(comm_bucket_mb=2.5, comm_dtype="bf16", comm_overlap=True)
    c = comms.CommConfig.from_train(t)
    assert (c.bucket_mb, c.dtype, c.overlap) == (2.5, "bf16", "defer")
    assert comms.CommConfig.from_train(TrainConfig()).overlap == "off"
    jt = JaxTrainConfig(comm_bucket_mb=2.5, comm_dtype="bf16",
                        comm_overlap=True)
    assert jcomms.CommConfig.from_train(jt) == jcomms.CommConfig(
        c.bucket_mb, c.dtype, c.overlap)
