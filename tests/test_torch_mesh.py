"""The port's data mesh and partition contract (``train/mesh.py``) against
the JAX package's ``train/mesh.py``: the two rule tables as plain data,
the JAX parameter paths of the port's model (``param_path_names``, from
``convert.py``'s layout) equal to the JAX model's on the same config, full
rule coverage, first-match specs and provenance; ``shard_batch`` /
``batch_sharding`` against the host-sharded ``Batcher``; the mesh's
refusals (the model- and sequence-parallel meshes, a ``num_devices`` the
run was not launched with). ``replicate`` at two ranks is in
``test_torch_comms.py`` (it shares that file's launch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch  # graftlint: disable=GL006

from cst_captioning_tpu.config.config import ModelConfig as JaxModelConfig
from cst_captioning_tpu.models import CaptionModel as JaxCaptionModel
from cst_captioning_tpu.train import mesh as jmesh
from cst_captioning_tpu_torch.config import ModelConfig
from cst_captioning_tpu_torch.convert import (
    load_flax_params,
    state_dict_to_flax,
)
from cst_captioning_tpu_torch.data import Batcher
from cst_captioning_tpu_torch.models import CaptionModel
from cst_captioning_tpu_torch.train import mesh as tmesh

torch.set_num_threads(1)

MODEL = dict(vocab_size=23, modalities=(("resnet", 8), ("c3d", 6)),
             d_embed=12, d_hidden=10, d_att=6, max_len=6, max_frames=4,
             dtype="float32", dropout=0.0)


@pytest.fixture(scope="module", params=[1, 2], ids=["layers1", "layers2"])
def models(request):
    kw = dict(MODEL, num_layers=request.param)
    jm = JaxCaptionModel(JaxModelConfig(**kw))
    feats = {"resnet": jnp.zeros((2, 4, 8)), "c3d": jnp.zeros((2, 4, 6))}
    masks = {k: jnp.ones((2, 4)) for k in feats}
    params = jm.init(jax.random.key(0), feats, masks,
                     jnp.zeros((2, 6), jnp.int32))
    tm = CaptionModel(ModelConfig(**kw), device="cpu")
    load_flax_params(tm, jax.tree.map(np.asarray, params))
    return params, tm


def _spec(p):
    return None if p is None else tuple(p)


@pytest.mark.parametrize("name", ["PARAM_PARTITION_RULES",
                                  "MP_PARAM_PARTITION_RULES"])
def test_rule_tables_equal_jax(name):
    want = [(f, pat, tuple(spec)) for f, pat, spec in getattr(jmesh, name)]
    got = list(getattr(tmesh, name))
    assert got == want
    assert tmesh.SHARDING_CONTRACT == jmesh.SHARDING_CONTRACT


def test_param_path_names_equal_jax(models):
    params, tm = models
    want = jmesh.param_path_names(params)
    assert tmesh.param_path_names(tm) == want
    shapes = [tuple(x.shape) for x in jax.tree_util.tree_leaves(params)]
    leaves = tmesh.param_leaves(tm)
    assert [lf.shape for lf in leaves] == shapes
    # every element of every port tensor is covered exactly once
    cover = [torch.zeros(p.numel(), dtype=torch.int32)
             for p in tm.parameters()]
    for lf in leaves:
        cover[lf.param][lf.offset:lf.offset + lf.numel] += 1
    assert all(bool((c == 1).all()) for c in cover)


def test_param_leaves_locate_the_jax_leaves(models):
    """A leaf's block of the port tensor holds the JAX leaf's values (the
    JAX kernel's transpose, or the gate's rows)."""
    params, tm = models
    flat = [p.detach().reshape(-1) for p in tm.parameters()]
    jleaves = jax.tree_util.tree_leaves(params)
    for lf, jl in zip(tmesh.param_leaves(tm), jleaves):
        block = flat[lf.param][lf.offset:lf.offset + lf.numel].numpy()
        jl = np.asarray(jl)
        # a kernel [in, out] lies as its transpose, the rest as it is
        want = jl.T if lf.path.endswith("/kernel") else jl
        np.testing.assert_array_equal(block, want.ravel(), err_msg=lf.path)
    # and the round trip through the flax layout agrees
    back = state_dict_to_flax(tm.cfg, tm.state_dict())
    assert jmesh.param_path_names(back) == tmesh.param_path_names(tm)


@pytest.mark.parametrize("name", ["PARAM_PARTITION_RULES",
                                  "MP_PARAM_PARTITION_RULES"])
def test_rule_coverage_and_specs_equal_jax(models, name):
    params, tm = models
    names = tmesh.param_path_names(tm)
    rules_j, rules_t = getattr(jmesh, name), getattr(tmesh, name)
    assert tmesh.rule_coverage(names, rules_t) == ([], [])
    assert tmesh.rule_coverage(names, rules_t) == \
        jmesh.rule_coverage(names, rules_j)
    assert tmesh.rule_provenance(rules_t, names) == \
        jmesh.rule_provenance(rules_j, names)
    want = [_spec(s) for s in jax.tree_util.tree_leaves(
        jmesh.match_partition_rules(rules_j, params),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]
    assert [_spec(s) for s in tmesh.match_partition_rules(rules_t, names)] \
        == want
    if name == "PARAM_PARTITION_RULES":
        assert tmesh.param_partition_specs(names) == [()] * len(names)


def test_rule_coverage_reports_gaps_as_jax():
    names = ["params/cell/out_proj/kernel", "params/stray"]
    assert tmesh.rule_coverage(names) == jmesh.rule_coverage(names)
    with pytest.raises(ValueError, match="matches no partition rule"):
        tmesh.match_rule(tmesh.PARAM_PARTITION_RULES, "params/stray")
    with pytest.raises(ValueError, match="matches no partition rule"):
        jmesh.match_rule(jmesh.PARAM_PARTITION_RULES, "params/stray")


def test_make_mesh_world_one_and_refusals():
    mesh = tmesh.make_mesh(device="cpu")
    assert (mesh.axis, mesh.rank, mesh.world) == ("data", 0, 1)
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": 1}
    assert mesh.group is None and mesh.device == torch.device("cpu")
    assert tmesh.make_mesh(1, device="cpu").world == 1
    with pytest.raises(ValueError, match="launch 4 processes"):
        tmesh.make_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="sequence-parallel slice"):
        tmesh.make_mesh(seq_devices=2, device="cpu")
    with pytest.raises(ValueError, match="sequence-parallel slice"):
        tmesh.make_mesh(mp_devices=2, device="cpu")
    with pytest.raises(ValueError, match="cannot compose"):
        tmesh.make_mesh(seq_devices=2, mp_devices=2, device="cpu")
    with pytest.raises(ValueError, match="cannot compose"):
        jmesh.make_mesh(seq_devices=2, mp_devices=2)


class _Store:
    def __init__(self, dim):
        self.dim = dim


class _Rec:
    def __init__(self, vid, n):
        self.video_id = vid
        self.caption_ids = [[4 + (n + j) % 7, 5] for j in range(2)]
        self.weights = [1.0, 0.5]


class _Dataset:
    max_frames = 3
    stores = {"resnet": _Store(4)}

    def __init__(self, n):
        self.records = [_Rec(f"v{i}", i) for i in range(n)]

    def features_for(self, vid):
        i = int(vid[1:])
        return {"resnet": (np.full((3, 4), i, np.float32),
                           np.ones((3,), np.float32))}


@pytest.mark.parametrize("mode", ["caption", "video"])
def test_shard_batch_is_the_host_shard_slice(mode):
    """shard_batch of a global batch is what Batcher(host_shard=(rank,
    world)) collates for that rank, for every batch of an epoch."""
    ds = _Dataset(11)
    kw = dict(batch_size=6, max_len=5, mode=mode, seq_per_vid=2, seed=3)
    whole = list(Batcher(ds, **kw).epoch())
    for rank in range(3):
        mesh = tmesh.DataMesh("data", rank, 3, torch.device("cpu"))
        assert tmesh.batch_sharding(mesh) == (rank, 3)
        part = list(Batcher(ds, **kw, host_shard=tmesh.batch_sharding(mesh))
                    .epoch())
        assert len(part) == len(whole)
        for b, p in zip(whole, part):
            got = tmesh.shard_batch(mesh, (b.labels, b.valid, b.feats))
            np.testing.assert_array_equal(got[0], p.labels)
            np.testing.assert_array_equal(got[1], p.valid)
            np.testing.assert_array_equal(got[2]["resnet"],
                                          p.feats["resnet"])
            t = tmesh.shard_batch(mesh, torch.from_numpy(b.mask))
            assert torch.equal(t, torch.from_numpy(p.mask))
    mesh = tmesh.DataMesh("data", 1, 4, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.shard_batch(mesh, np.zeros((6, 2)))
    kb = tmesh.shard_batch(mesh, np.arange(24).reshape(3, 8), dim=1)
    np.testing.assert_array_equal(kb, np.arange(24).reshape(3, 8)[:, 2:4])
