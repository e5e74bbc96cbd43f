"""The port's actor/learner submesh arithmetic (``parallel/submesh.py``)
against the JAX package's on the same counts, case for case with
``tests/test_async_scst.py:86-170``: the JAX side plans over the
conftest's virtual CPU devices, the port over the ranks of a ``DataMesh``
(a plan's arithmetic needs no process group), and device index i of the
JAX mesh is rank i of the port's. Also the row split of a 2-D grid, and
``train.mesh.submesh``'s view of a side."""

import jax
import numpy as np
import pytest
import torch  # graftlint: disable=GL006
from jax.sharding import Mesh

from cst_captioning_tpu.parallel import grow_actors as jax_grow
from cst_captioning_tpu.parallel import largest_divisor as jax_divisor
from cst_captioning_tpu.parallel import plan_submesh as jax_plan
from cst_captioning_tpu.parallel import shared_plan as jax_shared
from cst_captioning_tpu.parallel import shrink_actors as jax_shrink
from cst_captioning_tpu.train.mesh import make_mesh as jax_make_mesh
from cst_captioning_tpu_torch.parallel import (
    SubmeshPlan,
    grow_actors,
    largest_divisor,
    plan_submesh,
    shared_plan,
    shrink_actors,
)
from cst_captioning_tpu_torch.train.mesh import DataMesh, GridMesh, submesh

torch.set_num_threads(1)


def _meshes(n: int):
    devs = jax.devices()[:n]
    return (Mesh(np.asarray(devs), ("data",)),
            DataMesh("data", 0, n, torch.device("cpu")))


def _ids(devices) -> tuple:
    order = [d.id for d in jax.devices()]
    return tuple(order.index(d.id) for d in devices)


def _same(jp, tp):
    """A JAX plan and a port plan name the same members, in order."""
    assert jp is not None and tp is not None
    assert _ids(jp.actor_devices) == tp.actor_ranks
    assert _ids(jp.learner_devices) == tp.learner_ranks
    assert jp.shared == tp.shared
    assert (jp.n_actors, jp.n_learners) == (tp.n_actors, tp.n_learners)


@pytest.mark.parametrize("batch,upper", [
    (8, 3), (8, 4), (6, 4), (7, 4), (0, 5), (8, 0), (64, 2), (64, 3),
    (1, 1), (12, 5)])
def test_largest_divisor(batch, upper):
    assert largest_divisor(batch, upper) == jax_divisor(batch, upper)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("fraction", [0.25, 0.5, 0.75])
@pytest.mark.parametrize("batch", [0, 6, 8, 64])
def test_plan_submesh_matches_jax(n, fraction, batch):
    jm, tm = _meshes(n)
    jp = jax_plan(jm, fraction, batch_size=batch)
    tp = plan_submesh(tm, fraction, batch_size=batch)
    _same(jp, tp)
    if not tp.shared:
        assert set(tp.actor_ranks).isdisjoint(tp.learner_ranks)
        assert tp.n_actors >= 1 and tp.n_learners >= 1
        if batch:
            assert batch % tp.n_actors == 0 and batch % tp.n_learners == 0


def test_plan_submesh_single_device_is_shared():
    jm, tm = _meshes(1)
    tp = plan_submesh(tm, 0.5, batch_size=8)
    assert tp.shared and tp.n_actors == tp.n_learners == 1
    _same(jax_plan(jm, 0.5, batch_size=8), tp)
    assert tp.actor is tm and tp.learner is tm


def test_shared_plan_spans_full_mesh():
    jm, tm = _meshes(8)
    tp = shared_plan(tm)
    assert tp.shared and tp.n_actors == tp.n_learners == 8
    _same(jax_shared(jm), tp)


@pytest.mark.parametrize("n,batch,drop", [(8, 8, 0), (8, 8, 3), (8, 6, 1),
                                          (4, 8, 0), (6, 64, 2)])
def test_shrink_actors_reclamps_and_exhausts(n, batch, drop):
    jm, tm = _meshes(n)
    jp = jax_plan(jm, 0.5, batch_size=batch)
    tp = plan_submesh(tm, 0.5, batch_size=batch)
    learners = tp.learner_ranks
    while tp is not None and tp.n_actors > 1:
        jp = jax_shrink(jp, drop, batch_size=batch)
        smaller = shrink_actors(tp, drop, batch_size=batch)
        _same(jp, smaller)
        assert smaller.n_actors < tp.n_actors
        assert batch % smaller.n_actors == 0
        assert smaller.learner_ranks == learners   # the learners stay
        tp = smaller
    # the last actor cannot be shed: the caller falls back to sync
    assert shrink_actors(tp, drop, batch_size=batch) is None
    assert jax_shrink(jp, drop, batch_size=batch) is None


def test_grow_actors_round_trip_restores_initial_plan():
    jm, tm = _meshes(8)
    j_init = jax_plan(jm, 0.5, batch_size=8)
    t_init = plan_submesh(tm, 0.5, batch_size=8)
    victim_dev, victim = j_init.actor_devices[0], t_init.actor_ranks[0]
    j_shrunk = jax_shrink(j_init, 0, batch_size=8)
    t_shrunk = shrink_actors(t_init, 0, batch_size=8)
    _same(j_shrunk, t_shrunk)
    assert victim not in t_shrunk.actor_ranks
    grown = grow_actors(t_shrunk, victim, t_init, batch_size=8, dead=set())
    _same(jax_grow(j_shrunk, victim_dev, j_init, batch_size=8, dead=set()),
          grown)
    assert grown.actor_ranks == t_init.actor_ranks
    assert grown.learner_ranks == t_init.learner_ranks
    # a duplicate rejoin changes nothing
    assert grow_actors(grown, victim, t_init, batch_size=8) is None
    assert jax_grow(jax_grow(j_shrunk, victim_dev, j_init, batch_size=8),
                    victim_dev, j_init, batch_size=8) is None
    # still-dead peers stay out of the grown membership
    other_dev, other = j_init.actor_devices[1], t_init.actor_ranks[1]
    jp = jax_grow(j_shrunk, victim_dev, j_init, batch_size=8,
                  dead={other_dev})
    tp = grow_actors(t_shrunk, victim, t_init, batch_size=8, dead={other})
    if jp is None:
        assert tp is None
    else:
        _same(jp, tp)
        assert other not in tp.actor_ranks
    # a rank that never belonged to the actor side is refused
    with pytest.raises(ValueError, match="never in the initial actor plan"):
        grow_actors(t_shrunk, t_init.learner_ranks[0], t_init, batch_size=8)
    with pytest.raises(ValueError, match="never in the initial actor plan"):
        jax_grow(j_shrunk, j_init.learner_devices[0], j_init, batch_size=8)
    # growing out of the sync fallback (no surviving plan) also works
    _same(jax_grow(None, victim_dev, j_init, batch_size=8),
          grow_actors(None, victim, t_init, batch_size=8))
    # a shared initial plan has nothing to grow
    assert grow_actors(None, 0, shared_plan(tm)) is None


def test_two_d_mesh_is_refused_naming_its_slice():
    """A (data, mp) grid splits along its data rows, as the JAX package's
    ``_plan_submesh_2d`` on as many virtual devices (device i = rank i):
    each side keeps every mp column, seen from each rank; only the 1-D
    shrink and grow refuse the 2-D plan, with the JAX messages."""
    jmesh = jax_make_mesh(mp_devices=2)                 # (4, 2)
    jplan = jax_plan(jmesh, actor_fraction=0.5, batch_size=4)
    dev = torch.device("cpu")
    for me in range(8):
        grid = GridMesh(rank=me, world=8, device=dev,
                        data=DataMesh("data", me // 2, 4, dev,
                                      ranks=tuple(range(me % 2, 8, 2))),
                        row=DataMesh("mp", me % 2, 2, dev,
                                     ranks=(me - me % 2, me - me % 2 + 1)))
        plan = plan_submesh(grid, 0.5, batch_size=4)
        assert not plan.shared
        assert plan.actor_ranks == _ids(jplan.actor_devices)
        assert plan.learner_ranks == _ids(
            jplan.learner_devices)
        side = plan.actor if me in plan.actor_ranks else plan.learner
        assert (plan.actor is None) == (me not in plan.actor_ranks)
        assert (plan.learner is None) == (me not in plan.learner_ranks)
        assert side.axis_names == jplan.actor.axis_names == ("data", "mp")
        assert side.shape["mp"] == 2 and side.row is grid.row
        # this rank's column: the same row split of its data ranks
        col = plan.column
        assert col.actor_ranks == tuple(r for r in plan.actor_ranks
                                        if r % 2 == me % 2)
        assert col.learner_ranks == tuple(r for r in plan.learner_ranks
                                          if r % 2 == me % 2)
        assert col.mesh is grid.data
    assert jplan.actor.shape["data"] + jplan.learner.shape["data"] == 4
    for mine, theirs in (
            (lambda: shrink_actors(plan, 0, batch_size=4),
             lambda: jax_shrink(jplan, 0, batch_size=4)),
            (lambda: grow_actors(plan, plan.actor_ranks[0], plan,
                                 batch_size=4),
             lambda: jax_grow(jplan, jplan.actor_devices[0], jplan,
                              batch_size=4))):
        with pytest.raises(ValueError, match="1-D") as m:
            mine()
        with pytest.raises(ValueError) as t:
            theirs()
        assert str(m.value) == str(t.value)


def test_submesh_views_a_side_from_each_rank():
    """A side's DataMesh: its index and size within the side, the global
    ranks; None off the side; no group without the parent's."""
    for me in range(4):
        mesh = DataMesh("data", me, 4, torch.device("cpu"))
        side = submesh(mesh, (2, 3))
        if me < 2:
            assert side is None
        else:
            assert (side.rank, side.world, side.ranks) == (me - 2, 2, (2, 3))
            assert side.group is None
        plan = plan_submesh(mesh, 0.5, batch_size=8)
        assert isinstance(plan, SubmeshPlan)
        assert (plan.actor is None) == (me >= 2)
        assert (plan.learner is None) == (me < 2)
    with pytest.raises(ValueError, match="not distinct ranks"):
        submesh(DataMesh("data", 0, 2, torch.device("cpu")), (1, 2))
