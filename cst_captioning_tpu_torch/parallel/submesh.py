"""Actor/learner submeshes for decoupled SCST (the JAX package's
``parallel/submesh.py``).

``train.rl_topology="decoupled"`` (``rl/async_scst.py``) splits the ranks
of the 1-D data mesh into two disjoint sets: ACTOR ranks decode rollouts,
LEARNER ranks consume them with the REINFORCE update. A JAX device of the
split is a rank here (one process a device, ``train/mesh.py``), so a plan
holds ranks where the JAX plan holds devices: ``actor_ranks`` and
``learner_ranks`` (global ranks, actors first), and ``actor`` / ``learner``,
this rank's :class:`~cst_captioning_tpu_torch.train.mesh.DataMesh` of each
side (``train.mesh.submesh``: None on a rank outside it).

Two constraints shape the split, as in the JAX package:

- both sides need at least one rank (a 1-rank mesh gives the SHARED plan:
  one rank plays both roles, which is also the strict replay layout);
- each side's rank count must divide the global batch (its rows shard over
  the side), so counts clamp DOWN to the largest divisor of the batch
  size; the same rule reclamps the survivors after an ``actor_preempt``
  shrinks the actor side (:func:`shrink_actors`) and the grown set after a
  ``host_rejoin`` re-admits a shed rank (:func:`grow_actors`).

Building a plan creates the sides' process groups, which is collective
over the whole world: every rank plans, shrinks and grows in the same
order.

A 2-D grid (``train.mesh.GridMesh``, the ``(data, mp)`` grid of model
parallelism) splits along its DATA rows, as the JAX package's
``_plan_submesh_2d``: whole rows move together, so each side keeps every
mp column. Its sides are ``GridMesh`` views (the side's share of this
rank's column, and this rank's row), its ranks the sides' rows in
row-major order, and ``column`` the 1-D plan of this rank's column alone
(the same row split), which the split trainer runs with its row's
replicas. :func:`shrink_actors` and :func:`grow_actors` refuse a 2-D plan
with the JAX messages: one device out of a grid would break its mp
columns.
"""

from __future__ import annotations

from dataclasses import dataclass

from cst_captioning_tpu_torch.train import multihost
from cst_captioning_tpu_torch.train.mesh import DataMesh, GridMesh, submesh


def largest_divisor(batch: int, upper: int) -> int:
    """Largest d with 1 <= d <= upper and batch % d == 0 (1 always works)."""
    upper = max(1, upper)
    if batch <= 0:
        return upper
    for d in range(min(upper, batch), 0, -1):
        if batch % d == 0:
            return d
    return 1


@dataclass(frozen=True)
class SubmeshPlan:
    """The actor/learner split of a data mesh, seen from this rank.

    ``shared`` marks the degenerate layout where both roles run on the
    whole mesh (1-rank meshes, and the strict replay mode). ``mesh`` is
    the mesh the plan cuts; shrinking and growing re-cut it.
    """

    actor: DataMesh | None
    learner: DataMesh | None
    actor_ranks: tuple
    learner_ranks: tuple
    shared: bool
    mesh: DataMesh | GridMesh | None = None
    # a 2-D plan: this rank's column's 1-D split
    column: "SubmeshPlan | None" = None

    @property
    def n_actors(self) -> int:
        return len(self.actor_ranks)

    @property
    def n_learners(self) -> int:
        return len(self.learner_ranks)


def _plan(mesh: DataMesh, actors, learners) -> SubmeshPlan:
    actors, learners = tuple(actors), tuple(learners)
    return SubmeshPlan(actor=submesh(mesh, actors),
                       learner=submesh(mesh, learners), actor_ranks=actors,
                       learner_ranks=learners, shared=False, mesh=mesh)


def shared_plan(mesh: DataMesh | GridMesh) -> SubmeshPlan:
    """Both roles on the full mesh (strict replay / 1-rank layout)."""
    ranks = mesh.global_ranks
    column = shared_plan(mesh.data) if isinstance(mesh, GridMesh) else None
    return SubmeshPlan(mesh, mesh, ranks, ranks, shared=True, mesh=mesh,
                       column=column)


def plan_submesh(mesh: DataMesh, actor_fraction: float = 0.5,
                 batch_size: int = 0) -> SubmeshPlan:
    """Partition ``mesh`` into disjoint actor/learner submeshes.

    The actor side takes ``round(n * actor_fraction)`` ranks clamped so
    both sides keep at least one, then each side clamps down to the
    largest divisor of ``batch_size`` (0 = no batch constraint); actors
    are the first ranks. A mesh of one rank returns the shared plan. A
    2-D grid splits along its data rows (module docstring). The sides keep
    the mesh's axis names."""
    if len(mesh.axis_names) == 2:
        return _plan_submesh_2d(mesh, actor_fraction, batch_size)
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"plan_submesh needs a 1-D or 2-D mesh, got axes "
            f"{mesh.axis_names!r}")
    ranks = mesh.global_ranks
    n = len(ranks)
    if n < 2:
        return shared_plan(mesh)
    n_actor = max(1, min(n - 1, round(n * actor_fraction)))
    n_actor = largest_divisor(batch_size, n_actor)
    n_learner = largest_divisor(batch_size, n - n_actor)
    return _plan(mesh, ranks[:n_actor], ranks[n_actor:n_actor + n_learner])


def _plan_submesh_2d(grid: GridMesh, actor_fraction: float,
                     batch_size: int) -> SubmeshPlan:
    """Row split of a ``(data, mp)`` grid: whole mp columns move
    together. Every column's side groups are created, in column order, on
    every rank (collective over the world)."""
    rows, M = grid.data.world, grid.row.world
    if rows < 2:
        return shared_plan(grid)
    n_actor = max(1, min(rows - 1, round(rows * actor_fraction)))
    n_actor = largest_divisor(batch_size, n_actor)
    n_learner = largest_divisor(batch_size, rows - n_actor)
    a_rows = range(n_actor)
    l_rows = range(n_actor, n_actor + n_learner)
    for s in range(M):
        for side in (a_rows, l_rows):
            if len(side) > 1 and grid.group is not None:
                multihost.group_of([d * M + s for d in side])
    col = grid.data.global_ranks
    column = _plan(grid.data, [col[d] for d in a_rows],
                   [col[d] for d in l_rows])

    def view(side, sub):
        return None if sub is None else GridMesh(
            rank=sub.rank * M + grid.row.rank, world=len(side) * M,
            device=grid.device, data=sub, row=grid.row)

    return SubmeshPlan(
        actor=view(a_rows, column.actor), learner=view(l_rows,
                                                       column.learner),
        actor_ranks=tuple(d * M + s for d in a_rows for s in range(M)),
        learner_ranks=tuple(d * M + s for d in l_rows for s in range(M)),
        shared=False, mesh=grid, column=column)


def shrink_actors(plan: SubmeshPlan, drop_index: int,
                  batch_size: int = 0) -> SubmeshPlan | None:
    """Remove one actor rank (an ``actor_preempt`` casualty) from the plan.

    ``drop_index`` indexes the CURRENT actor ranks modulo their count,
    mirroring how chaos faults address phantom hosts. Survivors reclamp to
    the largest batch divisor. Returns ``None`` when no actor survives:
    the caller falls back to the sync schedule on the learner submesh."""
    if plan.shared or plan.n_actors <= 1:
        return None
    if len(plan.mesh.axis_names) != 1:
        raise ValueError(
            "shrink_actors only handles 1-D plans: dropping one device from "
            "a (data, mp) grid would break the mp columns — shed a whole "
            "data row by re-planning instead")
    survivors = list(plan.actor_ranks)
    del survivors[drop_index % len(survivors)]
    keep = largest_divisor(batch_size, len(survivors))
    return _plan(plan.mesh, survivors[:keep], plan.learner_ranks)


def grow_actors(plan: SubmeshPlan | None, rank: int, initial: SubmeshPlan,
                batch_size: int = 0, dead=()) -> SubmeshPlan | None:
    """Re-admit one actor rank (the inverse of :func:`shrink_actors`).

    ``initial`` is the pristine pre-fault plan: membership AND order come
    from it, so a shrink -> grow round trip restores the original rank
    order. ``dead`` names ranks still known lost; every other rank of the
    initial plan returns with the rejoiner (including ranks the shrink
    clamped away for batch divisibility: they were shed, not preempted).
    ``plan`` is the current (possibly shrunk) plan, or ``None`` when the
    caller fell back to the sync schedule with no live actor. The grown
    set reclamps to the largest batch divisor. Returns ``None`` when the
    membership would not change (shared initial plan, or a duplicate
    rejoin the clamp swallows); raises if ``rank`` was never part of the
    initial plan."""
    if initial.shared:
        return None
    if len(initial.mesh.axis_names) != 1:
        raise ValueError(
            "grow_actors only handles 1-D plans: re-admission into a "
            "(data, mp) grid re-plans a whole data row instead")
    if rank not in initial.actor_ranks:
        raise ValueError(
            f"grow_actors rank {rank} was never in the initial actor plan "
            f"({initial.actor_ranks})")
    current = set() if plan is None or plan.shared else set(plan.actor_ranks)
    gone = set(dead) - {rank}
    members = tuple(r for r in initial.actor_ranks if r not in gone)
    members = members[:largest_divisor(batch_size, len(members))]
    if set(members) == current:
        return None
    return _plan(initial.mesh, members, initial.learner_ranks)
